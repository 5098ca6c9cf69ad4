"""Fleet supervision: N in-process replica engines behind one router.

Counterpart of ``tree_attention_tpu/serving/fleet.py`` for in-process
replicas. :mod:`.router` routes; this module is the lifecycle around it:

- :class:`LocalReplica`: one :class:`SlotServer` (or :class:`DisaggServer`)
  behind one :class:`IngressServer` on a loopback port. A restart wraps the
  same warmed engine in a fresh ingress (a drained engine serves again), so
  a rolling restart costs milliseconds and no kernel is built twice. This
  is the CLI's ``--serve-fleet`` shape.
- :class:`FleetSupervisor`: starts the replicas and the router, polls the
  replicas' health on a monitor thread (an unhealthy one is marked down in
  the router and restarted while its budget lasts), and rolls the fleet
  without drops: drain one replica (the router stops routing to it, its
  queued work sheds and is requeued on peers, its streams finish), restart
  it, wait until it is ready, rejoin it with a cleared affinity tree, then
  the next.

A replica as a child process (the reference's ``ProcessReplica``, with its
process supervision) is not ported yet (ROADMAP queue A4.5).

The supervisor's state is shared by its caller's thread and the monitor
thread: every mutation holds ``self._lock``, and whole drain/restart
sequences hold ``self._op_lock``. HTTP I/O runs outside the locks.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from tree_attention_tpu_torch.serving.ingress import IngressServer
from tree_attention_tpu_torch.serving.router import FleetRouter
from tree_attention_tpu_torch.utils.logging import get_logger

log = get_logger("serving.fleet")


class LocalReplica:
    """In-process replica: one engine + one ingress on a loopback port.

    ``engine_factory`` is called once, lazily at first start; restarts
    wrap the SAME engine in a fresh :class:`IngressServer` (new port —
    the supervisor re-registers it with the router). The engine's radix
    cache therefore *survives* an in-process restart; the router still
    clears its affinity tree on rejoin, which is merely conservative
    (affinity re-learns in one request per prefix).
    """

    def __init__(self, name: str, engine_factory: Callable[[], Any], *,
                 max_queue: int = 64,
                 default_deadline_s: Optional[float] = None,
                 default_max_tokens: int = 16,
                 keepalive_s: float = 0.5):
        self.name = name
        self.metrics_url: Optional[str] = None  # in-process replicas
        # share the router's registry; there is nothing to federate
        self._factory = engine_factory
        self._ingress_kw = dict(
            max_queue=max_queue,
            default_deadline_s=default_deadline_s,
            default_max_tokens=default_max_tokens,
            keepalive_s=keepalive_s,
        )
        self._lock = threading.RLock()
        self._engine: Optional[Any] = None
        self._ingress: Optional[IngressServer] = None

    @property
    def engine(self):
        with self._lock:
            if self._engine is None:
                self._engine = self._factory()
            return self._engine

    @property
    def port(self) -> int:
        with self._lock:
            return 0 if self._ingress is None else self._ingress.port

    def start(self) -> int:
        engine = self.engine  # build outside the assignment lock hold
        with self._lock:
            if self._ingress is not None and self._ingress.running:
                return self._ingress.port
            ing = IngressServer(engine, port=0, **self._ingress_kw)
            self._ingress = ing
        return ing.start()

    def ready(self) -> bool:
        with self._lock:
            ing = self._ingress
        return (ing is not None and ing.running and not ing.draining
                and ing.engine_error is None and ing.report is None)

    def begin_drain(self) -> None:
        with self._lock:
            ing = self._ingress
        if ing is not None:
            ing.drain()

    def await_drained(self, timeout_s: float = 60.0) -> bool:
        """Block until the engine loop returns its report, then tear the
        HTTP listener down; True iff it drained inside the timeout.

        On a timeout the listener is deliberately KEPT: the engine
        thread still owns the serve loop, and tearing down the ingress
        would let :meth:`restart`'s undrained guard pass — two
        concurrent serve() loops on one engine corrupt slot/pool state.
        A timed-out drain leaves the replica down-but-intact for a
        later retry."""
        with self._lock:
            ing = self._ingress
        if ing is None:
            return True
        report = ing.join(timeout=timeout_s)
        if report is None:
            return False  # engine loop still running: keep the guard up
        ing.stop()
        return True

    def restart(self) -> int:
        """Fresh ingress around the same warmed engine; returns the new
        port. The caller drains first — restarting an undrained replica
        raises (its engine thread still owns the serve loop)."""
        with self._lock:
            if self._ingress is not None and self._ingress.running:
                raise RuntimeError(
                    f"replica {self.name}: restart before drain "
                    f"(the engine thread still owns the serve loop)"
                )
            ing = IngressServer(self.engine, port=0, **self._ingress_kw)
            self._ingress = ing
        return ing.start()

    def stop(self) -> None:
        self.begin_drain()
        self.await_drained()

    def leak_report(self) -> Dict[str, int]:
        return self.engine.leak_report()


class FleetSupervisor:
    """Start, watch, and roll a fleet of replicas behind one router.

    Args:
      replicas: the replica handles (:class:`LocalReplica`).
      router: a pre-built :class:`FleetRouter` (its ``block`` must match
        the replicas' prefix block), or None to build a default.
      monitor_interval_s: health-poll period; 0 disables the monitor
        thread entirely (tests drive lifecycle explicitly).
      restarts: per-replica restart budget for UNPLANNED deaths (the
        elastic-recovery idiom); rolling restarts are planned and do not
        consume it.
    """

    def __init__(self, replicas: Sequence[Any], *,
                 router: Optional[FleetRouter] = None,
                 monitor_interval_s: float = 1.0,
                 restarts: int = 1):
        if not replicas:
            raise ValueError("a fleet needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique: {names}")
        self.replicas: Dict[str, Any] = {r.name: r for r in replicas}
        self.router = router if router is not None else FleetRouter()
        self.monitor_interval_s = monitor_interval_s
        self.restarts = restarts
        self._lock = threading.RLock()
        # Serializes whole drain/restart SEQUENCES (monitor recovery vs
        # rolling restart) — self._lock only guards state snapshots, so
        # without this a monitor poll could observe a mid-roll replica
        # as unhealthy and race a second restart into it.
        self._op_lock = threading.Lock()
        self._maintenance: set = set()  # replicas mid-rolling-restart
        self._restarts_used: Dict[str, int] = {n: 0 for n in names}
        self._monitor: Optional[threading.Thread] = None
        self._stop_monitor = threading.Event()

    # -- lifecycle --------------------------------------------------------

    def start(self) -> int:
        """Start every replica, register them, start the router (and the
        monitor); returns the router's port."""
        for name, rep in sorted(self.replicas.items()):
            port = rep.start()
            self.router.add_replica(name, port,
                                    metrics_url=rep.metrics_url)
            log.info("fleet: replica %s up on port %d", name, port)
        port = self.router.start()
        if self.monitor_interval_s > 0:
            with self._lock:
                self._monitor = threading.Thread(
                    target=self._monitor_loop, name="fleet-monitor",
                    daemon=True,
                )
                self._monitor.start()
        log.info("fleet: router up on http://127.0.0.1:%d (%d replicas)",
                 port, len(self.replicas))
        return port

    def stop(self) -> None:
        """Graceful fleet shutdown: stop the monitor, drain every
        replica (concurrently), then the router."""
        self._stop_monitor.set()
        with self._op_lock:
            # Barrier: an in-flight _check_one recovery (drain up to
            # 30s + restart) must complete before the fleet drains, or
            # it would rejoin/restart a replica AFTER stop() returned —
            # a serve loop nothing will ever drain.
            pass
        with self._lock:
            mon = self._monitor
        if mon is not None:
            mon.join(timeout=60.0)
        for name in self.replicas:
            self.router.set_draining(name)
        for rep in self.replicas.values():
            rep.begin_drain()
        for rep in self.replicas.values():
            rep.await_drained()
        self.router.stop()

    # -- health monitor ---------------------------------------------------

    def _monitor_loop(self) -> None:
        while not self._stop_monitor.wait(self.monitor_interval_s):
            for name, rep in list(self.replicas.items()):
                with self._lock:
                    if name in self._maintenance:
                        continue
                self._check_one(name, rep)

    def _check_one(self, name: str, rep) -> None:
        if rep.ready():
            return
        with self._op_lock:
            # Re-check under the operation lock: a rolling restart may
            # have taken this replica into maintenance (or finished
            # healing it) between the monitor's poll and here — acting
            # on the stale observation would double-drain the replica
            # and burn the unplanned-restart budget on planned work.
            # A requested shutdown also beats recovery: stop()'s barrier
            # must not be followed by a resurrection.
            if self._stop_monitor.is_set():
                return
            with self._lock:
                if name in self._maintenance:
                    return
            if rep.ready():
                return
            self.router.mark_down(name)
            with self._lock:
                used = self._restarts_used.get(name, 0)
                if used >= self.restarts:
                    return
                self._restarts_used[name] = used + 1
            log.warning("fleet: replica %s unhealthy; restarting "
                        "(attempt %d/%d)", name, used + 1, self.restarts)
            try:
                rep.begin_drain()
                if not rep.await_drained(timeout_s=30.0):
                    # Wedged drain: the engine thread still owns its
                    # serve loop — restarting now would double-serve the
                    # engine. Leave it down; the next poll retries.
                    log.error("fleet: replica %s drain timed out; "
                              "leaving it down", name)
                    return
                port = rep.restart()
            except (RuntimeError, OSError) as e:
                log.error("fleet: replica %s restart failed: %s", name, e)
                return
            self.router.rejoin(name, port=port, reset_tree=True)

    # -- rolling restart --------------------------------------------------

    def rolling_restart(self, *, drain_timeout_s: float = 60.0,
                        ready_timeout_s: float = 60.0) -> Dict[str, Any]:
        """Restart every replica, one at a time, with zero dropped
        accepted requests: the router stops routing to the victim, its
        queued work sheds replica-side and requeues router-side onto
        peers, its in-flight streams finish, then drain -> restart ->
        ready -> rejoin. Returns per-replica outcomes."""
        out: Dict[str, Any] = {}
        for name in sorted(self.replicas):
            rep = self.replicas[name]
            with self._op_lock:
                # Mutual exclusion with the monitor's recovery path: a
                # concurrent unplanned restart of the SAME replica would
                # double-drain it.
                with self._lock:
                    self._maintenance.add(name)
            try:
                self.router.set_draining(name)
                rep.begin_drain()
                drained = rep.await_drained(timeout_s=drain_timeout_s)
                if not drained:
                    # The engine loop is wedged past the timeout:
                    # restarting would double-serve the engine. Mark it
                    # down (it takes no routes), move on — the fleet
                    # keeps serving on its peers.
                    self.router.mark_down(name)
                    out[name] = {"drained": False, "skipped": True}
                    log.error("fleet: rolling restart of %s aborted — "
                              "drain timed out; replica left down", name)
                    continue
                leak = (rep.leak_report()
                        if hasattr(rep, "leak_report") else None)
                port = rep.restart()
                deadline = time.monotonic() + ready_timeout_s
                while not rep.ready():
                    if time.monotonic() >= deadline:
                        raise RuntimeError(
                            f"replica {name} not ready after restart"
                        )
                    time.sleep(0.05)
                self.router.rejoin(name, port=port, reset_tree=True)
                out[name] = {"drained": drained, "port": port,
                             **({"leak": leak} if leak else {})}
                log.info("fleet: rolled %s (drained=%s, new port %d)",
                         name, drained, port)
            finally:
                with self._lock:
                    self._maintenance.discard(name)
        return out

    # -- introspection ----------------------------------------------------

    def leak_reports(self) -> Dict[str, Dict[str, int]]:
        return {n: r.leak_report() for n, r in self.replicas.items()
                if hasattr(r, "leak_report")}

    @property
    def engines(self) -> List[Any]:
        """The in-process engines, one per :class:`LocalReplica`."""
        return [r.engine for r in self.replicas.values()
                if isinstance(r, LocalReplica)]


def install_fleet_drain_signals(supervisor: FleetSupervisor
                                ) -> threading.Event:
    """SIGTERM/SIGINT -> set the returned event (main thread only).

    The ingress's :func:`install_drain_signals` drains one server from
    inside the handler because drain() is a quick flag flip; a fleet
    drain JOINS N engine loops, which must not run in a signal handler.
    So the handler only sets an event — the caller (the CLI's fleet
    loop) waits on it and runs :meth:`FleetSupervisor.stop` on the main
    thread. A second signal while draining escalates to the previous
    handler (an operator's double-SIGTERM must still kill a stuck
    drain), the same rule the ingress uses.
    """
    import signal

    evt = threading.Event()
    prev = {}

    def _begin_drain(signum, frame):
        if evt.is_set():
            handler = prev.get(signum)
            if callable(handler):
                handler(signum, frame)
            else:
                signal.signal(signum, signal.SIG_DFL)
                import os

                os.kill(os.getpid(), signum)
            return
        evt.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        prev[sig] = signal.signal(sig, _begin_drain)
    return evt
