"""Cache-aware HTTP router in front of a fleet of replica ingresses.

Counterpart of ``tree_attention_tpu/serving/router.py``. One engine behind
one ingress serves one machine's traffic; N of them behind round-robin
would dilute the radix prefix cache's hits by 1/N, since a prompt's shared
prefix would land on a different replica's tree each time. The router
routes by prefix instead (SGLang's cache-aware routing, arXiv:2312.07104):

- **An approximate radix tree per replica** (:class:`ReplicaTree`):
  block-granular, over the prompts routed there. The router never sees a
  replica's pool, only its own routing history and the replica's own
  report of each request's hit (``usage.prefix_hit_tokens``): a report of
  fewer hit tokens than predicted means the replica evicted that path, and
  the tree is truncated to match. An LRU cap and an optional TTL bound it.
- **Affinity with hysteresis**: the replica with the longest prefix match
  wins unless its in-flight load exceeds the fleet's least by more than
  ``hysteresis`` requests; then (and for cold prompts) the least loaded
  wins, round-robin among ties. The chosen replica's tree learns the
  prompt either way.
- **Failover and drain requeue**: a replica that refuses (503: draining
  or its engine died) or sheds a queued request before any token reached
  the client is retried on a peer (reason ``failover``) with the deadline
  budget that is left. This turns a replica's drain into a rolling restart
  that drops nothing.
- **Federation**: ``GET /metrics`` is the router's registry plus every
  replica's scrape under a ``replica`` label; ``GET /requests`` merges the
  request ledgers (this process's, where in-process replicas record,
  labelled with the replica the router relayed the uid to, or ``local``
  for one it did not route, and every replica endpoint's, labelled with
  that replica); ``GET /healthz`` rolls
  up tick liveness, so a wedged replica fails the fleet's check; ``GET
  /flight`` returns this process's flight ring and every replica's.
- **Trace propagation**: the router adopts the client's W3C
  ``traceparent`` (or mints one) and forwards it with its routing span as
  the parent, so the client's trace id lands in the replica's ledger.

The router passes the replica's SSE events through byte for byte, so a
routed stream is token-identical to serving the replica directly. Handler
threads share the replica registry, the trees and the in-flight counts;
every mutation holds ``self._lock`` (re-entrant), and replica I/O runs
outside it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, List, Optional, Set, Tuple

from tree_attention_tpu_torch import obs
from tree_attention_tpu_torch.utils.httpd import DaemonHTTPServer
from tree_attention_tpu_torch.utils.logging import get_logger

log = get_logger("serving.router")

#: Routing reasons — the label vocabulary of serving_router_requests_total.
REASON_AFFINITY = "affinity"          # longest-prefix match won
REASON_LEAST_LOADED = "least_loaded"  # cold prompt / hysteresis fallback
REASON_FAILOVER = "failover"          # re-route after a replica refused

#: How many finished uids the router remembers the replica of.
SERVED_BY_CAP = 4096

_ROUTED = obs.counter(
    "serving_router_requests_total",
    "requests routed, by replica and routing reason "
    "(affinity | least_loaded | failover)",
    labels=("replica", "reason"),
)
_AFFINITY_HITS = obs.counter(
    "serving_router_prefix_affinity_hits_total",
    "affinity-routed requests whose replica confirmed a prefix-cache hit "
    "(usage.prefix_hit_tokens > 0) — the router's bet, paid off",
)
_REPLICA_HEALTHY = obs.gauge(
    "serving_router_replica_healthy",
    "1 while the replica is routable (up, not draining), else 0",
    labels=("replica",),
)
_REPLICA_INFLIGHT = obs.gauge(
    "serving_router_replica_inflight",
    "requests this router currently has streaming from the replica",
    labels=("replica",),
)


class ReplicaTree:
    """Approximate radix tree over the prompts routed to ONE replica.

    Block-granular like the engine's real tree (a partial block can
    never be a cache hit replica-side, so the router scores in the same
    units), but with none of the pool machinery: nodes carry only a
    last-use stamp. Bounded two ways — an LRU node cap (``max_blocks``)
    and an optional ``ttl_s`` after which untouched subtrees decay — and
    corrected by replica feedback (:meth:`truncate`).

    NOT thread-safe on its own: the router mutates it under its lock.
    """

    def __init__(self, block: int = 16, max_blocks: int = 2048,
                 ttl_s: Optional[float] = None):
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        if max_blocks < 1:
            raise ValueError(f"max_blocks must be >= 1, got {max_blocks}")
        self.block = block
        self.max_blocks = max_blocks
        self.ttl_s = ttl_s
        # node = {key: [children-dict, last_use]} rooted at self._root.
        self._root: Dict[Tuple[int, ...], List[Any]] = {}
        self._count = 0

    @property
    def blocks(self) -> int:
        """Nodes (= full prompt blocks) currently tracked."""
        return self._count

    def _keys(self, tokens) -> List[Tuple[int, ...]]:
        toks = [int(t) for t in tokens]
        nb = len(toks) // self.block
        return [tuple(toks[j * self.block:(j + 1) * self.block])
                for j in range(nb)]

    def match(self, tokens) -> int:
        """Longest tracked prefix of ``tokens``, in tokens (full blocks)."""
        level = self._root
        matched = 0
        for key in self._keys(tokens):
            ent = level.get(key)
            if ent is None:
                break
            matched += self.block
            level = ent[0]
        return matched

    def insert(self, tokens, now: float) -> None:
        """Track the prompt's full blocks (touches the whole path)."""
        level = self._root
        for key in self._keys(tokens):
            ent = level.get(key)
            if ent is None:
                ent = [{}, now]
                level[key] = ent
                self._count += 1
            else:
                ent[1] = now
            level = ent[0]
        while self._count > self.max_blocks:
            if not self._evict_lru_leaf():
                break

    def truncate(self, tokens, keep_tokens: int) -> None:
        """Replica feedback: it only matched ``keep_tokens`` of this
        prompt, so everything the tree tracks past that point (along
        this path) is stale — drop the subtree there."""
        keep_blocks = max(keep_tokens, 0) // self.block
        keys = self._keys(tokens)
        if keep_blocks >= len(keys):
            return
        level = self._root
        for key in keys[:keep_blocks]:
            ent = level.get(key)
            if ent is None:
                return  # path already gone
            level = ent[0]
        ent = level.get(keys[keep_blocks])
        if ent is not None:
            self._count -= 1 + self._size(ent[0])
            del level[keys[keep_blocks]]

    def decay(self, now: float) -> int:
        """Drop subtrees untouched for ``ttl_s`` (no-op when ttl is off);
        returns nodes dropped. Stale affinity is worse than no affinity —
        it routes a request to a replica whose cache moved on."""
        if self.ttl_s is None:
            return 0
        dropped = self._decay_level(self._root, now)
        self._count -= dropped
        return dropped

    def clear(self) -> None:
        """Forget everything (a restarted replica's cache is empty)."""
        self._root = {}
        self._count = 0

    def _decay_level(self, level: Dict, now: float) -> int:
        dropped = 0
        for key in list(level):
            children, last_use = level[key]
            if now - last_use > self.ttl_s:
                dropped += 1 + self._size(children)
                del level[key]
            else:
                dropped += self._decay_level(children, now)
        return dropped

    def _size(self, level: Dict) -> int:
        return sum(1 + self._size(ent[0]) for ent in level.values())

    def _evict_lru_leaf(self) -> bool:
        """Drop the least-recently-used LEAF (interior nodes are live
        prefixes of their children — same rule as the engine's tree)."""
        best: Optional[Tuple[Dict, Tuple[int, ...]]] = None
        best_use = math.inf
        stack = [self._root]
        while stack:
            level = stack.pop()
            for key, (children, last_use) in level.items():
                if children:
                    stack.append(children)
                elif last_use < best_use:
                    best, best_use = (level, key), last_use
        if best is None:
            return False
        del best[0][best[1]]
        self._count -= 1
        return True


@dataclasses.dataclass
class _Replica:
    """Router-side view of one replica ingress."""

    name: str
    host: str
    port: int
    metrics_url: Optional[str] = None
    state: str = "up"  # up | draining | down

    @property
    def routable(self) -> bool:
        return self.state == "up"


class FleetRouter(DaemonHTTPServer):
    """The fleet front door: affinity-routed pass-through proxy.

    Args:
      block: prefix granularity of the approximate trees — MUST equal
        the replicas' ``--prefix-block`` (scores in any other unit would
        promise hits the replicas cannot deliver).
      affinity: route by longest-prefix match (False = pure least-loaded
        with round-robin tie-break — the dilution baseline).
      hysteresis: max in-flight excess (over the fleet minimum) an
        affinity pick may carry before least-loaded overrides it.
      min_match: smallest prefix match (tokens) worth routing on
        (default: one block).
      max_tree_blocks / tree_ttl_s: per-replica tree bounds.
      replica_timeout_s: read timeout on replica connections (the
        ingress's SSE keepalives tick faster than this unless the
        replica process is gone).
    """

    thread_name = "serving-router"

    def __init__(
        self,
        *,
        port: int = 0,
        host: str = "127.0.0.1",
        block: int = 16,
        affinity: bool = True,
        hysteresis: int = 2,
        min_match: Optional[int] = None,
        max_tree_blocks: int = 2048,
        tree_ttl_s: Optional[float] = None,
        replica_timeout_s: float = 60.0,
    ):
        super().__init__(port, host)
        if hysteresis < 0:
            raise ValueError(f"hysteresis must be >= 0, got {hysteresis}")
        self.block = block
        self.affinity = affinity
        self.hysteresis = hysteresis
        self.min_match = block if min_match is None else min_match
        self.max_tree_blocks = max_tree_blocks
        self.tree_ttl_s = tree_ttl_s
        self.replica_timeout_s = replica_timeout_s
        self._lock = threading.RLock()
        self._replicas: Dict[str, _Replica] = {}
        self._trees: Dict[str, ReplicaTree] = {}
        self._inflight: Dict[str, int] = {}
        self._rr = 0  # round-robin cursor for least-loaded ties
        self._last_decay = 0.0  # TTL sweeps are periodic, not per-route
        self._routed = {REASON_AFFINITY: 0, REASON_LEAST_LOADED: 0,
                        REASON_FAILOVER: 0}
        self._requeued = 0   # shed/refused work replayed onto a peer
        self._dropped = 0    # accepted work the router could NOT save
        # uid -> the replica that finished it (read off the relayed
        # ``cmpl-<uid>`` ids; bounded like the ledger's recent ring): how
        # /requests labels this process's ledgers, which in-process
        # replicas share.
        self._served_by: "OrderedDict[int, str]" = OrderedDict()

    # -- replica registry (the fleet supervisor's seam) -------------------

    def add_replica(self, name: str, port: int, *,
                    host: str = "127.0.0.1",
                    metrics_url: Optional[str] = None) -> None:
        with self._lock:
            if name in self._replicas:
                raise ValueError(f"replica {name!r} already registered")
            self._replicas[name] = _Replica(name, host, port, metrics_url)
            self._trees[name] = ReplicaTree(
                block=self.block, max_blocks=self.max_tree_blocks,
                ttl_s=self.tree_ttl_s,
            )
            self._inflight[name] = 0
        self._publish_health(name, True)

    def set_draining(self, name: str) -> None:
        """Stop routing NEW work to the replica (rolling-restart phase
        one); its in-flight streams keep relaying."""
        with self._lock:
            self._replicas[name].state = "draining"
        self._publish_health(name, False)

    def mark_down(self, name: str) -> None:
        with self._lock:
            rep = self._replicas.get(name)
            if rep is None or rep.state == "down":
                return
            rep.state = "down"
        self._publish_health(name, False)
        log.warning("router: replica %s marked down", name)

    def rejoin(self, name: str, *, port: Optional[int] = None,
               reset_tree: bool = True) -> None:
        """Route to the replica again (rolling-restart phase three). A
        restarted process has an empty radix cache — ``reset_tree``
        clears the router's view so affinity is re-learned, not
        hallucinated."""
        with self._lock:
            rep = self._replicas[name]
            rep.state = "up"
            if port is not None:
                rep.port = port
            if reset_tree:
                self._trees[name].clear()
        self._publish_health(name, True)

    def _publish_health(self, name: str, healthy: bool) -> None:
        if obs.REGISTRY.enabled:
            _REPLICA_HEALTHY.labels(replica=name).set(1 if healthy else 0)

    @property
    def replica_names(self) -> List[str]:
        with self._lock:
            return sorted(self._replicas)

    # -- routing policy ---------------------------------------------------

    def choose(self, prompt, exclude: Set[str] = frozenset(),
               now: Optional[float] = None,
               ) -> Tuple[Optional[str], str, int]:
        """Pick a replica for ``prompt``: (name, reason, predicted-match).

        Affinity wins when the best longest-prefix match is at least
        ``min_match`` tokens AND that replica's in-flight excess over
        the fleet minimum is within ``hysteresis``; otherwise
        least-loaded (round-robin among ties). Either way the chosen
        replica's tree learns the prompt. Public and HTTP-free so the
        scoring tests drive it directly.
        """
        now = time.monotonic() if now is None else now
        with self._lock:
            names = [n for n, r in self._replicas.items()
                     if r.routable and n not in exclude]
            if not names:
                return None, REASON_LEAST_LOADED, 0
            names.sort()
            if (self.tree_ttl_s is not None
                    and now - self._last_decay >= self.tree_ttl_s / 2):
                # Amortized: a full-tree sweep per routed request would
                # serialize handler threads behind O(fleet x tree) work;
                # twice per TTL keeps staleness bounded at 1.5x ttl.
                self._last_decay = now
                for n in names:
                    self._trees[n].decay(now)
            loads = {n: self._inflight[n] for n in names}
            min_load = min(loads.values())
            pick: Optional[str] = None
            reason = REASON_LEAST_LOADED
            matched = 0
            if self.affinity:
                best, best_m = None, 0
                for n in names:
                    m = self._trees[n].match(prompt)
                    if m > best_m:
                        best, best_m = n, m
                if (best is not None and best_m >= self.min_match
                        and loads[best] - min_load <= self.hysteresis):
                    pick, reason, matched = best, REASON_AFFINITY, best_m
            if pick is None:
                ties = [n for n in names if loads[n] == min_load]
                pick = ties[self._rr % len(ties)]
                self._rr += 1
            if exclude:
                reason = REASON_FAILOVER
            self._trees[pick].insert(prompt, now)
            self._inflight[pick] += 1
            self._routed[reason] += 1
            if obs.REGISTRY.enabled:
                _ROUTED.labels(replica=pick, reason=reason).inc()
                _REPLICA_INFLIGHT.labels(replica=pick).set(
                    self._inflight[pick]
                )
            return pick, reason, matched

    def finish(self, name: str, prompt, *, reason: str,
               predicted: int, hit_tokens: Optional[int]) -> None:
        """One routed stream ended. ``hit_tokens`` is the replica's own
        report (``usage.prefix_hit_tokens``; None = stream died before a
        finish event): the feedback that keeps the approximate tree
        honest — fewer hit tokens than predicted means the replica
        evicted that path, so the router forgets it too."""
        with self._lock:
            if name in self._inflight:
                self._inflight[name] = max(self._inflight[name] - 1, 0)
                if obs.REGISTRY.enabled:
                    _REPLICA_INFLIGHT.labels(replica=name).set(
                        self._inflight[name]
                    )
            if hit_tokens is None:
                return
            if reason == REASON_AFFINITY and hit_tokens > 0:
                _AFFINITY_HITS.inc()
            if hit_tokens + self.block <= predicted:
                self._trees[name].truncate(prompt, hit_tokens)

    # -- HTTP surface -----------------------------------------------------

    def handle(self, method: str, req: BaseHTTPRequestHandler) -> None:
        path = req.path.split("?", 1)[0].rstrip("/") or "/"
        if method == "POST" and path == "/v1/completions":
            self._completions(req)
        elif method == "GET" and path == "/router/stats":
            self.reply(req, 200, json.dumps(self.stats(), indent=2),
                       "application/json")
        elif method == "GET" and path == "/metrics":
            self.reply(req, 200, self.federated_metrics(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif method == "GET" and path == "/requests":
            self.reply(req, 200,
                       json.dumps(self.federated_requests(), indent=2),
                       "application/json")
        elif method == "GET" and path == "/healthz":
            code, body = self.federated_health()
            self.reply(req, code, json.dumps(body, indent=2),
                       "application/json")
        elif method == "GET" and path == "/flight":
            self.reply(req, 200,
                       json.dumps(self.federated_flight(), indent=2,
                                  default=str),
                       "application/json")
        elif method == "GET" and path == "/":
            self.reply(
                req, 200,
                "tree_attention_tpu_torch serving router: "
                "POST /v1/completions  GET /router/stats  GET /metrics  "
                "GET /requests  GET /healthz  GET /flight\n",
                "text/plain",
            )
        else:
            self.reply(req, 404, f"no such endpoint: {method} {path}\n",
                       "text/plain")

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "affinity": self.affinity,
                "hysteresis": self.hysteresis,
                "routed": dict(self._routed),
                "requeued": self._requeued,
                "dropped": self._dropped,
                "replicas": {
                    n: {
                        "state": r.state,
                        "port": r.port,
                        "inflight": self._inflight[n],
                        "tree_blocks": self._trees[n].blocks,
                    }
                    for n, r in sorted(self._replicas.items())
                },
            }

    def federated_metrics(self) -> str:
        """The router's registry plus every replica scrape under a
        ``replica`` label — one Prometheus target for the fleet."""
        with self._lock:
            targets = [(r.name, r.metrics_url) for r in
                       self._replicas.values() if r.metrics_url]
        # Concurrent scrapes: the targets are independent replicas, and
        # k of them being mid-restart must cost ONE timeout, not k
        # serial ones, on every Prometheus poll.
        sections: Dict[str, str] = {}
        threads = []
        for name, url in targets:

            def scrape_one(name=name, url=url):
                text = _scrape(url, timeout=2.0)
                if text is not None:
                    sections[name] = text  # per-key writes; GIL-atomic

            t = threading.Thread(target=scrape_one, daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=3.0)
        own = obs.REGISTRY.to_prometheus()
        fed = federate_metrics(sections)
        return own + ("\n" + fed if fed else "")

    # -- telemetry federation ---------------------------------------------

    def _obs_targets(self) -> List[Tuple[str, str, str]]:
        """(name, obs-base-url, state) per replica that exports one —
        derived from the registered ``metrics_url`` by stripping its
        ``/metrics`` path (the obs server mounts every endpoint on one
        port). In-process replicas have none: they record into THIS
        process's singletons, covered by the ``local`` section."""
        with self._lock:
            reps = list(self._replicas.values())
        out = []
        for r in reps:
            if r.metrics_url and r.metrics_url.endswith("/metrics"):
                out.append((r.name, r.metrics_url[:-len("/metrics")],
                            r.state))
        return out

    def federated_requests(self) -> Dict[str, Any]:
        """Fleet-wide request-ledger view: every entry labeled with the
        replica it ran on. This process's ledgers (where LocalReplica
        engines record) take the replica the router relayed their uid to,
        or ``local`` for a uid it did not route."""
        out: Dict[str, Any] = {"live": [], "recent": []}
        local = obs.REQLOG.snapshot()
        with self._lock:
            served = dict(self._served_by)
        for section in ("live", "recent"):
            for entry in local[section]:
                entry["replica"] = served.get(entry.get("uid"), "local")
                out[section].append(entry)
        for name, base, _state in self._obs_targets():
            snap = _get_json(f"{base}/requests", timeout=2.0)
            if not isinstance(snap, dict):
                continue
            for section in ("live", "recent"):
                for entry in snap.get(section) or []:
                    entry["replica"] = name
                    out[section].append(entry)
        return out

    def federated_health(self) -> Tuple[int, Dict[str, Any]]:
        """Fleet tick-liveness roll-up: 503 iff this process is stalled,
        any replica obs endpoint reports stalled (a WEDGED engine whose
        HTTP thread still answers — the failure /healthz exists to
        catch), or a replica the router still considers up has an
        unreachable obs endpoint (process gone mid-scrape)."""
        from tree_attention_tpu_torch.obs.http import flight_health

        code, own = flight_health(obs.FLIGHT)
        body: Dict[str, Any] = {"router": own, "replicas": {}}
        worst = code
        for name, base, state in self._obs_targets():
            snap = _get_json(f"{base}/healthz", timeout=2.0,
                             accept_errors=True)
            if not isinstance(snap, dict):
                snap = {"status": "unreachable"}
                if state == "up":
                    worst = 503
            elif snap.get("status") == "stalled":
                worst = 503
            snap["state"] = state
            body["replicas"][name] = snap
        body["status"] = "ok" if worst == 200 else "stalled"
        return worst, body

    def federated_flight(self) -> Dict[str, Any]:
        """The router process's flight ring plus every reachable
        replica's — the fleet-wide live post-mortem."""
        out: Dict[str, Any] = {"router": obs.FLIGHT.snapshot(),
                               "replicas": {}}
        for name, base, _state in self._obs_targets():
            snap = _get_json(f"{base}/flight", timeout=2.0)
            out["replicas"][name] = (
                snap if isinstance(snap, dict) else {"error": "unreachable"}
            )
        return out

    # -- the proxy --------------------------------------------------------

    def _completions(self, req: BaseHTTPRequestHandler) -> None:
        # Validate EVERYTHING the router itself consumes BEFORE choose()
        # takes accounting (tree insert, in-flight increment, routed
        # counter): a failure after that point would leak the replica's
        # in-flight count — the ingress's brick-the-server class, one
        # tier up.
        try:
            n = int(req.headers.get("Content-Length", 0))
            body = json.loads(req.rfile.read(n) or b"{}")
            prompt = body.get("prompt")
            if (not isinstance(prompt, list) or not prompt
                    or not all(isinstance(t, int)
                               and not isinstance(t, bool)
                               for t in prompt)):
                raise ValueError(
                    "body.prompt must be a non-empty list of token ids"
                )
            if body.get("deadline_s") is not None:
                body["deadline_s"] = float(body["deadline_s"])
        except (TypeError, ValueError, json.JSONDecodeError) as e:
            self.reply(req, 400, json.dumps({"error": {
                "message": f"unroutable request: {e}",
                "type": "invalid_request"}}), "application/json")
            return
        stream = bool(body.get("stream", True))
        # Trace context: the router is the first hop that traces, so it
        # owns the trace_id — adopt the client's
        # traceparent when one arrived, mint otherwise. Each relay
        # attempt below forwards it with a fresh routing span id.
        parsed = obs.parse_traceparent(
            req.headers.get(obs.TRACEPARENT_HEADER, ""))
        trace_id = parsed[0] if parsed is not None else obs.new_trace_id()
        orig_deadline = body.get("deadline_s")
        t0 = time.monotonic()
        tried: Set[str] = set()
        relay = _ClientRelay(req, stream)
        while True:
            name, reason, predicted = self.choose(prompt, exclude=tried)
            if name is None:
                self._give_up(relay, tried)
                return
            with self._lock:
                rep = self._replicas[name]
                host, port = rep.host, rep.port
            if orig_deadline is not None:
                # The peer must see only the deadline budget actually
                # left — a failover retry does not reset the clock.
                body["deadline_s"] = max(
                    orig_deadline - (time.monotonic() - t0), 1e-3
                )
            verdict = self._relay_one(relay, name, host, port, body,
                                      prompt, reason, predicted, trace_id)
            if verdict == "done":
                return
            # "retry": the replica refused (503/shed/dead) before any
            # token reached the client — requeue on a peer.
            tried.add(name)
            with self._lock:
                self._requeued += 1

    def _give_up(self, relay: "_ClientRelay", tried: Set[str]) -> None:
        with self._lock:
            if tried:
                # Accepted work we failed to place anywhere — the count
                # a rolling restart must keep at zero.
                self._dropped += 1
        relay.error(
            503, "no routable replica (fleet draining or down)",
            finish_reason="shed",
        )

    def _relay_one(self, relay: "_ClientRelay", name: str, host: str,
                   port: int, body: Dict[str, Any], prompt,
                   reason: str, predicted: int, trace_id: str) -> str:
        """Proxy one attempt to one replica; returns 'done' | 'retry'."""
        import http.client

        # Routing span: a fresh span id per attempt (a failover retry is
        # its OWN hop in the trace), forwarded as the replica's parent.
        # The flow "s" point inside the slice starts the cross-process
        # arrow the replica's adopt points continue.
        rspan = obs.new_span_id()
        if obs.TRACER.active:
            with obs.span("route_relay", cat="serving",
                          args={"replica": name, "reason": reason,
                                "trace_id": trace_id,
                                "predicted_match": predicted}):
                obs.flow("s", obs.flow_id(trace_id))
        hit_tokens: Optional[int] = None
        uid: Optional[int] = None  # the replica's uid, from its finish
        conn = http.client.HTTPConnection(
            host, port, timeout=self.replica_timeout_s
        )
        try:
            try:
                conn.request(
                    "POST", "/v1/completions", json.dumps(body),
                    {"Content-Type": "application/json",
                     obs.TRACEPARENT_HEADER: obs.make_traceparent(
                         trace_id, rspan)},
                )
                resp = conn.getresponse()
            except OSError:
                # Connection refused/reset: the replica process is gone
                # (mid-restart). Health-wise that is DOWN until the
                # supervisor rejoins it.
                self.mark_down(name)
                return "retry"
            if resp.status != 200:
                try:
                    data = resp.read()
                except OSError:
                    self.mark_down(name)
                    data = b""
                if resp.status == 503 and not relay.started:
                    return "retry"  # draining/dead replica: requeue
                # Backpressure (429 + Retry-After) and validation (400)
                # verdicts pass through — the replica's answer IS the
                # fleet's answer.
                relay.passthrough(resp.status, data, dict(
                    (k, v) for k, v in resp.getheaders()
                    if k.lower() == "retry-after"
                ))
                return "done"
            if not relay.stream:
                try:
                    data = resp.read()
                except OSError:
                    # Replica died mid-body; nothing reached the client
                    # yet (passthrough is all-or-nothing) — requeue.
                    self.mark_down(name)
                    return "retry"
                verdict, hit_tokens, uid = _whole_verdict(data)
                if verdict == "retry":
                    return "retry"
                relay.passthrough(200, data, {})
                return "done"
            events = _iter_events(resp)
            while True:
                try:
                    raw, payload = next(events)
                except StopIteration:
                    break
                except OSError:
                    # Replica-side READ failure mid-stream (TCP reset
                    # from a dying process, or a wedged replica that
                    # stopped sending even keepalives until the read
                    # timed out) — distinct from a client-side write
                    # failure, which raises from relay.write below and
                    # propagates (the disconnect-cancel arc).
                    self.mark_down(name)
                    if not relay.started:
                        return "retry"
                    relay.error(503, "replica lost mid-stream",
                                finish_reason="error")
                    return "done"
                if payload is None:  # comment/keepalive frame
                    relay.write(raw)
                    continue
                if payload == b"[DONE]":
                    relay.write(raw)
                    return "done"
                kind, info = _classify_event(payload)
                if kind == "token":
                    relay.write(raw, token=True)
                elif kind == "finish":
                    hit_tokens = info.get("prefix_hit_tokens")
                    uid = _uid_of(info.get("id"))
                    if (info.get("finish_reason") == "shed"
                            and not relay.started):
                        _drain_done(resp)
                        return "retry"
                    relay.write(raw)
                else:  # replica-side error event (engine died mid-run)
                    self.mark_down(name)
                    if not relay.started:
                        _drain_done(resp)
                        return "retry"
                    relay.write(raw)
            # EOF without [DONE]: the replica vanished mid-stream.
            self.mark_down(name)
            if not relay.started:
                return "retry"
            relay.error(503, "replica lost mid-stream",
                        finish_reason="error")
            return "done"
        finally:
            conn.close()
            self.finish(name, prompt, reason=reason, predicted=predicted,
                        hit_tokens=hit_tokens)
            if uid is not None:
                with self._lock:
                    self._served_by[uid] = name
                    if len(self._served_by) > SERVED_BY_CAP:
                        self._served_by.popitem(last=False)


class _ClientRelay:
    """The router->client half of one proxied request.

    Tracks whether any token bytes reached the client: before that point
    a failed attempt is silently retryable; after it, the stream is
    committed to this attempt (a replayed request would duplicate
    tokens)."""

    def __init__(self, req: BaseHTTPRequestHandler, stream: bool):
        self.req = req
        self.stream = stream
        self.started = False  # a token (or terminal body) reached the client
        self._headers_sent = False

    def _ensure_sse_headers(self) -> None:
        if not self._headers_sent:
            self.req.send_response(200)
            self.req.send_header("Content-Type", "text/event-stream")
            self.req.send_header("Cache-Control", "no-cache")
            self.req.end_headers()
            self._headers_sent = True

    def write(self, raw: bytes, token: bool = False) -> None:
        self._ensure_sse_headers()
        if token:
            self.started = True
        self.req.wfile.write(raw)
        self.req.wfile.flush()

    def passthrough(self, code: int, data: bytes,
                    headers: Dict[str, str]) -> None:
        if self._headers_sent:
            # An earlier attempt already opened the SSE stream (keepalive
            # frames only — else we would not be retrying): a status line
            # now would corrupt the protocol, so the verdict becomes an
            # SSE error frame instead.
            self.error(code, data.decode("utf-8", "replace"),
                       finish_reason="error")
            return
        self.started = True
        self.req.send_response(code)
        self.req.send_header("Content-Type", "application/json")
        self.req.send_header("Content-Length", str(len(data)))
        for k, v in headers.items():
            self.req.send_header(k, str(v))
        self.req.end_headers()
        self.req.wfile.write(data)

    def error(self, code: int, message: str, finish_reason: str) -> None:
        payload = {"error": {"message": message, "type": "server_error"},
                   "finish_reason": finish_reason}
        if self.stream and self._headers_sent:
            self.req.wfile.write(
                b"data: " + json.dumps(payload).encode() + b"\n\n"
                b"data: [DONE]\n\n"
            )
            self.req.wfile.flush()
        else:
            data = json.dumps(payload, indent=2).encode()
            self.req.send_response(code)
            self.req.send_header("Content-Type", "application/json")
            self.req.send_header("Content-Length", str(len(data)))
            self.req.end_headers()
            self.req.wfile.write(data)


# -- SSE/JSON plumbing ------------------------------------------------------


def _iter_events(resp):
    """Yield (raw_bytes, payload) per complete SSE frame: payload is the
    ``data:`` line's content, or None for comment/keepalive frames. Raw
    bytes are exactly what came off the wire — the pass-through
    guarantee lives here."""
    raw: List[bytes] = []
    payload: Optional[bytes] = None
    while True:
        line = resp.readline()
        if not line:
            return  # EOF
        raw.append(line)
        if line.startswith(b"data: "):
            payload = line[6:].strip()
        if line == b"\n":  # frame terminator
            yield b"".join(raw), payload
            raw, payload = [], None


def _classify_event(payload: bytes) -> Tuple[str, Dict[str, Any]]:
    """'token' | 'finish' | 'error' for one data: payload."""
    try:
        d = json.loads(payload)
    except json.JSONDecodeError:
        return "error", {}
    if "error" in d:
        return "error", d
    ch = (d.get("choices") or [{}])[0]
    if ch.get("finish_reason") is None:
        return "token", ch
    usage = d.get("usage") or {}
    return "finish", {
        "finish_reason": ch.get("finish_reason"),
        "prefix_hit_tokens": usage.get("prefix_hit_tokens"),
        "id": d.get("id"),
    }


def _whole_verdict(data: bytes
                   ) -> Tuple[str, Optional[int], Optional[int]]:
    """'retry' iff a stream:false body reports shed with no tokens; with
    the body's prefix hit and uid."""
    try:
        d = json.loads(data)
    except json.JSONDecodeError:
        return "done", None, None
    ch = (d.get("choices") or [{}])[0]
    usage = d.get("usage") or {}
    if ch.get("finish_reason") == "shed" and not ch.get("token_ids"):
        return "retry", None, None
    return "done", usage.get("prefix_hit_tokens"), _uid_of(d.get("id"))


def _uid_of(response_id: Any) -> Optional[int]:
    """The engine uid in an ingress response id (``cmpl-<uid>``)."""
    if isinstance(response_id, str) and response_id.startswith("cmpl-"):
        try:
            return int(response_id[len("cmpl-"):])
        except ValueError:
            return None
    return None


def _drain_done(resp) -> None:
    """Consume the [DONE] frame after a swallowed finish event, so the
    replica handler sees a clean read-to-end, not a reset. Best-effort:
    a replica dying right here must not abort the caller's retry."""
    try:
        for _, payload in _iter_events(resp):
            if payload == b"[DONE]":
                return
    except OSError:
        pass


def _scrape(url: str, timeout: float) -> Optional[str]:
    """Best-effort GET of one replica's /metrics text."""
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.read().decode("utf-8", "replace")
    except OSError:
        return None


def _get_json(url: str, timeout: float,
              accept_errors: bool = False) -> Optional[Any]:
    """Best-effort GET + JSON parse of one replica obs endpoint.
    ``accept_errors`` keeps non-2xx BODIES (a 503 /healthz still carries
    its status JSON — that verdict is the payload, not a failure)."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        if not accept_errors:
            return None
        try:
            return json.loads(e.read())
        except (OSError, ValueError):
            return None
    except (OSError, ValueError):
        return None


def federate_metrics(sections: Dict[str, str]) -> str:
    """Merge per-replica Prometheus expositions under a ``replica`` label.

    ``# HELP``/``# TYPE`` lines are kept once per metric (first replica
    wins); every sample line gains ``replica="<name>"`` as its first
    label. Pure text-to-text so the tests pin it without HTTP."""
    out: List[str] = []
    seen_meta: Set[Tuple[str, str]] = set()
    for name in sorted(sections):
        for line in sections[name].splitlines():
            if not line.strip():
                continue
            if line.startswith("#"):
                parts = line.split(None, 3)
                # Key by (directive, metric): HELP and TYPE for one
                # metric must BOTH survive — deduping on the metric
                # name alone dropped every TYPE line behind its HELP.
                key = (parts[1] if len(parts) > 1 else "",
                       parts[2] if len(parts) > 2 else line)
                if key in seen_meta:
                    continue
                seen_meta.add(key)
                out.append(line)
                continue
            brace = line.find("{")
            space = line.find(" ")
            if brace != -1 and (space == -1 or brace < space):
                out.append(f'{line[:brace]}{{replica="{name}",'
                           f'{line[brace + 1:]}')
            elif space != -1:
                mname, rest = line.split(None, 1)
                out.append(f'{mname}{{replica="{name}"}} {rest}')
            # else: not a Prometheus sample line (truncated scrape, an
            # error page behind the url) — drop it rather than kill the
            # fleet-wide /metrics response with an unpack error.
    return "\n".join(out) + ("\n" if out else "")
