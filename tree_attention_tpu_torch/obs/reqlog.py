"""Per-request cost ledger: where did one request's time and KV go?

Counterpart of ``tree_attention_tpu/obs/reqlog.py``. The registry counts
and the tracer records spans; neither answers for ONE request how long it
queued, prefilled, waited in a handoff and decoded, how many prompt tokens
the prefix cache served, how many device block-seconds its KV held, or
what speculation proposed and kept for it. One :class:`RequestLedger` per
uid, opened at the engine's one admission seam, fed at its block-growth,
first-token, fork, speculation and (disaggregated) park/adopt seams, and
closed at retire, when it moves from the live table to a bounded ring of
recent completions. It is read three ways:

- the ``usage`` block of the ingress's SSE finish event and whole body
  (the branch that closed the ledger carries it);
- ``ServeReport.requests``: :func:`aggregate_ledgers` over the run's
  finished ledgers (a pure function);
- the telemetry endpoint's ``/requests`` and ``/request/{uid}`` (live
  table and ring, from :data:`REQLOG`), federated by the fleet router.

Disarmed (the default) it is free: every method returns after one
attribute check, and call sites guard with ``if REQLOG.enabled:`` before
they build a payload. The ledger reads host-side state only; it adds no
device operation and no host read of the device. One re-entrant lock
guards the live table and the ring: HTTP handler threads snapshot them
while the engine thread writes.

Wall segments (the reconciliation contract): for a finished ledger
``prefill_s + handoff_s + decode_s`` equals the admit -> retire span, and
``queue_wait_s`` is the wait before it. An ``n > 1`` family has one ledger
under its uid, closed by the branch that retires first on the fork-slot
path and by the family's last branch on the token-tree path.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from tree_attention_tpu_torch.obs.tracing import TRACER

DEFAULT_RING = 256

#: Integer accumulator fields note() accepts (anything else is a bug).
_COUNTERS = (
    "host_demotes", "host_restores", "spec_proposed", "spec_accepted",
    "fork_shared_blocks",
)


class RequestLedger:
    """Mutable per-request cost record; one per uid, engine-thread owned
    while live (readers go through :meth:`ReqLog.snapshot` copies)."""

    __slots__ = (
        "uid", "trace_id", "span_id", "parent_span_id", "phase",
        "arrival_tick", "admit_tick", "finish_tick", "outcome",
        "prompt_tokens", "prefix_hit_tokens", "tokens_prefilled",
        "tokens_decoded",
        "queue_wait_s", "prefill_s", "handoff_s", "decode_s",
        "kv_block_seconds", "host_demotes", "host_restores",
        "spec_proposed", "spec_accepted", "fork_shared_blocks",
        "_t_admit", "_t_first", "_t_park", "_blk_n", "_blk_t",
    )

    def __init__(self, uid: int, now: float):
        self.uid = uid
        self.trace_id = ""
        self.span_id = ""
        self.parent_span_id = ""
        self.phase = "prefill"
        self.arrival_tick = 0
        self.admit_tick = 0
        self.finish_tick = -1
        self.outcome = ""  # empty while live
        self.prompt_tokens = 0
        self.prefix_hit_tokens = 0
        self.tokens_prefilled = 0
        self.tokens_decoded = 0
        self.queue_wait_s = 0.0
        self.prefill_s = 0.0
        self.handoff_s = 0.0
        self.decode_s = 0.0
        self.kv_block_seconds = 0.0
        self.host_demotes = 0
        self.host_restores = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.fork_shared_blocks = 0
        self._t_admit = now
        self._t_first = -1.0
        self._t_park = -1.0
        self._blk_n = 0
        self._blk_t = now

    # -- derived views ----------------------------------------------------

    def wall_s(self, now: Optional[float] = None) -> float:
        """Admit → retire (or → now while live); the request span's dur."""
        end = now if now is not None else self._blk_t
        return max(0.0, end - self._t_admit)

    def as_dict(self, now: Optional[float] = None) -> Dict[str, Any]:
        live = self.outcome == ""
        t = time.monotonic() if (live and now is None) else now
        d: Dict[str, Any] = {
            "uid": self.uid,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "phase": self.phase,
            "outcome": self.outcome or None,
            "arrival_tick": self.arrival_tick,
            "admit_tick": self.admit_tick,
            "finish_tick": self.finish_tick,
            "prompt_tokens": self.prompt_tokens,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "tokens_prefilled": self.tokens_prefilled,
            "tokens_decoded": self.tokens_decoded,
            "queue_wait_s": round(self.queue_wait_s, 6),
            "prefill_s": round(self.prefill_s, 6),
            "handoff_s": round(self.handoff_s, 6),
            "decode_s": round(self.decode_s, 6),
            "wall_s": round(self.wall_s(t), 6),
            "kv_block_seconds": round(self.kv_block_seconds, 6),
            "host_demotes": self.host_demotes,
            "host_restores": self.host_restores,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "fork_shared_blocks": self.fork_shared_blocks,
        }
        d["phases"] = [
            {"phase": "queue", "wall_s": d["queue_wait_s"]},
            {"phase": "prefill", "wall_s": d["prefill_s"]},
            {"phase": "handoff", "wall_s": d["handoff_s"]},
            {"phase": "decode", "wall_s": d["decode_s"]},
        ]
        return d


class ReqLog:
    """Process-wide ledger table: live requests + a ring of recent
    completions. Disarmed (the default) every method is one attribute
    check; armed, mutations happen under the re-entrant lock (HTTP
    handler threads snapshot while the engine thread writes)."""

    def __init__(self, ring: int = DEFAULT_RING):
        # RLock, not Lock: snapshot() is called from HTTP handler threads
        # while finish() may be emitting under TRACER's own lock — and the
        # crash handlers may interrupt either; re-entrancy keeps the
        # flush-then-die contract deadlock-free (same reasoning as the
        # tracer and registry locks).
        self._lock = threading.RLock()
        self._live: Dict[int, RequestLedger] = {}
        self._ring: deque = deque(maxlen=ring)
        self.enabled = False

    # -- lifecycle --------------------------------------------------------

    def arm(self, ring: Optional[int] = None) -> None:
        with self._lock:
            if ring is not None and ring != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=ring)
            self.enabled = True

    def disarm(self) -> None:
        """Stop recording and drop state (a later run arms afresh)."""
        with self._lock:
            self.enabled = False
            self._live.clear()
            self._ring.clear()

    # -- accumulation seams (engine thread) -------------------------------

    def open(
        self,
        uid: int,
        *,
        trace_id: str = "",
        span_id: str = "",
        parent_span_id: str = "",
        prompt_tokens: int = 0,
        prefix_hit_tokens: int = 0,
        arrival_tick: int = 0,
        admit_tick: int = 0,
        queue_wait_s: float = 0.0,
        nblocks: int = 0,
        now: Optional[float] = None,
    ) -> None:
        """Open a ledger at the engine's one-admit-path seam."""
        if not self.enabled:
            return
        t = time.monotonic() if now is None else now
        led = RequestLedger(uid, t)
        led.trace_id = trace_id
        led.span_id = span_id
        led.parent_span_id = parent_span_id
        led.prompt_tokens = prompt_tokens
        led.prefix_hit_tokens = prefix_hit_tokens
        led.tokens_prefilled = max(0, prompt_tokens - prefix_hit_tokens)
        led.arrival_tick = arrival_tick
        led.admit_tick = admit_tick
        led.queue_wait_s = queue_wait_s
        led._blk_n = nblocks
        with self._lock:
            self._live[uid] = led

    def note(self, uid: int, **deltas: int) -> None:
        """Accumulate integer counters (``spec_proposed=4``, …)."""
        if not self.enabled:
            return
        with self._lock:
            led = self._live.get(uid)
            if led is None:
                return
            for k, v in deltas.items():
                if k in _COUNTERS:
                    setattr(led, k, getattr(led, k) + v)

    def blocks(self, uid: int, n: int, now: Optional[float] = None) -> None:
        """Device-block count changed: integrate block-seconds so far."""
        if not self.enabled:
            return
        t = time.monotonic() if now is None else now
        with self._lock:
            led = self._live.get(uid)
            if led is None:
                return
            led.kv_block_seconds += led._blk_n * max(0.0, t - led._blk_t)
            led._blk_n = n
            led._blk_t = t

    def first_token(self, uid: int, now: Optional[float] = None) -> None:
        """First token produced: closes the prefill segment."""
        if not self.enabled:
            return
        t = time.monotonic() if now is None else now
        with self._lock:
            led = self._live.get(uid)
            if led is None or led._t_first >= 0.0:
                return
            led._t_first = t
            led.prefill_s = max(0.0, t - led._t_admit)
            led.phase = "decode"

    def park(self, uid: int, now: Optional[float] = None) -> None:
        """Disagg handoff: the prefill worker parked this request."""
        if not self.enabled:
            return
        t = time.monotonic() if now is None else now
        with self._lock:
            led = self._live.get(uid)
            if led is None:
                return
            led._t_park = t
            led.phase = "handoff"

    def resume(self, uid: int, now: Optional[float] = None) -> None:
        """Disagg handoff: a decode worker adopted this request."""
        if not self.enabled:
            return
        t = time.monotonic() if now is None else now
        with self._lock:
            led = self._live.get(uid)
            if led is None:
                return
            if led._t_park >= 0.0:
                led.handoff_s += max(0.0, t - led._t_park)
                led._t_park = -1.0
            led.phase = "decode"

    def finish(
        self,
        uid: int,
        *,
        outcome: str,
        finish_tick: int = -1,
        tokens_decoded: int = 0,
        nblocks: int = 0,
        now: Optional[float] = None,
    ) -> Optional[Dict[str, Any]]:
        """Finalize at the one-retire-path seam; returns the finished
        ledger dict (``None`` when disabled or the uid is unknown —
        idempotent for ``n>1`` branch retires after the first)."""
        if not self.enabled:
            return None
        t = time.monotonic() if now is None else now
        with self._lock:
            led = self._live.pop(uid, None)
            if led is None:
                return None
            # Close the block-seconds integral and any open park.
            led.kv_block_seconds += led._blk_n * max(0.0, t - led._blk_t)
            led._blk_n = nblocks
            led._blk_t = t
            if led._t_park >= 0.0:
                led.handoff_s += max(0.0, t - led._t_park)
                led._t_park = -1.0
            if led._t_first < 0.0:
                # Never produced a token: the whole span was prefill.
                led.prefill_s = max(0.0, t - led._t_admit)
                led._t_first = t
            # Decode is the remainder, so the three segments sum to the
            # span duration exactly: wall = prefill + handoff + decode.
            led.decode_s = max(
                0.0,
                (t - led._t_admit) - led.prefill_s - led.handoff_s,
            )
            led.tokens_decoded = tokens_decoded
            led.outcome = outcome
            led.phase = "done"
            led.finish_tick = finish_tick
            out = led.as_dict(t)
            self._ring.append(out)
        if TRACER.active:
            TRACER.instant("request_ledger", cat="serving", args={
                "rid": uid, "trace_id": led.trace_id,
                "outcome": outcome, "decode_s": out["decode_s"],
                "prefill_s": out["prefill_s"],
                "handoff_s": out["handoff_s"],
            })
        return out

    def drop(self, uid: int) -> None:
        """Forget a live ledger without ringing it (rejected pre-admit)."""
        if not self.enabled:
            return
        with self._lock:
            self._live.pop(uid, None)

    # -- read side (HTTP handler threads) ---------------------------------

    def get(self, uid: int) -> Optional[Dict[str, Any]]:
        """Single-ledger view: live first, then the recent ring."""
        with self._lock:
            led = self._live.get(uid)
            if led is not None:
                return led.as_dict()
            for d in reversed(self._ring):
                if d["uid"] == uid:
                    return dict(d)
        return None

    def snapshot(self) -> Dict[str, Any]:
        """``{"live": [...], "recent": [...]}`` — copies, lock released
        before serialization."""
        with self._lock:
            live = [led.as_dict() for led in self._live.values()]
            recent = [dict(d) for d in self._ring]
        live.sort(key=lambda d: d["uid"])
        return {"enabled": self.enabled, "live": live, "recent": recent}


def aggregate_ledgers(
    ledgers: List[Dict[str, Any]],
) -> Optional[Dict[str, Any]]:
    """Run-level aggregates for ``ServeReport.requests`` — pure function
    over finished ledger dicts (no global state, usable disabled → None).
    """
    if not ledgers:
        return None
    n = len(ledgers)
    out: Dict[str, Any] = {"count": n}
    for key in ("queue_wait_s", "prefill_s", "handoff_s", "decode_s",
                "kv_block_seconds"):
        vals = sorted(d.get(key, 0.0) for d in ledgers)
        out[f"{key}_sum"] = round(sum(vals), 6)
        out[f"{key}_p50"] = round(vals[n // 2], 6)
    for key in ("tokens_prefilled", "tokens_decoded", "prefix_hit_tokens",
                "host_demotes", "host_restores", "spec_proposed",
                "spec_accepted", "fork_shared_blocks"):
        out[f"{key}_total"] = sum(int(d.get(key, 0)) for d in ledgers)
    return out


#: The process-wide ledger table every seam records into.
REQLOG = ReqLog()
