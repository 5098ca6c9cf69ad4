"""Tick flight recorder: a bounded ring of per-tick serving records.

Counterpart of ``tree_attention_tpu/obs/flight.py`` (the port's own copy).
The registry says *how much* and the span trace *how long*; neither says
what the engine was doing when it wedged, once the process is gone. This
is the black box: each tick the engine appends one small record
(occupancy, slot states, chunk plan, tokens emitted, whether the tick
paid the host fetch, queue depth, wall time) to a fixed-capacity ring.
O(1) per tick, bounded memory; the ring holds the LAST ``capacity`` ticks.

Dumps: on demand (``/flight``, :meth:`snapshot`), on an engine error
(``SlotServer.serve`` and ``DisaggServer.serve`` dump before re-raising),
and on SIGTERM, SIGUSR1 or exit through
:func:`~tree_attention_tpu_torch.obs.install_crash_handlers`, which
flushes the armed sink (``--flight-out`` / ``TA_FLIGHT_OUT``).

Liveness: :meth:`last_tick_age` is the seconds since the last recorded
tick, what ``/healthz`` reads (a loop whose ring stopped moving is wedged
even while the HTTP thread answers).

Disarmed (the default) is free: :meth:`record` is one attribute check;
call sites build their record dict only under ``if FLIGHT.enabled:``.
Every record field comes from the engine's host-side ledgers: recording
reads no device memory.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

DEFAULT_CAPACITY = 256


class FlightRecorder:
    """Fixed-capacity ring of per-tick records; disarmed until armed."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        # Reentrant: the SIGTERM/SIGUSR1 flush runs on the main thread and
        # may interrupt a record() that holds this lock; a plain Lock would
        # deadlock the dump instead of writing it.
        self._lock = threading.RLock()
        self._ring: deque = deque(maxlen=capacity)
        self._ticks_recorded = 0
        self._last_tick_t: Optional[float] = None
        self._idle = True
        self._dump_path: Optional[str] = None
        self.enabled = False

    # -- lifecycle --------------------------------------------------------

    def arm(self, dump_path: Optional[str] = None,
            capacity: Optional[int] = None) -> None:
        """Start recording. ``dump_path`` is where error, signal and exit
        dumps land (``None``: memory only; ``/flight`` and
        :meth:`snapshot` still serve the ring)."""
        with self._lock:
            if capacity is not None and capacity != self._ring.maxlen:
                self._ring = deque(self._ring, maxlen=max(capacity, 1))
            self._dump_path = dump_path
        self.enabled = True

    def disarm(self) -> None:
        self.enabled = False
        with self._lock:
            self._dump_path = None

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._ticks_recorded = 0
            self._last_tick_t = None
            self._idle = True

    @property
    def dump_path(self) -> Optional[str]:
        return self._dump_path

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    @property
    def ticks_recorded(self) -> int:
        return self._ticks_recorded

    # -- recording --------------------------------------------------------

    def record(self, rec: Optional[Dict[str, Any]]) -> None:
        """Append one per-tick record (the caller's dict, built only while
        armed; ``record(None)`` is the disarmed call shape)."""
        if not self.enabled or rec is None:
            return
        now = time.monotonic()
        with self._lock:
            self._ring.append(rec)
            self._ticks_recorded += 1
            self._last_tick_t = now
            self._idle = False

    def mark_idle(self) -> None:
        """The tick loop drained (or waits for work): between runs, not
        wedged, so ``/healthz`` must not read the last tick's age as a
        stall. The ring and the timestamp stay; the next record() clears
        the flag."""
        with self._lock:
            self._idle = True

    @property
    def idle(self) -> bool:
        return self._idle

    def last_tick_age(self) -> Optional[float]:
        """Seconds since the last recorded tick; None before any tick."""
        t = self._last_tick_t
        return None if t is None else max(time.monotonic() - t, 0.0)

    # -- export -----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            records: List[Dict[str, Any]] = list(self._ring)
            ticks = self._ticks_recorded
        age = self.last_tick_age()
        return {
            "captured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "capacity": self.capacity,
            "ticks_recorded": ticks,
            "last_tick_age_s": None if age is None else round(age, 3),
            "records": records,
        }

    def dump(self, path: str, reason: str = "on_demand") -> None:
        """Write the ring as JSON (creates parent directories)."""
        snap = self.snapshot()
        snap["reason"] = reason
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(snap, f, indent=2, default=str)
            f.write("\n")

    def dump_if_armed(self, reason: str) -> Optional[str]:
        """Dump to the armed sink, if any: the error and signal hook. A
        failed write returns None (the black box must not kill the run it
        records); returns the path written otherwise."""
        path = self._dump_path
        if not self.enabled or not path:
            return None
        try:
            self.dump(path, reason=reason)
            return path
        except OSError:
            return None


#: The process-wide recorder the serving engines feed.
FLIGHT = FlightRecorder()
