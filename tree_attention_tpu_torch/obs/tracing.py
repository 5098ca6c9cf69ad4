"""Host-side span tracer: Chrome-trace-format JSONL, one event per line.

Counterpart of ``tree_attention_tpu/obs/tracing.py`` (the port's own copy).
``torch.profiler`` captures what the *device* did; this tracer records where
the *host* spent a run's wall clock, as explicit spans (context manager or
decorator) emitted as Chrome trace events, loadable in Perfetto /
``chrome://tracing`` beside a device profile:

- Each line of the output file is one complete JSON object (``json.loads``
  per line succeeds — the machine-checkable contract). Perfetto's JSON
  tokenizer accepts concatenated objects without an enclosing array.
- ``pid`` is the process's rank (``RANK``, 0 when absent), so traces of a
  multi-process run merge into one timeline with one row group per rank.
  ``tid`` is a small per-thread ordinal; metadata events name both.
- Complete events (``ph: "X"``) are written at span *close* with
  microsecond ``ts``/``dur`` from the monotonic clock; instants
  (``ph: "i"``) record point occurrences; flow events (``s``/``t``/``f``)
  stitch one request's spans across threads and processes.

Disabled (no sink installed — the default) is free: :func:`span` returns a
shared no-op context manager after one attribute check, and
:func:`instant` returns immediately. Same contract as the metrics
registry's disabled path.

W3C ``traceparent`` helpers (:func:`parse_traceparent`,
:func:`make_traceparent`) carry one request's trace id across hops: the
HTTP ingress adopts a client's header or mints a fresh context.
"""

from __future__ import annotations

import atexit
import functools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple


# -- W3C-traceparent-style request context -----------------------------------
#
# One request = one trace_id, minted at the FIRST ingress that sees it
# (router-fronted fleets: the router's relay forwards the header and the
# replica ingress ADOPTS instead of minting). Each process that handles the
# request stamps its own span_id. The wire format is the W3C traceparent
# header, ``00-<32 hex trace_id>-<16 hex span_id>-01`` — close enough that
# off-the-shelf middleboxes pass it through untouched.

TRACEPARENT_HEADER = "traceparent"


def new_trace_id() -> str:
    """128-bit random trace id, 32 lowercase hex chars."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """64-bit random span id, 16 lowercase hex chars."""
    return os.urandom(8).hex()


def make_traceparent(trace_id: str, span_id: str) -> str:
    """Serialize to the W3C header value (version 00, sampled flag set)."""
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(value: Optional[str]) -> Optional[Tuple[str, str]]:
    """Parse a traceparent header value → ``(trace_id, span_id)``.

    Returns ``None`` for anything malformed (wrong field count, wrong
    lengths, non-hex, all-zero ids) — the caller mints a fresh context
    instead of propagating garbage.
    """
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) < 4:
        return None
    _, trace_id, span_id = parts[0], parts[1], parts[2]
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def flow_id(trace_id: str) -> int:
    """Chrome-trace flow ``id`` for a trace: the low 53 bits of the
    trace_id (kept under 2**53 so JSON consumers that parse numbers as
    doubles — Perfetto's legacy JSON importer among them — round-trip it
    exactly)."""
    return int(trace_id[-14:], 16) & ((1 << 53) - 1)


class _NoopSpan:
    """Singleton no-op context manager for the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args: Any) -> None:
        """No-op twin of :meth:`_Span.set`."""


_NOOP_SPAN = _NoopSpan()


class _Span:
    """One open span; emits a complete ("X") event when it closes."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str, cat: str,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = time.monotonic_ns()

    def set(self, **args: Any) -> None:
        """Attach/extend args mid-span (recorded when the span closes)."""
        if self.args is None:
            self.args = {}
        self.args.update(args)

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.set(error=exc_type.__name__)
        t1 = time.monotonic_ns()
        self._tracer._emit_complete(
            self.name, self.cat, self._t0 // 1000, (t1 - self._t0) // 1000,
            self.args,
        )
        return False


class SpanTracer:
    """Writes Chrome trace events to a JSONL sink; inactive until started.

    Spans may nest freely (Chrome's flattener reconstructs the stack from
    enclosing ``ts``/``dur`` per tid) and may close out of start order
    across threads — each event is self-contained.
    """

    def __init__(self):
        # Reentrant: the crash handlers (obs.flush) run on the main thread
        # and may interrupt an _emit holding this lock — a plain Lock
        # would deadlock the flush-then-die path instead of flushing.
        self._lock = threading.RLock()
        self._file = None
        self._path: Optional[str] = None
        self._pid = 0
        self._tids: Dict[int, int] = {}
        self.active = False

    # -- lifecycle --------------------------------------------------------

    def start(self, path: str) -> None:
        """Open (truncate) the sink and emit process metadata."""
        from tree_attention_tpu_torch.utils.logging import _process_index

        with self._lock:
            if self._file is not None:
                self._file.close()
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            self._file = open(path, "w")
            self._path = path
            self._pid = _process_index()
            self._tids = {}
            self.active = True
            self._write_locked({
                "name": "process_name", "ph": "M", "pid": self._pid,
                "tid": 0, "args": {"name": f"host rank {self._pid}"},
            })
        atexit.register(self.close)

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
            self.active = False

    def flush(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.flush()

    @property
    def path(self) -> Optional[str]:
        return self._path

    # -- recording --------------------------------------------------------

    def span(self, name: str, cat: str = "host",
             args: Optional[Dict[str, Any]] = None):
        """Context manager timing a host-side phase.

        Pass structured detail via ``args`` (one dict, not kwargs — the
        disabled path must not build anything). A span around a CUDA launch
        measures the enqueue, not the kernel: the device time is
        ``torch.profiler``'s.
        """
        if not self.active:
            return _NOOP_SPAN
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "host",
                args: Optional[Dict[str, Any]] = None) -> None:
        """Point-in-time event (guard verdict, stall, rank exit)."""
        if not self.active:
            return
        self._emit({
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": time.monotonic_ns() // 1000,
            "pid": self._pid, "tid": self._tid(),
            **({"args": args} if args else {}),
        })

    def counter_event(self, name: str, values: Dict[str, float]) -> None:
        """Chrome counter track ("C") — a value series over the timeline."""
        if not self.active:
            return
        self._emit({
            "name": name, "ph": "C", "ts": time.monotonic_ns() // 1000,
            "pid": self._pid, "tid": self._tid(), "args": values,
        })

    def flow(self, phase: str, fid: int, name: str = "request",
             cat: str = "serving") -> None:
        """Chrome-trace flow event binding cross-process arrows.

        ``phase`` is ``"s"`` (start), ``"t"`` (step), or ``"f"`` (finish);
        ``fid`` is the shared flow id (:func:`flow_id` of the trace_id).
        Flow points bind to whichever slice encloses their ``ts`` on this
        pid/tid — emit them INSIDE the span that should anchor the arrow.
        Perfetto then draws one connected arrow chain across every process
        file merged into the load (``tools/trace_merge.py``).
        """
        if not self.active:
            return
        ev: Dict[str, Any] = {
            "name": name, "cat": cat, "ph": phase, "id": fid,
            "ts": time.monotonic_ns() // 1000,
            "pid": self._pid, "tid": self._tid(),
        }
        if phase == "f":
            ev["bp"] = "e"  # bind the finish to the enclosing slice
        self._emit(ev)

    # -- internals --------------------------------------------------------

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
                t = threading.current_thread()
                self._write_locked({
                    "name": "thread_name", "ph": "M", "pid": self._pid,
                    "tid": tid, "args": {"name": t.name},
                })
        return tid

    def _emit_complete(self, name, cat, ts_us, dur_us, args) -> None:
        if not self.active:
            return  # sink closed while the span was open
        self._emit({
            "name": name, "cat": cat, "ph": "X",
            "ts": ts_us, "dur": dur_us,
            "pid": self._pid, "tid": self._tid(),
            **({"args": args} if args else {}),
        })

    def _emit(self, event: Dict[str, Any]) -> None:
        with self._lock:
            self._write_locked(event)

    def _write_locked(self, event: Dict[str, Any]) -> None:
        if self._file is None:
            return
        try:
            self._file.write(json.dumps(event, default=str) + "\n")
        except (OSError, ValueError):
            pass  # never let observability kill the workload


#: The process-wide tracer every instrumentation site uses.
TRACER = SpanTracer()


def span(name: str, cat: str = "host",
         args: Optional[Dict[str, Any]] = None):
    """Module-level shorthand for ``TRACER.span`` (the common call site)."""
    if not TRACER.active:
        return _NOOP_SPAN
    return _Span(TRACER, name, cat, args)


def instant(name: str, cat: str = "host",
            args: Optional[Dict[str, Any]] = None) -> None:
    TRACER.instant(name, cat, args)


def flow(phase: str, fid: int, name: str = "request",
         cat: str = "serving") -> None:
    """Module-level shorthand for ``TRACER.flow``."""
    TRACER.flow(phase, fid, name, cat)


def traced(name: Optional[str] = None, cat: str = "host") -> Callable:
    """Decorator form: ``@traced()`` wraps the call in a span.

    The wrapper costs one flag check when tracing is off — cheap enough for
    per-call host functions, still not for per-element inner loops.
    """

    def deco(fn: Callable) -> Callable:
        span_name = name or f"{fn.__module__.split('.')[-1]}.{fn.__qualname__}"

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not TRACER.active:
                return fn(*a, **kw)
            with _Span(TRACER, span_name, cat, None):
                return fn(*a, **kw)

        return wrapper

    return deco
