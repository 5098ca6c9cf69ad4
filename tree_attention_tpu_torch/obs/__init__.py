"""Telemetry: the metrics registry, the span tracer, the SLO monitor and
the tick flight recorder.

Counterpart of ``tree_attention_tpu/obs`` for the slices ported so far: the
registry (:mod:`.metrics`) that the ops, models and serving layers emit
through, exported as JSON (``--metrics-out``) and Prometheus text; the
Chrome-trace span tracer (:mod:`.tracing`, ``--trace-events``); the
sliding-window SLO monitor (:mod:`.slo`) that feeds ``ServeReport.slo``;
the serving engines' per-tick flight recorder (:mod:`.flight`,
``--flight-out``); and the live HTTP exporter (:mod:`.http`,
``--metrics-port``, imported where it is started: mounting ``/metrics``
must not tax every import of the package). All are off (and free) until
:func:`configure` (or :func:`enable` for the registry alone);
:func:`install_crash_handlers` makes the armed sinks crash-safe (atexit
and SIGTERM flush, SIGUSR1 dumps and keeps running). The request ledger
waits for a later slice (ROADMAP).

``TA_METRICS_OUT`` / ``TA_TRACE_EVENTS`` / ``TA_FLIGHT_OUT`` stand in for
:func:`configure`'s arguments, so a process a run spawns inherits its
telemetry; a multi-process run rank-suffixes every sink path.
"""

from __future__ import annotations

import atexit
import os
from typing import Any, Dict, Optional

from tree_attention_tpu_torch.obs.metrics import (  # noqa: F401
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
    counter,
    gauge,
    histogram,
    percentile,
)
from tree_attention_tpu_torch.obs.tracing import (  # noqa: F401
    SpanTracer,
    TRACEPARENT_HEADER,
    TRACER,
    flow,
    flow_id,
    instant,
    make_traceparent,
    new_span_id,
    new_trace_id,
    parse_traceparent,
    span,
    traced,
)
from tree_attention_tpu_torch.obs.flight import (  # noqa: F401
    FLIGHT,
    FlightRecorder,
)
from tree_attention_tpu_torch.obs.slo import SLOMonitor  # noqa: F401

_STATE: Dict[str, Optional[str]] = {"metrics_out": None}


def enable() -> None:
    REGISTRY.enable()


def disable() -> None:
    REGISTRY.disable()


def _rank_suffixed(path: str) -> str:
    """Each rank of a multi-process run owns its own file (``PATH.pK``)."""
    from tree_attention_tpu_torch.utils.logging import _process_index

    if int(os.environ.get("WORLD_SIZE", "1") or 1) > 1:
        return f"{path}.p{_process_index()}"
    return path


def configure(metrics_out: Optional[str] = None,
              trace_events: Optional[str] = None,
              flight_out: Optional[str] = None) -> None:
    """Arm telemetry for this process: ``metrics_out`` is where
    :func:`shutdown` writes the registry's JSON snapshot (and enables the
    registry); ``trace_events`` starts the span tracer's JSONL sink (and
    enables the registry too: spans without counters are half a story);
    ``flight_out`` arms the tick flight recorder with a dump sink (written
    by :func:`shutdown`, on an engine error and by the signal handlers).
    ``None`` falls back to ``TA_METRICS_OUT`` / ``TA_TRACE_EVENTS`` /
    ``TA_FLIGHT_OUT``."""
    metrics_out = metrics_out or os.environ.get("TA_METRICS_OUT")
    trace_events = trace_events or os.environ.get("TA_TRACE_EVENTS")
    flight_out = flight_out or os.environ.get("TA_FLIGHT_OUT")
    if metrics_out:
        _STATE["metrics_out"] = _rank_suffixed(metrics_out)
        REGISTRY.enable()
    if trace_events:
        TRACER.start(_rank_suffixed(trace_events))
        REGISTRY.enable()
    if flight_out:
        FLIGHT.arm(_rank_suffixed(flight_out))


def shutdown() -> Dict[str, Any]:
    """Write the metrics snapshot (if configured), dump the flight recorder
    (if armed with a sink), close the tracer, and disarm: a later run in
    the process records nothing unless it configures again. Idempotent.
    Returns the sinks this run wrote, ``{"metrics_out": ...,
    "trace_events": ..., "flight_out": ...}``."""
    out: Dict[str, Any] = {
        "metrics_out": None,
        "trace_events": TRACER.path if TRACER.active else None,
        "flight_out": None,
    }
    path = _STATE["metrics_out"]
    if path and REGISTRY.enabled:
        try:
            REGISTRY.write_json(path)
            out["metrics_out"] = path
        except OSError:
            pass  # never let observability fail the run at exit
    out["flight_out"] = FLIGHT.dump_if_armed("shutdown")
    _STATE["metrics_out"] = None
    REGISTRY.disable()
    TRACER.close()
    FLIGHT.disarm()
    return out


def flush() -> Dict[str, Any]:
    """The crash-time flush: write every armed sink without disarming (the
    run may go on, SIGUSR1, or die an instant later, SIGTERM or exit).
    Safe to call again; raises nothing."""
    out: Dict[str, Any] = {
        "metrics_out": None, "trace_events": None, "flight_out": None,
    }
    path = _STATE["metrics_out"]
    if path and REGISTRY.enabled:
        try:
            REGISTRY.write_json(path)
            out["metrics_out"] = path
        except OSError:
            pass
    if TRACER.active:
        TRACER.flush()
        out["trace_events"] = TRACER.path
    out["flight_out"] = FLIGHT.dump_if_armed("flush")
    return out


_HANDLERS: Dict[str, Any] = {"installed": False}


def install_crash_handlers() -> bool:
    """Make the armed sinks crash-safe. Registers, once and from the main
    thread only (Python installs signal handlers there alone; elsewhere
    this returns False):

    - ``atexit``: :func:`flush`, a backstop for exits that skip the
      caller's ``finally`` (``os._exit`` excepted);
    - ``SIGTERM``: flush, restore the previous handler and raise the
      signal again, so the process still dies with 143;
    - ``SIGUSR1``: flush and keep running (the live dump of a run that
      looks wedged).

    ``--serve-http`` then installs its drain on SIGTERM over this one
    (``serving/ingress.py:install_drain_signals``): the drain exits through
    the CLI's ``finally``, and a second SIGTERM reaches this handler."""
    import signal

    if _HANDLERS["installed"]:
        return True
    try:
        prev_term = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            flush()
            signal.signal(
                signal.SIGTERM,
                prev_term if prev_term is not None else signal.SIG_DFL,
            )
            os.kill(os.getpid(), signum)

        def _on_usr1(signum, frame):
            flush()

        signal.signal(signal.SIGTERM, _on_term)
        signal.signal(signal.SIGUSR1, _on_usr1)
    except ValueError:  # not the main thread
        return False
    atexit.register(flush)
    _HANDLERS["installed"] = True
    return True
