"""Telemetry: the metrics registry, the span tracer and the SLO monitor.

Counterpart of ``tree_attention_tpu/obs`` for the slices ported so far: the
registry (:mod:`.metrics`) that the ops, models and serving layers emit
through, the Chrome-trace span tracer (:mod:`.tracing`), and the
sliding-window SLO monitor (:mod:`.slo`) that feeds ``ServeReport.slo``.
The registry and the tracer are off (and free) until :func:`configure` (or
:func:`enable` for the registry alone). The flight recorder, the request
ledger and the metrics endpoint wait for a later slice (ROADMAP).
"""

from __future__ import annotations

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
              trace_events: Optional[str] = None) -> None:
    """Arm telemetry for this process: ``metrics_out`` is where
    :func:`shutdown` writes the registry's JSON snapshot (and enables the
    registry); ``trace_events`` starts the span tracer's JSONL sink (and
    enables the registry too: spans without counters are half a story)."""
    if metrics_out:
        _STATE["metrics_out"] = _rank_suffixed(metrics_out)
        REGISTRY.enable()
    if trace_events:
        TRACER.start(_rank_suffixed(trace_events))
        REGISTRY.enable()


def shutdown() -> Dict[str, Any]:
    """Write the metrics snapshot (if configured), close the tracer, and
    disarm. Idempotent. Returns the sinks this run wrote,
    ``{"metrics_out": ..., "trace_events": ...}``."""
    out: Dict[str, Any] = {
        "metrics_out": None,
        "trace_events": TRACER.path if TRACER.active else None,
    }
    path = _STATE["metrics_out"]
    if path and REGISTRY.enabled:
        try:
            REGISTRY.write_json(path)
            out["metrics_out"] = path
        except OSError:
            pass  # never let observability fail the run at exit
    _STATE["metrics_out"] = None
    REGISTRY.disable()
    TRACER.close()
    return out
