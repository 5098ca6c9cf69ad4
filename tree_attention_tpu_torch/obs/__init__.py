"""Telemetry: the process-wide metrics registry and the SLO monitor.

Counterpart of ``tree_attention_tpu/obs`` for this slice: the registry
(:mod:`.metrics`) that the ops, models and serving layers emit through, and
the sliding-window SLO monitor (:mod:`.slo`) that feeds ``ServeReport.slo``.
Both are off (and free) until :func:`enable`.
"""

from tree_attention_tpu_torch.obs.metrics import (  # noqa: F401
    REGISTRY,
    counter,
    gauge,
    histogram,
    percentile,
)
from tree_attention_tpu_torch.obs.slo import SLOMonitor  # noqa: F401


def enable() -> None:
    REGISTRY.enable()


def disable() -> None:
    REGISTRY.disable()
