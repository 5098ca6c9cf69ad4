"""Sliding-window SLO monitor: live TTFT / TBT / queue-wait percentiles.

Counterpart of ``tree_attention_tpu/obs/slo.py`` (the port's own copy).

End-of-run percentiles (``ServeReport``) answer "how did the run go";
a serving process needs "how is it going NOW" — windowed latencies a
scraper can watch move, and **goodput**: the fraction of recently retired
requests that met a configurable TTFT+TBT SLO, the Sarathi-style headline
(arXiv:2403.02310 §6 evaluates exactly this). Chunked admission exists to
protect TTFT and TBT under load; this monitor is where that protection
becomes continuously observable instead of bench-reported.

Mechanics: three bounded sample windows (TTFT, TBT, queue wait — a deque
of the last ``window`` observations each, O(1) per observation) plus a
window of per-request SLO verdicts. A request meets the SLO iff its TTFT
``<= ttft_slo`` AND its worst inter-token gap ``<= tbt_slo`` (max, not
p95 — one visible stall breaks the experience the SLO describes).
Percentiles are exact nearest-rank over the window
(:func:`~tree_attention_tpu_torch.obs.metrics.percentile` — the shared
definition). :meth:`maybe_export` re-publishes the gauges at most once per
``export_every`` seconds, so the per-tick cost stays one time check; the
gauges appear on ``/metrics`` as ``serving_slo_*{q=...}`` and
``serving_goodput_ratio``.

:meth:`snapshot` additionally reports run-lifetime quantiles interpolated
from the cumulative ``serving_ttft_seconds`` / ``serving_tbt_seconds``
histograms (:meth:`Histogram.quantile
<tree_attention_tpu_torch.obs.metrics.Histogram.quantile>`) when the registry is
recording — window vs lifetime disagreement is itself a signal (the run
degraded or recovered).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Optional

from tree_attention_tpu_torch.obs import metrics as _m
from tree_attention_tpu_torch.obs.metrics import percentile

DEFAULT_WINDOW = 1024
_QS = ((0.50, "p50"), (0.95, "p95"), (0.99, "p99"))

# The live-window gauges (one labeled family per latency, quantile as a
# label so a scraper gets the whole distribution in one series).
_SLO_TTFT = _m.gauge(
    "serving_slo_ttft_seconds",
    "sliding-window TTFT quantiles over recent requests", labels=("q",),
)
_SLO_TBT = _m.gauge(
    "serving_slo_tbt_seconds",
    "sliding-window inter-token-latency quantiles over recent tokens",
    labels=("q",),
)
_SLO_QWAIT = _m.gauge(
    "serving_slo_queue_wait_seconds",
    "sliding-window queue-wait quantiles over recent admissions",
    labels=("q",),
)
_GOODPUT = _m.gauge(
    "serving_goodput_ratio",
    "fraction of recently retired requests meeting the TTFT+TBT SLO",
)
_SLO_WINDOW_REQS = _m.gauge(
    "serving_slo_window_requests",
    "retired requests currently inside the goodput window",
)


class SLOMonitor:
    """Windowed latency percentiles + goodput against a TTFT/TBT SLO."""

    def __init__(
        self,
        *,
        ttft_slo: float = 1.0,
        tbt_slo: float = 0.2,
        window: int = DEFAULT_WINDOW,
        export_every: float = 1.0,
    ):
        if ttft_slo <= 0 or tbt_slo <= 0:
            raise ValueError(
                f"SLO thresholds must be > 0, got ttft={ttft_slo} "
                f"tbt={tbt_slo}"
            )
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.ttft_slo = float(ttft_slo)
        self.tbt_slo = float(tbt_slo)
        self.window = int(window)
        self.export_every = float(export_every)
        self._lock = threading.Lock()
        self._ttft: deque = deque(maxlen=window)
        self._tbt: deque = deque(maxlen=window)
        self._qwait: deque = deque(maxlen=window)
        self._met: deque = deque(maxlen=window)
        self._retired = 0
        self._last_export = 0.0

    # -- feeding (engine-side, O(1) each) ---------------------------------

    def reset(self) -> None:
        """Drop every window and verdict (SLO targets stay). For callers
        reusing one engine across distinct runs — a bench's warmup must
        not leave its compile-stalled requests in the measured runs'
        goodput window."""
        with self._lock:
            self._ttft.clear()
            self._tbt.clear()
            self._qwait.clear()
            self._met.clear()
            self._retired = 0

    def observe_ttft(self, v: float) -> None:
        with self._lock:
            self._ttft.append(v)

    def observe_tbt(self, v: float) -> None:
        with self._lock:
            self._tbt.append(v)

    def observe_queue_wait(self, v: float) -> None:
        with self._lock:
            self._qwait.append(v)

    def observe_request(self, ttft_s: float, max_tbt_s: float) -> bool:
        """One retired request's verdict against the SLO; returns it."""
        met = ttft_s <= self.ttft_slo and max_tbt_s <= self.tbt_slo
        with self._lock:
            self._met.append(met)
            self._retired += 1
        return met

    # -- reading ----------------------------------------------------------

    def goodput(self) -> float:
        """Fraction of the goodput window meeting the SLO (1.0 when no
        request has retired yet — an idle server is not failing its SLO)."""
        with self._lock:
            if not self._met:
                return 1.0
            return sum(self._met) / len(self._met)

    def _window_quantiles(self) -> Dict[str, float]:
        with self._lock:
            ttft = sorted(self._ttft)
            tbt = sorted(self._tbt)
            qwait = sorted(self._qwait)
        out: Dict[str, float] = {}
        for p, tag in _QS:
            out[f"ttft_{tag}_s"] = percentile(ttft, p)
            out[f"tbt_{tag}_s"] = percentile(tbt, p)
            out[f"queue_wait_{tag}_s"] = percentile(qwait, p)
        return out

    def snapshot(self) -> Dict[str, Any]:
        """The JSON shape ``ServeReport`` and ``--mode serve`` surface."""
        out: Dict[str, Any] = {
            "slo": {"ttft_s": self.ttft_slo, "tbt_s": self.tbt_slo},
            "goodput": round(self.goodput(), 4),
            "window": self.window,
            "requests_in_window": len(self._met),
            "requests_retired": self._retired,
        }
        out.update({
            k: round(v, 6) for k, v in self._window_quantiles().items()
        })
        if _m.REGISTRY.enabled:
            # Run-lifetime quantiles via bucket interpolation — the
            # Histogram.quantile reuse; drift from the window values above
            # means the run's tail moved.
            for name, key in (("serving_ttft_seconds", "ttft"),
                              ("serving_tbt_seconds", "tbt")):
                h = _m.REGISTRY.get(name)
                if h is not None and isinstance(h, _m.Histogram):
                    for p, tag in _QS:
                        out[f"{key}_lifetime_{tag}_s"] = round(
                            h.quantile(p), 6
                        )
        return out

    # -- exporting --------------------------------------------------------

    def export_gauges(self) -> None:
        """Publish the window quantiles + goodput to the registry gauges
        (no-op while the registry is disabled)."""
        if not _m.REGISTRY.enabled:
            return
        q = self._window_quantiles()
        for _, tag in _QS:
            _SLO_TTFT.labels(q=tag).set(q[f"ttft_{tag}_s"])
            _SLO_TBT.labels(q=tag).set(q[f"tbt_{tag}_s"])
            _SLO_QWAIT.labels(q=tag).set(q[f"queue_wait_{tag}_s"])
        _GOODPUT.set(self.goodput())
        _SLO_WINDOW_REQS.set(len(self._met))

    def maybe_export(self, now: Optional[float] = None) -> None:
        """Rate-limited :meth:`export_gauges` — the per-tick call site.
        One time comparison per tick; the sort only runs when a scrape
        could actually see fresh values."""
        if not _m.REGISTRY.enabled:
            return
        if now is None:
            now = time.monotonic()
        with self._lock:  # claim the export slot before releasing: two
            # ticks racing here must not both pay the window sort
            if now - self._last_export < self.export_every:
                return
            self._last_export = now
        self.export_gauges()
