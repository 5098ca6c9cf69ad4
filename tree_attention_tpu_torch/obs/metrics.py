"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

Counterpart of ``tree_attention_tpu/obs/metrics.py`` (the same registry,
kept as the port's own copy). The registry starts disabled; every mutation
method's first action is one attribute check and an early return, so hot
paths pay nothing unless a run enables telemetry. Thread-safe when enabled.
:meth:`MetricsRegistry.snapshot` / :meth:`~MetricsRegistry.write_json` back
``--metrics-out``; :meth:`MetricsRegistry.to_prometheus` is the text
exposition format (0.0.4) that ``/metrics`` serves, byte for byte the JAX
package's for the same registry contents.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from bisect import bisect_left
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Latency-shaped default buckets (seconds): decode steps live in the
# 100us-100ms band, host phases (compile, launch) in the 0.1-60s band.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def percentile(sorted_vals: Sequence[float], p: float) -> float:
    """Nearest-rank percentile of an ascending sequence (``0 <= p <= 1``).

    The ONE exact-percentile definition every latency report uses
    (``ServeReport``, the SLO windows, bench records) — duplicated
    nearest-rank variants drift in their rounding and then p95s disagree
    across layers for no physical reason. Empty input returns 0.0 (a
    report with no samples, not an error).
    """
    if not sorted_vals:
        return 0.0
    return sorted_vals[
        min(len(sorted_vals) - 1, int(p * (len(sorted_vals) - 1) + 0.5))
    ]


def _check_name(name: str) -> None:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric name {name!r}")


def _check_labels(label_names: Sequence[str]) -> Tuple[str, ...]:
    names = tuple(label_names)
    for n in names:
        if not _LABEL_RE.match(n):
            raise ValueError(f"invalid label name {n!r}")
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate label names in {names}")
    return names


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    """Prometheus sample value: integral floats print as ints (repr
    round-trips everything else)."""
    if isinstance(v, bool):  # bool is an int subclass
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    if v != v:  # NaN
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 2**53:
        return str(int(v))
    return repr(float(v))


class _Metric:
    """Shared parent/child machinery.

    An unlabeled metric is its own (only) child. A labeled metric is a
    parent: :meth:`labels` resolves/creates the child for one label-value
    tuple, and mutations on the parent itself raise (there is no value to
    mutate). Children cache forever — a bounded label space is the caller's
    contract, same as Prometheus client libraries.
    """

    _type = "untyped"

    __slots__ = (
        "name", "help", "_label_names", "_registry", "_children", "_lock",
    )

    def __init__(
        self,
        registry: "MetricsRegistry",
        name: str,
        help: str,
        label_names: Tuple[str, ...],
    ):
        self.name = name
        self.help = help
        self._label_names = label_names
        self._registry = registry
        self._lock = registry._lock
        self._children: Dict[Tuple[str, ...], "_Metric"] = {}
        if not label_names:
            self._init_value()

    def _init_value(self) -> None:  # pragma: no cover - overridden
        raise NotImplementedError

    def _make_child(self) -> "_Metric":
        child = type(self).__new__(type(self))
        child.name = self.name
        child.help = self.help
        child._label_names = ()
        child._registry = self._registry
        child._lock = self._lock
        child._children = {}
        self._copy_config(child)
        child._init_value()
        return child

    def _copy_config(self, child: "_Metric") -> None:
        """Hook for subclasses with per-metric config (histogram buckets)."""

    def labels(self, **labels: Any) -> "_Metric":
        """The child for one label-value assignment (created on first use).

        Resolve once and keep the returned child where the call site is hot:
        the child's mutators are the allocation-free fast path; this lookup
        builds a tuple per call.
        """
        if tuple(sorted(labels)) != tuple(sorted(self._label_names)):
            raise ValueError(
                f"metric {self.name!r} takes labels {self._label_names}, "
                f"got {tuple(sorted(labels))}"
            )
        key = tuple(str(labels[n]) for n in self._label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._make_child()
                self._children[key] = child
        return child

    def _samples(self) -> Iterable[Tuple[Dict[str, str], Any]]:
        """(labels-dict, value-payload) pairs under the registry lock."""
        if not self._label_names:
            yield {}, self._value_payload()
            return
        for key, child in self._children.items():
            yield dict(zip(self._label_names, key)), child._value_payload()

    def _value_payload(self) -> Any:  # pragma: no cover - overridden
        raise NotImplementedError

    def _guard_unlabeled(self) -> None:
        if self._label_names:
            raise ValueError(
                f"metric {self.name!r} is labeled "
                f"({self._label_names}); call .labels(...) first"
            )


class Counter(_Metric):
    """Monotonically increasing count."""

    _type = "counter"
    __slots__ = ("_value",)

    def _init_value(self) -> None:
        self._value = 0

    def inc(self, value: float = 1) -> None:
        if not self._registry._enabled:
            return
        self._guard_unlabeled()
        if value < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        with self._lock:
            self._value += value

    def value(self) -> float:
        self._guard_unlabeled()
        return self._value

    def _value_payload(self) -> float:
        return self._value


class Gauge(_Metric):
    """A value that can go up and down (capacities, fill levels, flags)."""

    _type = "gauge"
    __slots__ = ("_value",)

    def _init_value(self) -> None:
        self._value = 0

    def set(self, value: float) -> None:
        if not self._registry._enabled:
            return
        self._guard_unlabeled()
        with self._lock:
            self._value = value

    def inc(self, value: float = 1) -> None:
        if not self._registry._enabled:
            return
        self._guard_unlabeled()
        with self._lock:
            self._value += value

    def dec(self, value: float = 1) -> None:
        self.inc(-value)

    def value(self) -> float:
        self._guard_unlabeled()
        return self._value

    def _value_payload(self) -> float:
        return self._value


class Histogram(_Metric):
    """Fixed-bucket histogram (per-bucket counts + sum + count).

    Buckets are upper bounds; an implicit ``+Inf`` bucket catches the rest.
    Counts are kept per band; the export is cumulative (the Prometheus
    ``le`` convention).
    """

    _type = "histogram"
    __slots__ = ("_buckets", "_counts", "_sum", "_count")

    def __init__(self, registry, name, help, label_names, buckets):
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError(f"histogram {name!r} needs at least one bucket")
        if len(set(b)) != len(b):
            raise ValueError(f"histogram {name!r} has duplicate buckets {b}")
        self._buckets = b
        super().__init__(registry, name, help, label_names)

    def _init_value(self) -> None:
        self._counts = [0] * (len(self._buckets) + 1)
        self._sum = 0.0
        self._count = 0

    def _copy_config(self, child: "_Metric") -> None:
        child._buckets = self._buckets  # shared, immutable

    def observe(self, value: float) -> None:
        if not self._registry._enabled:
            return
        self._guard_unlabeled()
        idx = bisect_left(self._buckets, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    def _value_payload(self) -> Dict[str, Any]:
        cum, total = [], 0
        for le, c in zip(self._buckets, self._counts):
            total += c
            cum.append([le, total])
        cum.append(["+Inf", self._count])
        return {"count": self._count, "sum": self._sum, "buckets": cum}

    def quantile(self, p: float) -> float:
        """Estimate the ``p``-quantile (``0 <= p <= 1``) from the bucket
        counts — monotone linear interpolation inside the target bucket,
        the same model ``histogram_quantile`` applies to a Prometheus
        scrape, so a live dashboard and this in-process value agree.

        The first bucket interpolates from 0 (these are latency-shaped
        metrics); a quantile landing in the ``+Inf`` bucket clamps to the
        highest finite bound (there is no upper edge to interpolate
        toward). Returns 0.0 for an empty histogram.
        """
        self._guard_unlabeled()
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"quantile p must be in [0, 1], got {p}")
        with self._lock:
            counts = list(self._counts)
            total = self._count
        if total == 0:
            return 0.0
        target = p * total
        cum = 0
        for i, c in enumerate(counts[:-1]):
            if cum + c >= target and c > 0:
                lo = self._buckets[i - 1] if i > 0 else 0.0
                hi = self._buckets[i]
                return lo + (hi - lo) * (target - cum) / c
            cum += c
        return self._buckets[-1]


class MetricsRegistry:
    """Process-wide metric store; starts disabled (mutations are no-ops).

    Metric registration is idempotent: re-declaring the same (name, type,
    labels) returns the existing object — module-level instrumentation can
    declare its metrics at import without coordination — while a conflicting
    redeclaration raises.
    """

    def __init__(self, enabled: bool = False):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}
        self._enabled = bool(enabled)

    # -- enablement -------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        with self._lock:  # cold path; reads stay lock-free via .enabled
            self._enabled = True

    def disable(self) -> None:
        with self._lock:
            self._enabled = False

    # -- registration -----------------------------------------------------

    def _register(self, cls, name, help, label_names, **kw) -> _Metric:
        _check_name(name)
        labels = _check_labels(label_names)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (
                    type(existing) is not cls
                    or existing._label_names != labels
                    or (
                        cls is Histogram
                        and kw
                        and existing._buckets
                        != tuple(sorted(float(x) for x in kw["buckets"]))
                    )
                ):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing._type} with labels "
                        f"{existing._label_names}"
                    )
                return existing
            metric = cls(self, name, help, labels, **kw)
            self._metrics[name] = metric
            return metric

    def counter(
        self, name: str, help: str = "", labels: Sequence[str] = ()
    ) -> Counter:
        return self._register(Counter, name, help, labels)  # type: ignore

    def gauge(
        self, name: str, help: str = "", labels: Sequence[str] = ()
    ) -> Gauge:
        return self._register(Gauge, name, help, labels)  # type: ignore

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._register(
            Histogram, name, help, labels, buckets=buckets
        )  # type: ignore

    # -- export -----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able dump of every metric (the ``--metrics-out`` payload)."""
        from tree_attention_tpu_torch.utils.logging import _process_index

        out: List[Dict[str, Any]] = []
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                samples = [
                    {"labels": lbls, **(
                        v if isinstance(v, dict) else {"value": v}
                    )}
                    for lbls, v in m._samples()
                ]
                out.append({
                    "name": m.name, "type": m._type, "help": m.help,
                    "samples": samples,
                })
        return {
            "captured_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "process_index": _process_index(),
            "metrics": out,
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent)

    def write_json(self, path: str) -> None:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json(indent=2))
            f.write("\n")

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: List[str] = []
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                lines.append(f"# TYPE {m.name} {m._type}")
                for lbls, payload in m._samples():
                    if isinstance(payload, dict):  # histogram
                        for le, c in payload["buckets"]:
                            lines.append(
                                f"{m.name}_bucket"
                                f"{_label_str({**lbls, 'le': _fmt_le(le)})}"
                                f" {c}"
                            )
                        lines.append(
                            f"{m.name}_sum{_label_str(lbls)} "
                            f"{_fmt_value(payload['sum'])}"
                        )
                        lines.append(
                            f"{m.name}_count{_label_str(lbls)} "
                            f"{payload['count']}"
                        )
                    else:
                        lines.append(
                            f"{m.name}{_label_str(lbls)} "
                            f"{_fmt_value(payload)}"
                        )
        return "\n".join(lines) + "\n"

    # -- test support -----------------------------------------------------

    def reset(self) -> None:
        """Zero every value (keeps registrations). For tests."""
        with self._lock:
            for m in self._metrics.values():
                if not m._label_names:
                    m._init_value()
                for child in m._children.values():
                    child._init_value()

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)


def _fmt_le(le: Any) -> str:
    return le if isinstance(le, str) else _fmt_value(le)


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(str(v))}"' for k, v in labels.items()
    )
    return "{" + inner + "}"


#: The process-wide default registry every instrumentation site uses.
REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "", labels: Sequence[str] = ()) -> Counter:
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Sequence[str] = ()) -> Gauge:
    return REGISTRY.gauge(name, help, labels)


def histogram(
    name: str,
    help: str = "",
    labels: Sequence[str] = (),
    buckets: Sequence[float] = DEFAULT_BUCKETS,
) -> Histogram:
    return REGISTRY.histogram(name, help, labels, buckets)


# Host-loop totals of the train loop (each counted unit is a step the
# process finished), under the JAX CLI's names.
TRAIN_STEPS = counter(
    "train_steps_total", "optimizer steps completed by the CLI train loop"
)
TRAIN_TOKENS = counter(
    "train_tokens_total", "tokens consumed by completed train steps"
)
