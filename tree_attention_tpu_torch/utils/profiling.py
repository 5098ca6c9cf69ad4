"""Timing of one callable: per-call device time on the GPU.

Counterpart of ``tree_attention_tpu/utils/profiling.py``'s ``time_fn`` and
``TimingStats``. On a CUDA device each call is bracketed by CUDA events on
the current stream (device time, including the launch gaps between the
call's kernels); on the CPU by the host clock.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Dict, Union

import torch


@dataclasses.dataclass
class TimingStats:
    """Per-call seconds over ``iters`` calls."""

    median: float
    mean: float
    minimum: float
    maximum: float
    iters: int
    clock: str  # "cuda_events" or "host"

    def as_dict(self) -> Dict[str, Any]:
        return {
            "median_s": self.median,
            "mean_s": self.mean,
            "min_s": self.minimum,
            "max_s": self.maximum,
            "iters": self.iters,
        }


def time_fn(fn: Callable[..., Any], *args: Any,
            device: Union[str, torch.device], iters: int = 10,
            warmup: int = 2, **kwargs: Any) -> TimingStats:
    """Time ``fn(*args, **kwargs)`` on ``device`` (which picks the clock):
    ``warmup`` untimed calls, then ``iters`` timed ones."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    cuda = torch.device(device).type == "cuda"
    for _ in range(max(warmup, 0)):
        fn(*args, **kwargs)
    times = []
    for _ in range(iters):
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn(*args, **kwargs)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args, **kwargs)
            times.append(time.perf_counter() - t0)
    return TimingStats(
        median=statistics.median(times), mean=statistics.fmean(times),
        minimum=min(times), maximum=max(times), iters=len(times),
        clock="cuda_events" if cuda else "host",
    )
