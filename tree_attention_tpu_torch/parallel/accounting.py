"""Collective-payload accounting of the sequence-parallel merge.

Counterpart of ``tree_attention_tpu/parallel/accounting.py``, on the port's
metrics registry: per-rank wire bytes by collective kind, and entry-point
dispatch counts, from the closed-form byte counts of each call's shapes
(the JAX package's formulas). Counted per call, only while the registry is
on.
"""

from __future__ import annotations

from typing import Optional, Tuple

from tree_attention_tpu_torch import obs

PAYLOAD_BYTES = obs.counter(
    "collective_payload_bytes_total",
    "per-rank collective operand bytes of dispatched calls",
    labels=("algorithm", "collective"),
)
DISPATCH = obs.counter(
    "parallel_dispatch_total",
    "sequence-parallel entry-point dispatches",
    labels=("algorithm",),
)


def shard_counts(mesh, data_axis: Optional[str],
                 head_axis: Optional[str]) -> Tuple[int, int]:
    """``(data_shards, head_shards)`` that divide an entry point's global
    batch and head dims into the per-rank dims its collectives move."""

    def size(axis: Optional[str]) -> int:
        return mesh.shape.get(axis, 1) if axis is not None else 1

    return max(size(data_axis), 1), max(size(head_axis), 1)


def account_payload(algorithm: str, **collective_bytes: int) -> None:
    """Record one dispatch's per-rank payload bytes by collective kind."""
    if not obs.REGISTRY.enabled:
        return
    DISPATCH.labels(algorithm=algorithm).inc()
    for coll, nbytes in collective_bytes.items():
        PAYLOAD_BYTES.labels(algorithm=algorithm, collective=coll).inc(
            int(nbytes))
