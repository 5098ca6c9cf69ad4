"""Continuous-batching serving over the paged KV pool or per-slot regions,
exact or int8 (``SlotServer(quantize=True)``), on one rank or over a
sequence-sharded pool (``SlotServer(mesh=..., kv_shard="seq")``)."""

from tree_attention_tpu_torch.serving.block_pool import (  # noqa: F401
    BlockAllocator,
    ShardedBlockAllocator,
)
from tree_attention_tpu_torch.serving.engine import (  # noqa: F401
    Request,
    RequestResult,
    RequestSource,
    ServeReport,
    SlotServer,
    StaticRequestSource,
    synthetic_trace,
)
