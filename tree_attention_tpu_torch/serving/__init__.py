"""Continuous-batching serving over the paged KV pool or per-slot regions,
exact or int8 (``SlotServer(quantize=True)``), on one rank or over a
sequence-sharded pool (``SlotServer(mesh=..., kv_shard="seq")``), with
shared prompt prefixes reused through a radix tree
(``SlotServer(prefix_cache=True)``)."""

from tree_attention_tpu_torch.serving.block_pool import (  # noqa: F401
    BlockAllocator,
    ShardedBlockAllocator,
)
from tree_attention_tpu_torch.serving.prefix_cache import (  # noqa: F401
    PagedPrefixIndex,
    PrefixCache,
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
