"""Continuous-batching serving over the paged KV pool or per-slot regions,
exact or int8 (``SlotServer(quantize=True)``), on one rank or over a
sequence-sharded pool (``SlotServer(mesh=..., kv_shard="seq")``), with
shared prompt prefixes reused through a radix tree
(``SlotServer(prefix_cache=True)``) and kept in a host-RAM tier under the
pool (``SlotServer(host_blocks=N)``, :class:`HostBlockPool`); admitted in
chunks or whole (``admission="whole"``); served live over HTTP by
:class:`IngressServer` (SSE streaming, cancellation, deadlines, drain)."""

from tree_attention_tpu_torch.serving.block_pool import (  # noqa: F401
    BlockAllocator,
    ShardedBlockAllocator,
)
from tree_attention_tpu_torch.serving.host_pool import (  # noqa: F401
    HostBlockPool,
)
from tree_attention_tpu_torch.serving.prefix_cache import (  # noqa: F401
    TIER_DEVICE,
    TIER_HOST,
    PagedPrefixIndex,
    PrefixCache,
)
from tree_attention_tpu_torch.serving.engine import (  # noqa: F401
    OUTCOME_BUDGET,
    OUTCOME_CANCELLED,
    OUTCOME_DEADLINE,
    OUTCOME_EOS,
    OUTCOME_ERROR,
    OUTCOME_SHED,
    OUTCOMES,
    Request,
    RequestResult,
    RequestSource,
    ServeReport,
    SlotServer,
    StaticRequestSource,
    synthetic_trace,
)
from tree_attention_tpu_torch.serving.ingress import (  # noqa: F401
    IngressServer,
    QueueRequestSource,
    install_drain_signals,
)
