"""Continuous-batching serving over the paged KV pool or per-slot regions,
exact or int8 (``SlotServer(quantize=True)``), on one rank or over a
sequence-sharded pool (``SlotServer(mesh=..., kv_shard="seq")``), with
shared prompt prefixes reused through a radix tree
(``SlotServer(prefix_cache=True)``) and kept in a host-RAM tier under the
pool (``SlotServer(host_blocks=N)``, :class:`HostBlockPool`); admitted in
chunks or whole (``admission="whole"``); several completions of one
prompt (``Request(n=, best_of=, fork_at=)``, ``SlotServer.fork``) as
copy-on-write fork families over shared pool blocks, or as token trees
in one slot (``tree_sampling=True``, the default); prefill and decode on
two engines over one pool (:class:`DisaggServer`, a handoff that moves no
KV byte); served live over HTTP by :class:`IngressServer` (SSE streaming,
cancellation, deadlines, drain); N in-process replicas behind a
prefix-affinity :class:`FleetRouter` under a :class:`FleetSupervisor`
(``--serve-fleet``)."""

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
from tree_attention_tpu_torch.serving.disagg import (  # noqa: F401
    DisaggServer,
)
from tree_attention_tpu_torch.serving.ingress import (  # noqa: F401
    IngressServer,
    QueueRequestSource,
    install_drain_signals,
)
from tree_attention_tpu_torch.serving.router import (  # noqa: F401
    FleetRouter,
    ReplicaTree,
    federate_metrics,
)
from tree_attention_tpu_torch.serving.fleet import (  # noqa: F401
    FleetSupervisor,
    LocalReplica,
    install_fleet_drain_signals,
)
