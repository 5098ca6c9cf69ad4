"""Parallelism: the process group and mesh, and the tree merge across ranks.

Counterpart of ``tree_attention_tpu/parallel`` for the decode half of the
sequence-parallel algorithm (training's ``tree_attention`` and the ring and
Ulysses comparators are later slices of the port).
"""

from tree_attention_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_DATA,
    AXIS_MODEL,
    AXIS_SEQ,
    Mesh,
    initialize_distributed,
    make_mesh,
    prune_axes,
    shard_along,
)
from tree_attention_tpu_torch.parallel.tree import (  # noqa: F401
    COLLECTIVES,
    MERGE_PAYLOAD_FORMATS,
    paged_tree_decode,
    resolve_merge_payload,
    tree_decode,
    tree_decode_q8,
)
