"""Parallelism: the process group and mesh, and the tree merge across ranks.

Counterpart of ``tree_attention_tpu/parallel``: the decode merge
(``tree_decode``, ``paged_tree_decode``) and the training shape
(``tree_attention`` with the zigzag layout). The ring and Ulysses
comparators are a later slice of the port, with the bench that calls them.
"""

from tree_attention_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_DATA,
    AXIS_MODEL,
    AXIS_SEQ,
    Mesh,
    check_ranks_agree,
    initialize_distributed,
    make_mesh,
    prune_axes,
    shard_along,
)
from tree_attention_tpu_torch.parallel.tree import (  # noqa: F401
    COLLECTIVES,
    MERGE_PAYLOAD_FORMATS,
    SEQ_LAYOUTS,
    local_positions,
    paged_tree_decode,
    resolve_merge_payload,
    shard_zigzag,
    tree_attention,
    tree_decode,
    tree_decode_q8,
    unshard_zigzag,
    zigzag_perm,
)
