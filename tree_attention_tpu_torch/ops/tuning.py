"""Kernel choice and tile defaults on the H100.

Counterpart of ``tree_attention_tpu/ops/tuning.py``. The TPU tables (tile
sizes measured on a v5e) do not carry over: on the card the decode kernels'
split length is chosen per call from the work-item count
(``ops/cuda_decode.py``) and the forward kernel's (32, 64) tile is fixed in
``csrc/flash_fwd.cu``. What carries over is the dispatch policy: the
packed-row decode kernels below the Q-tile width, the Q-tiled kernel above
it (packing a prefill chunk's rows per KV head would re-stream the KV once
per 8-row tile).
"""

from __future__ import annotations

# Queries per slot from which the Q-tiled kernel (B3) takes over from the
# packed-row decode kernels (B1/B2): the same split as the TPU dispatch.
DECODE_KERNEL_MAX_TQ = 128

# KV block of the plain blockwise reference.
BLOCKWISE_BLOCK_K = 512


def kernel_for(tq: int) -> str:
    """``"decode"`` (B1/B2) below the Q-tile width, ``"fwd"`` (B3) above."""
    return "decode" if tq < DECODE_KERNEL_MAX_TQ else "fwd"


def default_block_size(impl: str, tk: int) -> int:
    """KV block of the plain ``blockwise`` impl (the CUDA kernels size their
    own splits)."""
    del impl, tk
    return BLOCKWISE_BLOCK_K
