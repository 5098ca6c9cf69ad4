"""Kernel choice and tile defaults on the H100.

Counterpart of ``tree_attention_tpu/ops/tuning.py``. The TPU tables (tile
sizes measured on a v5e) do not carry over: on the card the decode kernels'
split length is chosen per call from the work-item count
(``ops/cuda_decode.py``), and the (Q, KV) tiles of B3, B6 and B7 are fixed
in ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` and stated below, where
the wrappers check the built libraries against them. What carries over is
the dispatch policy: the packed-row decode kernels below the Q-tile
width, the Q-tiled kernel above it (packing a prefill chunk's rows per KV head would re-stream the KV once
per 8-row tile).
"""

from __future__ import annotations

# Queries per slot from which the Q-tiled kernel (B3) takes over from the
# packed-row decode kernels (B1/B2): the same split as the TPU dispatch.
DECODE_KERNEL_MAX_TQ = 128

# KV block of the plain blockwise reference.
BLOCKWISE_BLOCK_K = 512

# (Q rows, keys) per tile of each body, by input dtype. bf16 runs the
# tensor-core bodies of B3, B6 and B7 (wgmma fed by a TMA ring, two consumer
# warpgroups of 64 rows or keys): B3 streams 128-key tiles; B6 64-key
# tiles, since it holds S, dP and dQ in registers at once; B7 keeps 128
# keys resident (64 per warpgroup) and streams 64-row Q/dO tiles, since it
# holds S^T, dP^T, dK and dV at once. float32 runs the CUDA-core bodies (32
# rows, 64 keys: two keys per lane in the score phase); B7's 32-row Q tile
# there was chosen on an H100 over 64 rows, which were slower (``PERF.md``).
# The v5e ``default_block_q*`` tables do not carry over.
FWD_TILES = {"bfloat16": (128, 128), "float32": (32, 64)}  # B3
DQ_TILES = {"bfloat16": (128, 64), "float32": (32, 64)}    # B6
DKV_TILES = {"bfloat16": (64, 128), "float32": (32, 64)}   # B7


def kernel_for(tq: int) -> str:
    """``"decode"`` (B1/B2) below the Q-tile width, ``"fwd"`` (B3) above."""
    return "decode" if tq < DECODE_KERNEL_MAX_TQ else "fwd"


def default_block_size(impl: str, tk: int) -> int:
    """KV block of the plain ``blockwise`` impl (the CUDA kernels size their
    own splits)."""
    del impl, tk
    return BLOCKWISE_BLOCK_K
