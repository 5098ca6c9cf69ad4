"""Split-KV flash decode on Hopper: kernels B1 (contiguous KV) and B2 (paged).

Counterpart of ``tree_attention_tpu/ops/pallas_decode.py``; the kernels are
``csrc/flash_decode.cu`` (design notes and the bound there). Same
``(out, lse)`` contract: each KV head's ``G*Tq`` query rows are packed into
one tile, a key at global position ``kv_offset + j`` is visible to packed
row ``r`` iff ``kv_offset + j <= q_offset[b] + r % Tq`` (causal), scores and
lse in f32, P rounded to V's dtype, output in q's dtype, empty rows
``(0, -inf)``.

Each wrapper runs its kernel for a CUDA tensor and its plain version
(:func:`decode_plain`, :func:`paged_decode_plain`) for a CPU
tensor — nothing else: a build or launch failure raises. ``.launches``
counts the kernel launches of each wrapper.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from tree_attention_tpu_torch.ops import _build
from tree_attention_tpu_torch.ops.block_utils import Offset, offsets
from tree_attention_tpu_torch.ops.reference import (
    attention_packed,
    default_scale,
    empty_result,
)

# Work items the split heuristic aims for: enough warps in flight to cover
# HBM latency on 132 SMs even for the B=1 reference workload.
_TARGET_WARPS = 4096
# Fewest keys a split streams (below this the merge costs more than it buys).
_MIN_SPLIT_KEYS = 64

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib_fn = None


def _launcher():
    global _lib_fn
    if _lib_fn is None:
        lib = _build.library("flash_decode")
        fn = lib.flash_decode_launch
        fn.argtypes = (
            [ctypes.c_void_p] * 9
            + [ctypes.c_int] * 14
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _lib_fn = (fn, lib.flash_decode_warps_per_cta())
    return _lib_fn


def _rows_per_warp(rows: int) -> int:
    """The kernel's Q tile: 1 packed row per warp when a KV head has one
    query row (the lean variant), else 8."""
    return 1 if rows == 1 else 8


def gather_paged_kv(k: torch.Tensor, v: torch.Tensor,
                    block_table: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The logical ``(B, Hkv, NB*block, D)`` view of ``(N, Hkv, block, D)``
    pools: row ``b``'s logical block ``j`` is pool row ``block_table[b, j]``
    (out-of-range entries clamp; they sit past the slot's length and are
    causally masked)."""

    def g(pool: torch.Tensor) -> torch.Tensor:
        B, NB = block_table.shape
        N, Hkv, blk, D = pool.shape
        idx = block_table.long().clamp(0, N - 1)
        return pool[idx].transpose(1, 2).reshape(B, Hkv, NB * blk, D)

    return g(k), g(v)


def decode_plain(q, k, v, *, causal: bool = False,
                 scale: Optional[float] = None, q_offset: Offset = 0,
                 kv_offset: Offset = 0):
    """B1's plain version (any device)."""
    return attention_packed(q, k, v, causal=causal, scale=scale,
                            q_offset=q_offset, kv_offset=kv_offset)


def paged_decode_plain(q, k, v, block_table, *, q_offset: Offset,
                       scale: Optional[float] = None):
    """B2's plain version (any device): gather the logical view, then B1's."""
    kg, vg = gather_paged_kv(k, v, block_table)
    return attention_packed(q, kg, vg, causal=True, scale=scale,
                            q_offset=q_offset, kv_offset=0)


def _check(q: torch.Tensor, *kv: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {q.dtype} (float32, bfloat16)")
    for t in kv:
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k and v must share dtype and device")
    if q.shape[-1] not in (64, 128):
        raise ValueError(f"head dim {q.shape[-1]} unsupported (64, 128)")


def _launch(q, k, v, offs, table, *, B, Hkv, Tk, blk, NB, causal, scale):
    fn, warps = _launcher()
    _, Hq, Tq, D = q.shape
    R = (Hq // Hkv) * Tq
    rows_per_warp = _rows_per_warp(R)
    qp = q.contiguous().reshape(B * Hkv, R, D)
    k, v = k.contiguous(), v.contiguous()
    base = -(-R // rows_per_warp) * B * Hkv
    splits = max(1, min(-(-_TARGET_WARPS // base), Tk // _MIN_SPLIT_KEYS))
    split_len = -(-math.ceil(Tk / splits) // 8) * 8
    ctas = -(-math.ceil(Tk / split_len) // warps)
    s_eff = ctas * warps
    o_part = torch.empty((s_eff, B * Hkv, R, D), dtype=torch.float32,
                         device=q.device)
    lse_part = torch.empty((s_eff, B * Hkv, R), dtype=torch.float32,
                           device=q.device)
    out = torch.empty_like(qp)
    lse = torch.empty((B * Hkv, R), dtype=torch.float32, device=q.device)
    err = fn(
        qp.data_ptr(), k.data_ptr(), v.data_ptr(), offs.data_ptr(),
        0 if table is None else table.data_ptr(), o_part.data_ptr(),
        lse_part.data_ptr(), out.data_ptr(), lse.data_ptr(),
        _DTYPES[q.dtype], D, int(table is not None), rows_per_warp, B, Hkv, R,
        Tq, Tk, blk, NB, ctas, split_len, int(causal),
        float(default_scale(D, scale)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error {err}")
    return out.reshape(B, Hq, Tq, D), lse.reshape(B, Hq, Tq)


def attention_cuda_decode(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = False,
                          scale: Optional[float] = None,
                          q_offset: Offset = 0, kv_offset: Offset = 0):
    """B1: ``q`` ``(B, Hq, Tq, D)`` against contiguous ``k``/``v``
    ``(B, Hkv, Tk, D)``; offsets scalar or ``(B,)``."""
    if q.device.type == "cpu":
        return decode_plain(q, k, v, causal=causal, scale=scale,
                            q_offset=q_offset, kv_offset=kv_offset)
    _check(q, k, v)
    B, Hkv, Tk, _ = k.shape
    if Tk == 0:
        return empty_result(q)
    offs = offsets(q_offset, kv_offset, B, q.device).contiguous()
    attention_cuda_decode.launches += 1
    return _launch(q, k, v, offs, None, B=B, Hkv=Hkv, Tk=Tk, blk=1, NB=0,
                   causal=causal, scale=scale)


attention_cuda_decode.launches = 0


def attention_cuda_decode_paged(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, block_table: torch.Tensor,
                                *, q_offset: Offset,
                                scale: Optional[float] = None):
    """B2: causal decode of ``q`` ``(B, Hq, Tq, D)`` against
    ``(N, Hkv, block, D)`` pools through the ``(B, NB)`` int32 table; slot
    ``b``'s queries sit at ``q_offset[b]``. Table entries past a slot's
    length are never read."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k, v, block_table,
                                  q_offset=q_offset, scale=scale)
    _check(q, k, v)
    if block_table.dtype != torch.int32 or block_table.device != q.device:
        raise ValueError("block_table must be int32 on q's device")
    B, NB = block_table.shape
    _, Hkv, blk, _ = k.shape
    offs = offsets(q_offset, 0, B, q.device).contiguous()
    attention_cuda_decode_paged.launches += 1
    return _launch(q, k, v, offs, block_table.contiguous(), B=B, Hkv=Hkv,
                   Tk=NB * blk, blk=blk, NB=NB, causal=True, scale=scale)


attention_cuda_decode_paged.launches = 0
