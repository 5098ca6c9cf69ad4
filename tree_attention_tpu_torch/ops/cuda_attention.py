"""Q-tiled flash-attention forward on Hopper: kernel B3.

Counterpart of ``tree_attention_tpu/ops/pallas_attention.py`` (forward
only); the kernel is ``csrc/flash_fwd.cu`` (design notes and the bound
there). Same ``(out, lse)`` contract as the decode kernels, for prefill-sized
query counts: causal with per-batch ``(q_offset, kv_offset)``, GQA through
the KV head index, lse f32, P rounded to V's dtype, empty rows ``(0, -inf)``.

The kernel has two bodies, chosen by dtype alone: bf16 runs on the tensor
cores (``wgmma`` fed by a TMA ring), float32 on the CUDA cores (the JAX
reference pins f32 products at full precision). Their tiles are
``ops/tuning.FWD_TILES``, checked against the built library. The wrapper
runs the kernel for a CUDA tensor and its plain version (:func:`fwd_plain`)
for a CPU tensor — nothing else: a build or launch failure raises.
``attention_cuda_fwd.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tree_attention_tpu_torch.ops import _build
from tree_attention_tpu_torch.ops.block_utils import Offset, offsets
from tree_attention_tpu_torch.ops.cuda_decode import _DTYPES, _check
from tree_attention_tpu_torch.ops.reference import (
    attention_packed,
    default_scale,
    empty_result,
)
from tree_attention_tpu_torch.ops.tuning import FWD_TILES

_lib_fn = None


def _launcher():
    global _lib_fn
    if _lib_fn is None:
        lib = _build.library("flash_fwd")
        check_tiles(lib, "flash_fwd", FWD_TILES)
        fn = lib.flash_fwd_launch
        fn.argtypes = (
            [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _lib_fn = fn
    return _lib_fn


def check_tiles(lib, kernel: str, tiles) -> None:
    """Raise unless each dtype's body of ``kernel`` in the loaded ``lib``
    was built with the (Q, KV) tiles ``tiles[dtype name]`` (from
    ``ops/tuning.py``), as its ``<kernel>_block_q/k(dtype code)`` exports
    report them."""
    for dtype, code in _DTYPES.items():
        want = tiles[str(dtype).removeprefix("torch.")]
        built = (getattr(lib, f"{kernel}_block_q")(code),
                 getattr(lib, f"{kernel}_block_k")(code))
        if built != want:
            raise RuntimeError(
                f"{kernel} was built with (Q, KV) tiles {built} for {dtype}, "
                f"ops/tuning.py says {want}"
            )


def fwd_plain(q, k, v, *, causal: bool = False,
              scale: Optional[float] = None, q_offset: Offset = 0,
              kv_offset: Offset = 0):
    """B3's plain version (any device). B3 computes the same function as
    the decode kernels with its rows tiled per query head instead of packed
    per KV head, so the plain version is shared."""
    return attention_packed(q, k, v, causal=causal, scale=scale,
                            q_offset=q_offset, kv_offset=kv_offset)


def attention_cuda_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = False, scale: Optional[float] = None,
                       q_offset: Offset = 0, kv_offset: Offset = 0):
    """B3: ``q`` ``(B, Hq, Tq, D)`` against ``k``/``v`` ``(B, Hkv, Tk, D)``;
    offsets scalar or ``(B,)``."""
    if q.device.type == "cpu":
        return fwd_plain(q, k, v, causal=causal, scale=scale,
                         q_offset=q_offset, kv_offset=kv_offset)
    _check(q, k, v)
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(
            f"query heads ({Hq}) must be a multiple of kv heads ({Hkv})"
        )
    if Tk == 0 or Tq == 0:
        return empty_result(q)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    offs = offsets(q_offset, kv_offset, B, q.device).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Tq), dtype=torch.float32, device=q.device)
    attention_cuda_fwd.launches += 1
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), offs.data_ptr(),
        out.data_ptr(), lse.data_ptr(), _DTYPES[q.dtype], D, B, Hq, Hkv, Tq,
        Tk, int(causal), float(default_scale(D, scale)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    return out, lse


attention_cuda_fwd.launches = 0
