"""Attention ops: one ``(out, lse)`` contract, several implementations.

Counterpart of ``tree_attention_tpu/ops/__init__.py``.
``flash_attention(q, k, v, ...) -> (out, lse)`` with ``impl``:

- ``"auto"``      — the CUDA kernels: the packed-row decode kernel B1
  below the Q-tile width (:mod:`.cuda_decode`), the Q-tiled kernel B3 above
  it (:mod:`.cuda_attention`); each runs its plain version for CPU tensors
- ``"plain"``     — the kernels' plain version on any device
- ``"naive"``     — materialised f32 scores, the oracle (:mod:`.reference`)
- ``"blockwise"`` — online softmax over KV blocks (:mod:`.reference`)

Inference only in this slice: there is no autograd rule yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tree_attention_tpu_torch.ops.cuda_attention import attention_cuda_fwd
from tree_attention_tpu_torch.ops.cuda_decode import attention_cuda_decode
from tree_attention_tpu_torch.ops.decode import flash_decode  # noqa: F401
from tree_attention_tpu_torch.ops.reference import (  # noqa: F401
    attention_blockwise,
    attention_naive,
    attention_packed,
    finalize,
    merge_partials,
)
from tree_attention_tpu_torch.ops.tuning import (
    default_block_size,
    kernel_for,
)

IMPLS = ("auto", "plain", "naive", "blockwise")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    q_offset=0, kv_offset=0, impl: str = "auto",
                    block_size: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over the sequence axis, returning ``(out, lse)``.

    ``q`` ``(B, Hq, Tq, D)``, ``k``/``v`` ``(B, Hkv, Tk, D)``; ``causal``
    masks with ``-inf`` before the softmax using the global positions
    ``q_offset``/``kv_offset`` of the first rows (``auto`` and ``plain``
    also take ``(B,)`` offsets). Returns ``out`` in q's dtype and ``lse``
    ``(B, Hq, Tq)`` float32.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    kw = dict(causal=causal, scale=scale, q_offset=q_offset,
              kv_offset=kv_offset)
    if impl == "auto":
        kernel = (attention_cuda_decode if kernel_for(q.shape[2]) == "decode"
                  else attention_cuda_fwd)
        return kernel(q, k, v, **kw)
    if impl == "plain":
        return attention_packed(q, k, v, **kw)
    if impl == "naive":
        return attention_naive(q, k, v, **kw)
    if block_size is None:
        block_size = default_block_size(impl, k.shape[2])
    return attention_blockwise(q, k, v, block_size=block_size, **kw)
