"""Flash-attention backward as a ``torch.autograd.Function``.

Counterpart of ``tree_attention_tpu/ops/vjp.py``. The forward saves only
``(q, k, v, out, lse)`` and the offsets; the backward recomputes the
probabilities from lse instead of storing them (O(T) residual memory).

Attention returns ``(out, lse)``, and callers may differentiate through lse
too (the tree merge weighs shards by ``exp(lse - m)``). Since
``d lse / d logits`` is the softmax ``p`` itself, the lse cotangent folds
into the standard backward as one more term of delta:

    ds = p * (dout.v^T - delta),   delta = rowsum(dout * out) - dlse

Routes, by the query count (``ops/tuning.kernel_for``), as JAX's
``impl="pallas"`` / ``impl="pallas_decode"``:

- Tq >= 128: forward B3 (``ops/cuda_attention.py``), backward B6 + B7
  (``ops/cuda_bwd.py``);
- Tq < 128: forward B1 (``ops/cuda_decode.py``), backward the plain
  :func:`attention_bwd_blockwise` — JAX differentiates its decode kernel
  through the same jnp recomputation (decode grads are rare, Tq tiny).

Each kernel wrapper runs its plain version for CPU tensors; ``impl="plain"``
runs the plain versions on any device (the comparison path of the on-card
checks). For CUDA tensors under ``"auto"`` the kernels launch or raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tree_attention_tpu_torch.ops.block_utils import (
    NEG_INF,
    Offset,
    offsets,
    pad_to_block,
    tile_live,
)
from tree_attention_tpu_torch.ops.cuda_attention import (
    attention_cuda_fwd,
    fwd_plain,
)
from tree_attention_tpu_torch.ops.cuda_bwd import attention_cuda_bwd, bwd_plain
from tree_attention_tpu_torch.ops.cuda_decode import (
    attention_cuda_decode,
    decode_plain,
)
from tree_attention_tpu_torch.ops.reference import _group, default_scale
from tree_attention_tpu_torch.ops.tuning import BLOCKWISE_BLOCK_K, kernel_for


def attention_bwd_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, lse: torch.Tensor,
                            dout: torch.Tensor,
                            dlse: Optional[torch.Tensor] = None, *,
                            causal: bool, scale: Optional[float],
                            q_offset: Offset = 0, kv_offset: Offset = 0,
                            block_size: int = BLOCKWISE_BLOCK_K
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Blockwise flash backward in plain torch: recompute p from ``(q, k,
    lse)`` one KV block at a time, dk/dv reduced over the query-head group
    so they stay ``Hkv``-sized. Rows with ``lse = -inf`` (no visible key)
    use lse 0: their logits are all ``-inf``, so p is 0 anyway. Offsets are
    scalars or ``(B,)``; causally dead blocks are skipped for scalar ones."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    G = _group(q, k)
    s = default_scale(D, scale)
    if Tk == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dev = q.device
    qf = q.float().reshape(B, Hkv, G, Tq, D)
    doutf = dout.float().reshape(B, Hkv, G, Tq, D)
    lse_g = lse.float().reshape(B, Hkv, G, Tq)
    lse_safe = torch.where(torch.isneginf(lse_g), 0.0, lse_g)
    delta = (doutf * out.float().reshape(B, Hkv, G, Tq, D)).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float().reshape(B, Hkv, G, Tq)

    blk = min(block_size, Tk)
    kp, vp = pad_to_block(k, 2, blk), pad_to_block(v, 2, blk)
    n_blocks = kp.shape[2] // blk
    offs = offsets(q_offset, kv_offset, B, dev).long()
    qpos = offs[0][:, None] + torch.arange(Tq, device=dev)        # (B, Tq)
    scalar = not isinstance(q_offset, torch.Tensor) and not isinstance(
        kv_offset, torch.Tensor)

    dq = torch.zeros((B, Hkv, G, Tq, D), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, Hkv, n_blocks * blk, D), dtype=torch.float32,
                     device=dev)
    dv = torch.zeros_like(dk)
    for i in range(n_blocks):
        if scalar and not tile_live(0, i, Tq, blk, q_offset, kv_offset,
                                    causal):
            continue  # fully masked block: p = 0, no contribution
        cols = slice(i * blk, (i + 1) * blk)
        kf, vf = kp[:, :, cols].float(), vp[:, :, cols].float()
        col = i * blk + torch.arange(blk, device=dev)
        valid = (col < Tk)[None, None, :].expand(B, Tq, blk)
        if causal:
            kpos = offs[1][:, None] + col                          # (B, blk)
            valid = valid & (qpos[:, :, None] >= kpos[:, None, :])
        logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * s
        logits = logits.masked_fill(~valid[:, None, None], NEG_INF)
        p = torch.exp(logits - lse_safe[..., None])
        dp = torch.einsum("bhgqd,bhkd->bhgqk", doutf, vf)
        ds = p * (dp - delta[..., None])
        dq += torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * s
        dk[:, :, cols] = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) * s
        dv[:, :, cols] = torch.einsum("bhgqk,bhgqd->bhkd", p, doutf)
    return (dq.reshape(B, Hq, Tq, D).to(q.dtype), dk[:, :, :Tk].to(k.dtype),
            dv[:, :, :Tk].to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """``(out, lse)`` of causal-with-offsets attention with the flash
    (recompute-from-lse) backward; see the module docstring for routes."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: Optional[float],
                q_offset: Offset, kv_offset: Offset, impl: str):
        decode = kernel_for(q.shape[2]) == "decode"
        plain = impl == "plain"
        if decode:
            fwd = decode_plain if plain else attention_cuda_decode
        else:
            fwd = fwd_plain if plain else attention_cuda_fwd
        out, lse = fwd(q, k, v, causal=causal, scale=scale,
                       q_offset=q_offset, kv_offset=kv_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, scale=scale, q_offset=q_offset,
                      kv_offset=kv_offset)
        ctx.decode, ctx.plain = decode, plain
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:  # only lse reached the loss
            dout = torch.zeros_like(out)
        if ctx.decode:
            bwd = attention_bwd_blockwise
        else:
            bwd = bwd_plain if ctx.plain else attention_cuda_bwd
        dq, dk, dv = bwd(q, k, v, out, lse, dout, dlse, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, scale: Optional[float] = None,
                        q_offset: Offset = 0, kv_offset: Offset = 0,
                        impl: str = "auto"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable ``(out, lse)`` through :class:`FlashAttention`;
    ``impl`` is ``"auto"`` (the kernels) or ``"plain"``."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    return FlashAttention.apply(q, k, v, causal, scale, q_offset, kv_offset,
                                impl)
