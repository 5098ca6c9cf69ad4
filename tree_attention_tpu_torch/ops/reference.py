"""Plain PyTorch reference attention emitting ``(out, lse)``.

Counterpart of ``tree_attention_tpu/ops/reference.py``: the numerics anchor
every kernel is held against. Every attention function returns the output
and the logsumexp of the scaled logits per query row (the merge currency of
the safe-softmax monoid); rows that see no key emit ``(0, -inf)``.

Shapes: ``q`` ``(B, Hq, Tq, D)``; ``k``, ``v`` ``(B, Hkv, Tk, D)`` with
``Hq % Hkv == 0`` (query head ``h`` reads KV head ``h // G``); ``out`` in
q's dtype, ``lse`` ``(B, Hq, Tq)`` float32.
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
    tile_mask,
)


def default_scale(head_dim: int, scale: Optional[float]) -> float:
    return (head_dim ** -0.5) if scale is None else scale


def _group(q: torch.Tensor, k: torch.Tensor) -> int:
    Hq, Hkv = q.shape[1], k.shape[1]
    if Hq % Hkv:
        raise ValueError(
            f"query heads ({Hq}) must be a multiple of kv heads ({Hkv})"
        )
    return Hq // Hkv


def finalize(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
             out_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running ``(acc, max, sum)`` online-softmax state -> ``(out, lse)``;
    rows with ``l == 0`` emit ``(0, -inf)``."""
    empty = l <= 0.0
    safe_l = torch.where(empty, torch.ones_like(l), l)
    out = torch.where(empty[..., None], 0.0, acc / safe_l[..., None])
    lse = torch.where(empty, NEG_INF, m + torch.log(safe_l))
    return out.to(out_dtype), lse.float()


def empty_result(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(0, -inf)`` for every query row: attention against no keys (the
    identity of the safe-softmax monoid)."""
    B, Hq, Tq, _ = q.shape
    return (torch.zeros_like(q),
            torch.full((B, Hq, Tq), NEG_INF, dtype=torch.float32,
                       device=q.device))


def attention_naive(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    q_offset: int = 0, kv_offset: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialised-scores attention in float32 (the readable oracle)."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    G = _group(q, k)
    if Tk == 0:
        return empty_result(q)
    s = torch.einsum(
        "bhgqd,bhkd->bhgqk", q.reshape(B, Hkv, G, Tq, D).float(), k.float()
    ) * default_scale(D, scale)
    if causal:
        qp = q_offset + torch.arange(Tq, device=q.device)[:, None]
        kp = kv_offset + torch.arange(Tk, device=q.device)[None, :]
        s = s.masked_fill(~(qp >= kp), NEG_INF)
    m = s.amax(-1)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.exp(s - m_safe[..., None])
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return finalize(acc.reshape(B, Hq, Tq, D), m.reshape(B, Hq, Tq),
                    p.sum(-1).reshape(B, Hq, Tq), q.dtype)


def attention_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, scale: Optional[float] = None,
                        q_offset: int = 0, kv_offset: int = 0,
                        block_size: int = 512
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online-softmax attention over KV blocks, O(block) score memory; the
    same fold the kernels run, skipping causally dead blocks."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    G = _group(q, k)
    if Tk == 0:
        return empty_result(q)
    blk = min(block_size, Tk)
    kp, vp = pad_to_block(k, 2, blk), pad_to_block(v, 2, blk)
    qf = q.float().reshape(B, Hkv, G, Tq, D) * default_scale(D, scale)
    m = torch.full((B, Hkv, G, Tq), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, G, Tq), device=q.device)
    acc = torch.zeros((B, Hkv, G, Tq, D), device=q.device)
    for i in range(kp.shape[2] // blk):
        if not tile_live(0, i, Tq, blk, q_offset, kv_offset, causal):
            continue
        kb = kp[:, :, i * blk:(i + 1) * blk].float()
        vb = vp[:, :, i * blk:(i + 1) * blk].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kb)
        valid = tile_mask(Tq, blk, i, Tk, q_offset, kv_offset, causal,
                          q.device)
        s = s.masked_fill(~valid, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        alpha = torch.exp(torch.where(torch.isneginf(m), NEG_INF, m - m_safe))
        p = torch.exp(s - m_safe[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vb)
        m = m_new
    out, lse = finalize(acc, m, l, q.dtype)
    return out.reshape(B, Hq, Tq, D), lse.reshape(B, Hq, Tq)


def merge_partials(outs: torch.Tensor, lses: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard ``(out, lse)`` partials stacked on a leading axis:
    ``m = max lse_i; num = sum out_i e^(lse_i - m); den = sum e^(lse_i - m)``."""
    m = lses.amax(0)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    w = torch.exp(lses - m_safe[None])
    return finalize_merge((outs.float() * w[..., None]).sum(0), w.sum(0), m,
                          outs.dtype)


def finalize_merge(num: torch.Tensor, den: torch.Tensor, m: torch.Tensor,
                   out_dtype: torch.dtype
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalise reduced safe-softmax state into ``(out, lse)``; rows with
    ``den <= 0`` emit ``(0, -inf)``."""
    empty = den <= 0.0
    den_safe = torch.where(empty, torch.ones_like(den), den)
    out = torch.where(empty[..., None], 0.0, num / den_safe[..., None])
    lse = torch.where(empty, NEG_INF, m + torch.log(den_safe))
    return out.to(out_dtype), lse.float()


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype an operand computes in: int8 codes are widened to bf16
    (exact for [-127, 127]), as the TPU kernels cast them."""
    return torch.bfloat16 if dtype == torch.int8 else dtype


def attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool, scale: Optional[float], q_offset: Offset,
                     kv_offset: Offset,
                     row_scale: Optional[torch.Tensor] = None,
                     key_scales: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                     key_mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernels' plain version: dense f32 scores over each KV head's
    packed ``G*Tq`` query rows, per-batch ``(B,)`` or scalar offsets, P
    rounded to V's dtype before an f32-accumulated P.V — the kernels'
    arithmetic, term for term, in one materialised pass.

    Int8 operands (the q8 routes): int8 K/V and Q codes enter the products
    as exact integers; P rounds to bf16 and the output is bf16 when q is
    int8. ``row_scale`` ``(B, Hkv, G*Tq, 1)`` replaces the softmax scale as
    each packed row's multiplier of the raw dot (q8q: the row's Q scale);
    ``key_scales`` ``(k_key, v_key)``, each ``(B, Hkv, Tk)``, are per-key
    dequantization scalars: K's multiplies the score, V's multiplies p
    after the softmax sum has taken it (the kernels' fold order).
    ``key_mask`` ``(B, Tk)`` bool hides the keys it is False for (B2's
    remote blocks under ``local_blocks``)."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    G = _group(q, k)
    if Tk == 0:
        return empty_result(q)
    R = G * Tq
    s = torch.einsum(
        "bhrd,bhkd->bhrk", q.reshape(B, Hkv, R, D).float(), k.float()
    ) * (default_scale(D, scale) if row_scale is None else row_scale)
    if key_scales is not None:
        s = s * key_scales[0][:, :, None, :]
    if causal:
        offs = offsets(q_offset, kv_offset, B, q.device).long()
        qpos = offs[0][:, None] + torch.arange(R, device=q.device) % Tq
        kpos = offs[1][:, None] + torch.arange(Tk, device=q.device)
        s = s.masked_fill(~(kpos[:, None, None, :] <= qpos[:, None, :, None]),
                          NEG_INF)
    if key_mask is not None:
        s = s.masked_fill(~key_mask[:, None, None, :], NEG_INF)
    m = s.amax(-1)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(-1)
    if key_scales is not None:
        p = p * key_scales[1][:, :, None, :]
    acc = torch.einsum("bhrk,bhkd->bhrd",
                       p.to(compute_dtype(v.dtype)).float(), v.float())
    out, lse = finalize(acc, m, l, compute_dtype(q.dtype))
    return out.reshape(B, Hq, Tq, D), lse.reshape(B, Hq, Tq)
