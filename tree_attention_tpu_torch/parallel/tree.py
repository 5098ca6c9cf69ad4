"""Sequence-parallel tree attention for decode: the merge across ranks.

Counterpart of ``tree_attention_tpu/parallel/tree.py`` (its decode half).
Each rank holds a shard of the KV sequence, computes flash attention over
it with the CUDA decode kernels (their plain versions on the CPU), emits
``(out, lse)``, and the partials merge with the safe-softmax monoid across
the mesh's ``seq`` axis:

    m = max_r lse_r;  num = sum_r out_r e^(lse_r - m);  den = sum_r e^(lse_r - m)

as all-reduces — one MAX over the f32 lse rows, then SUM. The merged result
comes out of the all-reduce, so it is bit-identical on every rank.

The port is SPMD, one process per rank (:mod:`.mesh`): every entry point
takes THIS rank's shard (the JAX functions take global arrays sharded over
the mesh) and returns the merged ``(out, lse)``, the same on every rank.

- :func:`tree_decode` — Q replicated, KV ``(B, Hkv, Tk/W, D)`` per rank,
  rank ``r``'s keys at global positions ``[r Tk/W, (r+1) Tk/W)``: 1 MAX and
  1 SUM (``num`` and ``den`` together).
- :func:`tree_decode_q8` — the same over int8 K/V with channel scales.
- :func:`paged_tree_decode` — one rank's slice of a sequence-sharded paged
  pool under the global block table: 1 MAX and 2 SUM (``num``, then
  ``den``), the paper's monoid stated as collectives.

Every collective issued is counted in :data:`COLLECTIVES` (always on; the
bytes go to :mod:`.accounting` when the metrics registry is on).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from tree_attention_tpu_torch.ops.cuda_decode import (
    attention_cuda_decode,
    decode_plain,
    resolve_q8_kernel,
)
from tree_attention_tpu_torch.ops.decode import paged_local_partial
from tree_attention_tpu_torch.ops.reference import finalize_merge
from tree_attention_tpu_torch.parallel.accounting import (
    account_payload,
    shard_counts,
)
from tree_attention_tpu_torch.parallel.mesh import AXIS_SEQ, Mesh

# Collectives issued, by (algorithm, collective): "pmax" is a MAX
# all-reduce, "psum"/"psum_num"/"psum_den" SUM all-reduces — the labels of
# the payload accounting.
COLLECTIVES: Dict[Tuple[str, str], int] = {}

_OPS = {"pmax": dist.ReduceOp.MAX}

# Merge wire format of tree_decode's SUM: "split" reduces one flat f32
# buffer that holds num and den as views (nothing is concatenated);
# "packed" concatenates [num | den] into a trailing D+1 and reduces that.
MERGE_PAYLOAD_FORMATS = ("split", "packed")


def resolve_merge_payload(value: Optional[str] = None) -> str:
    """The merge wire format: ``value``, else ``TREE_ATTN_MERGE_PAYLOAD``
    read at call time, else ``"split"``."""
    fmt = value if value is not None else os.environ.get(
        "TREE_ATTN_MERGE_PAYLOAD", "split")
    if fmt not in MERGE_PAYLOAD_FORMATS:
        raise ValueError(
            f"merge payload format must be one of {MERGE_PAYLOAD_FORMATS}, "
            f"got {fmt!r} (from TREE_ATTN_MERGE_PAYLOAD if not passed "
            f"explicitly)")
    return fmt


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str, algorithm: str,
               collective: str) -> None:
    """In-place all-reduce over ``axis`` (MAX for ``pmax``, else SUM),
    counted; a size-1 axis issues nothing."""
    if mesh.axis_size(axis) < 2:
        return
    dist.all_reduce(t, op=_OPS.get(collective, dist.ReduceOp.SUM),
                    group=mesh.group(axis))
    key = (algorithm, collective)
    COLLECTIVES[key] = COLLECTIVES.get(key, 0) + 1


def _weigh(out: torch.Tensor, lse: torch.Tensor, mesh: Mesh, axis: str,
           algorithm: str) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Rescale this rank's partial by ``exp(lse - global max)``: the MAX
    all-reduce, then ``num`` and ``den`` written as views of one flat f32
    buffer (returned too), ready for the SUM."""
    m = lse.float().clone()
    all_reduce(m, mesh, axis, algorithm, "pmax")
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    n = out.numel()
    buf = torch.empty(n + lse.numel(), dtype=torch.float32, device=out.device)
    num = buf[:n].view(out.shape)
    den = buf[n:].view(lse.shape)
    torch.exp(lse - m_safe, out=den)
    torch.mul(out, den[..., None], out=num)
    return num, den, m, buf


def _merge_across(out: torch.Tensor, lse: torch.Tensor, mesh: Mesh,
                  axis: str, payload: str, algorithm: str
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The all-reduce form of the merge: MAX, then one SUM over ``num``
    and ``den`` together. Returns the reduced ``(num, den, m)``."""
    num, den, m, buf = _weigh(out, lse, mesh, axis, algorithm)
    if payload == "split":
        all_reduce(buf, mesh, axis, algorithm, "psum")
        return num, den, m
    packed = torch.cat([num, den[..., None]], dim=-1)
    all_reduce(packed, mesh, axis, algorithm, "psum")
    return packed[..., :-1], packed[..., -1], m


def _tree_decode_common(q: torch.Tensor, tk_local: int,
                        local_attn: Callable, *, mesh: Mesh, seq_axis: str,
                        q_position, merge_payload: Optional[str],
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The replicated-Q decode skeleton: this rank's partial by
    ``local_attn(q_position, kv_offset)`` (its keys start at global
    position ``rank * tk_local``), then the merge."""
    payload = resolve_merge_payload(merge_payload)
    B, Hq, Tq, D = q.shape
    n_shards = mesh.axis_size(seq_axis)
    if q_position is None:
        q_position = tk_local * n_shards - Tq
    out, lse = local_attn(q_position,
                          mesh.axis_index(seq_axis) * tk_local)
    # Per-rank wire bytes (context independent): one f32 MAX over the lse
    # rows, one SUM over [num | den] (the same bytes split or packed).
    d_sh, h_sh = shard_counts(mesh, None, None)
    lse_bytes = 4 * -(-B // d_sh) * -(-Hq // h_sh) * Tq
    account_payload("tree_decode", pmax=lse_bytes,
                    psum=4 * -(-B // d_sh) * -(-Hq // h_sh) * Tq * D
                    + lse_bytes)
    num, den, m = _merge_across(out, lse, mesh, seq_axis, payload,
                                "tree_decode")
    return finalize_merge(num, den, m, q.dtype)


def tree_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                mesh: Mesh, seq_axis: str = AXIS_SEQ, causal: bool = False,
                scale: Optional[float] = None, q_position=None,
                impl: str = "auto", merge_payload: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replicated-Q, sequence-sharded-KV exact attention (the decode shape).

    Args:
      q: ``(B, Hq, Tq, D)``, the same on every rank (Tq is typically 1).
      k, v: this rank's shard ``(B, Hkv, Tk/W, D)``; rank ``r`` of ``W``
        holds global key positions ``[r Tk/W, (r+1) Tk/W)``.
      q_position: global position of the first query row for causal
        masking, an int or a per-slot ``(B,)`` tensor; defaults to ``Tk -
        Tq`` (the queries are the newest tokens).
      impl: ``"auto"`` (B1 on the card, its plain version on the CPU) or
        ``"plain"``.
      merge_payload: ``"split"`` / ``"packed"``; None reads
        ``TREE_ATTN_MERGE_PAYLOAD``.

    Returns ``(out, lse)``, identical on every rank.
    """
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    fn = decode_plain if impl == "plain" else attention_cuda_decode

    def local_attn(q_pos, kv_off):
        return fn(q, k, v, causal=causal, scale=scale, q_offset=q_pos,
                  kv_offset=kv_off)

    return _tree_decode_common(q, k.shape[2], local_attn, mesh=mesh,
                               seq_axis=seq_axis, q_position=q_position,
                               merge_payload=merge_payload)


def tree_decode_q8(q: torch.Tensor, k_q: torch.Tensor, v_q: torch.Tensor,
                   k_scale: torch.Tensor, v_scale: torch.Tensor, *,
                   mesh: Mesh, seq_axis: str = AXIS_SEQ, causal: bool = False,
                   scale: Optional[float] = None, q_position=None,
                   kernel: str = "q8q", impl: str = "auto",
                   merge_payload: Optional[str] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`tree_decode` over int8 K/V: ``k_q``/``v_q`` are this rank's
    int8 shard, ``k_scale``/``v_scale`` ``(B, Hkv, 1, D)`` the channel
    scales of the WHOLE sequence (the same on every rank: a scale is per
    channel, so a sequence shard does not change it). Each rank runs the
    q8 route ``kernel`` names — ``"q8q"``: B4 (int8 x int8 scores),
    ``"q8"``: B1 over the int8 K/V — whose lse is of the dequantized
    logits, so the partials merge exactly as the exact path's do."""
    fn = resolve_q8_kernel(kernel, plain=impl == "plain")

    def local_attn(q_pos, kv_off):
        return fn(q, k_q, v_q, k_scale, v_scale, causal=causal, scale=scale,
                  q_offset=q_pos, kv_offset=kv_off)

    return _tree_decode_common(q, k_q.shape[2], local_attn, mesh=mesh,
                               seq_axis=seq_axis, q_position=q_position,
                               merge_payload=merge_payload)


def local_table(table: torch.Tensor, mesh: Mesh, n_local: int, fill: int,
                seq_axis: str = AXIS_SEQ) -> torch.Tensor:
    """Global block ids -> this rank's local ids (int64); an id another
    rank holds becomes ``fill``: -1 for the signed table B2's
    ``local_blocks`` reads, or the rank's drop block ``n_local`` for a
    scatter that must write only the rows this rank holds."""
    loc = table.long() - mesh.axis_index(seq_axis) * n_local
    return torch.where((loc >= 0) & (loc < n_local), loc, fill)


def paged_tree_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      block_table: torch.Tensor, *, mesh: Mesh,
                      q_position, seq_axis: str = AXIS_SEQ,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None,
                      scale: Optional[float] = None, impl: str = "auto"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tree decode over a sequence-sharded paged pool.

    Args:
      q: ``(B, Hq, Tq, D)``, the same on every rank.
      k, v: this rank's pool slice ``(N/W, Hkv, block, D)``: rank ``r``
        holds GLOBAL block ids ``[r N/W, (r+1) N/W)``, the rule
        ``ShardedBlockAllocator`` hands ids out by.
      block_table: ``(B, NB)`` int32 of GLOBAL block ids, the same on every
        rank. Each rank rebases it to local ids, ``-1`` for a block outside
        its range, so each logical block's keys count on exactly one rank.
      q_position: per-slot ``(B,)`` first-query positions.
      k_scale, v_scale: optional ``(N/W, Hkv)`` per-block scales of an
        int8 slice (sharded with it).

    This rank's partial is :func:`~tree_attention_tpu_torch.ops.decode
    .paged_local_partial` (B2 with ``local_blocks``); the merge is one MAX
    over the lse rows, then one SUM over the weighted numerator and one
    over the denominator — 3 collectives, accounted as ``pmax`` /
    ``psum_num`` / ``psum_den`` under ``paged_tree_decode``.

    Returns ``(out, lse)``, identical on every rank.
    """
    if getattr(q_position, "ndim", 0) != 1:
        raise ValueError("paged_tree_decode needs a per-slot (B,) "
                         "q_position")
    loc = local_table(block_table, mesh, k.shape[0], -1,
                      seq_axis).to(torch.int32)
    out, lse = paged_local_partial(q, k, v, loc, q_position=q_position,
                                   scale=scale, k_scale=k_scale,
                                   v_scale=v_scale,
                                   shards=mesh.axis_size(seq_axis),
                                   impl=impl)
    B, Hq, Tq, D = q.shape
    d_sh, h_sh = shard_counts(mesh, None, None)
    lse_bytes = 4 * -(-B // d_sh) * -(-Hq // h_sh) * Tq
    account_payload("paged_tree_decode", pmax=lse_bytes,
                    psum_num=4 * -(-B // d_sh) * -(-Hq // h_sh) * Tq * D,
                    psum_den=lse_bytes)
    num, den, m, _ = _weigh(out, lse, mesh, seq_axis, "paged_tree_decode")
    all_reduce(num, mesh, seq_axis, "paged_tree_decode", "psum_num")
    all_reduce(den, mesh, seq_axis, "paged_tree_decode", "psum_den")
    return finalize_merge(num, den, m, q.dtype)
