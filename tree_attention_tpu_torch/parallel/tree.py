"""Sequence-parallel tree attention: the merge across ranks.

Counterpart of ``tree_attention_tpu/parallel/tree.py``.
Each rank holds a shard of the KV sequence, computes flash attention over
it with the CUDA kernels (their plain versions on the CPU), emits
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
- :func:`tree_attention` — the training shape: Q, K and V all sharded over
  the sequence. Per Q chunk, an all-gather of Q, this rank's partial of
  every gathered run against its local KV (B3, or nothing where the run
  cannot see the keys), 1 MAX over the lse rows, and the merge as a
  reduce-scatter, so each rank keeps its own rows. Differentiable: the
  gather's backward is a reduce-scatter and the reduce-scatter's an
  all-gather (B6/B7 run with the lse cotangent the merge weights give).
  :func:`zigzag_perm` / :func:`shard_zigzag` / :func:`unshard_zigzag`
  give the causally balanced layout.

Every collective issued is counted in :data:`COLLECTIVES` (always on; the
bytes go to :mod:`.accounting` when the metrics registry is on).

Collectives by backend: NCCL runs ``all_gather_into_tensor`` and
``reduce_scatter_tensor``. Gloo runs both as an f32 SUM all-reduce (the
gather over a zero buffer holding this rank's rows, exact; the
reduce-scatter keeping this rank's slice of the sum), the one collective
gloo is relied on for with CUDA tensors — two ranks sharing one card run
gloo. That path moves W times the bytes of the native ones; it is counted,
and accounted, as the one collective it stands for.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tree_attention_tpu_torch.ops import flash_attention
from tree_attention_tpu_torch.ops.cuda_decode import (
    attention_cuda_decode,
    decode_plain,
    resolve_q8_kernel,
)
from tree_attention_tpu_torch.ops.decode import paged_local_partial
from tree_attention_tpu_torch.ops.reference import (
    empty_result,
    finalize_merge,
    merge_partials,
)
from tree_attention_tpu_torch.parallel.accounting import (
    account_payload,
    shard_counts,
)
from tree_attention_tpu_torch.parallel.mesh import AXIS_SEQ, Mesh

# Collectives issued, by (algorithm, collective): "pmax" is a MAX
# all-reduce, "psum"/"psum_num"/"psum_den" SUM all-reduces, "all_gather"
# and "psum_scatter" tree_attention's gather and reduce-scatter (in the
# forward, and as each other's backward) — the labels of the payload
# accounting.
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


SEQ_LAYOUTS = ("contiguous", "zigzag")


def zigzag_perm(t: int, n_shards: int) -> Tuple[np.ndarray, np.ndarray]:
    """Natural -> zigzag sequence permutation for causally balanced
    sharding: shard ``j`` holds the half-blocks ``j`` and ``2N-1-j``, so
    every shard's causal work is the same. Returns ``(perm, inv)`` numpy
    index vectors: ``zigzag = natural[perm]`` and ``natural =
    zigzag[inv]``. Requires ``t % (2 n_shards) == 0``."""
    if t % (2 * n_shards):
        raise ValueError(
            f"sequence length {t} must divide into 2×{n_shards} half-blocks"
        )
    half = t // (2 * n_shards)
    blocks = []
    for j in range(n_shards):
        blocks.append(np.arange(j * half, (j + 1) * half))
        blocks.append(np.arange((2 * n_shards - 1 - j) * half,
                                (2 * n_shards - j) * half))
    perm = np.concatenate(blocks)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(t)
    return perm, inv


def shard_zigzag(x: torch.Tensor, axis: int, n_shards: int) -> torch.Tensor:
    """Reorder ``axis`` from natural to zigzag order: sharding it
    contiguously afterwards gives each rank its two half-blocks."""
    perm, _ = zigzag_perm(x.shape[axis], n_shards)
    return x.index_select(axis, torch.from_numpy(perm).to(x.device))


def unshard_zigzag(x: torch.Tensor, axis: int, n_shards: int
                   ) -> torch.Tensor:
    """Inverse of :func:`shard_zigzag`: zigzag order back to natural."""
    _, inv = zigzag_perm(x.shape[axis], n_shards)
    return x.index_select(axis, torch.from_numpy(inv).to(x.device))


def local_positions(t: int, mesh: Mesh, layout: str,
                    seq_axis: str = AXIS_SEQ) -> np.ndarray:
    """The natural positions of the ``t / W`` rows of a length-``t``
    sequence this rank holds under ``layout``, in its order (int64)."""
    if layout not in SEQ_LAYOUTS:
        raise ValueError(f"layout must be one of {SEQ_LAYOUTS}, got "
                         f"{layout!r}")
    n = mesh.axis_size(seq_axis)
    if t % n:
        raise ValueError(f"sequence length {t} must divide over {n} "
                         f"'{seq_axis}' shards")
    order = zigzag_perm(t, n)[0] if layout == "zigzag" else np.arange(t)
    r, m = mesh.axis_index(seq_axis), t // n
    return order[r * m:(r + 1) * m].astype(np.int64)


def partial_key_groups(t: int, n_shards: int, layout: str,
                       causal: bool = True) -> List[torch.Tensor]:
    """The partials :func:`tree_attention` casts to the output dtype, as
    key groups: for each cast of a partial's output (and so of its
    cotangent), a ``(t,)`` int64 tensor naming the partial each key of a
    length-``t`` key sequence lands in. Contiguous: the key's rank.
    Zigzag (causal): its rank (the merged local pair), then its half-block
    (the two local blocks, merged by ``merge_partials`` first)."""
    perm = zigzag_perm(t, n_shards)[0] if layout == "zigzag" else \
        np.arange(t)
    owner = np.empty(t, np.int64)
    owner[perm] = np.arange(t) // (t // n_shards)
    groups = [torch.from_numpy(owner)]
    if layout == "zigzag" and causal:
        groups.append(torch.from_numpy(np.arange(t) // (t // (2 * n_shards))))
    return groups


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str, algorithm: str,
               collective: str) -> None:
    """In-place all-reduce over ``axis`` (MAX for ``pmax``, else SUM),
    counted; a size-1 axis issues nothing."""
    if mesh.axis_size(axis) < 2:
        return
    dist.all_reduce(t, op=_OPS.get(collective, dist.ReduceOp.SUM),
                    group=mesh.group(axis))
    _count(algorithm, collective)


def _count(algorithm: str, collective: str) -> None:
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


# -- tree_attention: the training shape ------------------------------------

def _native_collectives(mesh: Mesh, axis: str) -> bool:
    """NCCL runs the native gather and reduce-scatter; gloo the all-reduce
    form (module docstring)."""
    return dist.get_backend(mesh.group(axis)) == "nccl"


def gather_rows(x: torch.Tensor, mesh: Mesh, axis: str, algorithm: str,
                native: Optional[bool] = None) -> torch.Tensor:
    """All-gather ``x`` over ``axis``: ``(W, *x.shape)``, rank ``r``'s
    tensor at index ``r``; counted as ``all_gather`` (a size-1 axis issues
    nothing). ``native`` None picks by backend."""
    n = mesh.axis_size(axis)
    if n < 2:
        return x[None]
    group = mesh.group(axis)
    if native is None:
        native = _native_collectives(mesh, axis)
    if native:
        out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous().view(-1),
                                    group=group)
        out = out.view(n, *x.shape)
    else:
        buf = torch.zeros((n, *x.shape), dtype=torch.float32,
                          device=x.device)
        buf[mesh.axis_index(axis)] = x
        dist.all_reduce(buf, group=group)
        out = buf.to(x.dtype)
    _count(algorithm, "all_gather")
    return out


def scatter_rows(x: torch.Tensor, mesh: Mesh, axis: str, algorithm: str,
                 native: Optional[bool] = None) -> torch.Tensor:
    """Reduce-scatter ``x`` ``(W, ...)`` over ``axis``: the SUM over ranks
    of ``x[r]`` on rank ``r``; counted as ``psum_scatter`` (a size-1 axis
    issues nothing). ``native`` None picks by backend."""
    n = mesh.axis_size(axis)
    if n < 2:
        return x[0]
    group = mesh.group(axis)
    if native is None:
        native = _native_collectives(mesh, axis)
    if native:
        out = torch.empty(x[0].numel(), dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x.contiguous().view(-1), group=group)
        out = out.view(x.shape[1:])
    else:
        buf = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        buf.copy_(x)
        dist.all_reduce(buf, group=group)
        out = buf[mesh.axis_index(axis)].to(x.dtype)
    _count(algorithm, "psum_scatter")
    return out


class GatherRows(torch.autograd.Function):
    """:func:`gather_rows` whose backward is :func:`scatter_rows`."""

    @staticmethod
    def forward(ctx, x, mesh, axis, algorithm):
        ctx.args = (mesh, axis, algorithm)
        return gather_rows(x, mesh, axis, algorithm)

    @staticmethod
    def backward(ctx, g):
        return scatter_rows(g, *ctx.args), None, None, None


class ScatterRows(torch.autograd.Function):
    """:func:`scatter_rows` whose backward is :func:`gather_rows`."""

    @staticmethod
    def forward(ctx, x, mesh, axis, algorithm):
        ctx.args = (mesh, axis, algorithm)
        return scatter_rows(x, mesh, axis, algorithm)

    @staticmethod
    def backward(ctx, g):
        return gather_rows(g, *ctx.args), None, None, None


def _rank_major(x: torch.Tensor, n: int) -> torch.Tensor:
    """``(B, H, n*c, ...)`` rows grouped by source rank -> ``(n, B, H, c,
    ...)``."""
    B, H, rows = x.shape[:3]
    return x.reshape(B, H, n, rows // n, *x.shape[3:]).movedim(2, 0)


def _weigh_rows(out: torch.Tensor, lse: torch.Tensor, mesh: Mesh, axis: str,
                algorithm: str
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Differentiable counterpart of :func:`_weigh` (autograd refuses its
    ``out=`` writes): ``(num, den, m)`` with ``m`` the MAX over ranks of
    the detached lse rows (the merged softmax does not depend on the
    shift, so no gradient flows through it)."""
    m = lse.detach().float().clone()
    all_reduce(m, mesh, axis, algorithm, "pmax")
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    w = torch.exp(lse - m_safe)
    return out.float() * w[..., None], w, m


def _scatter_merge(num: torch.Tensor, den: torch.Tensor, mesh: Mesh,
                   axis: str, payload: str, algorithm: str
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduce-scatter the merge payload so each rank keeps its own rows,
    in one collective: ``"split"`` lays ``num`` and ``den`` out rank-major
    in one flat buffer (each rank's share ``[num rows | den rows]``);
    ``"packed"`` reduces ``[num | den]`` of width ``D + 1``."""
    n = mesh.axis_size(axis)
    B, H, rows, D = num.shape
    c = rows // n
    if payload == "split":
        flat = torch.cat([_rank_major(num, n).reshape(n, -1),
                          _rank_major(den, n).reshape(n, -1)], dim=1)
        mine = ScatterRows.apply(flat, mesh, axis, algorithm)
        return (mine[:B * H * c * D].view(B, H, c, D),
                mine[B * H * c * D:].view(B, H, c))
    packed = torch.cat([num, den[..., None]], dim=-1)
    mine = ScatterRows.apply(_rank_major(packed, n), mesh, axis, algorithm)
    return mine[..., :D], mine[..., D]


def segment_relation(q_off: int, n_rows: int, h: int, seg_len: int) -> str:
    """How a run of ``n_rows`` queries at global positions ``[q_off, q_off
    + n_rows)`` sees KV block ``h`` (keys ``[h seg_len, (h+1) seg_len)``)
    under causality: ``"full"`` (its first row sees the block's last key),
    ``"masked"`` (its last row precedes the block's first key) or
    ``"diagonal"``."""
    hi_full = (q_off - seg_len + 1) // seg_len
    lo_mask = (q_off + n_rows - 1) // seg_len + 1
    if h <= hi_full:
        return "full"
    if h >= lo_mask:
        return "masked"
    return "diagonal"


def _segment_attend(q_blk: torch.Tensor, k_seg: torch.Tensor,
                    v_seg: torch.Tensor, h: int, *, q_off: int, seg_len: int,
                    scale: Optional[float], impl: str
                    ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """One gathered Q run against one local KV block, by
    :func:`segment_relation`: ``causal=False`` for ``"full"``, ``causal``
    with the run's and the block's global offsets for ``"diagonal"``, and
    None — no launch; the monoid's identity — for ``"masked"``."""
    kind = segment_relation(q_off, q_blk.shape[2], h, seg_len)
    if kind == "masked":
        return None
    if kind == "full":
        return flash_attention(q_blk, k_seg, v_seg, causal=False,
                               scale=scale, impl=impl)
    return flash_attention(q_blk, k_seg, v_seg, causal=True, scale=scale,
                           q_offset=q_off, kv_offset=h * seg_len, impl=impl)


def gather_chunk(q_chunk: Optional[int], *, batch: int, heads: int,
                 head_dim: int, itemsize: int, n_shards: int,
                 tq_local: int) -> int:
    """Local Q rows gathered at once (the JAX package's policy): as given,
    else ``TREE_ATTN_GATHER_BUDGET`` bytes (default 256 MiB) of gathered Q
    plus its f32 numerator, at least ``tq_local / TREE_ATTN_MAX_CHUNKS``
    (default 16) rows, rounded down to a multiple of 128 where both
    allow; at most ``tq_local``."""
    if q_chunk is None:
        budget = int(os.environ.get("TREE_ATTN_GATHER_BUDGET", 1 << 28))
        per_row = batch * heads * head_dim * (itemsize + 8)
        q_chunk = max(budget // max(per_row * n_shards, 1), 1)
        cap_floor = -(-tq_local // int(
            os.environ.get("TREE_ATTN_MAX_CHUNKS", 16)))
        q_chunk = max(q_chunk, cap_floor)
        aligned = (q_chunk // 128) * 128
        if tq_local > q_chunk and aligned >= cap_floor and aligned >= 128:
            q_chunk = aligned
    if q_chunk < 1:
        raise ValueError(f"q_chunk must be >= 1, got {q_chunk}")
    return min(q_chunk, tq_local)


def tree_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   mesh: Mesh, seq_axis: str = AXIS_SEQ,
                   data_axis: Optional[str] = None,
                   head_axis: Optional[str] = None, causal: bool = False,
                   scale: Optional[float] = None,
                   q_position: Optional[int] = None, impl: str = "auto",
                   layout: str = "contiguous", q_chunk: Optional[int] = None,
                   merge_payload: Optional[str] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fully sequence-sharded exact attention (the training shape).

    Args:
      q: this rank's shard ``(B, Hq, Tq/W, D)``; k, v: ``(B, Hkv, Tk/W,
        D)``. Under ``layout="contiguous"`` rank ``r`` holds rows ``[r T/W,
        (r+1) T/W)``; under ``"zigzag"`` its shard of the arrays permuted
        by :func:`shard_zigzag` (half-blocks ``r`` and ``2W-1-r``), and the
        output comes back in that order.
      q_position: global position of the first query row; defaults to
        ``Tk - Tq`` (bottom-right alignment: 0 when Tq == Tk).
      impl: passed to :func:`~tree_attention_tpu_torch.ops
        .flash_attention` (``"auto"``: B3, and under grad B6/B7; runs
        below 128 rows B1 and the blockwise backward).
      q_chunk: local Q rows gathered at once (:func:`gather_chunk`).
      merge_payload: ``"split"`` / ``"packed"``; None reads
        ``TREE_ATTN_MERGE_PAYLOAD``.

    Per chunk: an all-gather of Q, then each gathered run — one per source
    rank, two (its half-blocks) under zigzag, each with its natural global
    offset — against each local KV block by :func:`segment_relation` (a
    plain ``if``: the shard index is a Python int), the two zigzag blocks'
    partials merged by :func:`~tree_attention_tpu_torch.ops.reference
    .merge_partials`; then 1 MAX over the lse rows and the
    reduce-scatter of the weighted ``(num, den)``. Non-causal: one call
    over the whole gathered chunk. Only ``data_axis=None`` and
    ``head_axis=None`` are accepted (the mesh shards ``seq`` alone).

    Returns ``(out, lse)``: this rank's rows, sharded like ``q``.
    """
    if layout not in SEQ_LAYOUTS:
        raise ValueError(f"layout must be 'contiguous' or 'zigzag', got "
                         f"{layout!r}")
    if data_axis is not None or head_axis is not None:
        raise NotImplementedError(
            "tree_attention shards the seq axis only: data_axis and "
            "head_axis must be None (the mesh's data and model axes are a "
            "later item of the port, ROADMAP queue A)")
    payload = resolve_merge_payload(merge_payload)
    B, Hq, tq_local, D = q.shape
    tk_local = k.shape[2]
    n = mesh.axis_size(seq_axis)
    shard = mesh.axis_index(seq_axis)
    if q_position is None:
        q_position = (tk_local - tq_local) * n
    if layout == "zigzag" and (tq_local % 2 or tk_local % 2):
        raise ValueError(f"zigzag needs even local lengths, got "
                         f"q={tq_local}, k={tk_local}")
    half_q, half_k = tq_local // 2, tk_local // 2
    chunk = gather_chunk(q_chunk, batch=B, heads=Hq, head_dim=D,
                         itemsize=q.element_size(), n_shards=n,
                         tq_local=tq_local)

    def run_offsets(j: int, lo: int, hi: int) -> List[Tuple[int, int, int]]:
        """``(local start, rows, natural global offset)`` runs covering
        local rows ``[lo, hi)`` of source rank ``j``: one run, or under
        zigzag one per half-block."""
        if layout == "contiguous":
            return [(lo, hi - lo, q_position + j * tq_local + lo)]
        runs = []
        if lo < half_q:
            end = min(hi, half_q)
            runs.append((lo, end - lo, q_position + j * half_q + lo))
        if hi > half_q:
            start = max(lo, half_q)
            runs.append((start, hi - start,
                         q_position + (2 * n - 1 - j) * half_q
                         + start - half_q))
        return runs

    # Local KV blocks: (k, v, global block index, block length).
    if layout == "contiguous" or not causal:
        segments = [(k, v, shard, tk_local)]
    else:
        segments = [(k[:, :, :half_k], v[:, :, :half_k], shard, half_k),
                    (k[:, :, half_k:], v[:, :, half_k:], 2 * n - 1 - shard,
                     half_k)]

    outs_m, lses_m = [], []
    for lo in range(0, tq_local, chunk):
        hi = min(tq_local, lo + chunk)
        cm = hi - lo
        q_g = GatherRows.apply(q[:, :, lo:hi], mesh, seq_axis,
                               "tree_attention")     # (W, B, Hq, cm, D)
        if not causal:
            out, lse = flash_attention(
                q_g.movedim(0, 2).reshape(B, Hq, n * cm, D), k, v,
                causal=False, scale=scale, impl=impl)
        else:
            outs, lses = [], []
            for j in range(n):
                for rlo, rlen, q_off in run_offsets(j, lo, hi):
                    q_blk = q_g[j][:, :, rlo - lo:rlo - lo + rlen]
                    parts = [p for p in (
                        _segment_attend(q_blk, k_s, v_s, h, q_off=q_off,
                                        seg_len=len_s, scale=scale,
                                        impl=impl)
                        for k_s, v_s, h, len_s in segments) if p is not None]
                    if not parts:
                        o, l = empty_result(q_blk)
                    elif len(parts) == 1:
                        o, l = parts[0]
                    else:
                        o, l = merge_partials(
                            torch.stack([p[0] for p in parts]),
                            torch.stack([p[1] for p in parts]))
                    outs.append(o)
                    lses.append(l)
            out, lse = torch.cat(outs, dim=2), torch.cat(lses, dim=2)
        num, den, mx = _weigh_rows(out, lse, mesh, seq_axis,
                                   "tree_attention")
        num, den = _scatter_merge(num, den, mesh, seq_axis, payload,
                                  "tree_attention")
        o_m, l_m = finalize_merge(num, den,
                                  mx[:, :, shard * cm:(shard + 1) * cm],
                                  q.dtype)
        outs_m.append(o_m)
        lses_m.append(l_m)
    # Per-rank wire bytes over all chunks (JAX's formulas): the gathered
    # Q, the f32 MAX over the gathered lse rows, the [num | den]
    # reduce-scatter (the same bytes split or packed).
    d_sh, h_sh = shard_counts(mesh, data_axis, head_axis)
    rows = -(-B // d_sh) * -(-Hq // h_sh) * tq_local * n
    account_payload("tree_attention", all_gather=rows * D * q.element_size(),
                    pmax=4 * rows, psum_scatter=4 * rows * (D + 1))
    if len(outs_m) == 1:
        return outs_m[0], lses_m[0]
    return torch.cat(outs_m, dim=2), torch.cat(lses_m, dim=2)
