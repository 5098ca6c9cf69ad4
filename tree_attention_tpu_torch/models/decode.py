"""Autoregressive decoding: KV caches, the mixed-Tq step, sampling, generate.

Counterpart of ``tree_attention_tpu/models/decode.py``:

- :class:`KVCache` — per-layer buffers ``(L, B, Hkv, Tmax, D)`` plus a
  per-slot length vector ``(B,)``.
- :class:`PagedKVCache` — one block pool under every slot plus per-slot
  block tables (PagedAttention, arXiv:2309.06180).
- :class:`QuantKVCache` / :class:`PagedQuantKVCache` — their int8
  counterparts: frozen per-channel scales per slot, or one scale per pool
  block and head (:func:`quantize_cache`, :func:`quantize_paged_blocks`).
- :func:`forward_step` — ``Tq`` new tokens per slot against the cache: slot
  ``i``'s rows land at ``[length[i], length[i] + n_tokens[i])`` and its
  queries attend causally from ``length[i]``. Mixed-Tq ``n_tokens`` lets
  decode slots (one token) and prefill chunks share one step; ``positions``
  and ``tree_mask`` make it the verify step of speculative tree decoding.
- :func:`compact_decode_window` — the device half of a tree-draft commit.
- :func:`sample_rows` / :func:`sample_slots` — per-row sampling, each draw
  keyed by the request's key and the token's stream index
  (:func:`fold_in`).

Unlike the JAX package (immutable arrays), the cache buffers are updated IN
PLACE: a step writes its new rows into the cache tensors it was given and
returns a cache object with the advanced lengths over the same buffers.

Under a mesh with ``kv_shard="seq"`` a paged pool is sequence-SHARDED: rank
``r`` of ``W`` holds global block ids ``[r N/W, (r+1) N/W)`` (plus its own
drop block), the block tables stay global and the same on every rank, and
attention runs the tree merge (``parallel/tree.py:paged_tree_decode``).
Each rank writes only the rows whose blocks it holds.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from tree_attention_tpu_torch import obs
from tree_attention_tpu_torch.models.transformer import (
    Params,
    TransformerConfig,
    _mlp_block,
    heads,
    layer,
    rms_norm,
    rope,
    unheads,
)
from tree_attention_tpu_torch.ops.cuda_decode import (
    quantize_symmetric_int8,
    resolve_q8_kernel,
)
from tree_attention_tpu_torch.ops.decode import flash_decode
from tree_attention_tpu_torch.parallel.accounting import account_payload
from tree_attention_tpu_torch.parallel.mesh import AXIS_SEQ, Mesh
from tree_attention_tpu_torch.parallel.tree import (
    all_reduce,
    local_table,
    paged_tree_decode,
    tree_decode,
    tree_decode_q8,
)
from tree_attention_tpu_torch.utils import resolve_device

_CACHE_CAPACITY = obs.gauge(
    "kv_cache_capacity_tokens",
    "capacity of the most recently allocated KV cache (tokens)",
)
_STEP_DISPATCH = obs.counter(
    "forward_step_dispatch_total",
    "forward_step calls by cache kind",
    labels=("cache",),
)
_CACHE_QUANTIZE = obs.counter(
    "kv_cache_quantize_total",
    "whole-cache int8 quantizations (quantize-after-prefill)",
)


@dataclasses.dataclass
class KVCache:
    """Per-layer KV buffers ``(L, B, Hkv, Tmax, D)`` and per-slot lengths."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor  # (B,) int32 — tokens written so far, per slot

    @property
    def capacity(self) -> int:
        return self.k.shape[3]


@dataclasses.dataclass
class PagedKVCache:
    """Paged KV: one block pool, per-slot block tables.

    ``k``/``v`` are ``(L, N + 1, Hkv, block, D)``: pool blocks ``[0, N)``
    plus one DROP block at index ``N`` that absorbs the writes of invalid
    rows (pad rows past a slot's ``n_tokens``, rows past its logical
    capacity) — the JAX scatter drops them with ``mode="drop"``; here they
    land where no table entry ever points. ``table[i, j]`` names the pool
    block holding slot ``i``'s tokens ``[j*block, (j+1)*block)``; unwritten
    entries stay at a valid index (0) and sit past the slot's length, where
    the causal mask hides them and the kernel never reads them.

    On a sequence-sharded pool the buffers are this rank's slice, ``(L,
    N/W + 1, Hkv, block, D)`` with the rank's drop block at ``N/W``, and
    :attr:`blocks` counts the slice; ``table`` holds GLOBAL ids.
    """

    k: torch.Tensor      # (L, N + 1, Hkv, block, D)
    v: torch.Tensor
    table: torch.Tensor  # (B, NB) int32
    length: torch.Tensor  # (B,) int32

    @property
    def blocks(self) -> int:
        return self.k.shape[1] - 1

    @property
    def block(self) -> int:
        return self.k.shape[3]

    @property
    def capacity(self) -> int:
        return self.table.shape[1] * self.block

    def pool(self, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layer ``i``'s ``(N, Hkv, block, D)`` K and V pools."""
        n = self.blocks
        return self.k[i, :n], self.v[i, :n]


@dataclasses.dataclass
class QuantKVCache(KVCache):
    """int8 per-layer KV buffers with frozen per-channel scales.

    The quantize-after-prefill shape: a prompt is prefilled in the model
    dtype, :func:`quantize_cache` converts the filled rows once (scales =
    per-channel absmax of the prefix), and later decode steps append rows
    quantized under those frozen scales (outliers clamp to +-127). Halves
    the KV bytes a decode step streams.
    """

    # (L, B, Hkv, 1, D) float32 each
    k_scale: torch.Tensor = dataclasses.field(kw_only=True)
    v_scale: torch.Tensor = dataclasses.field(kw_only=True)


@dataclasses.dataclass
class PagedQuantKVCache(PagedKVCache):
    """int8 paged KV: int8 block pools plus one scale per POOL block.

    ``k``/``v`` are ``(L, N + 1, Hkv, block, D)`` int8 (with the drop block
    at ``N``), ``k_scale``/``v_scale`` ``(L, N + 1, Hkv)`` float32 — a
    block carries what dequantizes it. A prompt block's scale is the absmax
    of its rows when the prompt is quantized (:func:`quantize_paged_blocks`);
    rows appended later quantize under the slot's **anchor** scale — the
    scale of the block holding the slot's last row before the write — which
    every block the write enters (its first row) inherits. So all rows of a
    block share the block's scale, and the per-block scalar commutes out of
    the score product (what B5 relies on).
    """

    # (L, N + 1, Hkv) float32 each
    k_scale: torch.Tensor = dataclasses.field(kw_only=True)
    v_scale: torch.Tensor = dataclasses.field(kw_only=True)

    def scales(self, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layer ``i``'s ``(N, Hkv)`` K and V block scales."""
        n = self.blocks
        return self.k_scale[i, :n], self.v_scale[i, :n]


AnyCache = Union[KVCache, PagedKVCache]


def init_cache(cfg: TransformerConfig, batch_size: int, max_len: int, *,
               device: Union[str, torch.device] = "cuda",
               quantize: bool = False) -> KVCache:
    """An empty contiguous cache; with ``quantize`` an int8
    :class:`QuantKVCache` with unit scales (what :func:`quantize_cache`
    gives an empty cache)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch_size, cfg.n_kv_heads, max_len, cfg.d_head)
    if obs.REGISTRY.enabled:
        _CACHE_CAPACITY.set(max_len)
    dtype = torch.int8 if quantize else cfg.dtype
    kw = dict(
        k=torch.zeros(shape, dtype=dtype, device=dev),
        v=torch.zeros(shape, dtype=dtype, device=dev),
        length=torch.zeros((batch_size,), dtype=torch.int32, device=dev),
    )
    if not quantize:
        return KVCache(**kw)
    sshape = shape[:3] + (1, shape[4])
    return QuantKVCache(
        **kw,
        k_scale=torch.ones(sshape, dtype=torch.float32, device=dev),
        v_scale=torch.ones(sshape, dtype=torch.float32, device=dev),
    )


def _seq_shards(mesh: Optional[Mesh], kv_shard: str) -> int:
    """The pool's shard count: the mesh's ``seq`` size under
    ``kv_shard="seq"``, else 1 (a replicated pool)."""
    if kv_shard not in ("replicated", "seq"):
        raise ValueError(
            f"kv_shard must be 'replicated' or 'seq', got {kv_shard!r}")
    if kv_shard == "seq" and mesh is not None:
        return mesh.axis_size(AXIS_SEQ)
    return 1


def init_paged_cache(cfg: TransformerConfig, batch_size: int, max_len: int,
                     blocks: int, *, block: int = 64,
                     device: Union[str, torch.device] = "cuda",
                     quantize: bool = False, mesh: Optional[Mesh] = None,
                     kv_shard: str = "replicated") -> PagedKVCache:
    """An empty paged cache: a ``blocks``-block pool (plus the drop block)
    and all-zero tables of ``ceil(max_len / block)`` entries per slot; with
    ``quantize`` int8 pools and unit per-block scales
    (:class:`PagedQuantKVCache`), so a paged and a contiguous int8 server
    start alike.

    ``kv_shard="seq"`` under ``mesh``: this rank's slice of a pool
    sequence-sharded over the ``seq`` axis — ``blocks/W`` rows (``blocks``
    must divide; callers round up) plus the rank's drop block; per-block
    int8 scales are sharded with it. ``"replicated"``: the whole pool."""
    if block < 1 or block & (block - 1):
        raise ValueError(f"kv block must be a power of two, got {block}")
    if blocks < 1:
        raise ValueError(f"paged pool needs >= 1 block, got {blocks}")
    n_sh = _seq_shards(mesh, kv_shard)
    if blocks % n_sh:
        raise ValueError(
            f"kv_shard='seq': pool of {blocks} blocks must divide over "
            f"{n_sh} '{AXIS_SEQ}' shards — round the pool up")
    dev = resolve_device(device)
    nb = -(-max_len // block)
    shape = (cfg.n_layers, blocks // n_sh + 1, cfg.n_kv_heads, block,
             cfg.d_head)
    if obs.REGISTRY.enabled:
        _CACHE_CAPACITY.set(nb * block)
    dtype = torch.int8 if quantize else cfg.dtype
    kw = dict(
        k=torch.zeros(shape, dtype=dtype, device=dev),
        v=torch.zeros(shape, dtype=dtype, device=dev),
        table=torch.zeros((batch_size, nb), dtype=torch.int32, device=dev),
        length=torch.zeros((batch_size,), dtype=torch.int32, device=dev),
    )
    if not quantize:
        return PagedKVCache(**kw)
    return PagedQuantKVCache(
        **kw,
        k_scale=torch.ones(shape[:3], dtype=torch.float32, device=dev),
        v_scale=torch.ones(shape[:3], dtype=torch.float32, device=dev),
    )


def quantize_cache(cache: KVCache) -> QuantKVCache:
    """Per-channel int8 quantization of a (typically just-prefilled) cache,
    scales over the token axis. Unwritten capacity rows are zeros and do not
    shrink a scale; a channel that is zero over the whole prefix takes the
    contract's scale of 1.0 (:func:`quantize_symmetric_int8`), so rows
    appended later quantize as ``round(x)``."""
    _CACHE_QUANTIZE.inc()
    k_q, k_s = quantize_symmetric_int8(cache.k, 3)
    v_q, v_s = quantize_symmetric_int8(cache.v, 3)
    return QuantKVCache(k=k_q, v=v_q, length=cache.length, k_scale=k_s,
                        v_scale=v_s)


def _quantize_rows(rows: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize new ``(B, Hkv, Tq, D)`` rows under a frozen scale (divided,
    as the TPU path does, so both give the same bytes)."""
    return torch.clamp(torch.round(rows.float() / scale), -127, 127).to(
        torch.int8)


def quantize_paged_blocks(k: torch.Tensor, v: torch.Tensor, block: int
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    """Per-BLOCK int8 quantization of a just-prefilled B=1 cache.

    ``k``/``v`` are ``(L, 1, Hkv, T, D)`` exact rows; the caller zeroes the
    rows past the prompt, so the absmax ignores them. ``T`` pads up to
    whole ``block``-token spans; span ``j``'s scale is the absmax over its
    rows and all channels (1.0 for a zero span). Returns ``(k_q, v_q,
    k_scale, v_scale)``: int8 rows shaped like the inputs and scales
    ``(L, nb, Hkv)``."""
    L, _, Hkv, T, D = k.shape
    nb = -(-T // block)

    def one(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        xf = F.pad(x.float()[:, 0], (0, 0, 0, nb * block - T))
        q, scale = quantize_symmetric_int8(
            xf.reshape(L, Hkv, nb, block * D), 3)  # one scale per span
        q = q.reshape(L, Hkv, nb * block, D)[:, :, :T]
        return q[:, None], scale[..., 0].transpose(1, 2).contiguous()

    k_q, k_s = one(k)
    v_q, v_s = one(v)
    return k_q, v_q, k_s, v_s


def gather_kv_blocks(pool_k: torch.Tensor, pool_v: torch.Tensor,
                     ids: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, ...]:
    """Stack paged pool blocks ``ids`` for one read: ``(nb, L, Hkv, block,
    D)`` K and V rows, plus ``(nb, L, Hkv)`` per-block scale scalars for an
    int8 pool. ``pool_k``/``pool_v`` are a :class:`PagedKVCache`'s ``(L, N
    + 1, Hkv, block, D)`` buffers; padded ``ids`` clip into ``[0, N)`` (the
    drop block is never read) and the caller ignores their rows. Returns
    copies."""
    idx = ids.to(pool_k.device).long().clamp(0, pool_k.shape[1] - 2)
    out = [pool_k[:, idx].transpose(0, 1), pool_v[:, idx].transpose(0, 1)]
    if k_scale is not None:
        out += [k_scale[:, idx].transpose(0, 1),
                v_scale[:, idx].transpose(0, 1)]
    return tuple(t.contiguous() for t in out)


def scatter_kv_blocks(pool_k: torch.Tensor, pool_v: torch.Tensor,
                      ids: torch.Tensor, k_rows: torch.Tensor,
                      v_rows: torch.Tensor,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None,
                      ks_rows: Optional[torch.Tensor] = None,
                      vs_rows: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, ...]:
    """The inverse of :func:`gather_kv_blocks`, in place: ``(nb, L, Hkv,
    block, D)`` rows land in pool blocks ``ids`` (entries ``>= N`` go to the
    drop block, as the JAX scatter drops them); an int8 pool also takes its
    ``(nb, L, Hkv)`` per-block scalars. Returns the pool tensors (and the
    scale tensors when given)."""
    n = pool_k.shape[1] - 1
    idx = ids.to(pool_k.device).long().clamp(0, n)
    pool_k[:, idx] = k_rows.transpose(0, 1).to(pool_k.dtype)
    pool_v[:, idx] = v_rows.transpose(0, 1).to(pool_v.dtype)
    if k_scale is None:
        return pool_k, pool_v
    k_scale[:, idx] = ks_rows.transpose(0, 1).to(k_scale.dtype)
    v_scale[:, idx] = vs_rows.transpose(0, 1).to(v_scale.dtype)
    return pool_k, pool_v, k_scale, v_scale


def insert_dequant_prefix(staging: KVCache, pool_k: torch.Tensor,
                          pool_v: torch.Tensor, k_scale: torch.Tensor,
                          v_scale: torch.Tensor, ids: torch.Tensor,
                          matched: int) -> KVCache:
    """Dequantize matched int8 pool blocks into the B=1 staging cache, in
    place: the int8 paged prefix hit. The slot reads the matched int8
    blocks through its table, but the suffix's exact staged prefill needs
    the prefix as activations: ``matched`` tokens (``int8 x block scale``,
    in f32, cast to the staging dtype) land at positions ``[0, matched)``
    of staging slot 0 and its length becomes ``matched``. ``ids`` ``(nb,)``
    name the matched blocks in prompt order (padding repeats a valid id;
    rows at ``>= matched`` keep their old values); ``nb * block`` must fit
    the staging capacity. ``pool_k``/``pool_v`` ``(L, N + 1, Hkv, block,
    D)`` int8 and ``k_scale``/``v_scale`` ``(L, N + 1, Hkv)``, as a
    :class:`PagedQuantKVCache` holds them."""
    nb, blk = ids.shape[0], pool_k.shape[3]
    span = nb * blk
    idx = ids.to(pool_k.device).long().clamp(0, pool_k.shape[1] - 2)
    valid = (torch.arange(span, device=pool_k.device)
             < matched)[None, None, :, None]
    for buf, pool, scale in ((staging.k, pool_k, k_scale),
                             (staging.v, pool_v, v_scale)):
        rows = pool[:, idx].float() * scale[:, idx][..., None, None]
        L, _, Hkv, _, D = rows.shape  # (L, nb, Hkv, block, D)
        rows = rows.transpose(1, 2).reshape(L, Hkv, span, D)
        buf[:, 0, :, :span] = torch.where(valid, rows.to(buf.dtype),
                                          buf[:, 0, :, :span])
    staging.length.fill_(matched)
    return staging


def insert_prefix_blocks(cache: KVCache, pool_k: torch.Tensor,
                         pool_v: torch.Tensor, ids: torch.Tensor,
                         matched: int, slot: int) -> KVCache:
    """Copy ``matched`` tokens of pooled prefix KV into one cache slot, in
    place: the contiguous prefix-cache hit. ``pool_k``/``pool_v`` are ``(P
    + 1, L, Hkv, block, D)`` block pools (row ``P`` the drop row),
    ``ids`` ``(nb,)`` the pool rows holding the matched prefix in prompt
    order (padding may repeat a valid id: rows at ``>= matched`` are
    masked off), and the copy lands at token positions ``[0, matched)`` of
    slot ``slot``, whose ``length`` becomes ``matched``. Bytes at ``>= nb *
    block`` are untouched and those in ``[matched, nb * block)`` keep their
    values; ``nb * block`` must not exceed the capacity."""
    nb, blk = ids.shape[0], pool_k.shape[3]
    span = nb * blk
    idx = ids.to(pool_k.device).long()
    valid = (torch.arange(span, device=pool_k.device)
             < matched)[None, None, :, None]
    for buf, pool in ((cache.k, pool_k), (cache.v, pool_v)):
        rows = pool[idx]                       # (nb, L, Hkv, block, D)
        _, L, Hkv, _, D = rows.shape
        rows = rows.permute(1, 2, 0, 3, 4).reshape(L, Hkv, span, D)
        buf[:, slot, :, :span] = torch.where(valid, rows.to(buf.dtype),
                                             buf[:, slot, :, :span])
    cache.length[slot] = matched
    return cache


def extract_prefix_blocks(pool_k: torch.Tensor, pool_v: torch.Tensor,
                          cache_k: torch.Tensor, cache_v: torch.Tensor,
                          slot: int, ids: torch.Tensor, start_block: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Publish one slot's prefix KV into pool rows, in place: the inverse
    of :func:`insert_prefix_blocks`. Token rows ``[start_block * block,
    (start_block + nb) * block)`` of slot ``slot`` land in pool rows
    ``ids`` (prompt order). Padded ``ids`` name the drop row ``P`` (or
    beyond) and change nothing of ``[0, P)``; source positions past the
    capacity clamp to its last row and pair only with such ids. Returns
    ``(pool_k, pool_v)``."""
    nb, blk = ids.shape[0], pool_k.shape[3]
    drop = pool_k.shape[0] - 1
    idx = ids.to(pool_k.device).long().clamp(0, drop)
    cap = cache_k.shape[3]
    pos = (start_block * blk
           + torch.arange(nb * blk, device=pool_k.device)).clamp(max=cap - 1)
    for pool, buf in ((pool_k, cache_k), (pool_v, cache_v)):
        rows = buf[:, slot][:, :, pos]          # (L, Hkv, nb * block, D)
        L, Hkv, _, D = rows.shape
        pool[idx] = rows.reshape(L, Hkv, nb, blk, D).permute(
            2, 0, 1, 3, 4).to(pool.dtype)
    return pool_k, pool_v


def paged_insert_slot(cache: Union[PagedKVCache, PagedQuantKVCache],
                      slot: int, k_rows: torch.Tensor, v_rows: torch.Tensor,
                      plen: int, k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None, *,
                      lo: int = 0, mesh: Optional[Mesh] = None,
                      kv_shard: str = "replicated"
                      ) -> Union[PagedKVCache, PagedQuantKVCache]:
    """Place a B=1 prefilled prompt into one slot's mapped blocks, in place.

    ``k_rows``/``v_rows`` are ``(L, 1, Hkv, T, D)``: exact rows for a
    :class:`PagedKVCache` (whole-prompt admission), int8 rows for a
    :class:`PagedQuantKVCache`, whose per-block scales ``k_scale`` /
    ``v_scale`` ``(L, nb, Hkv)`` come along. Token positions ``[lo, plen)``
    scatter through the slot's table row; every other row goes to the drop
    block, which no table entry names, so the many pad rows writing it are
    harmless. The scales of the blocks from ``lo // block`` that hold a
    prompt row land in the pool's scale arrays through the same row, and
    the slot's length becomes ``plen``. ``lo`` is the int8 prefix hit's
    block-aligned matched length: the matched blocks are shared
    (tree-owned, with their own scales) and are never rewritten. The
    caller maps blocks covering ``[0, plen)`` first. On a
    sequence-sharded pool (``kv_shard="seq"`` under ``mesh``) the row is
    rebased to this rank's ids, and rows and scales of blocks another rank
    holds go to the drop block."""
    quant = isinstance(cache, PagedQuantKVCache)
    if quant != (k_scale is not None):
        raise ValueError("an int8 pool takes its block scales; an exact "
                         "pool takes none")
    L, _, Hkv, T, D = k_rows.shape
    N, blk = cache.blocks, cache.block
    row = cache.table[slot].long()
    if _seq_shards(mesh, kv_shard) > 1:
        row = local_table(row, mesh, N, N)
    NB = row.shape[0]
    dev = row.device
    pos = torch.arange(T, device=dev)
    ok = (pos >= lo) & (pos < plen) & (pos < NB * blk)
    pb = torch.where(ok, row[(pos // blk).clamp(max=NB - 1)], N)
    off = pos % blk
    for pool, rows in ((cache.k, k_rows), (cache.v, v_rows)):
        pool[:, pb, :, off] = rows[:, 0].permute(2, 0, 1, 3).to(pool.dtype)
    if quant:
        nbk = k_scale.shape[1]
        idx = torch.arange(nbk, device=dev)
        ok = (idx >= lo // blk) & (idx * blk < plen) & (idx < NB)
        pb_s = torch.where(ok, row[idx.clamp(max=NB - 1)], N)
        cache.k_scale[:, pb_s] = k_scale
        cache.v_scale[:, pb_s] = v_scale
    cache.length[slot] = plen
    return cache


def _paged_pool_write(pool: torch.Tensor, rows: torch.Tensor,
                      table: torch.Tensor, start: torch.Tensor,
                      n: torch.Tensor) -> None:
    """Scatter each slot's new rows through its block table, in place.

    ``pool`` is one layer's ``(N + 1, Hkv, block, D)`` buffer, ``rows``
    ``(B, Hkv, Tq, D)``, ``start``/``n`` ``(B,)``. Token ``j`` of slot ``i``
    (valid iff ``j < n[i]`` and inside the slot's logical capacity) lands at
    block ``table[i, (start[i] + j) // block]``, row ``(start[i] + j) %
    block``; invalid rows go to the drop block ``N``. Distinct slots never
    share a writable block, so valid writes never collide."""
    N = pool.shape[0] - 1
    blk = pool.shape[2]
    B, Hkv, Tq, D = rows.shape
    NB = table.shape[1]
    j = torch.arange(Tq, device=rows.device)
    pos = start.long()[:, None] + j[None, :]
    pb = table.long().gather(1, (pos // blk).clamp(0, NB - 1))
    valid = (j[None, :] < n.long()[:, None]) & (pos < NB * blk)
    pb = torch.where(valid, pb, N)
    pool[pb.reshape(-1), :, (pos % blk).reshape(-1)] = (
        rows.transpose(1, 2).reshape(B * Tq, Hkv, D).to(pool.dtype)
    )


def _masked_window_write(buf: torch.Tensor, rows: torch.Tensor,
                         start: torch.Tensor, n: torch.Tensor) -> None:
    """Write ``rows[b, :, :n[b]]`` into ``buf[b]`` at token positions
    ``[start[b], start[b] + n[b])``, in place, leaving every other byte.

    ``buf`` is one layer's ``(B, Hkv, Tmax, D)``, ``rows`` ``(B, Hkv, Tq,
    D)``. The Tq-row window is read at an offset clamped to ``Tmax - Tq``
    (a decode slot near capacity riding a chunk-sized Tq), the valid rows
    are placed at their true positions inside it, and it is written back."""
    B, _, cap, _ = buf.shape
    Tq = rows.shape[2]
    dev = rows.device
    start = start.long()
    ws = start.clamp(0, cap - Tq)
    j = torch.arange(Tq, device=dev)
    src = j[None, :] - (start - ws)[:, None]          # (B, Tq) row index
    keep = (src >= 0) & (src < n.long()[:, None])
    pos = ws[:, None] + j[None, :]
    b = torch.arange(B, device=dev)[:, None]
    window = buf[b, :, pos]                            # (B, Tq, Hkv, D)
    new = rows.transpose(1, 2)[b, src.clamp(0, Tq - 1)]
    buf[b, :, pos] = torch.where(keep[..., None, None], new.to(buf.dtype),
                                 window)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     q_position, block_table: Optional[torch.Tensor] = None,
                     impl: str = "auto",
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     quant_kernel: str = "q8q",
                     mesh: Optional[Mesh] = None,
                     kv_shard: str = "replicated",
                     tree_mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Op-level decode entry: split-KV flash decode over a contiguous
    buffer or, with ``block_table``, a paged pool; the tree merge across
    ranks on a sequence-sharded cache. Passing ``k_scale``/``v_scale``
    (with int8 ``k``/``v``) selects the q8 routes, ``quant_kernel`` which:
    ``"q8q"`` (B4/B5) or ``"q8"`` (the cast route over B1/B2).

    Under a mesh whose ``seq`` axis is larger than 1: a paged pool with
    ``kv_shard="seq"`` (``k``/``v`` this rank's slice, the table global)
    goes to :func:`paged_tree_decode` — B2 with ``local_blocks``, int8
    slices through B2's cast route whatever ``quant_kernel`` says, as the
    JAX package's sharded int8 pool does; a contiguous buffer (``k``/``v``
    this rank's token shard) goes to :func:`tree_decode` /
    :func:`tree_decode_q8`. A replicated paged pool ignores the mesh.

    ``tree_mask`` ``(B, Tq, Tq)`` (speculative tree verification; see
    :func:`~tree_attention_tpu_torch.ops.decode.flash_decode`) rides every
    single-device route, exact and q8; the tree merges have no window-mask
    plumbing and raise."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    sharded = mesh is not None and mesh.axis_size(AXIS_SEQ) > 1
    if tree_mask is not None and sharded and (
            block_table is None or kv_shard == "seq"):
        raise ValueError(
            "tree_mask is not supported on the sequence-sharded tree-decode "
            "path; use chain drafts or the replicated pool")
    if block_table is not None and sharded and kv_shard == "seq":
        return paged_tree_decode(q, k, v, block_table, mesh=mesh,
                                 q_position=q_position, k_scale=k_scale,
                                 v_scale=v_scale, impl=impl)
    if block_table is None and sharded:
        if k_scale is not None:
            return tree_decode_q8(q, k, v, k_scale, v_scale, mesh=mesh,
                                  causal=True, q_position=q_position,
                                  kernel=quant_kernel, impl=impl)
        return tree_decode(q, k, v, mesh=mesh, causal=True,
                           q_position=q_position, impl=impl)
    if k_scale is not None:
        fn = resolve_q8_kernel(quant_kernel, plain=impl == "plain")
        return fn(q, k, v, k_scale, v_scale, causal=True,
                  q_offset=q_position, block_table=block_table,
                  tree_mask=tree_mask)
    return flash_decode(q, k, v, q_position=q_position,
                        block_table=block_table, impl=impl,
                        tree_mask=tree_mask)


def _dequant_view(pool: torch.Tensor, scale: torch.Tensor,
                  table: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The dequantized logical view ``(L, B, Hkv, NB*block, D)`` of int8
    pools ``(L, N + 1, Hkv, block, D)`` and their ``(L, N + 1, Hkv)``
    scales: int8 x per-block scale in f32, cast to ``dtype``."""
    idx = table.long().clamp(0, pool.shape[1] - 2)  # never the drop block
    rows = pool[:, idx].float() * scale[:, idx][..., None, None]
    L, B, NB, Hkv, blk, D = rows.shape
    return rows.transpose(2, 3).reshape(L, B, Hkv, NB * blk, D).to(dtype)


@torch.no_grad()
def forward_step(params: Params, tokens: torch.Tensor, cache: AnyCache,
                 cfg: TransformerConfig, *,
                 n_tokens: Optional[torch.Tensor] = None,
                 quant_kernel: str = "q8q",
                 mesh: Optional[Mesh] = None,
                 kv_shard: str = "replicated",
                 positions: Optional[torch.Tensor] = None,
                 tree_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, AnyCache]:
    """Run ``Tq`` new tokens per slot through the model against the cache.

    ``tokens`` ``(B, Tq)``: row ``i`` occupies positions ``[length[i],
    length[i] + Tq)`` of its own slot. ``n_tokens`` (``(B,)``, optional) is
    the mixed-Tq step: slot ``i`` consumes only its first ``n_tokens[i]``
    rows (0 = inert: nothing written, length frozen); logits rows at
    ``>= n_tokens[i]`` are pad the caller ignores. Callers keep
    ``length + n_tokens <= capacity`` (and ``Tq <= capacity`` for the
    contiguous layout).

    Int8 caches quantize the new rows before writing them: under the
    slot's frozen channel scales (:class:`QuantKVCache`), or under the
    slot's anchor block scale, which each block the write enters inherits
    (:class:`PagedQuantKVCache`). Attention then runs the q8 route
    ``quant_kernel`` names (``"q8q"``: B4/B5; ``"q8"``: the cast route),
    except for a paged int8 cache on the CPU, which attends — as the JAX
    package does off the TPU — over the dequantized logical view through
    the exact path, with the step's new rows mirrored into it as they were
    quantized.

    ``kv_shard="seq"`` (a paged cache under a mesh whose ``seq`` axis is
    larger than 1) declares the cache this rank's slice of a
    sequence-sharded pool (:func:`init_paged_cache`): each rank writes the
    rows whose blocks it holds and attention is the tree merge
    (:func:`decode_attention`). On an int8 slice the anchor scales, which
    live on the rank holding the anchor block, reach the other ranks by one
    SUM all-reduce per step (every rank contributes the anchors it holds,
    zeros elsewhere) — the gather the JAX package leaves to GSPMD.

    ``positions`` ``(B, Tq)`` (optional) are the rows' RoPE positions — the
    speculative tree-verification shape (SpecInfer, arXiv:2305.09781), where
    packed draft node ``j`` of slot ``i`` sits at ``length[i] + depth[j]``.
    KV rows still land at buffer positions ``[length[i], length[i] + Tq)``
    in ROW order, and the paged int8 write's blocks and anchor scale follow
    those buffer positions. ``tree_mask`` ``(B, Tq, Tq)`` bool (``Tq <=
    32``): row ``j`` of slot ``i`` attends its committed history plus the
    window rows ``tree_mask[i, j]`` flags (its draft-tree ancestors and
    itself) instead of the causal window; a lower-triangular mask is the
    causal rule. Not supported on a sequence-sharded cache.

    Returns ``logits`` ``(B, Tq, vocab)`` float32 and the cache with
    ``length`` advanced (same buffers, written in place).
    """
    B, Tq = tokens.shape
    start = cache.length
    paged = isinstance(cache, PagedKVCache)
    quant = isinstance(cache, (QuantKVCache, PagedQuantKVCache))
    if kv_shard == "seq" and not paged:
        raise ValueError("kv_shard='seq' shards the paged block pool; a "
                         "contiguous cache has no block axis to shard")
    seq_sharded = paged and _seq_shards(mesh, kv_shard) > 1
    if seq_sharded and tree_mask is not None:
        raise ValueError(
            "tree_mask is not supported under kv_shard='seq' (the tree "
            "merge has no window-mask plumbing); use chain drafts or the "
            "replicated pool")
    if not paged and Tq > cache.capacity:
        raise ValueError(
            f"step of Tq={Tq} exceeds cache capacity {cache.capacity}"
        )
    if obs.REGISTRY.enabled:
        kind = (("paged_quant" if quant else "paged") if paged
                else ("quant" if quant else "exact"))
        _STEP_DISPATCH.labels(cache=kind).inc()
    dev = tokens.device
    n_valid = (torch.full((B,), Tq, dtype=torch.int32, device=dev)
               if n_tokens is None else n_tokens)
    # Buffer positions of the new rows (row order): the writes, and the
    # paged int8 write's blocks and scales, follow these; RoPE takes
    # ``positions`` where a tree step gives them.
    buf_pos = start.long()[:, None] + torch.arange(Tq, device=dev)
    rope_pos = buf_pos if positions is None else positions.long()
    # The CPU's dequantized view is a replicated materialisation of the
    # pool: a sharded slice keeps the block-table path.
    view = paged and quant and dev.type == "cpu" and not seq_sharded
    write_table = cache.table if paged else None
    if seq_sharded:
        write_table = local_table(cache.table, mesh, cache.blocks,
                                  cache.blocks)
    if paged and quant:
        blk, NB, N = cache.block, cache.table.shape[1], cache.blocks
        n_all = N * (mesh.axis_size(AXIS_SEQ) if seq_sharded else 1)
        table = cache.table.long()
        # The anchor: the block holding each slot's last row before the
        # write (its first block for an empty slot), a global id.
        anchor = table.gather(
            1, torch.div(start.long() - 1, blk, rounding_mode="floor")
            .clamp(0, NB - 1)[:, None])[:, 0].clamp(0, n_all - 1)
        entered = ((torch.arange(Tq, device=dev)[None, :]
                    < n_valid.long()[:, None])
                   & (buf_pos % blk == 0) & (buf_pos < NB * blk))
        scale_tgt = torch.where(
            entered, write_table.long().gather(
                1, (buf_pos // blk).clamp(0, NB - 1)), N
        ).reshape(-1)  # invalid rows land on the drop block's scale
        if seq_sharded:
            # (2, L, B, Hkv): every layer's anchor scales, from the rank
            # that holds each anchor block.
            loc = local_table(anchor, mesh, N, N)
            held = (loc < N)[None, None, :, None]
            anchors = torch.stack([cache.k_scale[:, loc.clamp(max=N - 1)],
                                   cache.v_scale[:, loc.clamp(max=N - 1)]])
            anchors = torch.where(held, anchors, 0.0)
            account_payload("paged_anchor_scales",
                            psum=anchors.numel() * 4)
            all_reduce(anchors, mesh, AXIS_SEQ, "paged_anchor_scales",
                        "psum")
        if view:
            k_view = _dequant_view(cache.k, cache.k_scale, cache.table,
                                   cfg.dtype)
            v_view = _dequant_view(cache.v, cache.v_scale, cache.table,
                                   cfg.dtype)
    x = params["embed"][tokens.long()]
    for i in range(cfg.n_layers):
        p = layer(params, i)
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q = rope(heads(h @ p["wq"], cfg.n_heads, cfg.d_head), rope_pos,
                 cfg.rope_theta)
        k_new = rope(heads(h @ p["wk"], cfg.n_kv_heads, cfg.d_head),
                     rope_pos, cfg.rope_theta)
        v_new = heads(h @ p["wv"], cfg.n_kv_heads, cfg.d_head)
        scales = {}
        if paged and quant:
            ks, vs = cache.k_scale[i], cache.v_scale[i]
            if seq_sharded:
                k_anchor = anchors[0, i][:, :, None, None]  # (B, Hkv, 1, 1)
                v_anchor = anchors[1, i][:, :, None, None]
            else:
                k_anchor = ks[anchor][:, :, None, None]
                v_anchor = vs[anchor][:, :, None, None]
            k_new = _quantize_rows(k_new, k_anchor)
            v_new = _quantize_rows(v_new, v_anchor)
            Hkv = ks.shape[1]
            ks[scale_tgt] = k_anchor[:, None, :, 0, 0].expand(
                B, Tq, Hkv).reshape(-1, Hkv)
            vs[scale_tgt] = v_anchor[:, None, :, 0, 0].expand(
                B, Tq, Hkv).reshape(-1, Hkv)
            if view:
                # Mirror what the pool now holds into the view.
                _masked_window_write(
                    k_view[i], (k_new.float() * k_anchor).to(cfg.dtype),
                    start, n_valid)
                _masked_window_write(
                    v_view[i], (v_new.float() * v_anchor).to(cfg.dtype),
                    start, n_valid)
            else:
                k_pool_s, v_pool_s = cache.scales(i)
                scales = dict(k_scale=k_pool_s, v_scale=v_pool_s)
        elif quant:
            k_new = _quantize_rows(k_new, cache.k_scale[i])
            v_new = _quantize_rows(v_new, cache.v_scale[i])
            scales = dict(k_scale=cache.k_scale[i], v_scale=cache.v_scale[i])
        if paged:
            _paged_pool_write(cache.k[i], k_new, write_table, start, n_valid)
            _paged_pool_write(cache.v[i], v_new, write_table, start, n_valid)
        else:
            _masked_window_write(cache.k[i], k_new, start, n_valid)
            _masked_window_write(cache.v[i], v_new, start, n_valid)
        if view:
            out, _ = decode_attention(q, k_view[i], v_view[i],
                                      q_position=start, impl=cfg.attn_impl,
                                      tree_mask=tree_mask)
        elif paged:
            k_pool, v_pool = cache.pool(i)
            out, _ = decode_attention(q, k_pool, v_pool, q_position=start,
                                      block_table=cache.table,
                                      impl=cfg.attn_impl,
                                      quant_kernel=quant_kernel,
                                      mesh=mesh if seq_sharded else None,
                                      kv_shard=kv_shard, tree_mask=tree_mask,
                                      **scales)
        else:
            out, _ = decode_attention(q, cache.k[i], cache.v[i],
                                      q_position=start, impl=cfg.attn_impl,
                                      quant_kernel=quant_kernel,
                                      tree_mask=tree_mask, **scales)
        x = x + unheads(out) @ p["wo"]
        x = x + _mlp_block(p, rms_norm(x, p["ln2"], cfg.norm_eps))
    logits = (rms_norm(x, params["ln_f"], cfg.norm_eps) @ params["wout"]).float()
    return logits, dataclasses.replace(cache, length=start + n_valid)


def compact_decode_window(cache: AnyCache, start: torch.Tensor,
                          src: torch.Tensor, n: torch.Tensor) -> AnyCache:
    """Move each slot's accepted tree rows to the front of its verify
    window, in place (the device half of a tree-draft commit).

    A tree verify step writes its packed draft nodes at buffer positions
    ``[start[i], start[i] + W)`` in row order, and the accepted root path's
    rows lie scattered among them. Token position ``start[i] + j`` takes
    the KV bytes of ``start[i] + src[i, j]`` for ``j < n[i]``; every read
    sees the buffer as it was before the call. ``src`` ``(B, W)``,
    ``start``/``n`` ``(B,)``. Slots with ``n[i] = 0`` are left bit-identical;
    ``length`` is not changed (the engine rolls it back through the next
    step's reset).

    All four layouts: a contiguous buffer permutes inside each slot's
    window, read at an offset clamped to ``capacity - W`` as
    :func:`_masked_window_write` does; a paged pool gathers the moved rows
    through the block table and scatters them back (invalid rows to the
    drop block). Int8 rows move verbatim and no scale changes: a window's
    rows were all quantized under one scale (the slot's frozen channel
    scales, or its anchor block scale, which every block the window entered
    inherited), as in the JAX package. Not for a sequence-sharded pool."""
    dev = cache.k.device
    src = src.to(dev).long()
    start = start.to(dev).long()
    n = n.to(dev).long()
    B, W = src.shape
    loc = torch.arange(W, device=dev)
    if isinstance(cache, PagedKVCache):
        table = cache.table.long()
        N, blk, nb = cache.blocks, cache.block, table.shape[1]
        pos_dst = start[:, None] + loc[None]
        pos_src = start[:, None] + src
        valid = ((loc[None] < n[:, None]) & (pos_dst < nb * blk)
                 & (pos_src < nb * blk))
        pb_src = table.gather(1, (pos_src // blk).clamp(0, nb - 1)).clamp(
            0, N - 1)
        pb_dst = torch.where(
            valid, table.gather(1, (pos_dst // blk).clamp(0, nb - 1)), N)
        sb, so = pb_src.reshape(-1), (pos_src % blk).reshape(-1)
        db, do = pb_dst.reshape(-1), (pos_dst % blk).reshape(-1)
        for pool in (cache.k, cache.v):
            pool[:, db, :, do] = pool[:, sb, :, so]
        return cache
    cap = cache.k.shape[3]
    ws = start.clamp(0, cap - W)
    shift = start - ws  # > 0 only where the window straddles capacity
    rel = loc[None] - shift[:, None]
    src_loc = shift[:, None] + src.gather(1, rel.clamp(0, W - 1))
    idx = torch.where((rel >= 0) & (rel < n[:, None]), src_loc, loc[None])
    pos = ws[:, None] + loc[None]
    b = torch.arange(B, device=dev)[:, None]
    for buf in (cache.k, cache.v):
        window = buf[:, b, :, pos]          # (B, W, L, Hkv, D)
        buf[:, b, :, pos] = window[b, idx.clamp(0, W - 1)]
    return cache


def round_cache_len(total: int, mesh: Optional[Mesh] = None) -> int:
    """Cache capacity for ``total`` tokens, rounded up to the mesh's
    ``seq``-shard multiple (no rounding without a mesh)."""
    shards = mesh.axis_size(AXIS_SEQ) if mesh is not None else 1
    return total + (-total) % max(shards, 1)


_MASK64 = (1 << 64) - 1


def fold_in(key: int, index: int) -> int:
    """The seed of one draw: a pure function of a request's ``key`` and the
    token's stream ``index`` (splitmix64 over both), the counterpart of
    ``jax.random.fold_in(key, index)``. A request's ``j``-th token is drawn
    under ``fold_in(key, j)`` whichever tick, batch or verify row draws it,
    so a speculative serve commits the stream a plain serve samples."""
    x = (int(key) * 0x9E3779B97F4A7C15 + int(index) + 1) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (x ^ (x >> 31)) & 0x7FFF_FFFF_FFFF_FFFF


def sample_rows(logits: torch.Tensor, temperature: np.ndarray,
                top_k: np.ndarray, keys: Sequence[int],
                sample_idx: np.ndarray, active: np.ndarray
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ROW sampling over a verify-shaped ``(S, Tq, V)`` logits bundle:
    exact argmax where a slot's temperature is 0 (token-identical to the
    greedy path), else a temperature / top-k categorical draw seeded by
    ``fold_in(keys[i], sample_idx[i, j])`` — the request's key and the
    stream index of the token the row predicts. The key, not a running
    generator, decides each draw, so a row drawn for a rejected draft leaves
    every later token alone. ``jax.random`` streams are not reproduced:
    sampled parity with the JAX engine is distributional.

    Args:
      logits: ``(S, Tq, V)``.
      temperature, top_k: ``(S,)`` host arrays (0 = greedy / top-k off).
      keys: one request key per slot (used where it samples).
      sample_idx: ``(S, Tq)`` host stream indices.
      active: ``(S, Tq)`` host bool — the rows whose draw is kept.

    Returns ``(tok, logprob)``: ``(S, Tq)`` int32 ids and the float32 model
    log-probabilities of the chosen tokens (unadjusted by temperature).
    """
    lf = logits.float()
    tok = lf.argmax(-1)
    V = lf.shape[-1]
    draws = np.asarray(active, bool) & (np.asarray(temperature)[:, None] > 0)
    gen = None
    for i in np.flatnonzero(draws.any(1)):
        lg = lf[i]
        k = int(top_k[i])
        if k > 0:
            thresh = torch.topk(lg, min(k, V), dim=-1).values[:, -1:]
            lg = lg.masked_fill(lg < thresh, float("-inf"))
        probs = torch.softmax(lg / float(temperature[i]), -1)
        if gen is None:
            gen = torch.Generator(device=lf.device)
        for j in np.flatnonzero(draws[i]):
            gen.manual_seed(fold_in(keys[i], sample_idx[i, j]))
            tok[i, j] = torch.multinomial(probs[j], 1, generator=gen)[0]
    lp = F.log_softmax(lf, -1).gather(-1, tok[..., None])[..., 0]
    return tok.int(), lp


def sample_slots(logits: torch.Tensor, temperature: np.ndarray,
                 top_k: np.ndarray, keys: Sequence[int],
                 sample_idx: np.ndarray, active: np.ndarray
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot sampling for the serving tick: :func:`sample_rows`' one-row
    case. ``logits`` ``(S, V)`` last-row logits, ``sample_idx`` and
    ``active`` ``(S,)``. Returns ``(S,)`` int32 ids and float32
    log-probabilities."""
    tok, lp = sample_rows(logits[:, None], temperature, top_k, keys,
                          np.asarray(sample_idx)[:, None],
                          np.asarray(active, bool)[:, None])
    return tok[:, 0], lp[:, 0]


def _sample(logits: torch.Tensor, temperature: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    if temperature == 0.0:
        return logits.argmax(-1)
    probs = torch.softmax(logits.float() / temperature, -1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(params: Params, prompt: torch.Tensor, max_new_tokens: int,
             cfg: TransformerConfig, *, cache_len: Optional[int] = None,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             quantize_after_prefill: bool = False,
             quant_kernel: str = "q8q") -> torch.Tensor:
    """Prefill ``prompt`` ``(B, Tp)`` then decode ``max_new_tokens``
    (greedy at temperature 0). With ``quantize_after_prefill`` the prefill
    runs exactly, the cache is then int8-quantized (:func:`quantize_cache`)
    and the decode steps run the ``quant_kernel`` q8 route. Returns
    ``(B, max_new_tokens)`` ids."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    B, Tp = prompt.shape
    total = Tp + max_new_tokens
    cache_len = round_cache_len(total) if cache_len is None else cache_len
    if cache_len < total:
        raise ValueError(f"cache_len={cache_len} < prompt+new={total}")
    cache = init_cache(cfg, B, cache_len, device=prompt.device)
    logits, cache = forward_step(params, prompt, cache, cfg)
    if quantize_after_prefill:
        cache = quantize_cache(cache)
    toks: List[torch.Tensor] = [_sample(logits[:, -1], temperature,
                                        generator)]
    for _ in range(max_new_tokens - 1):
        logits, cache = forward_step(params, toks[-1][:, None], cache, cfg,
                                     quant_kernel=quant_kernel)
        toks.append(_sample(logits[:, -1], temperature, generator))
    return torch.stack(toks, 1).int()
