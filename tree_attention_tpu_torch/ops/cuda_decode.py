"""Split-KV flash decode on Hopper: kernels B1 and B2 (exact or int8 K/V),
B4 and B5 (int8 Q x int8 K).

Counterpart of ``tree_attention_tpu/ops/pallas_decode.py``; the kernels are
``csrc/flash_decode.cu``, ``csrc/decode_tiled.cuh`` and
``csrc/decode_tick.cu`` (design notes and the bound there). Same
``(out, lse)`` contract: each KV head's ``G*Tq`` query rows are packed into
one tile, a key at global position ``kv_offset + j`` is visible to packed
row ``r`` iff ``kv_offset + j <= q_offset[b] + r % Tq`` (causal), scores and
lse in f32, P rounded to V's dtype (bf16 for int8 V), output in q's dtype,
empty rows ``(0, -inf)``.

Each wrapper and plain version takes ``tree_mask`` ``(B, Tq, Tq)`` bool
(causal only, ``Tq <= 32``): the tree-window rule of speculative tree
verification (:func:`~.block_utils.tree_window_mask`) replaces the causal
one. The kernels read it as one int32 ancestor bitmask per packed query row
(:func:`tree_bits_rows`), packed on the device by the wrapper.

The int8 routes serve a cache quantized by the one q8 numeric contract,
:func:`quantize_symmetric_int8` (absmax/127 scale, 1.0 for a zero channel,
round half to even, clip to +-127):

- **q8q** (B4 contiguous, B5 paged): K's channel scale and the softmax
  scale fold into Q in f32 (only the softmax scale with per-block scales),
  each packed row is quantized over D, the kernel runs int8 x int8 -> int32
  scores rescaled by the row scale and writes bf16; V's channel scale then
  applies to the bf16 output in f32, rounded to q's dtype.
- **q8** (the cast route over B1/B2): K's channel scale folds into a bf16
  Q, B1/B2 widen the int8 K/V, and V's channel scale applies to the output;
  with per-block ``(N, Hkv)`` scales B2 takes them as ``block_scales``.

Each wrapper runs its kernel for a CUDA tensor and its plain version
(:func:`decode_plain`, :func:`paged_decode_plain`, :func:`decode_q8q_plain`,
:func:`paged_decode_q8q_plain`, :func:`decode_q8_plain`) for a CPU tensor —
nothing else: a build or launch failure raises. ``.launches`` counts the
kernel launches of each kernel wrapper; the cast route counts under B1/B2,
B2's ``local_blocks`` variant (one rank's slice of a sequence-sharded pool)
on ``attention_cuda_decode_paged.local_launches``, and each wrapper's tree
variant on its ``.tree_launches``.

Three bodies compute every launch, chosen by the static rule
:func:`decode_body`. The tick body (``csrc/decode_tick.cu``) takes every
one-row paged launch without a tree mask whose operands are not f32: B2
exact bf16 (with or without ``local_blocks``), B2's int8 cast route (with
or without per-block scales) and B5 (per-block or channel scales) — the
serving decode tick. A thread block cluster of up to 8 CTAs per (slot, KV
head) splits the slot's own visible blocks, the copy engine streams whole
blocks into a shared-memory ring, and the cluster merges its CTAs' states
through distributed shared memory: one launch, no partials in global
memory; counted on the wrapper's ``.tick_launches``. The multi-row body
(``csrc/decode_tiled.cuh``, tensor cores) takes every launch with more
than one packed row per KV head, or a tree mask, whatever its operands but
f32: exact bf16 (B1 on either layout, B2 with or without ``local_blocks``),
the int8 cast route over B1/B2 (with or without per-block scales and
``local_blocks``) and q8q (B4 contiguous, B5 through a block table):
prompt tails, staged int8 admission's chunks, verify ticks, the sharded
pool's chunks. It reads each key once per 64 packed rows; bytes bound it.
Each operand variant has a library of its own
(``csrc/flash_decode_tiled.cu``, ``_cast.cu``, ``_q8q.cu``). The split
body (``csrc/flash_decode.cu``, CUDA cores) takes the rest: one contiguous
packed row without a mask (``--mode decode``: B1, B4, B1's cast route) and
f32. A warp owns 1 packed row (then it reads each key once, and bytes
bound it) or, in f32, 8, and then re-reads the keys for every 8 rows. The
multi-row and split bodies write per-split partials that one merge kernel
combines. Launches of the multi-row body also count on the wrapper's
``.tiled_launches`` and, by Tq, ``.tiled_tq`` (B1, B2, B4, B5); the cast
route's also on B1's or B2's ``.cast_tiled_launches``.
:func:`decode_geometry` sizes each body's grid.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Callable, Optional, Tuple

import torch

from tree_attention_tpu_torch.ops import _build
from tree_attention_tpu_torch.ops.block_utils import (
    TREE_MAX_ROWS,
    Offset,
    check_tree_mask,
    offsets,
)
from tree_attention_tpu_torch.ops.reference import (
    attention_packed,
    default_scale,
    empty_result,
)

# Work items the split body aims for: enough warps in flight to cover HBM
# latency on 132 SMs even for the B=1 reference workload.
_TARGET_WARPS = 4096
# CTAs the multi-row body aims for: 4 per SM on 132 SMs (each streams its
# split's keys once for up to 64 packed rows).
_TARGET_CTAS = 528
# Fewest keys a split streams (below this the merge costs more than it buys).
_MIN_SPLIT_KEYS = 64
# CTAs the tick body aims for: two per SM on 132 SMs, as many as its
# largest ring (bf16 at D 128: 3 stages of 32 KB) lets an SM hold.
_TICK_TARGET_CTAS = 264
# What the built library says of itself, checked at load: warps per CTA of
# the split body; keys per tile of the multi-row body (its split lengths
# are multiples); packed rows a multi-row CTA takes (16 a warp).
_SPLIT_WARPS = 4
_TILED_KEYS = 64
_TILED_ROWS = (16, 32, 64)
# ... and of the tick body: keys a ring stage holds (a unit of the split is
# a block, or a piece of a longer block, of at most this many keys), and
# the largest cluster of CTAs a row may take.
_TICK_KEYS = 64
_TICK_MAX_CLUSTER = 8

# The kernels' dtype codes, and the decode kernel's operand variants
# (``csrc/flash_decode.cu``): 0/1 exact, then the two int8 routes.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CAST, _Q8Q = 2, 3
# The multi-row body's library of each operand variant (f32 has none).
_TILED_LIBS = {_DTYPES[torch.bfloat16]: "flash_decode_tiled",
               _CAST: "flash_decode_tiled_cast",
               _Q8Q: "flash_decode_tiled_q8q"}
_lib_fns = None

BlockScales = Tuple[torch.Tensor, torch.Tensor]


def _launchers():
    """``(split, {variant: multi-row}, tick)``: the split body's C entry,
    the multi-row body's of each operand variant and the tick body's,
    after checking what each built library says of itself."""
    global _lib_fns
    if _lib_fns is None:
        _build.build(("flash_decode", *_TILED_LIBS.values(),
                      "decode_tick"))  # in parallel
        lib = _build.library("flash_decode")
        tlibs = {v: (n, _build.library(n)) for v, n in _TILED_LIBS.items()}
        tick_lib = _build.library("decode_tick")
        built = (lib.flash_decode_warps_per_cta(),
                 *(getattr(t, f"{n}_keys")() for n, t in tlibs.values()),
                 tick_lib.decode_tick_keys(),
                 tick_lib.decode_tick_max_cluster())
        want = ((_SPLIT_WARPS,) + (_TILED_KEYS,) * len(tlibs)
                + (_TICK_KEYS, _TICK_MAX_CLUSTER))
        if built != want:
            raise RuntimeError(
                f"the decode libraries were built with (warps per CTA, keys "
                f"per tile of each multi-row library, the tick's keys per "
                f"stage and largest cluster) {built}, ops/cuda_decode.py "
                f"says {want}")
        split = lib.flash_decode_launch
        tiled = {v: getattr(t, f"{n}_launch") for v, (n, t) in tlibs.items()}
        for fn in (split, *tiled.values()):  # one signature: see _launch
            fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 15
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        tick = tick_lib.decode_tick_launch
        tick.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 11
                         + [ctypes.c_float, ctypes.c_void_p])
        tick.restype = ctypes.c_int
        _lib_fns = (split, tiled, tick)
    return _lib_fns


def _rows_per_warp(rows: int, tree: bool = False) -> int:
    """The split body's Q tile: 1 packed row per warp when a KV head has
    one query row (the lean variant), else 8 (f32 only); the tree variant
    is built for 8 only."""
    return 1 if rows == 1 and not tree else 8


def decode_body(variant: int, rows: int, tree: bool = False,
                paged: bool = False) -> str:
    """Which body a launch runs, by a static rule on its operands. Every
    variant but f32 (exact bf16, ``variant`` 1: B1, B2; the int8 cast
    route over B1/B2, 2; q8q, 3: B4 contiguous, B5 through a block table):
    ``"tiled"`` — the multi-row body on the tensor cores — for ``rows`` =
    G*Tq > 1 packed rows per KV head or a tree mask; ``"tick"`` — the
    cluster body — for one packed row without a mask through a block table
    (``paged``: the serving decode tick of B2 and B5). ``"split"`` for
    every other launch: one contiguous packed row without a mask (the
    reference workload: B1, B4) and f32 (the reference pins f32 products
    at HIGHEST: no tensor cores). The ``local_blocks`` flag and per-block
    scales do not enter the rule: the tick and multi-row bodies take them
    (and the split body, for f32 pools, ``local_blocks``), with any block
    size and kv_offset, so no shape a body receives is turned away."""
    if variant == _DTYPES[torch.float32]:
        return "split"
    if rows > 1 or tree:
        return "tiled"
    return "tick" if paged else "split"


@dataclasses.dataclass(frozen=True)
class Geometry:
    """A launch's grid. ``rows``: packed rows of a work item (its Q tile),
    ``q_tiles`` of them per KV head; ``split_len``: the logical keys a split
    covers (the tick body: the keys of a ring stage, its splits following
    each slot's own length, :func:`tick_units`); ``splits``: the partials
    each row gets (merged after; the tick body's inside its cluster);
    ``ctas``: CTAs along the keys (the split body packs ``_SPLIT_WARPS``
    splits, one per warp, into a CTA; the multi-row body one; the tick body
    one cluster of ``ctas`` per row)."""

    body: str
    rows: int
    q_tiles: int
    split_len: int
    splits: int
    ctas: int


def decode_geometry(body: str, R: int, B: int, Hkv: int, Tk: int, *,
                    tree: bool = False, shards: int = 1) -> Geometry:
    """Size the splits of a launch of ``body`` over ``R`` packed rows of
    ``B * Hkv`` KV heads and ``Tk`` logical keys: as many splits as bring
    the work items (Q tiles x B x Hkv x splits) to the body's target, each
    streaming at least ``_MIN_SPLIT_KEYS`` keys. ``shards``: the ranks a
    ``local_blocks`` pool is sharded over. A rank holds about ``Tk /
    shards`` of the keys, and the multi-row body's splits are sized on
    that share: its CTAs skip a tile of remote keys with one barrier. The
    split body's stay sized on the logical length: each of its warps
    checks its range chunk by chunk, so a long split of mostly remote
    chunks serializes the checks that short splits spread over warps
    (``PERF.md`` §6 has both sizings of both bodies on the card).

    The tick body takes one cluster of CTAs per KV head's row: the largest
    of 1, 2, 4, 8 that keeps ``B * Hkv`` clusters within
    ``_TICK_TARGET_CTAS`` (two CTAs per SM) and gives each CTA at least a
    stage of the table's width; each cluster then splits its own slot's
    visible blocks (:func:`tick_units`)."""
    if body == "tick":
        stages = -(-Tk // _TICK_KEYS)
        c = 1
        while (c < _TICK_MAX_CLUSTER and 2 * c * B * Hkv <= _TICK_TARGET_CTAS
               and 2 * c <= stages):
            c *= 2
        return Geometry(body, 1, 1, _TICK_KEYS, c, c)
    held = Tk // max(shards, 1) if body == "tiled" else Tk
    if body == "tiled":
        rows = next((r for r in _TILED_ROWS if R <= r), _TILED_ROWS[-1])
        target, granule = _TARGET_CTAS, _TILED_KEYS
    else:
        rows = _rows_per_warp(R, tree)
        target, granule = _TARGET_WARPS, 8
    q_tiles = -(-R // rows)
    base = q_tiles * B * Hkv
    splits = max(1, min(-(-target // base), held // _MIN_SPLIT_KEYS))
    split_len = max(granule, -(-math.ceil(Tk / splits) // granule) * granule)
    n = -(-Tk // split_len)
    if body == "tiled":
        return Geometry(body, rows, q_tiles, split_len, n, n)
    ctas = -(-n // _SPLIT_WARPS)
    return Geometry(body, rows, q_tiles, split_len, ctas * _SPLIT_WARPS, ctas)


def split_keys(geo: Geometry, split: int, q_offset: int, Tq: int, Tk: int,
               kv_offset: int = 0, causal: bool = True) -> range:
    """The keys split ``split`` of a launch streams for a slot whose first
    query sits at ``q_offset`` and whose keys start at ``kv_offset``: its
    range, culled (``causal``) at the last row's frontier ``q_offset -
    kv_offset + Tq`` — the rule both bodies compute on the card, so no table
    entry past a slot is read and a shard wholly past the frontier reads
    nothing."""
    j0 = split * geo.split_len
    hi = min(Tk, j0 + geo.split_len)
    if causal:
        hi = min(hi, q_offset - kv_offset + Tq)
    return range(j0, max(j0, hi))


def tick_units(geo: Geometry, rank: int, q_offset: int, Tq: int, Tk: int,
               blk: int, kv_offset: int = 0) -> list:
    """The units CTA ``rank`` of a row's cluster streams on the tick body,
    as ``(logical block, first row in it, rows)`` — the kernel's own
    arithmetic: the slot's visible keys ``[0, q_offset - kv_offset + Tq)``
    are cut into units (a block's rows, or ``geo.split_len``-key pieces of
    a longer block), and the ``n`` units split ``[rank * n // C, (rank + 1)
    * n // C)`` over the cluster's ``C = geo.ctas`` CTAs. A unit's rows end
    at the frontier, so no key past it is copied and no table entry past
    it is read; under ``local_blocks`` the kernel drops a unit whose table
    entry is negative before it reads a byte of it."""
    U = min(blk, geo.split_len)
    upb = -(-blk // U)
    j1 = min(Tk, q_offset - kv_offset + Tq)
    n = 0 if j1 <= 0 else (j1 // blk) * upb + -(-(j1 % blk) // U)
    units = []
    for u in range(rank * n // geo.ctas, (rank + 1) * n // geo.ctas):
        nb, piece = divmod(u, upb)
        row0 = piece * U
        units.append((nb, row0, min(U, blk - row0, j1 - nb * blk - row0)))
    return units


def tree_bits_rows(tree_mask: torch.Tensor, n_q_per_kv: int,
                   n_kv_heads: int) -> torch.Tensor:
    """Pack a ``(B, Tq, Tq)`` bool ancestor mask into the operand the decode
    kernels read: ``(B*Hkv, G*Tq)`` int32, bit ``j`` of packed row ``r`` set
    iff query row ``r % Tq`` sees window position ``j``. Bit 31 is the sign
    bit (the kernel shifts the word as unsigned). The counterpart of
    ``pallas_decode.py:_tree_bits_rows`` without its lane broadcast and Q
    tile padding."""
    B, Tq, _ = tree_mask.shape
    weights = torch.ones((), dtype=torch.int64, device=tree_mask.device) \
        << torch.arange(Tq, device=tree_mask.device)
    bits = (tree_mask.long() * weights).sum(2)                  # (B, Tq)
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)
    return bits[:, None, None, :].expand(
        B, n_kv_heads, n_q_per_kv, Tq).reshape(B * n_kv_heads,
                                               n_q_per_kv * Tq)


def _check_tree(q: torch.Tensor, tree_mask: Optional[torch.Tensor],
                causal: bool = True) -> None:
    """A kernel's tree mask: causal, ``Tq <= 32``, ``(B, Tq, Tq)``."""
    if tree_mask is not None:
        check_tree_mask(tree_mask, q.shape[0], q.shape[2], causal,
                        TREE_MAX_ROWS)


# -- the q8 numeric contract -------------------------------------------------

def quantize_symmetric_int8(x: torch.Tensor, dim: int,
                            amax: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The one definition of the q8 numeric contract the kernels dequant
    against: absmax/127 scale over ``dim`` (kept; a zero channel's scale is
    1.0), f32 intermediate, round half to even, clip to +-127, int8. ``dim``
    is the reduction axis — 2 (tokens) for a ``(B, Hkv, T, D)`` buffer, 3
    for a ``(L, B, Hkv, T, D)`` cache or the head dim of packed Q rows.
    Returns ``(codes, scale)``. ``amax`` (keepdim shape) replaces the
    absmax of ``x`` itself, e.g. one taken over every rank's shard.

    The scale is ``absmax * f32(1/127)``: XLA compiles the JAX package's
    division by the constant 127 into that product, and the bytes must
    match."""
    xf = x.float()
    if amax is None:
        amax = xf.abs().amax(dim, keepdim=True)
    scale = torch.where(amax == 0.0, torch.ones_like(amax),
                        amax * (1.0 / 127.0))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_kv_channelwise(k: torch.Tensor, v: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """Per-channel int8 quantization of ``(B, Hkv, T, D)`` K/V: returns
    ``(k_q, v_q, k_scale, v_scale)``, scales ``(B, Hkv, 1, D)`` f32 with
    ``k ~= k_q * k_scale`` — one scale per head-dim lane per KV head, so the
    scales fold into Q and the output instead of riding the KV stream."""
    k_q, k_s = quantize_symmetric_int8(k, 2)
    v_q, v_s = quantize_symmetric_int8(v, 2)
    return k_q, v_q, k_s, v_s


def resolve_q8_kernel(kernel: str, plain: bool = False) -> Callable:
    """The one home of the q8-kernel-name contract: ``"q8q"`` -> the int8 x
    int8 route (B4/B5), ``"q8"`` -> the cast route (B1/B2 over int8 K/V);
    anything else raises. The returned callable takes ``(q, k_q, v_q,
    k_scale, v_scale, *, causal, scale, q_offset, kv_offset, block_table)``
    and runs the kernels, or with ``plain`` their plain versions on any
    device; all of them also take ``tree_mask``."""
    if kernel == "q8q":
        return functools.partial(_q8q_route, plain=plain)
    if kernel == "q8":
        return decode_q8_plain if plain else attention_cuda_decode_q8
    raise ValueError(f"q8 kernel must be 'q8q' or 'q8', got {kernel!r}")


# -- plain versions ----------------------------------------------------------

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


def _key_scales(block_scales: BlockScales, block_table: torch.Tensor,
                blk: int) -> BlockScales:
    """Per-block ``(N, Hkv)`` scalars read through the table for every
    logical key: ``(B, Hkv, NB*blk)`` each."""

    def g(scale: torch.Tensor) -> torch.Tensor:
        idx = block_table.long().clamp(0, scale.shape[0] - 1)
        return scale[idx].transpose(1, 2).repeat_interleave(blk, dim=2)

    return g(block_scales[0]), g(block_scales[1])


def _cast_q(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Q against int8 K/V runs in bf16 (the TPU kernel's cast)."""
    return q.to(torch.bfloat16) if k.dtype == torch.int8 else q


def decode_plain(q, k, v, *, causal: bool = False,
                 scale: Optional[float] = None, q_offset: Offset = 0,
                 kv_offset: Offset = 0,
                 tree_mask: Optional[torch.Tensor] = None):
    """B1's plain version (any device)."""
    out, lse = attention_packed(_cast_q(q, k), k, v, causal=causal,
                                scale=scale, q_offset=q_offset,
                                kv_offset=kv_offset, tree_mask=tree_mask)
    return out.to(q.dtype), lse


def paged_decode_plain(q, k, v, block_table, *, q_offset: Offset,
                       scale: Optional[float] = None,
                       block_scales: Optional[BlockScales] = None,
                       local_blocks: bool = False,
                       tree_mask: Optional[torch.Tensor] = None):
    """B2's plain version (any device): gather the logical view (and the
    per-key scalars of ``block_scales``), then B1's. With ``local_blocks``
    the table is signed: a negative entry is a block another rank holds,
    gathered clamped to row 0 and masked out, so a row with no held
    visible block comes back ``(0, -inf)``."""
    kg, vg = gather_paged_kv(k, v, block_table)
    keys = (None if block_scales is None
            else _key_scales(block_scales, block_table, k.shape[2]))
    held = (block_table >= 0).repeat_interleave(k.shape[2], dim=1) \
        if local_blocks else None
    out, lse = attention_packed(_cast_q(q, k), kg, vg, causal=True,
                                scale=scale, q_offset=q_offset, kv_offset=0,
                                key_scales=keys, key_mask=held,
                                tree_mask=tree_mask)
    return out.to(q.dtype), lse


def _fold_quantize_q(q: torch.Tensor, n_kv_heads: int,
                     k_scale: Optional[torch.Tensor], scale: Optional[float]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q8q's Q: ``q * (k_scale * sm)`` in f32 (``q * sm`` when ``k_scale``
    is None: per-block scales cannot fold), each packed row ``(B, Hkv,
    G*Tq)`` quantized over D. Returns int8 codes ``(B, Hkv, R, D)`` and row
    scales ``(B, Hkv, R, 1)``."""
    B, Hq, Tq, D = q.shape
    sm = default_scale(D, scale)
    qf = q.float().reshape(B, n_kv_heads, (Hq // n_kv_heads) * Tq, D)
    return quantize_symmetric_int8(
        qf * (sm if k_scale is None else k_scale * sm), 3)


def _unfold_out(out: torch.Tensor, lse: torch.Tensor, q: torch.Tensor,
                v_scale: Optional[torch.Tensor]):
    """Packed ``(B, Hkv, R, D)`` bf16 kernel output -> ``(B, Hq, Tq, D)`` in
    q's dtype, V's channel scale applied in f32 first (the double rounding
    the TPU route has)."""
    if v_scale is not None:
        out = out.float().reshape(v_scale.shape[0], v_scale.shape[1], -1,
                                  out.shape[-1]) * v_scale
    return out.reshape(q.shape).to(q.dtype), lse.reshape(q.shape[:3])


def _check_q8(q, k_q, v_q, k_scale, v_scale, block_table) -> bool:
    """Validate a q8 call's operands; returns whether its scales are
    per-block ``(N, Hkv)`` (else per-channel ``(B, Hkv, 1, D)``)."""
    if k_q.dtype != torch.int8 or v_q.dtype != torch.int8:
        raise ValueError(f"k_q/v_q must be int8, got {k_q.dtype}/{v_q.dtype}")
    B, Hq, _, D = q.shape
    Hkv = k_q.shape[1]
    if Hq % Hkv:
        raise ValueError(
            f"query heads ({Hq}) must be a multiple of kv heads ({Hkv})")
    per_block = block_table is not None and k_scale.dim() == 2
    want = (k_q.shape[0], Hkv) if per_block else (B, Hkv, 1, D)
    if tuple(k_scale.shape) != want or tuple(v_scale.shape) != want:
        kind = "per-block" if per_block else "channel"
        raise ValueError(f"{kind} scales must be {want}, got "
                         f"{tuple(k_scale.shape)}/{tuple(v_scale.shape)}")
    return per_block


def decode_q8q_plain(q, k_q, v_q, k_scale, v_scale, *, causal: bool = False,
                     scale: Optional[float] = None, q_offset: Offset = 0,
                     kv_offset: Offset = 0,
                     tree_mask: Optional[torch.Tensor] = None):
    """B4's plain version (any device): the fold and quantize of Q, then
    exact int8 products summed in f32 (exact: |s| <= 128 * 127^2 < 2^24),
    rescaled by each row's Q scale, the f32 softmax, P rounded to bf16, and
    V's channel scale on the bf16 output."""
    _check_q8(q, k_q, v_q, k_scale, v_scale, None)
    if k_q.shape[2] == 0:
        return empty_result(q)
    codes, qs = _fold_quantize_q(q, k_q.shape[1], k_scale, scale)
    out, lse = attention_packed(codes.reshape(q.shape), k_q, v_q,
                                causal=causal, scale=None, q_offset=q_offset,
                                kv_offset=kv_offset, row_scale=qs,
                                tree_mask=tree_mask)
    return _unfold_out(out, lse, q, v_scale)


def paged_decode_q8q_plain(q, k_q, v_q, block_table, k_scale, v_scale, *,
                           q_offset: Offset, scale: Optional[float] = None,
                           tree_mask: Optional[torch.Tensor] = None):
    """B5's plain version (any device): B4's over the gathered view, with
    per-block ``(N, Hkv)`` scales read through the table for each key (K's
    on the score after the row scale, V's on p after the softmax sum) or
    channel ``(B, Hkv, 1, D)`` scales folded as in B4."""
    per_block = _check_q8(q, k_q, v_q, k_scale, v_scale, block_table)
    if block_table.shape[1] == 0:
        return empty_result(q)
    codes, qs = _fold_quantize_q(q, k_q.shape[1],
                                 None if per_block else k_scale, scale)
    kg, vg = gather_paged_kv(k_q, v_q, block_table)
    keys = (_key_scales((k_scale, v_scale), block_table, k_q.shape[2])
            if per_block else None)
    out, lse = attention_packed(codes.reshape(q.shape), kg, vg, causal=True,
                                scale=None, q_offset=q_offset, kv_offset=0,
                                row_scale=qs, key_scales=keys,
                                tree_mask=tree_mask)
    return _unfold_out(out, lse, q, None if per_block else v_scale)


def _q8_cast(q, k_q, v_q, k_scale, v_scale, *, causal, scale, q_offset,
             kv_offset, block_table, b1, b2, tree_mask=None):
    """The cast route over ``b1``/``b2`` (the kernels or their plain
    versions): K's channel scale folds into a bf16 Q and V's applies to the
    output; per-block scales go to ``b2`` as ``block_scales`` with Q
    unfolded."""
    if _check_q8(q, k_q, v_q, k_scale, v_scale, block_table):
        out, lse = b2(q.to(torch.bfloat16), k_q, v_q, block_table,
                      q_offset=q_offset, scale=scale,
                      block_scales=(k_scale, v_scale), tree_mask=tree_mask)
        return out.to(q.dtype), lse
    B, Hq, Tq, D = q.shape
    Hkv = k_q.shape[1]
    qf = (q.float().reshape(B, Hkv, -1, D) * k_scale).to(
        torch.bfloat16).reshape(q.shape)
    if block_table is not None:
        out, lse = b2(qf, k_q, v_q, block_table, q_offset=q_offset,
                      scale=scale, tree_mask=tree_mask)
    else:
        out, lse = b1(qf, k_q, v_q, causal=causal, scale=scale,
                      q_offset=q_offset, kv_offset=kv_offset,
                      tree_mask=tree_mask)
    return _unfold_out(out, lse, q, v_scale)


def decode_q8_plain(q, k_q, v_q, k_scale, v_scale, *, causal: bool = False,
                    scale: Optional[float] = None, q_offset: Offset = 0,
                    kv_offset: Offset = 0,
                    block_table: Optional[torch.Tensor] = None,
                    tree_mask: Optional[torch.Tensor] = None):
    """The cast route's plain version (any device), over
    :func:`decode_plain` / :func:`paged_decode_plain`."""
    return _q8_cast(q, k_q, v_q, k_scale, v_scale, causal=causal,
                    scale=scale, q_offset=q_offset, kv_offset=kv_offset,
                    block_table=block_table, b1=decode_plain,
                    b2=paged_decode_plain, tree_mask=tree_mask)


# -- kernel wrappers ---------------------------------------------------------

def _check(q: torch.Tensor, *others: torch.Tensor) -> None:
    """The kernels' common operand check: CUDA tensors of one dtype (f32
    or bf16) on one device, head dim 64 or 128."""
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {q.dtype} (float32, bfloat16)")
    for t in others:
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k and v must share dtype and device")
    if q.shape[-1] not in (64, 128):
        raise ValueError(f"head dim {q.shape[-1]} unsupported (64, 128)")


def _check_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """:func:`_check` for the decode kernels, which also take int8 K/V (q
    then runs in bf16). Returns the kernel variant."""
    if k.dtype != torch.int8:
        _check(q, k, v)
        return _DTYPES[q.dtype]
    _check(q)
    if v.dtype != torch.int8 or k.device != q.device \
            or v.device != q.device:
        raise ValueError("int8 k and v must both be int8, on q's device")
    return _CAST


def _launch(wrapper, qp, k, v, offs, table, *, variant, Tq, Tk, blk, NB,
            causal, scale, qs=None, block_scales=None, local_blocks=False,
            tree_mask=None, shards=1):
    """Run a body (:func:`decode_body`) and, but for the tick body, its
    merge on packed ``qp`` ``(B, Hkv, R, D)``; returns ``out`` ``(B, Hkv,
    R, D)`` (bf16 for the int8 variants) and ``lse`` ``(B, Hkv, R)``.
    ``local_blocks``: the paged table is signed (negative = a block another
    rank holds), the pool sharded over ``shards`` ranks. ``tree_mask``: the
    tree variant, its bits packed here on the device. A launch of the tick
    body counts on ``wrapper.tick_launches``; of the multi-row body on
    ``wrapper.tiled_launches`` and, by Tq, in ``wrapper.tiled_tq``, the cast
    route's also on ``wrapper.cast_tiled_launches``."""
    split_fn, tiled_fns, tick_fn = _launchers()
    B, Hkv, R, D = qp.shape
    tree = tree_mask is not None
    geo = decode_geometry(decode_body(variant, R, tree, table is not None),
                          R, B, Hkv, Tk, tree=tree, shards=shards)
    bits = (tree_bits_rows(tree_mask.to(qp.device), R // Tq, Hkv)
            .contiguous() if tree else None)
    qp, k, v = qp.contiguous(), k.contiguous(), v.contiguous()
    dev = qp.device
    out = torch.empty((B, Hkv, R, D), device=dev,
                      dtype=qp.dtype if variant in _DTYPES.values()
                      else torch.bfloat16)
    lse = torch.empty((B, Hkv, R), dtype=torch.float32, device=dev)
    if block_scales is not None:
        block_scales = tuple(s.float().contiguous() for s in block_scales)
    if qs is not None:
        qs = qs.contiguous()

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    ks, vs = (None, None) if block_scales is None else block_scales
    stream = torch.cuda.current_stream(dev).cuda_stream
    if geo.body == "tick":
        # One launch: the cluster merges its CTAs' states on chip.
        wrapper.tick_launches += 1
        err = tick_fn(
            qp.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(qs), ptr(ks),
            ptr(vs), offs.data_ptr(), table.data_ptr(), out.data_ptr(),
            lse.data_ptr(), variant, D, B, Hkv, R, Tq, Tk, blk, NB,
            geo.ctas, int(local_blocks), float(scale), stream)
        if err:
            raise RuntimeError(
                f"decode_tick kernel launch failed: CUDA error {err}")
        return out, lse
    o_part = torch.empty((geo.splits, B * Hkv, R, D), dtype=torch.float32,
                         device=dev)
    lse_part = torch.empty((geo.splits, B * Hkv, R), dtype=torch.float32,
                           device=dev)
    if geo.body == "tiled":
        # The multi-row body takes rows a CTA and partials where the split
        # body takes rows a warp and CTAs along the keys.
        fn, rows, ctas = tiled_fns[variant], geo.rows, geo.splits
        wrapper.tiled_launches += 1
        wrapper.tiled_tq[Tq] = wrapper.tiled_tq.get(Tq, 0) + 1
        if variant == _CAST:
            wrapper.cast_tiled_launches += 1
    else:
        fn, rows, ctas = split_fn, geo.rows, geo.ctas
    err = fn(
        qp.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(qs), ptr(ks),
        ptr(vs), offs.data_ptr(), ptr(table), ptr(bits), o_part.data_ptr(),
        lse_part.data_ptr(), out.data_ptr(), lse.data_ptr(), variant, D,
        int(table is not None), rows, B, Hkv, R, Tq, Tk, blk, NB, ctas,
        geo.split_len, int(causal), int(local_blocks), float(scale), stream)
    if err:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error {err}")
    return out, lse


def _pack(q: torch.Tensor, n_kv_heads: int) -> torch.Tensor:
    B, Hq, Tq, D = q.shape
    return q.reshape(B, n_kv_heads, (Hq // n_kv_heads) * Tq, D)


def _count(wrapper, tree_mask) -> None:
    """One launch on the wrapper's count: ``.tree_launches`` for the tree
    variant, ``.launches`` otherwise."""
    if tree_mask is None:
        wrapper.launches += 1
    else:
        wrapper.tree_launches += 1


def attention_cuda_decode(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = False,
                          scale: Optional[float] = None,
                          q_offset: Offset = 0, kv_offset: Offset = 0,
                          tree_mask: Optional[torch.Tensor] = None):
    """B1: ``q`` ``(B, Hq, Tq, D)`` against contiguous ``k``/``v``
    ``(B, Hkv, Tk, D)`` of q's dtype, or int8 (q then runs in bf16);
    offsets scalar or ``(B,)``. Launches with ``tree_mask`` count on
    ``.tree_launches``, the others on ``.launches``; launches of the
    multi-row body (bf16 or int8, more than one packed row or a tree) also
    on ``.tiled_launches`` and, by Tq, in ``.tiled_tq``, and with int8 K/V
    on ``.cast_tiled_launches``."""
    _check_tree(q, tree_mask, causal)
    if q.device.type == "cpu":
        return decode_plain(q, k, v, causal=causal, scale=scale,
                            q_offset=q_offset, kv_offset=kv_offset,
                            tree_mask=tree_mask)
    variant = _check_decode(q, k, v)
    B, Hkv, Tk, D = k.shape
    if Tk == 0:
        return empty_result(q)
    offs = offsets(q_offset, kv_offset, B, q.device).contiguous()
    _count(attention_cuda_decode, tree_mask)
    out, lse = _launch(attention_cuda_decode, _pack(_cast_q(q, k), Hkv), k,
                       v, offs, None, variant=variant, Tq=q.shape[2], Tk=Tk,
                       blk=1, NB=0, causal=causal,
                       scale=default_scale(D, scale), tree_mask=tree_mask)
    return _unfold_out(out, lse, q, None)


attention_cuda_decode.launches = 0
attention_cuda_decode.tree_launches = 0
attention_cuda_decode.tiled_launches = 0
attention_cuda_decode.tiled_tq = {}  # multi-row launches by Tq
attention_cuda_decode.cast_tiled_launches = 0  # ... with int8 K/V


def attention_cuda_decode_paged(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, block_table: torch.Tensor,
                                *, q_offset: Offset,
                                scale: Optional[float] = None,
                                block_scales: Optional[BlockScales] = None,
                                local_blocks: bool = False,
                                local_shards: int = 1,
                                tree_mask: Optional[torch.Tensor] = None):
    """B2: causal decode of ``q`` ``(B, Hq, Tq, D)`` against
    ``(N, Hkv, block, D)`` pools (q's dtype, or int8 with q in bf16) through
    the ``(B, NB)`` int32 table; slot ``b``'s queries sit at
    ``q_offset[b]``. ``block_scales`` ``(k_scale, v_scale)``, each ``(N,
    Hkv)`` f32, dequantize int8 pools per block. The pool blocks that
    table entries past a slot's length name are never read.

    ``local_blocks``: the pools are one rank's slice of a sequence-sharded
    pool and the table is signed — entries in ``[0, N)`` are local blocks,
    a negative entry is a block another rank holds, never read and masked
    out; a row with no local visible key comes back ``(0, -inf)``;
    ``local_shards``, the ranks the pool is sharded over, sizes the
    multi-row body's splits on this rank's share of the keys. Such
    launches count on ``.local_launches``, the tree variant's (``tree_mask``) on
    ``.tree_launches``, the others on ``.launches``; launches of the
    multi-row body (bf16 or int8, more than one packed row or a tree) also
    on ``.tiled_launches`` and, by Tq, in ``.tiled_tq``, and with int8 pools
    on ``.cast_tiled_launches``; of the tick body (bf16 or int8, one packed
    row, no tree: the decode tick) also on ``.tick_launches``."""
    _check_tree(q, tree_mask)
    if local_blocks and tree_mask is not None:
        raise ValueError("tree_mask is not supported under local_blocks "
                         "(the sequence-sharded pool); use chain drafts")
    if q.device.type == "cpu":
        return paged_decode_plain(q, k, v, block_table, q_offset=q_offset,
                                  scale=scale, block_scales=block_scales,
                                  local_blocks=local_blocks,
                                  tree_mask=tree_mask)
    variant = _check_decode(q, k, v)
    if block_table.dtype != torch.int32 or block_table.device != q.device:
        raise ValueError("block_table must be int32 on q's device")
    if block_scales is not None and variant != _CAST:
        raise ValueError("block_scales dequantize int8 pools only")
    B, NB = block_table.shape
    _, Hkv, blk, D = k.shape
    offs = offsets(q_offset, 0, B, q.device).contiguous()
    if local_blocks:
        attention_cuda_decode_paged.local_launches += 1
    else:
        _count(attention_cuda_decode_paged, tree_mask)
    out, lse = _launch(attention_cuda_decode_paged,
                       _pack(_cast_q(q, k), Hkv), k, v, offs,
                       block_table.contiguous(), variant=variant,
                       Tq=q.shape[2], Tk=NB * blk,
                       blk=blk, NB=NB, causal=True,
                       scale=default_scale(D, scale),
                       block_scales=block_scales, local_blocks=local_blocks,
                       tree_mask=tree_mask, shards=local_shards)
    return _unfold_out(out, lse, q, None)


attention_cuda_decode_paged.launches = 0
attention_cuda_decode_paged.local_launches = 0
attention_cuda_decode_paged.tree_launches = 0
attention_cuda_decode_paged.tiled_launches = 0
attention_cuda_decode_paged.tiled_tq = {}  # multi-row launches by Tq
attention_cuda_decode_paged.cast_tiled_launches = 0  # ... with int8 pools
attention_cuda_decode_paged.tick_launches = 0  # one-row ticks, any variant


def attention_cuda_decode_q8q(q: torch.Tensor, k_q: torch.Tensor,
                              v_q: torch.Tensor, k_scale: torch.Tensor,
                              v_scale: torch.Tensor, *, causal: bool = False,
                              scale: Optional[float] = None,
                              q_offset: Offset = 0, kv_offset: Offset = 0,
                              tree_mask: Optional[torch.Tensor] = None):
    """B4: ``q`` ``(B, Hq, Tq, D)`` against contiguous int8 ``k_q``/``v_q``
    ``(B, Hkv, Tk, D)`` with channel scales ``(B, Hkv, 1, D)``; Q folded
    and quantized per packed row, int8 x int8 -> int32 scores. Launches
    count as B1's do (``.launches``, ``.tree_launches``; ``.tiled_launches``
    and ``.tiled_tq`` for the multi-row body, which takes more than one
    packed row or a tree)."""
    _check_tree(q, tree_mask, causal)
    if q.device.type == "cpu":
        return decode_q8q_plain(q, k_q, v_q, k_scale, v_scale, causal=causal,
                                scale=scale, q_offset=q_offset,
                                kv_offset=kv_offset, tree_mask=tree_mask)
    _check_q8(q, k_q, v_q, k_scale, v_scale, None)
    _check_decode(q, k_q, v_q)
    B, Hkv, Tk, _ = k_q.shape
    if Tk == 0:
        return empty_result(q)
    codes, qs = _fold_quantize_q(q, Hkv, k_scale, scale)
    offs = offsets(q_offset, kv_offset, B, q.device).contiguous()
    _count(attention_cuda_decode_q8q, tree_mask)
    out, lse = _launch(attention_cuda_decode_q8q, codes, k_q, v_q, offs,
                       None, variant=_Q8Q,
                       Tq=q.shape[2], Tk=Tk, blk=1, NB=0, causal=causal,
                       scale=1.0, qs=qs, tree_mask=tree_mask)
    return _unfold_out(out, lse, q, v_scale)


attention_cuda_decode_q8q.launches = 0
attention_cuda_decode_q8q.tree_launches = 0
attention_cuda_decode_q8q.tiled_launches = 0
attention_cuda_decode_q8q.tiled_tq = {}  # multi-row launches by Tq


def attention_cuda_decode_paged_q8q(q: torch.Tensor, k_q: torch.Tensor,
                                    v_q: torch.Tensor,
                                    block_table: torch.Tensor,
                                    k_scale: torch.Tensor,
                                    v_scale: torch.Tensor, *,
                                    q_offset: Offset,
                                    scale: Optional[float] = None,
                                    tree_mask: Optional[torch.Tensor] = None):
    """B5: B4 through the ``(B, NB)`` int32 table over int8 ``(N, Hkv,
    block, D)`` pools, with per-block ``(N, Hkv)`` scales (read through the
    table in the kernel) or channel ``(B, Hkv, 1, D)`` scales (folded as in
    B4). Launches count as B1's do (``.launches``, ``.tree_launches``;
    ``.tiled_launches`` and ``.tiled_tq`` for the multi-row body, which
    takes more than one packed row or a tree), and those of the tick body
    (one packed row, no tree: the int8 decode tick) on
    ``.tick_launches``."""
    _check_tree(q, tree_mask)
    if q.device.type == "cpu":
        return paged_decode_q8q_plain(q, k_q, v_q, block_table, k_scale,
                                      v_scale, q_offset=q_offset,
                                      scale=scale, tree_mask=tree_mask)
    per_block = _check_q8(q, k_q, v_q, k_scale, v_scale, block_table)
    _check_decode(q, k_q, v_q)
    if block_table.dtype != torch.int32 or block_table.device != q.device:
        raise ValueError("block_table must be int32 on q's device")
    B, NB = block_table.shape
    _, Hkv, blk, _ = k_q.shape
    if NB == 0:
        return empty_result(q)
    codes, qs = _fold_quantize_q(q, Hkv, None if per_block else k_scale,
                                 scale)
    offs = offsets(q_offset, 0, B, q.device).contiguous()
    _count(attention_cuda_decode_paged_q8q, tree_mask)
    out, lse = _launch(attention_cuda_decode_paged_q8q, codes, k_q, v_q,
                       offs, block_table.contiguous(),
                       variant=_Q8Q, Tq=q.shape[2], Tk=NB * blk, blk=blk,
                       NB=NB, causal=True, scale=1.0, qs=qs,
                       block_scales=(k_scale, v_scale) if per_block
                       else None, tree_mask=tree_mask)
    return _unfold_out(out, lse, q, None if per_block else v_scale)


attention_cuda_decode_paged_q8q.launches = 0
attention_cuda_decode_paged_q8q.tree_launches = 0
attention_cuda_decode_paged_q8q.tiled_launches = 0
attention_cuda_decode_paged_q8q.tiled_tq = {}  # multi-row launches by Tq
attention_cuda_decode_paged_q8q.tick_launches = 0  # one-row ticks


def attention_cuda_decode_q8(q, k_q, v_q, k_scale, v_scale, *,
                             causal: bool = False,
                             scale: Optional[float] = None,
                             q_offset: Offset = 0, kv_offset: Offset = 0,
                             block_table: Optional[torch.Tensor] = None,
                             tree_mask: Optional[torch.Tensor] = None):
    """The cast route (``q8``): B1, or B2 with ``block_table``, over int8
    K/V with channel scales folded, or B2 with per-block scales."""
    return _q8_cast(q, k_q, v_q, k_scale, v_scale, causal=causal,
                    scale=scale, q_offset=q_offset, kv_offset=kv_offset,
                    block_table=block_table, b1=attention_cuda_decode,
                    b2=attention_cuda_decode_paged, tree_mask=tree_mask)


def _q8q_route(q, k_q, v_q, k_scale, v_scale, *, causal: bool = False,
               scale: Optional[float] = None, q_offset: Offset = 0,
               kv_offset: Offset = 0,
               block_table: Optional[torch.Tensor] = None,
               tree_mask: Optional[torch.Tensor] = None,
               plain: bool = False):
    """q8q with the TPU wrapper's signature: B5 with a table, else B4."""
    if block_table is not None:
        fn = paged_decode_q8q_plain if plain else \
            attention_cuda_decode_paged_q8q
        return fn(q, k_q, v_q, block_table, k_scale, v_scale,
                  q_offset=q_offset, scale=scale, tree_mask=tree_mask)
    fn = decode_q8q_plain if plain else attention_cuda_decode_q8q
    return fn(q, k_q, v_q, k_scale, v_scale, causal=causal, scale=scale,
              q_offset=q_offset, kv_offset=kv_offset, tree_mask=tree_mask)
