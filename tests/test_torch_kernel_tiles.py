"""How the redesigned kernels cut their work, on the CPU.

The multi-row decode body (``csrc/decode_tiled.cuh``
``decode_tiled_kernel``: B1, B2, B4 and B5, and the cast route over B1/B2,
with more than one packed row or a tree mask), the tick body
(``csrc/decode_tick.cu`` ``decode_tick_kernel``: the one-row paged launches
of B2, its cast route and B5), the split body's merge
(``csrc/decode.cuh``
``merge_splits_kernel``) and B7's tensor-core body (``csrc/flash_bwd.cu``
``flash_dkv_wgmma_kernel``) run only on the card; what surrounds them is
Python that these tests reach:

- (a) the static rule that picks a decode launch's body
  (``cuda_decode.decode_body``), and the launchers' check of the built
  libraries' constants;
- (b) the split geometry (``decode_geometry``, ``split_keys``): every
  visible (row, key) pair of a ragged batch falls in exactly one split and
  one Q tile, no split reads past its slot's frontier, and under
  ``local_blocks`` the multi-row body's splits are sized on the rank's
  share of the keys (the split body's on the logical length); on the
  contiguous layout also with a ``kv_offset`` (a ``tree_decode`` shard),
  a shard wholly past the frontier, and without the causal rule; the tick
  body's units (``tick_units``): every visible held key of a slot in
  exactly one CTA of its cluster, no unit past the frontier, no remote
  entry dereferenced, and its cluster size per shape;
- (c) the merge's grouping of the partials (the warps of a row take runs
  of 32, one weight per lane): a CPU model built on ``merge_partials``
  equals the flat merge; so does a model of the tick body's merge inside
  its cluster (rank 0 over up to 8 CTA states, in rank order);
- (d) B7's walk of (query head, Q tile) per K/V tile (``cuda_bwd
  .dkv_walk``): it starts at the first live Q tile (held against the JAX
  package's ``causal_first_live_q``), leaves no live tile out and takes no
  tile twice.

The plain versions at the multi-row body's shapes (B2 bf16 at Tq 8 and 28,
G 1 and 4, tree and local_blocks; B1 at GQA Tq 16 with a kv_offset; B5 at
a Tq-8 tree with per-block scales over 4-token blocks; B4 at GQA Tq 16
with a kv_offset and at a Tq-8 tree; the cast route as a contiguous Tq-8
tree and as a paged 64-row chunk with per-block scales over 4-token
blocks) are held against the Pallas kernels in interpret mode, as
``tests/test_pallas_decode.py`` runs them; the cast route under
``local_blocks`` with per-block scales, its ranks' partials merged, against
the unsharded plain version. Tolerance as ``tests/test_torch_ops.py``
holds bf16: 2e-2 on out, 1e-2 on lse (the int8 routes: as
``tests/test_torch_q8.py`` holds them, 1e-2 of each row's largest |out|
and 1e-4 on lse). The ``gpu`` twins launch the kernels against their
plain versions and skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tree_attention_tpu.ops import block_utils as jbu
from tree_attention_tpu.ops.pallas_decode import (
    attention_pallas_decode,
    attention_pallas_decode_q8,
    attention_pallas_decode_q8q,
)

from tree_attention_tpu_torch.ops import _build, block_utils, cuda_bwd
from tree_attention_tpu_torch.ops import cuda_decode as cd
from tree_attention_tpu_torch.ops.reference import merge_partials
from tree_attention_tpu_torch.ops.tuning import DKV_TILES
from tree_attention_tpu_torch.serving import ShardedBlockAllocator
from tests.torch_threads import few_torch_threads  # noqa: F401

BF16, F32, CAST, Q8Q = 1, 0, 2, 3


# -- (a) the body rule --------------------------------------------------------

@pytest.mark.parametrize("variant,rows,paged,tree,body", [
    (BF16, 8, True, False, "tiled"),    # a prompt tail or a chain verify
    (BF16, 8, True, True, "tiled"),     # a tree verify tick
    (BF16, 1, True, True, "tiled"),     # a one-row tree: the mask's body
    (BF16, 2, True, False, "tiled"),    # the fewest rows that take it
    (BF16, 127, True, False, "tiled"),  # past one 64-row Q tile
    (BF16, 512, True, False, "tiled"),  # GQA 4 x 128 (sharded chunks)
    (BF16, 1, True, False, "tick"),     # the decode tick: the cluster body
    (F32, 8, True, False, "split"),     # f32 stays on the CUDA cores
    (F32, 8, True, True, "split"),
    (CAST, 8, True, True, "tiled"),     # int8 K/V widened (q8 route), tree
    (Q8Q, 8, True, False, "tiled"),     # int8 x int8 through a table (B5)
    (BF16, 8, False, True, "tiled"),    # contiguous B1, a tree verify tick
    (Q8Q, 8, False, False, "tiled"),    # contiguous B4
    (BF16, 64, False, False, "tiled"),  # B1 GQA 4 x 16 (a staged tail)
    (BF16, 1, False, False, "split"),   # B1 at the reference workload
    (BF16, 1, False, True, "tiled"),    # B1 one-row tree
    (Q8Q, 32, True, True, "tiled"),     # B5 tree verify tick, Tq 32
    (Q8Q, 1, True, True, "tiled"),      # B5 one-row tree
    (Q8Q, 1, True, False, "tick"),      # B5's decode tick
    (Q8Q, 8, False, True, "tiled"),     # contiguous q8q tree (B4)
    (CAST, 16, False, False, "tiled"),  # B1 over int8 K/V (cast route)
    (CAST, 64, True, False, "tiled"),   # B2 over int8 pools (cast route)
    (F32, 16, False, False, "split"),   # B1 in f32
    (Q8Q, 64, False, False, "tiled"),   # B4 GQA 4 x 16
    (Q8Q, 1, False, False, "split"),    # B4 at the reference workload
    (Q8Q, 1, False, True, "tiled"),     # B4 one-row tree
    (CAST, 1, False, False, "split"),   # B1's cast route, one row
    (CAST, 1, True, False, "tick"),     # B2's cast route: the int8 tick
    (CAST, 1, True, True, "tiled"),     # ... one-row tree
    (F32, 1, False, True, "split"),     # an f32 tree stays on CUDA cores
    (F32, 1, True, False, "split"),     # an f32 paged tick too
    # B2's local_blocks tick (one rank's slice of the sharded pool) and
    # B5's tick with channel scales: the flag and the scales' kind do not
    # enter the rule.
    pytest.param(BF16, 1, True, False, "tick", id="local_blocks-tick"),
    pytest.param(Q8Q, 1, True, False, "tick", id="b5-channel-scales-tick"),
])
def test_decode_body_rule(variant, rows, paged, tree, body):
    """The rule is static in the operands: every variant but f32 with more
    than one packed row or a tree mask -> the multi-row body; with one
    packed row and no mask, the tick body through a block table
    (``paged``) and the split body over contiguous K/V. The local_blocks
    flag and per-block or channel scales do not enter it: the bodies that
    take the paged layout carry them all."""
    assert cd.decode_body(variant, rows, tree, paged) == body


def test_decode_launchers_check_the_built_library(monkeypatch):
    """The launchers read the split library's warps per CTA and each
    multi-row library's keys per tile before the first launch, and raise
    on a library built otherwise."""

    class Lib:
        def __init__(self, name, warps, keys, cluster=cd._TICK_MAX_CLUSTER):
            self.flash_decode_warps_per_cta = lambda: warps
            setattr(self, f"{name}_keys", lambda: keys)
            self.decode_tick_max_cluster = lambda: cluster
            self.flash_decode_launch = lambda *a: 0
            setattr(self, f"{name}_launch", lambda *a: 0)

    built = []
    monkeypatch.setattr(cd, "_lib_fns", None)
    monkeypatch.setattr(_build, "build", built.append)
    monkeypatch.setattr(_build, "library", lambda name: Lib(
        name, 4, 32 if name == "flash_decode_tiled_cast" else 64))
    with pytest.raises(RuntimeError, match="keys per tile"):
        cd._launchers()
    # The tick body's library built with another largest cluster.
    monkeypatch.setattr(_build, "library", lambda name: Lib(
        name, cd._SPLIT_WARPS, cd._TILED_KEYS, cluster=4))
    with pytest.raises(RuntimeError, match="largest cluster"):
        cd._launchers()
    monkeypatch.setattr(_build, "library", lambda name: Lib(
        name, cd._SPLIT_WARPS, cd._TILED_KEYS))
    split, tiled, tick = cd._launchers()
    assert sorted(tiled) == [BF16, CAST, Q8Q]  # a library per variant
    assert cd._TICK_KEYS == cd._TILED_KEYS  # the mock's one keys value
    # Every decode library is built at once (one nvcc each, in parallel).
    assert set(built[-1]) == {"flash_decode", *cd._TILED_LIBS.values(),
                              "decode_tick"}


def test_cpu_wrapper_counts_no_multi_row_launch():
    """On a CPU tensor the wrapper runs the plain version: nothing counts
    on ``.tiled_launches``."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((2, 4, 8, 16), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((6, 2, 4, 16), np.float32))
            for _ in range(2))
    table = torch.tensor([[0, 1, 2, 3], [5, 4, 3, 2]], dtype=torch.int32)
    qo = torch.tensor([3, 7], dtype=torch.int32)
    w = cd.attention_cuda_decode_paged
    before = (w.launches, w.tiled_launches)
    got = w(q.bfloat16(), k.bfloat16(), v.bfloat16(), table, q_offset=qo)
    want = cd.paged_decode_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                 table, q_offset=qo)
    assert (w.launches, w.tiled_launches) == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_cpu_b4_and_cast_wrappers_count_no_multi_row_launch():
    """B4 carries the multi-row counters (``.tiled_launches``,
    ``.tiled_tq``) and B1/B2 the cast route's (``.cast_tiled_launches``);
    a CPU call of the int8 routes at a multi-row shape counts on none of
    them and equals the plain version."""
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((2, 4, 8, 16), np.float32))
    kq, vq = (torch.from_numpy(rng.integers(-127, 128, (2, 2, 40, 16)
                                            ).astype(np.int8))
              for _ in range(2))
    ks, vs = (torch.from_numpy(rng.uniform(0.005, 0.03, (2, 2, 1, 16))
                               .astype(np.float32)) for _ in range(2))
    qo = torch.tensor([30, 11], dtype=torch.int32)
    b1, b2, b4 = (cd.attention_cuda_decode, cd.attention_cuda_decode_paged,
                  cd.attention_cuda_decode_q8q)
    assert b4.tiled_tq is not b1.tiled_tq and isinstance(b4.tiled_tq, dict)
    counts = [(w.launches, w.tiled_launches, dict(w.tiled_tq),
               getattr(w, "cast_tiled_launches", None))
              for w in (b1, b2, b4)]
    kw = dict(causal=True, q_offset=qo)
    for route in ("q8q", "q8"):
        got = cd.resolve_q8_kernel(route)(q, kq, vq, ks, vs, **kw)
        want = cd.resolve_q8_kernel(route, plain=True)(q, kq, vq, ks, vs,
                                                       **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert counts == [(w.launches, w.tiled_launches, dict(w.tiled_tq),
                       getattr(w, "cast_tiled_launches", None))
                      for w in (b1, b2, b4)]
    assert counts[0][3] is not None and counts[1][3] is not None


def test_cpu_tick_wrappers_count_no_tick_launch():
    """B2 and B5 carry the tick body's counter (``.tick_launches``); a CPU
    call at the tick's shape (one packed row through a table: bf16, the
    cast route with per-block scales, B5 with channel scales) counts on no
    counter of a body and equals the plain version."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((2, 2, 1, 16), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((6, 2, 4, 16), np.float32)
                             ).bfloat16() for _ in range(2))
    kq, vq = (torch.from_numpy(rng.integers(-127, 128, (6, 2, 4, 16)
                                            ).astype(np.int8))
              for _ in range(2))
    bs = tuple(torch.from_numpy(rng.uniform(0.005, 0.03, (6, 2))
                                .astype(np.float32)) for _ in range(2))
    cs = tuple(torch.from_numpy(rng.uniform(0.005, 0.03, (2, 2, 1, 16))
                                .astype(np.float32)) for _ in range(2))
    table = torch.tensor([[0, 1, 2], [5, 4, 3]], dtype=torch.int32)
    qo = torch.tensor([6, 11], dtype=torch.int32)
    b2, b5 = cd.attention_cuda_decode_paged, cd.attention_cuda_decode_paged_q8q
    counts = [(w.launches, w.tiled_launches, w.tick_launches)
              for w in (b2, b5)]
    calls = (
        (lambda f: f(q.bfloat16(), k, v, table, q_offset=qo),
         b2, cd.paged_decode_plain),
        (lambda f: f(q.bfloat16(), kq, vq, table, q_offset=qo,
                     block_scales=bs), b2, cd.paged_decode_plain),
        (lambda f: f(q, kq, vq, table, *cs, q_offset=qo), b5,
         cd.paged_decode_q8q_plain),
    )
    for call, wrapper, plain in calls:
        got, want = call(wrapper), call(plain)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert counts == [(w.launches, w.tiled_launches, w.tick_launches)
                      for w in (b2, b5)]


# -- (b) the split geometry ---------------------------------------------------

B, HKV, BLK, NB = 3, 2, 16, 40  # 640-key slots of 16-key blocks


def _tables(W, rng):
    """``(B, NB)`` signed local tables of rank 0 (W > 1: blocks handed out
    as ShardedBlockAllocator hands them, slot by slot), or an unsharded
    permutation (W = 1)."""
    if W == 1:
        return np.stack([rng.permutation(B * NB) for _ in range(B)])[:, :NB]
    alloc = ShardedBlockAllocator(B * NB, W)
    alloc.reserve(B * NB)
    table = np.asarray([[alloc.alloc() for _ in range(NB)]
                        for _ in range(B)])
    nl = B * NB // W
    return np.where(table < nl, table, -1)


@pytest.mark.parametrize("W", [1, 2, 4])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("tq", [1, 8, 28, 32, 64, 127])
def test_split_geometry_covers_every_visible_pair_once(tq, G, W):
    rng = np.random.default_rng(tq * 10 + G + W)
    Tk = NB * BLK
    R = G * tq
    table = torch.from_numpy(_tables(W, rng))
    qoff = rng.integers(0, Tk - tq, size=B)
    qoff[0] = 3 * BLK - tq if 3 * BLK >= tq else 0  # ends on a block edge
    body = cd.decode_body(BF16, R)
    geo = cd.decode_geometry(body, R, B, HKV, Tk, shards=W)
    granule = cd._TILED_KEYS if body == "tiled" else 8
    assert geo.split_len % granule == 0
    assert geo.q_tiles == -(-R // geo.rows)
    if body == "tiled":
        assert geo.rows in cd._TILED_ROWS and geo.splits == geo.ctas
        assert geo.q_tiles == -(-R // 64)  # each key read once per 64 rows
    else:
        assert geo.splits == geo.ctas * cd._SPLIT_WARPS
    assert geo.splits * geo.split_len >= Tk
    # The multi-row body sizes on the rank's share: its splits with keys
    # stream at least _MIN_SPLIT_KEYS of the keys the rank holds, on
    # average; the split body sizes on the logical length.
    share = W if body == "tiled" else 1
    assert -(-Tk // geo.split_len) <= max(1, Tk // share
                                          // cd._MIN_SPLIT_KEYS)

    held = (table >= 0).repeat_interleave(BLK, 1)               # (B, Tk)
    pos = torch.from_numpy(qoff)[:, None] + torch.arange(R) % tq  # (B, R)
    keys = torch.arange(Tk)
    visible = (keys[None, None] <= pos[..., None]) & held[:, None]
    count = torch.zeros((B, R, Tk), dtype=torch.int32)
    read = torch.zeros((B, Tk), dtype=torch.bool)
    for b in range(B):
        for s in range(geo.splits):
            span = cd.split_keys(geo, s, int(qoff[b]), tq, Tk)
            if not len(span):
                continue
            read[b, span.start:span.stop] = True
            for y in range(geo.q_tiles):
                count[b, y * geo.rows:(y + 1) * geo.rows,
                      span.start:span.stop] += 1
    assert torch.all(count[visible] == 1)
    assert int(count.max()) <= 1  # no (row, key) twice, visible or not
    frontier = torch.from_numpy(qoff)[:, None] + tq
    assert not torch.any(read & (keys[None] >= frontier))


@pytest.mark.parametrize("blk", [16, 64, 100])
@pytest.mark.parametrize("W", [1, 2, 4])
def test_tick_geometry_covers_every_visible_key_once(W, blk):
    """The tick body at Tq 1 (``tick_units``, the kernel's arithmetic):
    over each slot's cluster, every visible key the rank holds is streamed
    by exactly one CTA, once; no unit runs past the slot's frontier, so no
    key past it is copied and no table entry past it is read; a remote
    entry (W > 1, rank 0's signed table) is never dereferenced. Slots:
    empty, one key, ending on a block edge, full, and random; blocks of 16
    and 64 keys (whole blocks a unit) and 100 (a block in 64-key pieces)."""
    rng = np.random.default_rng(W * 1000 + blk)
    Tk = NB * blk
    table = torch.from_numpy(_tables(W, rng))
    qoff = rng.integers(0, Tk, size=B)
    qoff[:3] = (-1, 0, 3 * blk - 1)  # empty, one key, ends on a block edge
    body = cd.decode_body(BF16, 1, paged=True)
    assert body == "tick"
    for hkv in (HKV, 16):  # a small grid (larger clusters) and the serve's
        geo = cd.decode_geometry(body, 1, B, hkv, Tk, shards=W)
        assert geo.ctas == geo.splits and geo.ctas in (1, 2, 4, 8)
        for b in range(B):
            j1 = max(0, min(Tk, int(qoff[b]) + 1))
            held = (table[b] >= 0).repeat_interleave(blk)
            count = torch.zeros(Tk, dtype=torch.int32)
            for rank in range(geo.ctas):
                for nb, row0, n in cd.tick_units(geo, rank, int(qoff[b]), 1,
                                                 Tk, blk):
                    start = nb * blk + row0
                    # A unit stays in its block and ends at the frontier:
                    # no table entry past the slot's is read.
                    assert 1 <= n <= min(blk, cd._TICK_KEYS)
                    assert row0 + n <= blk and start + n <= j1
                    if table[b, nb] < 0:  # remote: dropped, never read
                        continue
                    count[start:start + n] += 1
            visible = (torch.arange(Tk) < j1) & held
            assert torch.all(count[visible] == 1)
            assert int(count[~visible].sum()) == 0


def test_tick_cluster_fills_the_card():
    """The cluster per row: two CTAs per SM at the serve tick (8 slots x 16
    KV heads -> 2), the largest cluster for one long slot (the reference
    workload through a table, 16 heads -> 8), one CTA where the table
    holds a single stage of keys."""
    geo = cd.decode_geometry("tick", 1, 8, 16, 640)
    assert (geo.ctas, geo.split_len) == (2, cd._TICK_KEYS)
    assert 8 * 16 * geo.ctas <= cd._TICK_TARGET_CTAS
    assert cd.decode_geometry("tick", 1, 1, 16, 64000).ctas == 8
    assert cd.decode_geometry("tick", 1, 1, 16, 64).ctas == 1
    assert cd.decode_geometry("tick", 1, 64, 16, 64000).ctas == 1


@pytest.mark.parametrize("R,W", [(64, 2), (64, 4), (8, 4), (1, 2), (1, 4)])
def test_local_splits_follow_the_body(R, W):
    """The serve shape (8 slots, 16 KV heads, 640-key slots) with the pool
    sharded W ways, where a rank holds ~640/W keys of a slot: the
    multi-row body sizes its splits on that share (no split below
    _MIN_SPLIT_KEYS of HELD keys, on average); the split body (one packed
    row) keeps the logical sizing, which it ran faster with on the card."""
    body = cd.decode_body(BF16, R)
    one = cd.decode_geometry(body, R, 8, 16, 640)
    sharded = cd.decode_geometry(body, R, 8, 16, 640, shards=W)
    if body == "split":
        assert sharded == one
        return
    assert -(-640 // sharded.split_len) <= max(
        1, 640 // W // cd._MIN_SPLIT_KEYS)
    assert sharded.split_len >= one.split_len
    if W == 4:  # the share binds: longer splits than the logical sizing
        assert sharded.split_len > one.split_len


@pytest.mark.parametrize("mode", ["causal", "shard", "noncausal"])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("tq", [2, 16, 64, 127])
def test_contiguous_geometry_covers_every_visible_pair_once(tq, G, mode):
    """B1 on the multi-row body (contiguous K/V, Tk not a multiple of the
    64-key tile): with the causal rule at kv_offset 0; as one
    ``tree_decode`` shard (per-slot kv_offset, one slot's shard wholly
    past its frontier: it reads nothing); without the causal rule."""
    rng = np.random.default_rng(tq * 10 + G)
    Tk, R = 700, G * tq
    causal = mode != "noncausal"
    qoff = rng.integers(0, 2 * Tk, size=B)
    koff = np.zeros(B, dtype=np.int64)
    if mode == "shard":
        koff = rng.integers(1, Tk, size=B)
        qoff = koff + rng.integers(0, Tk - tq, size=B)
        koff[2] = qoff[2] + tq  # the slot's first key is past its frontier
    body = cd.decode_body(BF16, R)
    assert body == "tiled"
    geo = cd.decode_geometry(body, R, B, HKV, Tk)
    assert geo.split_len % cd._TILED_KEYS == 0
    assert geo.q_tiles == -(-R // 64) and geo.splits * geo.split_len >= Tk

    pos = torch.from_numpy(qoff)[:, None] + torch.arange(R) % tq  # (B, R)
    keys = torch.from_numpy(koff)[:, None] + torch.arange(Tk)      # (B, Tk)
    visible = ((keys[:, None] <= pos[..., None]) if causal
               else torch.ones((B, R, Tk), dtype=torch.bool))
    count = torch.zeros((B, R, Tk), dtype=torch.int32)
    for b in range(B):
        for s in range(geo.splits):
            span = cd.split_keys(geo, s, int(qoff[b]), tq, Tk,
                                 kv_offset=int(koff[b]), causal=causal)
            for y in range(geo.q_tiles):
                count[b, y * geo.rows:(y + 1) * geo.rows,
                      span.start:span.stop] += 1
    assert torch.all(count[visible] == 1)
    assert int(count.max()) <= 1
    if causal:  # nothing past a slot's frontier is read
        past = keys > pos[:, -1:]
        assert not torch.any(count.sum(1).bool() & past)
    if mode == "shard":
        assert int(count[2].sum()) == 0


# -- (c) the merge ------------------------------------------------------------

def _merge_as_kernel(o, lse, wpr):
    """``merge_splits_kernel``'s arithmetic on ``(S, rows, D)`` partials:
    one max over all S, then warp p of a row sums the weights and weighted
    rows of runs p, p + wpr, ... of 32 partials, and the warps' sums add."""
    S = lse.shape[0]
    m = lse.amax(0)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    num = torch.zeros(o.shape[1:])
    den = torch.zeros(lse.shape[1:])
    for p in range(wpr):
        for s0 in range(32 * p, S, 32 * wpr):
            w = torch.exp(lse[s0:s0 + 32] - m_safe)
            num += (w[..., None] * o[s0:s0 + 32]).sum(0)
            den += w.sum(0)
    empty = den <= 0
    out = torch.where(empty[..., None], 0.0,
                      num / torch.where(empty, 1.0, den)[..., None])
    return out, torch.where(empty, -torch.inf, m + torch.log(den))


@pytest.mark.parametrize("S", [12, 63, 100, 252])
def test_merge_grouping_equals_the_flat_merge(S):
    """The kernel's wpr warps per row (one per run of 32 partials, up to 8,
    rounded up to a power of two, as ``merge_splits`` picks) each merge
    their runs; the runs
    regrouped by ``merge_partials`` (each warp's set, then the warps'
    results) and the kernel's arithmetic both equal the flat merge. Row 0
    no split saw; in row 1 one warp's every partial is empty."""
    wpr = min(8, 1 << (-(-S // 32) - 1).bit_length())
    rng = np.random.default_rng(S)
    rows, D = 6, 8
    o = torch.from_numpy(rng.standard_normal((S, rows, D), np.float32))
    lse = torch.from_numpy(rng.standard_normal((S, rows)).astype(
        np.float32) * 3)
    lse[rng.random((S, rows)) < 0.3] = -torch.inf
    lse[:, 0] = -torch.inf
    groups = [[s for s0 in range(32 * p, S, 32 * wpr)
               for s in range(s0, min(s0 + 32, S))] for p in range(wpr)]
    groups = [x for x in groups if x]  # a warp with no run adds nothing
    lse[groups[-1], 1] = -torch.inf
    o[torch.isneginf(lse)] = 0.0  # an empty partial's o, as both bodies write
    flat = merge_partials(o, lse)
    parts = [merge_partials(o[g], lse[g]) for g in groups]
    regrouped = merge_partials(torch.stack([x for x, _ in parts]),
                               torch.stack([y for _, y in parts]))
    for got in (regrouped, _merge_as_kernel(o, lse, wpr)):
        torch.testing.assert_close(got[0], flat[0], atol=1e-6, rtol=1e-5)
        assert torch.equal(torch.isneginf(got[1]), torch.isneginf(flat[1]))
        fin = torch.isfinite(flat[1])
        torch.testing.assert_close(got[1][fin], flat[1][fin], atol=1e-6,
                                   rtol=1e-5)
    assert torch.all(flat[0][0] == 0) and torch.all(torch.isneginf(flat[1][0]))


def _merge_in_cluster(acc, m, l):
    """``decode_tick_kernel``'s merge of a cluster's ``C`` CTA states —
    unnormalised ``acc`` ``(C, rows, D)``, ``m`` and ``l`` ``(C, rows)`` —
    on rank 0, in rank order: the max of the m, then each rank's weight
    (0 for a rank with no visible key), and the sums."""
    M = torch.full(m.shape[1:], -torch.inf)
    for r in range(m.shape[0]):
        M = torch.maximum(M, m[r])
    num = torch.zeros(acc.shape[1:])
    den = torch.zeros(m.shape[1:])
    for r in range(m.shape[0]):
        w = torch.where(torch.isneginf(m[r]), 0.0, torch.exp(m[r] - M))
        den = den + w * l[r]
        num = num + w[..., None] * acc[r]
    empty = den <= 0
    out = torch.where(empty[..., None], 0.0,
                      num / torch.where(empty, 1.0, den)[..., None])
    return out, torch.where(empty, -torch.inf, M + torch.log(den))


@pytest.mark.parametrize("C", [1, 2, 4, 8])
def test_cluster_merge_equals_the_flat_merge(C):
    """The tick body's in-cluster merge of ``C`` CTAs' states equals the
    flat ``merge_partials`` of the same partials as ``(acc / l, m + log
    l)``; a CTA with no visible key is the identity, and a row no CTA saw
    (every state the identity) is exactly ``(0, -inf)``."""
    rng = np.random.default_rng(C)
    rows, D = 6, 8
    m = torch.from_numpy(rng.standard_normal((C, rows)).astype(np.float32)
                         * 3)
    l = torch.from_numpy(rng.uniform(1.0, 50.0, (C, rows)).astype(np.float32))
    acc = torch.from_numpy(rng.standard_normal((C, rows, D), np.float32)) \
        * l[..., None]
    idle = torch.from_numpy(rng.random((C, rows)) < 0.3)
    idle[:, 0] = True  # row 0: no CTA saw a key
    m[idle], l[idle] = -torch.inf, 0.0
    acc[idle] = 0.0
    flat = merge_partials(
        torch.where(idle[..., None], 0.0, acc / l.clamp_min(1e-30)[..., None]),
        torch.where(idle, -torch.inf, m + torch.log(l)))
    got = _merge_in_cluster(acc, m, l)
    torch.testing.assert_close(got[0], flat[0], atol=1e-6, rtol=1e-5)
    assert torch.equal(torch.isneginf(got[1]), torch.isneginf(flat[1]))
    fin = torch.isfinite(flat[1])
    torch.testing.assert_close(got[1][fin], flat[1][fin], atol=1e-6,
                               rtol=1e-5)
    assert torch.all(got[0][0] == 0) and torch.all(torch.isneginf(got[1][0]))


# -- (d) B7's walk ------------------------------------------------------------

@pytest.mark.parametrize("causal,qo,ko", [
    (False, 0, 0), (True, 0, 0), (True, 200, 0), (True, 0, 100),
    (True, -70, 0), (True, 37, 170), (True, 1000, 0), (True, 0, 1000)])
@pytest.mark.parametrize("G", [1, 3])
def test_dkv_walk_takes_each_live_tile_once(G, causal, qo, ko):
    bq, bk = DKV_TILES["bfloat16"]
    Tq, Tk = 300, 330
    n_q, n_k = -(-Tq // bq), -(-Tk // bk)
    rows, cols = torch.arange(Tq), torch.arange(Tk)
    sees = ((cols[None] + ko <= rows[:, None] + qo) if causal
            else torch.ones(Tq, Tk, dtype=torch.bool))
    for ki in range(n_k):
        walk = cuda_bwd.dkv_walk(ki, G, n_q, block_q=bq, block_k=bk,
                                 causal=causal, q_offset=qo, kv_offset=ko)
        assert len(walk) == len(set(walk))
        live = {(g, qt) for g in range(G) for qt in range(n_q)
                if sees[qt * bq:(qt + 1) * bq, ki * bk:(ki + 1) * bk].any()}
        assert live <= set(walk)
        if walk:  # head by head, each from the first live Q tile
            first = int(jbu.causal_first_live_q(ki, bq, bk, qo, ko, n_q)
                        ) if causal else 0
            assert first == block_utils.first_live_q(ki, bq, bk, qo, ko,
                                                     n_q) or not causal
            assert walk == [(g, qt) for g in range(G)
                            for qt in range(first, n_q)]
        else:  # no row sees the tile: nothing to walk, dk = dv = 0
            assert not live


# -- the plain version at the multi-row shapes, against Pallas ----------------

def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("tq,G,flag", [(8, 1, None), (28, 4, None),
                                       (8, 1, "tree"), (8, 1, "local")])
def test_multi_row_shapes_plain_match_pallas(tq, G, flag):
    rng = np.random.default_rng(tq + G)
    Bq, Hkv, D, blk, NBq, N = 2, 2, 16, 4, 12, 30
    q, k, v = (_bf16(rng.standard_normal(s).astype(np.float32)) for s in (
        (Bq, Hkv * G, tq, D), (N, Hkv, blk, D), (N, Hkv, blk, D)))
    table = np.stack([rng.permutation(N)[:NBq] for _ in range(Bq)]
                     ).astype(np.int32)
    pos = rng.integers(0, NBq * blk - tq, size=Bq).astype(np.int32)
    kw_j, kw_t = {}, {}
    if flag == "local":
        table[:, 1::3] = -1
        kw_j = kw_t = {"local_blocks": True}
    if flag == "tree":
        tree = np.tril(rng.random((Bq, tq, tq)) < 0.5)
        tree[:, np.arange(tq), np.arange(tq)] = True
        tree[:, :, 0] = True
        kw_j = {"tree_mask": jnp.asarray(tree)}
        kw_t = {"tree_mask": torch.from_numpy(tree)}
    ref = attention_pallas_decode(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), causal=True, q_offset=jnp.asarray(pos),
        kv_offset=0, block_table=jnp.asarray(table), interpret=True, **kw_j)
    o, l = cd.attention_cuda_decode_paged(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
        torch.from_numpy(table), q_offset=torch.from_numpy(pos), **kw_t)
    ro = np.asarray(jnp.asarray(ref[0], jnp.float32))
    rl = np.asarray(ref[1])
    np.testing.assert_allclose(o.float().numpy(), ro, atol=2e-2, rtol=2e-2)
    np.testing.assert_array_equal(np.isneginf(l.numpy()), np.isneginf(rl))
    fin = np.isfinite(rl)
    np.testing.assert_allclose(l.numpy()[fin], rl[fin], atol=1e-2, rtol=1e-2)


def test_b1_gqa_tq16_kv_offset_plain_matches_pallas():
    """B1's multi-row shape on the contiguous layout: GQA 4 x Tq 16 (64
    packed rows), per-slot q_offset and kv_offset as a ``tree_decode``
    shard has them, one slot's shard wholly past its frontier ((0, -inf)),
    Tk not a multiple of the TPU tile. (``tests/test_torch_ops.py
    test_b1_plain_matches_pallas_decode`` covers GQA Tq 16 at kv_offset 0.)"""
    rng = np.random.default_rng(16)
    Bq, Hkv, G, tq, Tk, D = 3, 2, 4, 16, 77, 16
    q, k, v = (_bf16(rng.standard_normal(s).astype(np.float32)) for s in (
        (Bq, Hkv * G, tq, D), (Bq, Hkv, Tk, D), (Bq, Hkv, Tk, D)))
    ko = np.array([40, 300, 5], np.int32)
    qo = np.array([100, 280, 30], np.int32)  # slot 1 sees none of its keys
    ref = attention_pallas_decode(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), causal=True, q_offset=jnp.asarray(qo),
        kv_offset=jnp.asarray(ko), block_size=32, interpret=True)
    o, l = cd.attention_cuda_decode(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)), causal=True,
        q_offset=torch.from_numpy(qo), kv_offset=torch.from_numpy(ko))
    ro = np.asarray(jnp.asarray(ref[0], jnp.float32))
    rl = np.asarray(ref[1])
    np.testing.assert_allclose(o.float().numpy(), ro, atol=2e-2, rtol=2e-2)
    np.testing.assert_array_equal(np.isneginf(l.numpy()), np.isneginf(rl))
    fin = np.isfinite(rl)
    np.testing.assert_allclose(l.numpy()[fin], rl[fin], atol=1e-2, rtol=1e-2)
    assert np.all(np.isneginf(l.numpy()[1])) and torch.all(o[1] == 0)


def _q8_rows_close(port, ref):
    """The int8 routes' row gate (``tests/test_torch_q8.py``): each query
    row within 1e-2 of its largest |out|, the same empty rows, |dlse|
    within 1e-4."""
    o = port[0].float().numpy()
    ro = np.asarray(jnp.asarray(ref[0], jnp.float32))
    rl = np.asarray(ref[1])
    assert o.shape == ro.shape
    assert np.all(np.abs(o - ro) <= 1e-2 * np.abs(ro).max(-1, keepdims=True))
    np.testing.assert_array_equal(np.isneginf(port[1].numpy()),
                                  np.isneginf(rl))
    fin = np.isfinite(rl)
    np.testing.assert_allclose(port[1].numpy()[fin], rl[fin], atol=1e-4,
                               rtol=0)


def _draft_tree(rng, Bq, tq):
    """``(Bq, tq, tq)`` ancestor masks with random parents: each row sees
    itself and the root; not the lower-triangular (causal) mask."""
    tree = np.tril(rng.random((Bq, tq, tq)) < 0.5)
    tree[:, np.arange(tq), np.arange(tq)] = True
    tree[:, :, 0] = True
    assert not np.all(tree == np.tril(np.ones((tq, tq), bool)))
    return tree


def test_b4_gqa_tq16_kv_offset_plain_matches_pallas():
    """B4's multi-row shape: GQA 4 x Tq 16 (64 packed rows) over contiguous
    int8 K/V with channel scales, per-slot q_offset and kv_offset as a
    ``tree_decode`` shard has them, one slot's shard wholly past its
    frontier ((0, -inf)), Tk not a multiple of the tile."""
    rng = np.random.default_rng(17)
    Bq, Hkv, G, tq, Tk, D = 3, 2, 4, 16, 77, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in (
        (Bq, Hkv * G, tq, D), (Bq, Hkv, Tk, D), (Bq, Hkv, Tk, D)))
    kq, vq, ks, vs = cd.quantize_kv_channelwise(torch.from_numpy(k),
                                                torch.from_numpy(v))
    ko = np.array([40, 300, 5], np.int32)
    qo = np.array([100, 280, 30], np.int32)  # slot 1 sees none of its keys
    ref = attention_pallas_decode_q8q(
        *(jnp.asarray(x) for x in (q, kq.numpy(), vq.numpy(), ks.numpy(),
                                   vs.numpy())),
        causal=True, q_offset=jnp.asarray(qo), kv_offset=jnp.asarray(ko),
        block_size=32, interpret=True)
    o, l = cd.attention_cuda_decode_q8q(
        torch.from_numpy(q), kq, vq, ks, vs, causal=True,
        q_offset=torch.from_numpy(qo), kv_offset=torch.from_numpy(ko))
    _q8_rows_close((o, l), ref)
    assert np.all(np.isneginf(l.numpy()[1])) and torch.all(o[1] == 0)
    assert np.all(np.isfinite(l.numpy()[[0, 2]]))


@pytest.mark.parametrize("route", ["q8q", "q8"])
def test_int8_contiguous_tree_tq8_plain_matches_pallas(route):
    """A Tq-8 verify tick on the contiguous int8 layout with a draft tree
    (not the causal mask): B4 against ``attention_pallas_decode_q8q``, the
    cast route over B1 against ``attention_pallas_decode_q8``."""
    rng = np.random.default_rng(18)
    Bq, Hkv, G, tq, Tk, D = 2, 2, 2, 8, 90, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in (
        (Bq, Hkv * G, tq, D), (Bq, Hkv, Tk, D), (Bq, Hkv, Tk, D)))
    kq, vq, ks, vs = cd.quantize_kv_channelwise(torch.from_numpy(k),
                                                torch.from_numpy(v))
    qo = np.array([Tk - tq, 37], np.int32)
    tree = _draft_tree(rng, Bq, tq)
    jfn = attention_pallas_decode_q8q if route == "q8q" else \
        attention_pallas_decode_q8
    ref = jfn(*(jnp.asarray(x) for x in (q, kq.numpy(), vq.numpy(),
                                         ks.numpy(), vs.numpy())),
              causal=True, q_offset=jnp.asarray(qo),
              tree_mask=jnp.asarray(tree), block_size=32, interpret=True)
    port = cd.resolve_q8_kernel(route)(
        torch.from_numpy(q), kq, vq, ks, vs, causal=True,
        q_offset=torch.from_numpy(qo), tree_mask=torch.from_numpy(tree))
    _q8_rows_close(port, ref)
    causal = cd.resolve_q8_kernel(route)(
        torch.from_numpy(q), kq, vq, ks, vs, causal=True,
        q_offset=torch.from_numpy(qo))
    assert (port[0] - causal[0]).abs().max() > 1e-2  # the mask has teeth


def _int8_pool(rng, N, Hkv, blk, D):
    """int8 K/V pools with per-block ``(N, Hkv)`` scales whose magnitudes
    differ by block."""
    kq, vq = (rng.integers(-127, 128, size=(N, Hkv, blk, D)).astype(np.int8)
              for _ in range(2))
    ks, vs = (np.exp(rng.standard_normal((N, Hkv))).astype(np.float32) * 0.01
              for _ in range(2))
    return kq, vq, ks, vs


def test_cast_paged_chunk_tq64_block_scales_plain_matches_pallas():
    """The cast route's multi-row shape on the paged layout: a 64-row chunk
    (Tq 64) over int8 pools of 4-token blocks with per-block scales (so
    the scalars change every 4 keys of the body's 64-key tiles), ragged
    slots, one seeing no key."""
    rng = np.random.default_rng(19)
    Bq, Hkv, tq, D, blk, NBq, N = 3, 2, 64, 16, 4, 40, 110
    kq, vq, ks, vs = _int8_pool(rng, N, Hkv, blk, D)
    table = np.stack([rng.permutation(N)[:NBq] for _ in range(Bq)]
                     ).astype(np.int32)
    qo = np.array([NBq * blk - tq, 21, -tq], np.int32)
    q = rng.standard_normal((Bq, Hkv, tq, D)).astype(np.float32)
    ref = attention_pallas_decode_q8(
        *(jnp.asarray(x) for x in (q, kq, vq, ks, vs)), causal=True,
        q_offset=jnp.asarray(qo), block_table=jnp.asarray(table),
        interpret=True)
    port = cd.attention_cuda_decode_q8(
        *(torch.from_numpy(x) for x in (q, kq, vq, ks, vs)), causal=True,
        q_offset=torch.from_numpy(qo), block_table=torch.from_numpy(table))
    _q8_rows_close(port, ref)
    assert np.all(np.isneginf(port[1].numpy()[2]))


@pytest.mark.parametrize("W", [2, 4])
def test_cast_local_blocks_block_scales_merge_to_unsharded(W):
    """B2's cast route under ``local_blocks`` with per-block scales (the
    sequence-sharded int8 pool's chunks): a 64-row chunk over the W ranks'
    slices of one pool, each rank's partial from its signed table, merged
    by the monoid, equals unsharded B2 on the whole pool, and the
    unsharded result equals ``attention_pallas_decode_q8``'s."""
    rng = np.random.default_rng(20 + W)
    Bq, Hkv, tq, D, blk, NBq = 3, 2, 64, 16, 4, 30
    N = 24 * W  # a multiple of W: every rank holds N / W blocks
    kq, vq, ks, vs = _int8_pool(rng, N, Hkv, blk, D)
    table = np.stack([rng.permutation(N)[:NBq] for _ in range(Bq)]
                     ).astype(np.int32)
    qo = np.array([NBq * blk - tq, 33, 5], np.int32)
    q = torch.from_numpy(rng.standard_normal((Bq, Hkv, tq, D)).astype(
        np.float32)).bfloat16()
    t = [torch.from_numpy(x) for x in (kq, vq, ks, vs, table, qo)]
    whole = cd.attention_cuda_decode_paged(q, t[0], t[1], t[4], q_offset=t[5],
                                           block_scales=(t[2], t[3]))
    nl = N // W
    parts = []
    for r in range(W):
        loc = table - r * nl
        loc = np.where((loc >= 0) & (loc < nl), loc, -1).astype(np.int32)
        sl = slice(r * nl, (r + 1) * nl)
        parts.append(cd.attention_cuda_decode_paged(
            q, t[0][sl], t[1][sl], torch.from_numpy(loc), q_offset=t[5],
            block_scales=(t[2][sl], t[3][sl]), local_blocks=True,
            local_shards=W))
    merged = merge_partials(torch.stack([o.float() for o, _ in parts]),
                            torch.stack([l for _, l in parts]))
    row = whole[0].float().abs().amax(-1, keepdim=True)
    assert torch.all((merged[0] - whole[0].float()).abs() <= 1e-2 * row)
    torch.testing.assert_close(merged[1], whole[1], atol=1e-4, rtol=0)
    ref = attention_pallas_decode_q8(
        *(jnp.asarray(x) for x in (q.float().numpy(), kq, vq, ks, vs)),
        causal=True, q_offset=jnp.asarray(qo),
        block_table=jnp.asarray(table), interpret=True)
    _q8_rows_close(whole, ref)


def test_b5_tree_tq8_small_blocks_plain_matches_pallas():
    """B5's multi-row shape: a Tq-8 tree verify tick over int8 pools of
    4-token blocks with per-block scales whose magnitudes differ by block,
    so the scalars change within one of the body's 64-key tiles. Row gate
    as ``tests/test_torch_q8.py`` holds q8q: each row within 1e-2 of its
    largest |out|, |dlse| within 1e-4."""
    rng = np.random.default_rng(8)
    Bq, Hkv, G, tq, D, blk, NBq, N = 2, 2, 2, 8, 16, 4, 24, 60
    kq, vq = (rng.integers(-127, 128, size=(N, Hkv, blk, D)).astype(np.int8)
              for _ in range(2))
    ks, vs = (np.exp(rng.standard_normal((N, Hkv))).astype(np.float32) * 0.01
              for _ in range(2))
    table = np.stack([rng.permutation(N)[:NBq] for _ in range(Bq)]
                     ).astype(np.int32)
    qo = np.array([NBq * blk - tq, 37], np.int32)
    q = rng.standard_normal((Bq, Hkv * G, tq, D)).astype(np.float32)
    tree = np.tril(rng.random((Bq, tq, tq)) < 0.5)
    tree[:, np.arange(tq), np.arange(tq)] = True
    tree[:, :, 0] = True
    ref = attention_pallas_decode_q8q(
        *(jnp.asarray(x) for x in (q, kq, vq, ks, vs)), causal=True,
        q_offset=jnp.asarray(qo), block_table=jnp.asarray(table),
        tree_mask=jnp.asarray(tree), interpret=True)
    o, l = cd.attention_cuda_decode_paged_q8q(
        *(torch.from_numpy(x) for x in (q, kq, vq, table, ks, vs)),
        q_offset=torch.from_numpy(qo), tree_mask=torch.from_numpy(tree))
    o = o.float().numpy()
    ro = np.asarray(jnp.asarray(ref[0], jnp.float32))
    rl = np.asarray(ref[1])
    assert np.all(np.abs(o - ro) <= 1e-2 * np.abs(ro).max(-1, keepdims=True))
    np.testing.assert_array_equal(np.isneginf(l.numpy()), np.isneginf(rl))
    np.testing.assert_allclose(l.numpy(), rl, atol=1e-4, rtol=0)


# -- on the card --------------------------------------------------------------

def _gate(a, b):
    """``chip_smoke.py``'s row gate: each query row's |dout| within 2e-2 of
    the row's largest plain |out|, the same empty rows, |dlse| <= 1e-3."""
    (o1, l1), (o2, l2) = a, b
    row = o2.float().abs().amax(-1, keepdim=True)
    fin = torch.isfinite(l2)
    return (bool(torch.all((o1.float() - o2.float()).abs() <= 2e-2 * row))
            and torch.equal(torch.isneginf(l1), torch.isneginf(l2))
            and float((l1[fin] - l2[fin]).abs().max()) <= 1e-3)


@pytest.mark.gpu
def test_multi_row_body_matches_plain_on_gpu():
    """B2's multi-row body on the card against its plain version: Tq 2, 8,
    28, 64, 127 at G 1 and 4, a tree mask (lower-triangular: bit-equal to
    the causal launch) and local_blocks, each launch counted on
    ``.tiled_launches``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode (the plain versions are tested above)")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    blk, nb, N = 64, 10, 96
    k, v = (torch.randn(N, 8, blk, 128, generator=g).to(dev, torch.bfloat16)
            for _ in range(2))
    table = torch.stack([torch.randperm(N, generator=g)[:nb]
                         for _ in range(4)]).to(dev, torch.int32)
    w = cd.attention_cuda_decode_paged
    for G in (1, 4):
        for tq in (2, 8, 28, 64, 127):
            q = torch.randn(4, 8 * G, tq, 128, generator=g).to(
                dev, torch.bfloat16)
            qo = torch.randint(0, nb * blk - tq, (4,), generator=g).to(
                dev, torch.int32)
            before = w.tiled_launches
            got = w(q, k, v, table, q_offset=qo)
            assert w.tiled_launches == before + 1
            assert _gate(got, cd.paged_decode_plain(q, k, v, table,
                                                    q_offset=qo)), (G, tq)
            if tq <= 32:
                tril = torch.tril(torch.ones(tq, tq, dtype=torch.bool,
                                             device=dev)).expand(4, tq, tq)
                t = w(q, k, v, table, q_offset=qo, tree_mask=tril)
                assert torch.equal(t[0], got[0]) and torch.equal(t[1], got[1])
    loc = torch.where(table < N // 2, table, -1).to(torch.int32)
    q = torch.randn(4, 8, 64, 128, generator=g).to(dev, torch.bfloat16)
    qo = torch.randint(0, nb * blk - 64, (4,), generator=g).to(dev,
                                                               torch.int32)
    got = w(q, k[:N // 2], v[:N // 2], loc, q_offset=qo, local_blocks=True,
            local_shards=2)
    assert _gate(got, cd.paged_decode_plain(q, k[:N // 2], v[:N // 2], loc,
                                            q_offset=qo, local_blocks=True))


@pytest.mark.gpu
def test_dkv_tensor_core_body_matches_plain_on_gpu():
    """B7's bf16 body on the card against its plain version under the row
    gate, causal and not, GQA, past its 64-row and 128-key tile edges."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode (the walk and the plain version are tested "
                    "above)")
    from tree_attention_tpu_torch.ops import cuda_attention

    g = torch.Generator().manual_seed(1)
    for D in (64, 128):
        for causal, Hq, Hkv, Tq, Tk, qo, ko in (
                (True, 8, 2, 130, 300, 170, 0), (False, 4, 4, 5, 300, 0, 0),
                (True, 4, 4, 256, 256, 0, 100)):
            q, do = (torch.randn(2, Hq, Tq, D, generator=g).to(
                "cuda", torch.bfloat16) for _ in range(2))
            k, v = (torch.randn(2, Hkv, Tk, D, generator=g).to(
                "cuda", torch.bfloat16) for _ in range(2))
            kw = dict(causal=causal, q_offset=qo, kv_offset=ko)
            lse_f, delta = cuda_bwd.bwd_residuals(
                *cuda_attention.fwd_plain(q, k, v, **kw), do)
            got = cuda_bwd.attention_cuda_dkv(q, k, v, do, lse_f, delta, **kw)
            want = cuda_bwd.dkv_plain(q, k, v, do, lse_f, delta, **kw)
            assert cuda_bwd.grad_rows_close(got, want, 2e-2)[0], (D, Tq)


@pytest.mark.gpu
def test_b1_multi_row_body_matches_plain_on_gpu():
    """B1 on the multi-row body against its plain version: GQA Tq 16 over a
    Tk that is not a multiple of 64, Tq 2, 5, 64, 127 at G 1 and 4, D 64
    and 128, causal and not, per-slot kv_offset with one slot's shard past
    its frontier ((0, -inf)), and a tree whose lower-triangular mask gives
    the causal launch bit for bit; each launch counted on
    ``.tiled_launches``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode (the plain versions are tested above)")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(2)
    w = cd.attention_cuda_decode
    for D in (64, 128):
        for G, tq, tk in ((4, 16, 4037), (1, 2, 640), (4, 5, 640),
                          (1, 64, 700), (4, 127, 700)):
            q = torch.randn(4, 8 * G, tq, D, generator=g).to(dev,
                                                            torch.bfloat16)
            k, v = (torch.randn(4, 8, tk, D, generator=g).to(
                dev, torch.bfloat16) for _ in range(2))
            ko = torch.tensor([0, 37, 900, 5], dtype=torch.int32, device=dev)
            qo = torch.tensor([tk - tq, 500, 700, 60], dtype=torch.int32,
                              device=dev)  # slot 2's shard is past it
            for kw in (dict(causal=True, q_offset=qo, kv_offset=ko),
                       dict(causal=False)):
                before = w.tiled_launches
                got = w(q, k, v, **kw)
                assert w.tiled_launches == before + 1
                assert _gate(got, cd.decode_plain(q, k, v, **kw)), (D, tq)
            if tq <= 32:
                tril = torch.tril(torch.ones(tq, tq, dtype=torch.bool,
                                             device=dev)).expand(4, tq, tq)
                kw = dict(causal=True, q_offset=qo, kv_offset=ko)
                a, t = w(q, k, v, **kw), w(q, k, v, tree_mask=tril, **kw)
                assert torch.equal(a[0], t[0]) and torch.equal(a[1], t[1])


@pytest.mark.gpu
def test_b5_multi_row_body_matches_plain_on_gpu():
    """B5 on the multi-row body against its plain version: chain and tree
    verify ticks at Tq 8 and 32 over 64- and 16-token blocks, per-block
    scales and channel scales; each launch counted on
    ``.tiled_launches``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode (the plain versions are tested above)")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(3)
    w = cd.attention_cuda_decode_paged_q8q
    for blk in (64, 16):
        nb, N = 640 // blk, 2 * 640 // blk
        kq, vq = (torch.randint(-127, 128, (N, 8, blk, 128), generator=g,
                                dtype=torch.int8).to(dev) for _ in range(2))
        scales = {
            "block": tuple((torch.rand(N, 8, generator=g) * 0.03 + 0.005
                            ).to(dev) for _ in range(2)),
            "channel": tuple((torch.rand(4, 8, 1, 128, generator=g) * 0.03
                              + 0.005).to(dev) for _ in range(2))}
        table = torch.stack([torch.randperm(N, generator=g)[:nb]
                             for _ in range(4)]).to(dev, torch.int32)
        for tq in (8, 32):
            q = torch.randn(4, 8, tq, 128, generator=g).to(dev,
                                                          torch.bfloat16)
            qo = torch.randint(0, 640 - tq, (4,), generator=g).to(
                dev, torch.int32)
            tree = torch.tril(torch.rand(4, tq, tq, generator=g) < 0.5)
            tree = (tree | torch.eye(tq, dtype=torch.bool)).to(dev)
            for ks, vs in scales.values():
                for tm in (None, tree):
                    before = w.tiled_launches
                    got = w(q, kq, vq, table, ks, vs, q_offset=qo,
                            tree_mask=tm)
                    assert w.tiled_launches == before + 1
                    assert _gate(got, cd.paged_decode_q8q_plain(
                        q, kq, vq, table, ks, vs, q_offset=qo,
                        tree_mask=tm)), (blk, tq)


@pytest.mark.gpu
def test_b4_multi_row_body_matches_plain_on_gpu():
    """B4 on the multi-row body against its plain version: GQA Tq 16 over
    a Tk that is not a multiple of 64, Tq 2, 5, 64, 127 at G 1 and 4, D 64
    and 128, causal with per-slot kv_offset (one slot's shard past its
    frontier: (0, -inf)) and not, and Tq-8 trees whose lower-triangular
    mask gives the causal launch bit for bit; each launch counted on
    ``.tiled_launches``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode (the plain versions are tested above)")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(4)
    w = cd.attention_cuda_decode_q8q
    for D in (64, 128):
        for G, tq, tk in ((4, 16, 4037), (1, 2, 640), (4, 5, 640),
                          (1, 64, 700), (4, 127, 700), (1, 8, 640)):
            q = torch.randn(4, 8 * G, tq, D, generator=g).to(dev,
                                                            torch.bfloat16)
            kq, vq, ks, vs = cd.quantize_kv_channelwise(*(
                torch.randn(4, 8, tk, D, generator=g).to(dev)
                for _ in range(2)))
            ko = torch.tensor([0, 37, 900, 5], dtype=torch.int32, device=dev)
            qo = torch.tensor([tk - tq, 500, 700, 60], dtype=torch.int32,
                              device=dev)  # slot 2's shard is past it
            for kw in (dict(causal=True, q_offset=qo, kv_offset=ko),
                       dict(causal=False)):
                before = w.tiled_launches
                got = w(q, kq, vq, ks, vs, **kw)
                assert w.tiled_launches == before + 1
                assert _gate(got, cd.decode_q8q_plain(q, kq, vq, ks, vs,
                                                      **kw)), (D, tq)
            if tq == 8:
                kw = dict(causal=True, q_offset=qo, kv_offset=ko)
                tril = torch.tril(torch.ones(8, 8, dtype=torch.bool,
                                             device=dev)).expand(4, 8, 8)
                a = w(q, kq, vq, ks, vs, **kw)
                t = w(q, kq, vq, ks, vs, tree_mask=tril, **kw)
                assert torch.equal(a[0], t[0]) and torch.equal(a[1], t[1])
                tree = torch.from_numpy(_draft_tree(
                    np.random.default_rng(D), 4, 8)).to(dev)
                assert _gate(w(q, kq, vq, ks, vs, tree_mask=tree, **kw),
                             cd.decode_q8q_plain(q, kq, vq, ks, vs,
                                                 tree_mask=tree, **kw))


@pytest.mark.gpu
def test_cast_multi_row_body_matches_plain_on_gpu():
    """The cast route over B1 and B2 on the multi-row body against its
    plain version: contiguous GQA Tq 16 and a Tq-8 tree over channel
    scales; paged Tq 8 and 64 over 64- and 16-token blocks with per-block
    and channel scales, and a Tq-8 tree; a 64-row chunk under
    ``local_blocks`` over two ranks, merged, against unsharded B2. Each
    launch counted on the wrapper's ``.cast_tiled_launches``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode (the plain versions are tested above)")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(5)
    b1, b2 = cd.attention_cuda_decode, cd.attention_cuda_decode_paged

    def counted(wr, fn):
        before = wr.cast_tiled_launches
        out = fn()
        assert wr.cast_tiled_launches == before + 1
        return out

    q = torch.randn(4, 32, 16, 128, generator=g).to(dev, torch.bfloat16)
    kq, vq, ks, vs = cd.quantize_kv_channelwise(*(
        torch.randn(4, 8, 4037, 128, generator=g).to(dev) for _ in range(2)))
    qo = torch.tensor([4021, 500, 3000, 60], dtype=torch.int32, device=dev)
    tree = torch.from_numpy(_draft_tree(np.random.default_rng(6), 4, 8)
                            ).to(dev)
    for qq, kw in ((q, dict(causal=True, q_offset=qo)),
                   (q[:, :8, :8], dict(causal=True, q_offset=qo,
                                       tree_mask=tree))):
        got = counted(b1, lambda: cd.attention_cuda_decode_q8(
            qq, kq, vq, ks, vs, **kw))
        assert _gate(got, cd.decode_q8_plain(qq, kq, vq, ks, vs, **kw))
    for blk in (64, 16):
        nb, N = 640 // blk, 2 * 640 // blk
        pk, pv = (torch.randint(-127, 128, (N, 8, blk, 128), generator=g,
                                dtype=torch.int8).to(dev) for _ in range(2))
        per_block = tuple((torch.rand(N, 8, generator=g) * 0.03 + 0.005
                           ).to(dev) for _ in range(2))
        channel = tuple((torch.rand(4, 8, 1, 128, generator=g) * 0.03
                         + 0.005).to(dev) for _ in range(2))
        table = torch.stack([torch.randperm(N, generator=g)[:nb]
                             for _ in range(4)]).to(dev, torch.int32)
        for tq in (8, 64):
            q = torch.randn(4, 8, tq, 128, generator=g).to(dev,
                                                          torch.bfloat16)
            qo = torch.randint(0, 640 - tq, (4,), generator=g).to(
                dev, torch.int32)
            for sc in (per_block, channel):
                for tm in ((None, tree) if tq == 8 else (None,)):
                    kw = dict(causal=True, q_offset=qo, block_table=table,
                              tree_mask=tm)
                    got = counted(b2, lambda: cd.attention_cuda_decode_q8(
                        q, pk, pv, *sc, **kw))
                    assert _gate(got, cd.decode_q8_plain(q, pk, pv, *sc,
                                                         **kw)), (blk, tq)
        # One 64-row chunk over two ranks' halves of the pool.
        parts = []
        for r in range(2):
            loc = table - r * (N // 2)
            loc = torch.where((loc >= 0) & (loc < N // 2), loc, -1).to(
                torch.int32)
            sl = slice(r * (N // 2), (r + 1) * (N // 2))
            parts.append(counted(b2, lambda: b2(
                q, pk[sl], pv[sl], loc, q_offset=qo,
                block_scales=tuple(x[sl] for x in per_block),
                local_blocks=True, local_shards=2)))
        merged = merge_partials(torch.stack([o.float() for o, _ in parts]),
                                torch.stack([l for _, l in parts]))
        assert _gate(merged, b2(q, pk, pv, table, q_offset=qo,
                                block_scales=per_block))


@pytest.mark.gpu
def test_tick_body_matches_plain_on_gpu():
    """The tick body (one packed row through a block table) on the card
    against its plain version: B2 bf16, the cast route with per-block
    scales, B5 with per-block and with channel scales, at D 64 and 128 over
    16- and 64-token blocks, ragged slots (one with no visible key); B2
    under local_blocks over two ranks, merged, against unsharded B2. Each
    launch counts on ``.tick_launches``; NaN written into the keys past
    each slot's frontier inside its last block changes nothing, bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode (the geometry and the merge are tested above)")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(7)
    b2, b5 = cd.attention_cuda_decode_paged, cd.attention_cuda_decode_paged_q8q

    def counted(w, fn):
        before = w.tick_launches
        out = fn()
        assert w.tick_launches == before + 1
        return out

    qo = torch.tensor([639, 130, -1, 191], dtype=torch.int32, device=dev)
    for D in (64, 128):
        for blk in (16, 64):
            nb = 640 // blk
            N = 4 * nb  # the slots' blocks are disjoint
            k, v = (torch.randn(N, 8, blk, D, generator=g).to(
                dev, torch.bfloat16) for _ in range(2))
            kq, vq = (torch.randint(-127, 128, (N, 8, blk, D), generator=g,
                                    dtype=torch.int8).to(dev)
                      for _ in range(2))
            per_block = tuple((torch.rand(N, 8, generator=g) * 0.03 + 0.005
                               ).to(dev) for _ in range(2))
            channel = tuple((torch.rand(4, 8, 1, D, generator=g) * 0.03
                             + 0.005).to(dev) for _ in range(2))
            table = torch.randperm(N, generator=g).reshape(4, nb).to(
                dev, torch.int32)
            q = torch.randn(4, 8, 1, D, generator=g).to(dev, torch.bfloat16)
            got = counted(b2, lambda: b2(q, k, v, table, q_offset=qo))
            assert _gate(got, cd.paged_decode_plain(q, k, v, table,
                                                    q_offset=qo)), (D, blk)
            kn, vn = k.clone(), v.clone()
            for b, o in enumerate(qo.tolist()):
                j1 = o + 1
                if j1 > 0 and j1 % blk:
                    pb = int(table[b, j1 // blk])
                    kn[pb, :, j1 % blk:] = torch.nan
                    vn[pb, :, j1 % blk:] = torch.nan
            nan = b2(q, kn, vn, table, q_offset=qo)
            assert torch.equal(nan[0], got[0]) and torch.equal(nan[1], got[1])
            got = counted(b2, lambda: b2(q, kq, vq, table, q_offset=qo,
                                         block_scales=per_block))
            assert _gate(got, cd.paged_decode_plain(
                q, kq, vq, table, q_offset=qo, block_scales=per_block))
            for ks, vs in (per_block, channel):
                got = counted(b5, lambda: b5(q, kq, vq, table, ks, vs,
                                             q_offset=qo))
                assert _gate(got, cd.paged_decode_q8q_plain(
                    q, kq, vq, table, ks, vs, q_offset=qo)), (D, blk)
            parts = []
            for r in range(2):
                loc = table - r * (N // 2)
                loc = torch.where((loc >= 0) & (loc < N // 2), loc, -1).to(
                    torch.int32)
                sl = slice(r * (N // 2), (r + 1) * (N // 2))
                parts.append(counted(b2, lambda: b2(
                    q, k[sl], v[sl], loc, q_offset=qo, local_blocks=True,
                    local_shards=2)))
            merged = merge_partials(torch.stack([o.float() for o, _ in parts]),
                                    torch.stack([l for _, l in parts]))
            assert _gate(merged, b2(q, k, v, table, q_offset=qo))


def test_cpu_tree_calls_count_no_tree_launch():
    """Each decode wrapper keeps its own ``.tree_tq`` (the ``tree``
    variant's launches by Tq, beside ``.tree_launches``); a CPU call with a
    tree mask counts on neither and equals the plain version."""
    rng = np.random.default_rng(2)
    wrappers = (cd.attention_cuda_decode, cd.attention_cuda_decode_paged,
                cd.attention_cuda_decode_q8q,
                cd.attention_cuda_decode_paged_q8q)
    assert len({id(w.tree_tq) for w in wrappers}) == len(wrappers)
    assert all(isinstance(w.tree_tq, dict) for w in wrappers)
    q = torch.from_numpy(rng.standard_normal((2, 4, 8, 16), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 2, 40, 16),
                                                 np.float32))
            for _ in range(2))
    # Two branches of four rows each, every row seeing its own ancestors.
    mask = torch.zeros((2, 8, 8), dtype=torch.bool)
    for r in (0, 4):
        mask[:, r:r + 4, r:r + 4] = torch.tril(torch.ones(4, 4,
                                                          dtype=torch.bool))
    qo = torch.tensor([30, 11], dtype=torch.int32)
    b1 = cd.attention_cuda_decode
    before = (b1.launches, b1.tree_launches, dict(b1.tree_tq))
    got = b1(q, k, v, causal=True, q_offset=qo, tree_mask=mask)
    want = cd.decode_plain(q, k, v, causal=True, q_offset=qo,
                           tree_mask=mask)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (b1.launches, b1.tree_launches, dict(b1.tree_tq)) == before
