"""The tree-mask variants of the port's decode kernels, and the model step
of speculative tree verification, against the JAX package's (CPU).

- **Ops**: the plain versions of B1, B2, B4, B5 and the cast route with a
  ``tree_mask`` (the kernel wrappers run them for CPU tensors) against
  ``attention_pallas_decode`` / ``_q8q`` / ``_q8`` in interpret mode, and
  ``attention_packed`` against ``attention_blockwise(tree_mask=)``; Tq 32
  with a mask that sets bit 31, GQA, per-slot offsets, a window across a
  paged block boundary. Tolerances: f32 out and lse within 2e-5 (both sides
  exact f32; only the order of the online-softmax sums differs); the int8
  routes each query row's out within 1e-2 of its largest |out| and lse
  within 1e-4 (P and the output round to bf16 on both sides, as in
  ``test_torch_q8.py``). A lower-triangular mask equals the causal call bit
  for bit. ``tree_bits_rows`` equals JAX's ``_tree_bits_rows`` (lane 0).
- **Model**: ``forward_step(positions=, tree_mask=)`` logits and written KV
  against JAX's on the four cache layouts (the dtype tiers of
  ``test_torch_models.py`` and ``test_torch_int8_serving.py``), the tree
  rows equal to each root path decoded one token at a time, and
  ``compact_decode_window`` bit-equal to JAX's on the four layouts.
- **Sampling**: ``sample_rows`` keyed by ``(key, stream index)``.
- The tree kernels on the card (``@pytest.mark.gpu``; skipped here).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tree_attention_tpu import models as jm
from tree_attention_tpu.models import decode as jdec
from tree_attention_tpu.ops import pallas_decode as jpd
from tree_attention_tpu.ops.reference import attention_blockwise

from tree_attention_tpu_torch import models as tm
from tree_attention_tpu_torch.ops import cuda_decode as cd
from tree_attention_tpu_torch.ops.decode import flash_decode
from tree_attention_tpu_torch.ops.reference import attention_packed
from tree_attention_tpu_torch.serving import speculation as tspec
from tests.torch_params import seeded_params
from tests.torch_threads import few_torch_threads  # noqa: F401

TOL_F32 = 2e-5
TOL_OUT_ROW, TOL_LSE_Q8 = 1e-2, 1e-4


def random_tree_mask(rng, B, Tq, chain_slot=None):
    """Ancestor-closed masks of random topological trees (each row sees
    itself and its parent's ancestors), as ``pack_proposal`` builds them;
    slot ``chain_slot`` gets a plain chain."""
    anc = np.zeros((B, Tq, Tq), bool)
    for b in range(B):
        parents = [-1] + [i - 1 if b == chain_slot
                          else int(rng.integers(-1, i))
                          for i in range(1, Tq)]
        for i in range(Tq):
            anc[b, i, i] = True
            if parents[i] >= 0:
                anc[b, i] |= anc[b, parents[i]]
    return anc


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _close_f32(port, ref):
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL_F32,
                                   rtol=0)


def _close_rows(port, ref):
    """Each query row's |dout| within TOL_OUT_ROW of its largest |out|, the
    same empty rows, |dlse| within TOL_LSE_Q8."""
    (o, l), (ro, rl) = port, ref
    o = o.float().numpy()
    ro = np.asarray(jnp.asarray(ro, jnp.float32))
    rl = np.asarray(rl)
    row = np.abs(ro).max(-1, keepdims=True)
    assert np.all(np.abs(o - ro) <= TOL_OUT_ROW * row + 1e-30)
    np.testing.assert_array_equal(np.isneginf(l.numpy()), np.isneginf(rl))
    fin = np.isfinite(rl)
    np.testing.assert_allclose(l.numpy()[fin], rl[fin], atol=TOL_LSE_Q8,
                               rtol=0)


# -- ops ---------------------------------------------------------------------

# (B, Hq, Hkv, Tq, Tk): a spec tick's 8 rows under MHA; the 32-row cap with
# GQA (bit 31 set in every row that sees row 31).
CONTIG = {"mha-tq8": (2, 4, 4, 8, 96), "gqa-tq32": (2, 4, 2, 32, 96)}


def _contig_case(name, seed):
    B, Hq, Hkv, Tq, Tk = CONTIG[name]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Tq, 16)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Tk, 16)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Tk, 16)).astype(np.float32)
    qoff = np.array([10, Tk - Tq][:B], np.int32)
    tree = random_tree_mask(rng, B, Tq, chain_slot=0)
    tree[-1, -1] = True  # the last row sees every window row: bit 31 at 32
    return q, k, v, qoff, tree


@pytest.mark.parametrize("case", sorted(CONTIG))
def test_tree_bits_rows_match_jax(case):
    q, _, _, _, tree = _contig_case(case, 0)
    B, Hq, Tq, _ = q.shape
    Hkv = CONTIG[case][2]
    G = Hq // Hkv
    bq = -(-G * Tq // 8) * 8
    ref = np.asarray(jpd._tree_bits_rows(jnp.asarray(tree), G, Hkv, bq, 1))
    got = cd.tree_bits_rows(torch.from_numpy(tree), G, Hkv)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref[:, :G * Tq, 0])
    if Tq == 32:
        assert (got.numpy() < 0).any()  # bit 31 survives as the sign bit


@pytest.mark.parametrize("case", sorted(CONTIG))
def test_b1_tree_plain_matches_pallas(case):
    q, k, v, qoff, tree = _contig_case(case, 1)
    ref = jpd.attention_pallas_decode(
        *_j(q, k, v), causal=True, q_offset=jnp.asarray(qoff),
        tree_mask=jnp.asarray(tree), interpret=True)
    port = cd.attention_cuda_decode(*_t(q, k, v), causal=True,
                                    q_offset=torch.from_numpy(qoff),
                                    tree_mask=torch.from_numpy(tree))
    _close_f32(port, ref)
    # flash_decode routes a tree mask to B1 and agrees with the oracle.
    fd = flash_decode(*_t(q, k, v), q_position=torch.from_numpy(qoff),
                      tree_mask=torch.from_numpy(tree))
    assert all(torch.equal(a, b) for a, b in zip(fd, port))


def test_packed_tree_matches_blockwise_oracle():
    q, k, v, qoff, tree = _contig_case("gqa-tq32", 2)
    port = attention_packed(*_t(q, k, v), causal=True, scale=None,
                            q_offset=torch.from_numpy(qoff), kv_offset=0,
                            tree_mask=torch.from_numpy(tree))
    for b in range(q.shape[0]):
        o, l = attention_blockwise(
            *_j(q[b:b + 1], k[b:b + 1], v[b:b + 1]), causal=True,
            q_offset=int(qoff[b]), block_size=32,
            tree_mask=jnp.asarray(tree[b:b + 1]))
        _close_f32((port[0][b:b + 1], port[1][b:b + 1]), (o, l))


def _paged_case(seed, Tq=8, B=3, Hq=4, Hkv=2, N=14, NB=5, blk=8):
    """Fragmented tables, per-slot offsets whose window straddles a block
    boundary (slot 0) and ends at the last table entry (slot 1)."""
    rng = np.random.default_rng(seed)
    kf = rng.standard_normal((N, Hkv, blk, 16)).astype(np.float32)
    vf = rng.standard_normal((N, Hkv, blk, 16)).astype(np.float32)
    table = np.stack([rng.permutation(N)[:NB] for _ in range(B)]).astype(
        np.int32)
    qoff = np.array([blk * 2 - 3, NB * blk - Tq, 5], np.int32)[:B]
    q = rng.standard_normal((B, Hq, Tq, 16)).astype(np.float32)
    tree = random_tree_mask(rng, B, Tq, chain_slot=2)
    return q, kf, vf, table, qoff, tree


def test_b2_tree_plain_matches_pallas_paged():
    q, kf, vf, table, qoff, tree = _paged_case(3)
    ref = jpd.attention_pallas_decode(
        *_j(q, kf, vf), causal=True, q_offset=jnp.asarray(qoff),
        block_table=jnp.asarray(table), tree_mask=jnp.asarray(tree),
        interpret=True)
    port = cd.attention_cuda_decode_paged(
        *_t(q, kf, vf, table), q_offset=torch.from_numpy(qoff),
        tree_mask=torch.from_numpy(tree))
    _close_f32(port, ref)


def _q8_pools(seed, N=14, Hkv=2, blk=8):
    rng = np.random.default_rng(seed)
    kq = rng.integers(-127, 128, size=(N, Hkv, blk, 16)).astype(np.int8)
    vq = rng.integers(-127, 128, size=(N, Hkv, blk, 16)).astype(np.int8)
    ks = rng.uniform(0.005, 0.03, size=(N, Hkv)).astype(np.float32)
    vs = rng.uniform(0.005, 0.03, size=(N, Hkv)).astype(np.float32)
    return kq, vq, ks, vs


@pytest.mark.parametrize("route", ["q8q", "q8"])
def test_b5_and_cast_b2_tree_match_pallas_paged(route):
    q, _, _, table, qoff, tree = _paged_case(4)
    kq, vq, ks, vs = _q8_pools(5)
    jfn = (jpd.attention_pallas_decode_q8q if route == "q8q"
           else jpd.attention_pallas_decode_q8)
    ref = jfn(*_j(q, kq, vq, ks, vs), causal=True,
              q_offset=jnp.asarray(qoff), block_table=jnp.asarray(table),
              tree_mask=jnp.asarray(tree), interpret=True)
    port = cd.resolve_q8_kernel(route)(
        *_t(q, kq, vq, ks, vs), causal=True,
        q_offset=torch.from_numpy(qoff), block_table=_t(table)[0],
        tree_mask=torch.from_numpy(tree))
    _close_rows(port, ref)


@pytest.mark.parametrize("route", ["q8q", "q8"])
def test_b4_and_cast_b1_tree_match_pallas(route):
    q, k, v, qoff, tree = _contig_case("gqa-tq32", 6)
    kq, vq, ks, vs = cd.quantize_kv_channelwise(*_t(k, v))
    jfn = (jpd.attention_pallas_decode_q8q if route == "q8q"
           else jpd.attention_pallas_decode_q8)
    ref = jfn(*_j(q, kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy()),
              causal=True, q_offset=jnp.asarray(qoff), block_size=32,
              tree_mask=jnp.asarray(tree), interpret=True)
    port = cd.resolve_q8_kernel(route)(
        *_t(q), kq, vq, ks, vs, causal=True,
        q_offset=torch.from_numpy(qoff), tree_mask=torch.from_numpy(tree))
    _close_rows(port, ref)


def test_tril_tree_is_causal_bit_for_bit():
    """A lower-triangular mask is the causal rule: every wrapper (its plain
    version here) gives the causal call's out and lse bit for bit."""
    q, k, v, qoff, _ = _contig_case("gqa-tq32", 7)
    B, _, Tq, _ = q.shape
    tril = torch.from_numpy(np.broadcast_to(np.tril(np.ones((Tq, Tq), bool)),
                                            (B, Tq, Tq)).copy())
    tq, tk, tv, to = _t(q, k, v, qoff)
    kq, vq, ks, vs = cd.quantize_kv_channelwise(tk, tv)
    pq, pkf, pvf, table, poff, _ = _paged_case(8, Tq=Tq, B=B)
    pkq, pvq, pks, pvs = _q8_pools(9)
    ptq, ptk, ptv, ptt, pto = _t(pq, pkf, pvf, table, poff)
    calls = {
        "B1": lambda **kw: cd.attention_cuda_decode(tq, tk, tv, causal=True,
                                                    q_offset=to, **kw),
        "B2": lambda **kw: cd.attention_cuda_decode_paged(
            ptq, ptk, ptv, ptt, q_offset=pto, **kw),
        "B4": lambda **kw: cd.attention_cuda_decode_q8q(
            tq, kq, vq, ks, vs, causal=True, q_offset=to, **kw),
        "B5": lambda **kw: cd.attention_cuda_decode_paged_q8q(
            ptq, *_t(pkq, pvq), ptt, *_t(pks, pvs), q_offset=pto, **kw),
    }
    for name, fn in calls.items():
        causal, tree = fn(), fn(tree_mask=tril)
        assert torch.equal(causal[0], tree[0]), name
        assert torch.equal(causal[1], tree[1]), name


def test_tree_mask_refusals():
    q, k, v, qoff, tree = _contig_case("mha-tq8", 10)
    tq, tk, tv, to, tt = _t(q, k, v, qoff, tree)
    with pytest.raises(ValueError, match="requires causal"):
        cd.attention_cuda_decode(tq, tk, tv, q_offset=to, tree_mask=tt)
    with pytest.raises(ValueError, match=r"must be \(B, Tq, Tq\)"):
        cd.attention_cuda_decode(tq, tk, tv, causal=True, q_offset=to,
                                 tree_mask=tt[:, :4, :4])
    wide = torch.ones((2, 4, 33, 16))
    with pytest.raises(ValueError, match="exceeds 32"):
        cd.attention_cuda_decode(wide, tk, tv, causal=True, q_offset=to,
                                 tree_mask=torch.ones((2, 33, 33), dtype=torch.bool))
    with pytest.raises(ValueError, match="exceeds 32"):
        flash_decode(wide, tk, tv, q_position=to,
                     tree_mask=torch.ones((2, 33, 33), dtype=torch.bool))
    with pytest.raises(ValueError, match="per-slot"):
        flash_decode(tq, tk, tv, q_position=3, tree_mask=tt)
    with pytest.raises(ValueError, match="local_blocks"):
        cd.attention_cuda_decode_paged(
            tq, tk[0], tv[0], torch.zeros((2, 1), dtype=torch.int32),
            q_offset=to, local_blocks=True, tree_mask=tt)


# -- model -------------------------------------------------------------------

CFG = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_head=16, d_ff=192)
J_CFG = jm.TransformerConfig(**CFG, dtype=jnp.float32)
T_CFG = tm.TransformerConfig(**CFG, dtype=torch.float32)
L, HKV, D = 2, 2, 16


@pytest.fixture(scope="module")
def params():
    return seeded_params(T_CFG)


def _caches(layout, seed):
    """The same cache in both packages: 3 slots at lengths 7, 4, 11, random
    KV (int8 codes and scales for the int8 layouts), fragmented tables."""
    rng = np.random.default_rng(seed)
    length = np.array([7, 4, 11], np.int32)
    int8 = layout.endswith("int8")

    def own(x):
        # The port's tensors get their own buffers: ``jnp.asarray`` may
        # alias a numpy array (it does for int8 on the CPU), and the port's
        # in-place writes must not reach an input JAX has yet to read.
        return torch.from_numpy(x.copy())

    def data(shape):
        if int8:
            return rng.integers(-60, 61, size=shape).astype(np.int8)
        return rng.standard_normal(shape).astype(np.float32)

    if layout.startswith("contiguous"):
        T = 32
        k, v = data((L, 3, HKV, T, D)), data((L, 3, HKV, T, D))
        if not int8:
            return (jm.KVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                               length=jnp.asarray(length)),
                    tm.KVCache(k=own(k), v=own(v),
                               length=own(length)))
        ks = rng.uniform(0.01, 0.05, (L, 3, HKV, 1, D)).astype(np.float32)
        vs = rng.uniform(0.01, 0.05, (L, 3, HKV, 1, D)).astype(np.float32)
        return (jm.QuantKVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                                k_scale=jnp.asarray(ks),
                                v_scale=jnp.asarray(vs),
                                length=jnp.asarray(length)),
                tm.QuantKVCache(k=own(k), v=own(v),
                                k_scale=own(ks),
                                v_scale=own(vs),
                                length=own(length)))
    # Fragmented tables; distinct slots never share a block.
    N, blk = 18, 4
    table = rng.permutation(N).reshape(3, 6).astype(np.int32)
    k, v = data((L, N, HKV, blk, D)), data((L, N, HKV, blk, D))

    def drop(x):  # the port's pools carry one drop block at index N
        return torch.from_numpy(np.concatenate(
            [x, np.zeros_like(x[:, :1])], axis=1))

    if not int8:
        return (jm.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                                table=jnp.asarray(table),
                                length=jnp.asarray(length)),
                tm.PagedKVCache(k=drop(k), v=drop(v),
                                table=own(table),
                                length=own(length)))
    ks = rng.uniform(0.01, 0.05, size=(L, N, HKV)).astype(np.float32)
    vs = rng.uniform(0.01, 0.05, size=(L, N, HKV)).astype(np.float32)
    return (jm.PagedQuantKVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                                 k_scale=jnp.asarray(ks),
                                 v_scale=jnp.asarray(vs),
                                 table=jnp.asarray(table),
                                 length=jnp.asarray(length)),
            tm.PagedQuantKVCache(k=drop(k), v=drop(v), k_scale=drop(ks),
                                 v_scale=drop(vs),
                                 table=own(table),
                                 length=own(length)))


def _tree_step_inputs(rng, Tq=6):
    """Three slots' verify windows: a tree, a chain, a 4-row tree padded to
    Tq (its pad rows ride the lower-triangular default)."""
    toks = rng.integers(0, 256, (3, Tq)).astype(np.int32)
    depth = np.tile(np.arange(Tq, dtype=np.int32), (3, 1))
    mask = np.broadcast_to(np.tril(np.ones((Tq, Tq), bool)),
                           (3, Tq, Tq)).copy()
    for b, parents in ((0, [-1, 0, 0, 1, 1, 2]), (2, [-1, 0, 0, 2])):
        pack = tspec.pack_proposal(0, tspec.DraftProposal(
            np.zeros(len(parents) - 1, np.int32),
            np.asarray(parents[1:]) - 1))
        depth[b, :pack.rows] = pack.depth
        mask[b, :pack.rows, :pack.rows] = pack.anc
    n = np.array([Tq, Tq, 4], np.int32)
    return toks, depth, mask, n


def _kv_of(cache, paged):
    if paged:
        n = cache.blocks
        return [x[:, :n].numpy() for x in (cache.k, cache.v)]
    return [cache.k.numpy(), cache.v.numpy()]


LAYOUTS = ["contiguous", "paged", "contiguous-int8", "paged-int8"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_forward_step_tree_matches_jax(params, layout):
    """One tree verify step (positions = length + depth, the ancestor mask)
    on the same cache in both packages: the valid rows' logits (exact
    layouts as in ``test_torch_models.py``, 2e-4; int8 as in
    ``test_torch_int8_serving.py``: 1e-3 contiguous, the q8q output
    rounding to bf16, and 1e-5 paged, both over the dequantized view) and
    the written KV (f32 within 1e-5; int8 codes equal but for a bounded few
    one step apart)."""
    jp, tp = params
    jc, tc = _caches(layout, 11)
    toks, depth, mask, n = _tree_step_inputs(np.random.default_rng(12))
    length = np.asarray(jc.length)
    jl, jc = jax.jit(jm.forward_step, static_argnums=3)(
        jp, jnp.asarray(toks), jc, J_CFG, n_tokens=jnp.asarray(n),
        positions=jnp.asarray(length[:, None] + depth),
        tree_mask=jnp.asarray(mask))
    tl, tc = tm.forward_step(
        tp, torch.from_numpy(toks), tc, T_CFG, n_tokens=torch.from_numpy(n),
        positions=torch.from_numpy(length[:, None] + depth),
        tree_mask=torch.from_numpy(mask))
    valid = np.arange(toks.shape[1])[None] < n[:, None]
    tol = {"contiguous": 2e-4, "paged": 2e-4, "contiguous-int8": 1e-3,
           "paged-int8": 1e-5}[layout]
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid],
                               atol=tol, rtol=1e-4 if tol > 1e-4 else 1e-5)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    paged = layout.startswith("paged")
    for got, want in zip(_kv_of(tc, paged), (np.asarray(jc.k),
                                             np.asarray(jc.v))):
        if layout.endswith("int8"):
            d = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert d.max() <= 1 and int((d == 1).sum()) <= 4
        else:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    if layout == "paged-int8":
        for name in ("k_scale", "v_scale"):
            np.testing.assert_array_equal(
                getattr(tc, name)[:, :tc.blocks].numpy(),
                np.asarray(getattr(jc, name)))


def _clone(cache):
    return dataclasses.replace(cache, **{
        f.name: getattr(cache, f.name).clone()
        for f in dataclasses.fields(cache)})


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_forward_step_tree_rows_equal_per_path_sequential(params, layout):
    """A packed tree's logits row j equals a decode of j's root path, one
    step per token, from the same prefilled cache (the port's steps write
    in place: each replay runs on a clone)."""
    _, tp = params
    prompt = torch.arange(7, dtype=torch.int64)[None] * 5 + 3
    toks = np.array([5, 11, 23, 7, 9, 23], np.int32)
    par = np.array([-1, 0, 0, 1, 1, 2], np.int32)
    pack = tspec.pack_proposal(int(toks[0]), tspec.DraftProposal(
        toks[1:], par[1:] - 1))
    if layout == "contiguous":
        base = tm.init_cache(T_CFG, 1, 32, device="cpu")
    else:
        base = tm.init_paged_cache(T_CFG, 1, 32, 10, block=4, device="cpu")
        base.table.copy_(torch.tensor([[7, 2, 9, 0, 5, 1, 8, 3]],
                                      dtype=torch.int32))
    _, base = tm.forward_step(tp, prompt, base, T_CFG)
    logits, _ = tm.forward_step(
        tp, torch.from_numpy(pack.row_tokens)[None], _clone(base), T_CFG,
        positions=torch.from_numpy(7 + pack.depth)[None],
        tree_mask=torch.from_numpy(pack.anc)[None])
    for i in range(pack.rows):
        path, j = [], i
        while j >= 0:
            path.append(j)
            j = int(pack.row_parents[j])
        cache = _clone(base)
        for r in path[::-1]:
            lr, cache = tm.forward_step(
                tp, torch.tensor([[int(pack.row_tokens[r])]]), cache, T_CFG)
        np.testing.assert_allclose(lr[0, -1].numpy(), logits[0, i].numpy(),
                                   atol=2e-4)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_compact_decode_window_matches_jax(layout):
    """The same cache and the same commit in both packages: the buffers
    after the compaction are bit-equal (rows move verbatim), a slot with
    ``n = 0`` is untouched, and a contiguous window straddling capacity
    shifts as JAX's does. Scales never move."""
    jc, tc = _caches(layout, 13)
    W = 6
    cap = tc.k.shape[3] if layout.startswith("contiguous") else \
        tc.table.shape[1] * tc.block
    start = np.array([3, 9, cap - 4], np.int32)
    src = np.tile(np.arange(W, dtype=np.int32), (3, 1))
    src[0, 1:4] = [2, 4, 5]
    src[2, 1:3] = [2, 3]
    n = np.array([4, 0, 3], np.int32)
    before = [x.clone() for x in (tc.k, tc.v)]
    jout = jax.jit(jdec.compact_decode_window)(
        jc, jnp.asarray(start), jnp.asarray(src), jnp.asarray(n))
    tout = tm.compact_decode_window(tc, *_t(start, src, n))
    paged = layout.startswith("paged")
    for got, want in zip(_kv_of(tout, paged), (np.asarray(jout.k),
                                               np.asarray(jout.v))):
        np.testing.assert_array_equal(got, want)
    if not paged:
        for a, b in zip(before, (tout.k, tout.v)):
            assert torch.equal(a[:, 1], b[:, 1])  # n = 0: bit-identical
    if layout.endswith("int8"):
        np.testing.assert_array_equal(
            tout.k_scale[:, :np.asarray(jc.k_scale).shape[1]].numpy(),
            np.asarray(jout.k_scale))


# -- sampling ----------------------------------------------------------------

def test_sample_rows_keyed_by_stream_index():
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(3, 4, 50, generator=g)
    temp = np.array([0.0, 1.0, 0.7], np.float32)
    topk = np.array([0, 0, 5], np.int32)
    keys = [11, 12, 13]
    idx = np.arange(4)[None].repeat(3, 0) + np.array([[0], [2], [5]])
    rows = np.ones((3, 4), bool)
    tok, lp = tm.sample_rows(logits, temp, topk, keys, idx, rows)
    assert torch.equal(tok[0], logits[0].argmax(-1).int())  # greedy slot
    # A draw depends on (key, index) only: row 2 of slot 1 drawn alone, as
    # the one-row case, gives the same token.
    one, _ = tm.sample_slots(logits[:, 2], temp, topk, keys, idx[:, 2],
                             np.ones(3, bool))
    assert torch.equal(one, tok[:, 2])
    again, _ = tm.sample_rows(logits, temp, topk, keys, idx, rows)
    assert torch.equal(again, tok)
    # top-k 5 keeps every draw among the 5 largest logits.
    top5 = logits[2].topk(5, -1).indices
    assert all(int(t) in top5[j].tolist() for j, t in enumerate(tok[2]))
    np.testing.assert_allclose(
        lp.numpy(), torch.log_softmax(logits, -1).gather(
            -1, tok.long()[..., None])[..., 0].numpy(), rtol=0, atol=0)
    assert tm.fold_in(11, 2) != tm.fold_in(11, 3) != tm.fold_in(12, 2)


# -- on the card -------------------------------------------------------------

@pytest.mark.gpu
def test_tree_kernels_match_plain_on_gpu():
    """B1, B2, B4 and B5 with a tree mask on the card against their plain
    versions (bf16; each query row within 2e-2 of its largest |out|, lse
    within 1e-3), and a lower-triangular mask bit-equal to the causal
    launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode (the plain versions are tested above)")
    g = torch.Generator().manual_seed(0)

    def rnd(*s):
        return torch.randn(*s, generator=g).to("cuda", torch.bfloat16)

    def close(a, b):
        row = b[0].float().abs().amax(-1, keepdim=True)
        assert bool(((a[0].float() - b[0].float()).abs()
                     <= 2e-2 * row).all())
        torch.testing.assert_close(a[1], b[1], atol=1e-3, rtol=0)

    tree = torch.from_numpy(random_tree_mask(np.random.default_rng(0), 3,
                                             32, chain_slot=1)).cuda()
    tril = torch.tril(torch.ones(32, 32, dtype=torch.bool)).expand(
        3, 32, 32).cuda()
    q = rnd(3, 8, 32, 128)
    k, v = rnd(3, 2, 300, 128), rnd(3, 2, 300, 128)
    qo = torch.tensor([0, 100, 268], dtype=torch.int32, device="cuda")
    kq, vq, ks, vs = cd.quantize_kv_channelwise(k, v)
    pk, pv = rnd(30, 2, 16, 128), rnd(30, 2, 16, 128)
    table = torch.stack([torch.randperm(30, generator=g)[:8]
                         for _ in range(3)]).to("cuda", torch.int32)
    pqo = qo.clamp(max=96)
    pkq, pvq, pks, pvs = (torch.randint(-127, 128, (30, 2, 16, 128),
                                        generator=g, dtype=torch.int8).cuda(),
                          torch.randint(-127, 128, (30, 2, 16, 128),
                                        generator=g, dtype=torch.int8).cuda(),
                          torch.rand(30, 2, generator=g).cuda() * 0.02 + 0.005,
                          torch.rand(30, 2, generator=g).cuda() * 0.02 + 0.005)
    calls = [
        (cd.attention_cuda_decode, cd.decode_plain, (q, k, v),
         dict(causal=True, q_offset=qo)),
        (cd.attention_cuda_decode_paged, cd.paged_decode_plain,
         (q, pk, pv, table), dict(q_offset=pqo)),
        (cd.attention_cuda_decode_q8q, cd.decode_q8q_plain,
         (q, kq, vq, ks, vs), dict(causal=True, q_offset=qo)),
        (cd.attention_cuda_decode_paged_q8q, cd.paged_decode_q8q_plain,
         (q, pkq, pvq, table, pks, pvs), dict(q_offset=pqo)),
    ]
    for kernel, plain, args, kw in calls:
        close(kernel(*args, tree_mask=tree, **kw),
              plain(*args, tree_mask=tree, **kw))
        a, b = kernel(*args, **kw), kernel(*args, tree_mask=tril, **kw)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
