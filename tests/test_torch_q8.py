"""The port's int8 KV numerics against the JAX package's (CPU).

- **Quantizers**: ``quantize_symmetric_int8``, ``quantize_kv_channelwise``,
  ``quantize_cache``, ``_quantize_rows`` and ``quantize_paged_blocks`` give
  the same int8 bytes and f32 scales as JAX, zero channels and zero blocks
  (the 1.0 fallback) included. Everything downstream depends on that.
- **q8q** (kernels B4, B5): the plain versions against
  ``attention_pallas_decode_q8q`` in interpret mode, with equal quantized Q
  codes. Tolerance: out within 1e-2 of each query row's largest |out| (P is
  rounded to bf16 on both sides, against running maxima that differ between
  the TPU kernel's tiles and the plain version's one pass, and the output is
  bf16: about one bf16 ulp of the row), lse within 1e-4 (the int8 scores
  are exact on both sides; only exp/log and summation order differ).
- **Cast route** (q8, over B1/B2): against ``attention_pallas_decode_q8``
  under the same tolerance.
- **Paged equals contiguous**: plain B5 over a pool equals plain B4 over the
  gathered view, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tree_attention_tpu.models import decode as jdec
from tree_attention_tpu.ops import pallas_decode as jpd

from tree_attention_tpu_torch.models import decode as tdec
from tree_attention_tpu_torch.ops import cuda_decode as cd
from tests.torch_threads import few_torch_threads  # noqa: F401

TOL_OUT_ROW, TOL_LSE = 1e-2, 1e-4


def _rng(seed):
    return np.random.default_rng(seed)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if hasattr(x, "dtype") \
        and x.dtype == jnp.bfloat16 else np.asarray(x)


def _close_rows(port, ref):
    """Each query row's |dout| within TOL_OUT_ROW of that row's largest
    |out|, the same empty rows, |dlse| within TOL_LSE."""
    (o, l), (ro, rl) = port, ref
    o = o.float().numpy()
    ro = _np(ro).astype(np.float32)
    rl = np.asarray(rl)
    assert o.shape == ro.shape
    row = np.abs(ro).max(-1, keepdims=True)
    assert np.all(np.abs(o - ro) <= TOL_OUT_ROW * row + 1e-30)
    np.testing.assert_array_equal(np.isneginf(l.numpy()), np.isneginf(rl))
    fin = np.isfinite(rl)
    np.testing.assert_allclose(l.numpy()[fin], rl[fin], atol=TOL_LSE,
                               rtol=0)


# -- quantizers --------------------------------------------------------------

def test_quantize_symmetric_int8_bit_identical():
    rng = _rng(0)
    x = (rng.standard_normal((2, 3, 40, 16)) * 3).astype(np.float32)
    x[0, 1, :, 5] = 0.0   # a zero channel over tokens: scale 1.0
    x[1, 2, 7, :] = 0.0   # a zero row over D
    x[0, 0, 3, 2] = 127.5 * x[0, 0, :, 2].max() / 127  # near a .5 tie
    for dim in (2, 3):
        jq, js = jpd.quantize_symmetric_int8(jnp.asarray(x), axis=dim)
        tq, ts = cd.quantize_symmetric_int8(torch.from_numpy(x), dim)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jk = jpd.quantize_kv_channelwise(jnp.asarray(x), jnp.asarray(x[::-1]))
    tk = cd.quantize_kv_channelwise(torch.from_numpy(x),
                                    torch.from_numpy(x[::-1].copy()))
    for a, b in zip(tk, jk):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert np.any(tk[2].numpy() == 1.0)  # the zero channel's fallback


def test_quantize_cache_and_rows_bit_identical():
    rng = _rng(1)
    L, B, Hkv, T, D = 2, 2, 2, 24, 16
    k = rng.standard_normal((L, B, Hkv, T, D)).astype(np.float32)
    v = rng.standard_normal((L, B, Hkv, T, D)).astype(np.float32)
    k[:, :, :, 10:] = 0.0          # unwritten capacity
    v[1, 0, 1, :, 3] = 0.0         # a zero channel
    length = np.array([10, 7], np.int32)
    jc = jdec.quantize_cache(jdec.KVCache(
        k=jnp.asarray(k), v=jnp.asarray(v), length=jnp.asarray(length)))
    tc = tdec.quantize_cache(tdec.KVCache(
        k=torch.from_numpy(k), v=torch.from_numpy(v),
        length=torch.from_numpy(length)))
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    rows = (rng.standard_normal((B, Hkv, 3, D)) * 4).astype(np.float32)
    for scale in (np.array(jc.k_scale[0]),
                  np.abs(rng.standard_normal((B, Hkv, 1, 1))).astype(
                      np.float32) + 0.01):
        np.testing.assert_array_equal(
            tdec._quantize_rows(torch.from_numpy(rows),
                                torch.from_numpy(scale)).numpy(),
            np.asarray(jdec._quantize_rows(jnp.asarray(rows),
                                           jnp.asarray(scale))))


def test_quantize_paged_blocks_bit_identical():
    rng = _rng(2)
    L, Hkv, T, D, blk = 2, 2, 21, 16, 4
    k = rng.standard_normal((L, 1, Hkv, T, D)).astype(np.float32)
    v = rng.standard_normal((L, 1, Hkv, T, D)).astype(np.float32)
    k[:, :, :, 13:] = 0.0    # the masked tail: blocks 4.. are zero
    v[:, :, :, 13:] = 0.0
    k[0, 0, 1, 4:8] = 0.0    # a zero block inside the prompt
    # Jitted, as the JAX engine's staged insert runs it (XLA then turns the
    # division by 127 into a product with its f32 reciprocal, as the port
    # computes it).
    j = jax.jit(jdec.quantize_paged_blocks, static_argnums=(2,))(
        jnp.asarray(k), jnp.asarray(v), blk, 13)
    t = tdec.quantize_paged_blocks(torch.from_numpy(k), torch.from_numpy(v),
                                   blk)
    for a, b in zip(t, j):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert t[2][0, 1, 1] == 1.0 and t[2][0, 5, 0] == 1.0


# -- q8q (B4, B5) and the cast route ----------------------------------------

def _case(seed, B, Hq, Hkv, Tq, Tk, D=16):
    rng = _rng(seed)
    q = rng.standard_normal((B, Hq, Tq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32)
    return q, k, v


def _paged_case(seed, B=3, Hq=4, Hkv=2, Tq=1, D=16, N=14, NB=5, blk=8):
    """Fragmented, non-monotone tables (two rows share blocks), int8 pools
    with per-block scales, ragged lengths (one slot empty)."""
    rng = _rng(seed)
    kq = rng.integers(-127, 128, size=(N, Hkv, blk, D)).astype(np.int8)
    vq = rng.integers(-127, 128, size=(N, Hkv, blk, D)).astype(np.int8)
    ks = rng.uniform(0.005, 0.03, size=(N, Hkv)).astype(np.float32)
    vs = rng.uniform(0.005, 0.03, size=(N, Hkv)).astype(np.float32)
    table = np.stack([rng.permutation(N)[:NB] for _ in range(B)]).astype(
        np.int32)
    table[1] = table[0][::-1]
    qoff = rng.integers(0, NB * blk - Tq, size=B).astype(np.int32)
    qoff[-1] = -Tq  # sees no key: (0, -inf)
    q = rng.standard_normal((B, Hq, Tq, D)).astype(np.float32)
    return q, kq, vq, ks, vs, table, qoff


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


# (B, Hq, Hkv, Tq, Tk, ragged): MHA decode; GQA with ragged Tk (not a
# multiple of the TPU tile) and per-batch offsets.
Q8Q_CONTIG = {"mha": (2, 4, 4, 1, 96), "gqa-ragged": (3, 4, 2, 3, 77)}


@pytest.mark.parametrize("case", sorted(Q8Q_CONTIG))
def test_b4_plain_matches_pallas_q8q(case):
    B, Hq, Hkv, Tq, Tk = Q8Q_CONTIG[case]
    q, k, v = _case(3, B, Hq, Hkv, Tq, Tk)
    kq, vq, ks, vs = cd.quantize_kv_channelwise(*_t(k, v))
    qoff = (np.arange(B, dtype=np.int32) * 11 + Tk // 2).astype(np.int32)
    ref = jpd.attention_pallas_decode_q8q(
        *_j(q, kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy()),
        causal=True, q_offset=jnp.asarray(qoff), block_size=32,
        interpret=True)
    port = cd.decode_q8q_plain(*_t(q), kq, vq, ks, vs, causal=True,
                               q_offset=torch.from_numpy(qoff))
    _close_rows(port, ref)
    # The quantized Q codes (and row scales) equal JAX's.
    sm = 16 ** -0.5
    jqf = (jnp.asarray(q).reshape(B, Hkv, -1, 16) * (jnp.asarray(ks.numpy())
                                                     * sm))
    jc, js = jpd.quantize_symmetric_int8(jqf, axis=3)
    tc, ts = cd._fold_quantize_q(*_t(q), Hkv, ks, None)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # The wrapper on a CPU tensor is its plain version.
    w = cd.attention_cuda_decode_q8q(*_t(q), kq, vq, ks, vs, causal=True,
                                     q_offset=torch.from_numpy(qoff))
    assert all(torch.equal(a, b) for a, b in zip(w, port))


@pytest.mark.parametrize("scales", ["per-block", "channel"])
def test_b5_plain_matches_pallas_paged_q8q(scales):
    q, kq, vq, ks, vs, table, qoff = _paged_case(4)
    if scales == "channel":
        rng = _rng(5)
        ks = rng.uniform(0.005, 0.03, size=(3, 2, 1, 16)).astype(np.float32)
        vs = rng.uniform(0.005, 0.03, size=(3, 2, 1, 16)).astype(np.float32)
    ref = jpd.attention_pallas_decode_q8q(
        *_j(q, kq, vq, ks, vs), causal=True, q_offset=jnp.asarray(qoff),
        block_table=jnp.asarray(table), interpret=True)
    port = cd.attention_cuda_decode_paged_q8q(
        *_t(q, kq, vq, table, ks, vs), q_offset=torch.from_numpy(qoff))
    _close_rows(port, ref)
    assert np.all(np.isneginf(port[1].numpy()[-1]))


def test_q8q_empty_kv():
    q = torch.randn(2, 4, 1, 16)
    kq = torch.zeros((2, 2, 0, 16), dtype=torch.int8)
    s = torch.ones(2, 2, 1, 16)
    out, lse = cd.decode_q8q_plain(q, kq, kq, s, s)
    ref = jpd.attention_pallas_decode_q8q(
        jnp.asarray(q.numpy()), jnp.zeros((2, 2, 0, 16), jnp.int8),
        jnp.zeros((2, 2, 0, 16), jnp.int8), jnp.ones((2, 2, 1, 16)),
        jnp.ones((2, 2, 1, 16)), interpret=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(lse.numpy(), np.asarray(ref[1]))
    with pytest.raises(ValueError, match="int8"):
        cd.decode_q8q_plain(q, kq.float(), kq.float(), s, s)
    with pytest.raises(ValueError, match="q8 kernel"):
        cd.resolve_q8_kernel("q4")


@pytest.mark.parametrize("layout", ["contiguous", "paged-per-block"])
def test_cast_route_matches_pallas_q8(layout):
    if layout == "contiguous":
        q, k, v = _case(6, 3, 4, 2, 2, 70)
        kq, vq, ks, vs = cd.quantize_kv_channelwise(*_t(k, v))
        qoff = np.array([5, 40, 68], np.int32)
        ref = jpd.attention_pallas_decode_q8(
            *_j(q, kq.numpy(), vq.numpy(), ks.numpy(), vs.numpy()),
            causal=True, q_offset=jnp.asarray(qoff), block_size=32,
            interpret=True)
        port = cd.attention_cuda_decode_q8(*_t(q), kq, vq, ks, vs,
                                           causal=True,
                                           q_offset=torch.from_numpy(qoff))
    else:
        q, kq, vq, ks, vs, table, qoff = _paged_case(7, Tq=2)
        ref = jpd.attention_pallas_decode_q8(
            *_j(q, kq, vq, ks, vs), causal=True,
            q_offset=jnp.asarray(qoff), block_table=jnp.asarray(table),
            interpret=True)
        port = cd.resolve_q8_kernel("q8")(
            *_t(q, kq, vq, ks, vs), causal=True,
            q_offset=torch.from_numpy(qoff), block_table=_t(table)[0])
    _close_rows(port, ref)


def test_paged_q8q_equals_contiguous_over_the_gathered_view():
    """Plain B5 == plain B4 over the gathered pool, bit for bit (channel
    scales: B4 takes only those)."""
    q, kq, vq, _, _, table, qoff = _paged_case(8, Tq=3)
    rng = _rng(9)
    ks = rng.uniform(0.005, 0.03, size=(3, 2, 1, 16)).astype(np.float32)
    vs = rng.uniform(0.005, 0.03, size=(3, 2, 1, 16)).astype(np.float32)
    tq, tkq, tvq, tks, tvs, tt, to = _t(q, kq, vq, ks, vs, table, qoff)
    paged = cd.paged_decode_q8q_plain(tq, tkq, tvq, tt, tks, tvs,
                                      q_offset=to)
    kg, vg = cd.gather_paged_kv(tkq, tvq, tt)
    contig = cd.decode_q8q_plain(tq, kg, vg, tks, tvs, causal=True,
                                 q_offset=to)
    for a, b in zip(paged, contig):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_q8_kernels_match_plain_on_gpu():
    """B4, B5 and the int8 routes of B1/B2 on the card against their plain
    versions (bf16 q; each query row within 2e-2 of its largest |out|)."""
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

    q = rnd(3, 8, 2, 128)
    kq, vq, ks, vs = cd.quantize_kv_channelwise(rnd(3, 2, 300, 128),
                                                rnd(3, 2, 300, 128))
    qo = torch.tensor([-2, 100, 290], dtype=torch.int32, device="cuda")
    for route in ("q8q", "q8"):
        kw = dict(causal=True, q_offset=qo)
        close(cd.resolve_q8_kernel(route)(q, kq, vq, ks, vs, **kw),
              cd.resolve_q8_kernel(route, plain=True)(q, kq, vq, ks, vs,
                                                      **kw))
    pk = torch.randint(-127, 128, (30, 2, 16, 128), generator=g,
                       dtype=torch.int8).cuda()
    pv = torch.randint(-127, 128, (30, 2, 16, 128), generator=g,
                       dtype=torch.int8).cuda()
    bs = (torch.rand(30, 2, generator=g).cuda() * 0.02 + 0.005,
          torch.rand(30, 2, generator=g).cuda() * 0.02 + 0.005)
    table = torch.stack([torch.randperm(30, generator=g)[:8]
                         for _ in range(3)]).to("cuda", torch.int32)
    for route in ("q8q", "q8"):
        kw = dict(q_offset=qo.clamp(max=120), block_table=table)
        close(cd.resolve_q8_kernel(route)(q, pk, pv, *bs, **kw),
              cd.resolve_q8_kernel(route, plain=True)(q, pk, pv, *bs, **kw))
