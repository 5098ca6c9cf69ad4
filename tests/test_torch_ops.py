"""The port's attention ops against the JAX package's (CPU).

The plain versions of the CUDA kernels B1 (contiguous decode), B2 (paged
decode) and B3 (Q-tiled forward) are held against the Pallas kernels they
replace, run in interpret mode as ``tests/test_pallas_decode.py`` and
``tests/test_pallas_fwd.py`` run them, on the same numpy inputs. The ops
layer (``flash_decode``, ``merge_partials``, ``attention_blockwise``) is
held against its JAX counterpart.

Tolerances: float32 1e-5 on out and lse (both sides accumulate in f32 over
different orders); bfloat16 inputs 2e-2 on out (one bf16 rounding of out,
and P rounded to bf16 on both sides) and 1e-2 on lse.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tree_attention_tpu.ops import decode as jdecode
from tree_attention_tpu.ops import reference as jref
from tree_attention_tpu.ops import tuning as jtuning
from tree_attention_tpu.ops.pallas_attention import attention_pallas_fwd
from tree_attention_tpu.ops.pallas_decode import attention_pallas_decode

from tree_attention_tpu_torch.ops import cuda_attention, cuda_decode
from tree_attention_tpu_torch.ops import decode as tdecode
from tree_attention_tpu_torch.ops import reference as tref
from tree_attention_tpu_torch.ops import tuning as ttuning
from tests.torch_threads import few_torch_threads  # noqa: F401

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 1e-2)}


def _data(seed, dtype, *shapes):
    rng = np.random.default_rng(seed)
    out = []
    for s in shapes:
        a = rng.standard_normal(s).astype(np.float32)
        if dtype == "bfloat16":  # round once so both sides see one value
            a = np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
        out.append(a)
    return out


def _jax(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _close(port, ref, dtype):
    (o, l), (ro, rl) = port, ref
    tol_o, tol_l = TOL[dtype]
    ro = np.asarray(jnp.asarray(ro, jnp.float32))
    rl = np.asarray(rl)
    np.testing.assert_allclose(o.float().numpy(), ro, atol=tol_o, rtol=tol_o)
    np.testing.assert_array_equal(np.isneginf(l.numpy()), np.isneginf(rl))
    fin = np.isfinite(rl)
    np.testing.assert_allclose(l.numpy()[fin], rl[fin], atol=tol_l,
                               rtol=tol_l)


# (B, Hq, Hkv, Tq, Tk): MHA and GQA, Tq in {1, 5, 16, 64}; the last case
# packs G*Tq = 128 rows (several of the kernel's row tiles).
DECODE_CASES = [
    (2, 4, 4, 1, 96),
    (3, 4, 2, 5, 80),
    (2, 8, 2, 16, 64),
    (2, 4, 2, 64, 160),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_b1_plain_matches_pallas_decode(case, dtype):
    B, Hq, Hkv, Tq, Tk = case
    D = 16
    q, k, v = _data(0, dtype, (B, Hq, Tq, D), (B, Hkv, Tk, D),
                    (B, Hkv, Tk, D))
    # Ragged (B,) offsets; batch row 0 sits before every key: all masked.
    qo = np.arange(B, dtype=np.int32) * 7 + Tk // 3
    qo[0] = -Tq
    ref = attention_pallas_decode(
        _jax(q, dtype), _jax(k, dtype), _jax(v, dtype), causal=True,
        q_offset=jnp.asarray(qo), block_size=32, interpret=True,
    )
    port = cuda_decode.attention_cuda_decode(
        _torch(q, dtype), _torch(k, dtype), _torch(v, dtype), causal=True,
        q_offset=torch.from_numpy(qo),
    )
    _close(port, ref, dtype)
    assert np.all(port[0].float().numpy()[0] == 0.0)
    assert np.all(np.isneginf(port[1].numpy()[0]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [(3, 4, 2, 1), (2, 4, 4, 5), (3, 4, 2, 16)])
def test_b2_plain_matches_pallas_paged(case, dtype):
    B, Hq, Hkv, Tq = case
    D, blk, NB, N = 16, 8, 6, 20
    q, kp, vp = _data(1, dtype, (B, Hq, Tq, D), (N, Hkv, blk, D),
                      (N, Hkv, blk, D))
    rng = np.random.default_rng(2)
    # Fragmented, non-monotone tables; rows share some blocks.
    table = np.stack([rng.permutation(N)[:NB] for _ in range(B)]).astype(
        np.int32)
    qo = rng.integers(0, NB * blk - Tq, size=B).astype(np.int32)
    ref = attention_pallas_decode(
        _jax(q, dtype), _jax(kp, dtype), _jax(vp, dtype), causal=True,
        q_offset=jnp.asarray(qo), block_table=jnp.asarray(table),
        interpret=True,
    )
    port = cuda_decode.attention_cuda_decode_paged(
        _torch(q, dtype), _torch(kp, dtype), _torch(vp, dtype),
        torch.from_numpy(table), q_offset=torch.from_numpy(qo),
    )
    _close(port, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [(2, 4, 2, 64, 200), (1, 2, 2, 40, 72)])
def test_b3_plain_matches_pallas_fwd(case, dtype):
    B, Hq, Hkv, Tq, Tk = case  # Tk not a multiple of the KV tile: ragged
    D = 16
    q, k, v = _data(3, dtype, (B, Hq, Tq, D), (B, Hkv, Tk, D),
                    (B, Hkv, Tk, D))
    qo = (Tk - Tq - np.arange(B) * 9).astype(np.int32)
    ref = attention_pallas_fwd(
        _jax(q, dtype), _jax(k, dtype), _jax(v, dtype), causal=True,
        q_offset=jnp.asarray(qo), block_size=64, block_q=32, interpret=True,
    )
    port = cuda_attention.attention_cuda_fwd(
        _torch(q, dtype), _torch(k, dtype), _torch(v, dtype), causal=True,
        q_offset=torch.from_numpy(qo),
    )
    _close(port, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b3_plain_matches_pallas_fwd_at_tile_edges(dtype):
    """D = 128 with Tq = 130 and Tk = 300 (past the tensor-core body's
    64-row and 128-key tile edges), GQA, and per-batch offsets one of which
    is negative (that row's first queries see no key)."""
    B, Hq, Hkv, Tq, Tk, D = 3, 4, 2, 130, 300, 128
    q, k, v = _data(11, dtype, (B, Hq, Tq, D), (B, Hkv, Tk, D),
                    (B, Hkv, Tk, D))
    qo = np.array([-5, 100, 170], dtype=np.int32)
    ref = attention_pallas_fwd(
        _jax(q, dtype), _jax(k, dtype), _jax(v, dtype), causal=True,
        q_offset=jnp.asarray(qo), block_size=128, block_q=64, interpret=True,
    )
    port = cuda_attention.attention_cuda_fwd(
        _torch(q, dtype), _torch(k, dtype), _torch(v, dtype), causal=True,
        q_offset=torch.from_numpy(qo),
    )
    _close(port, ref, dtype)
    assert np.all(np.isneginf(port[1].numpy()[0, :, :5]))


class _Lib:
    """A stand-in for a built kernel library: its tile exports report
    ``tiles`` for every dtype."""

    def __init__(self, tiles):
        self.tiles = tiles

    def __getattr__(self, name):
        if name.endswith("_block_q"):
            return lambda code: self.tiles[0]
        if name.endswith("_block_k"):
            return lambda code: self.tiles[1]
        raise AttributeError(name)


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd"])
def test_wrappers_reject_a_library_built_with_other_tiles(kernel,
                                                          monkeypatch):
    """B3's and B6/B7's launchers check the built library's tile exports
    against ``ops/tuning.py`` before the first launch, and raise on a
    mismatch instead of running tiles the Python side does not know."""
    from tree_attention_tpu_torch.ops import _build, cuda_bwd

    module, launcher, name = {
        "flash_fwd": (cuda_attention, "_launcher", "_lib_fn"),
        "flash_bwd": (cuda_bwd, "_launchers", "_fns"),
    }[kernel]
    monkeypatch.setattr(module, name, None)
    monkeypatch.setattr(_build, "library", lambda lib: _Lib((64, 32)))
    with pytest.raises(RuntimeError, match="tiles"):
        getattr(module, launcher)()
    assert getattr(module, name) is None


def test_cpu_wrappers_run_the_plain_versions_without_launching():
    q, k, v = _data(4, "float32", (1, 2, 3, 16), (1, 2, 40, 16),
                    (1, 2, 40, 16))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    before = (cuda_decode.attention_cuda_decode.launches,
              cuda_attention.attention_cuda_fwd.launches)
    a = cuda_decode.attention_cuda_decode(tq, tk, tv, causal=True,
                                          q_offset=20)
    b = cuda_attention.attention_cuda_fwd(tq, tk, tv, causal=True,
                                          q_offset=20)
    c = cuda_decode.decode_plain(tq, tk, tv, causal=True, q_offset=20)
    assert (cuda_decode.attention_cuda_decode.launches,
            cuda_attention.attention_cuda_fwd.launches) == before
    for x in (a, b):
        torch.testing.assert_close(x[0], c[0], atol=0, rtol=0)
        torch.testing.assert_close(x[1], c[1], atol=0, rtol=0)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("tq", [1, 4, 128])
def test_flash_decode_matches_jax(paged, tq):
    B, Hq, Hkv, D, blk, NB, N = 3, 4, 2, 16, 16, 12, 40
    rng = np.random.default_rng(5)
    q, kp, vp = _data(6, "float32", (B, Hq, tq, D), (N, Hkv, blk, D),
                      (N, Hkv, blk, D))
    table = np.stack([rng.permutation(N)[:NB] for _ in range(B)]).astype(
        np.int32)
    pos = rng.integers(0, NB * blk - tq, size=B).astype(np.int32)
    if paged:
        jk, jv, tk_, tv_ = (jnp.asarray(kp), jnp.asarray(vp),
                            torch.from_numpy(kp), torch.from_numpy(vp))
        kw_j = dict(block_table=jnp.asarray(table))
        kw_t = dict(block_table=torch.from_numpy(table))
    else:
        jk, jv = jdecode.gather_paged_kv(jnp.asarray(kp), jnp.asarray(vp),
                                         jnp.asarray(table))
        tk_, tv_ = torch.from_numpy(np.array(jk)), torch.from_numpy(
            np.array(jv))
        kw_j = kw_t = {}
    ref = jdecode.flash_decode(jnp.asarray(q), jk, jv,
                               q_position=jnp.asarray(pos), **kw_j)
    port = tdecode.flash_decode(torch.from_numpy(q), tk_, tv_,
                                q_position=torch.from_numpy(pos), **kw_t)
    _close(port, ref, "float32")


def test_gather_paged_kv_matches_jax():
    rng = np.random.default_rng(7)
    kp, vp = _data(8, "float32", (9, 2, 4, 8), (9, 2, 4, 8))
    table = rng.integers(0, 12, size=(3, 5)).astype(np.int32)  # some OOB
    jk, jv = jdecode.gather_paged_kv(jnp.asarray(kp), jnp.asarray(vp),
                                     jnp.asarray(table))
    tk_, tv_ = cuda_decode.gather_paged_kv(
        torch.from_numpy(kp), torch.from_numpy(vp), torch.from_numpy(table))
    np.testing.assert_array_equal(tk_.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv_.numpy(), np.asarray(jv))


@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_and_naive_match_jax(causal):
    q, k, v = _data(9, "float32", (2, 4, 24, 16), (2, 2, 70, 16),
                    (2, 2, 70, 16))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kw = dict(causal=causal, q_offset=40, kv_offset=0)
    _close(tref.attention_blockwise(tq, tk, tv, block_size=32, **kw),
           jref.attention_blockwise(jq, jk, jv, block_size=32, **kw),
           "float32")
    _close(tref.attention_naive(tq, tk, tv, **kw),
           jref.attention_naive(jq, jk, jv, **kw), "float32")


def test_merge_partials_matches_jax():
    rng = np.random.default_rng(10)
    outs = rng.standard_normal((4, 2, 3, 5, 8)).astype(np.float32)
    lses = rng.standard_normal((4, 2, 3, 5)).astype(np.float32)
    lses[:, 0, 0, 0] = -np.inf  # a row no shard saw: (0, -inf)
    lses[1:, 1, 1, 1] = -np.inf  # a row only shard 0 saw
    _close(tref.merge_partials(torch.from_numpy(outs),
                               torch.from_numpy(lses)),
           jref.merge_partials(jnp.asarray(outs), jnp.asarray(lses)),
           "float32")


def test_tuning_policy_matches_jax():
    names = {"pallas_decode": "decode", "pallas": "fwd"}
    for tq in (1, 5, 64, 127, 128, 256, 1024):
        assert ttuning.kernel_for(tq) == names[jtuning.tpu_kernel_for(tq)]
    for kv, bs in ((1, 512), (600, 512), (64000, 512), (10**6, 64)):
        assert tdecode.default_num_splits(kv, bs) == \
            jdecode.default_num_splits(kv, bs)


@pytest.mark.gpu
def test_kernels_match_plain_on_gpu():
    """B1/B2/B3 on the card against their plain versions, in bf16 (B3's
    tensor-core body) and f32 (its CUDA-core body), at D 64 and 128, with
    Tq = 130 and Tk = 300 off B3's 64-row and 128-key tile edges."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode (the plain versions are tested above)")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    tol = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

    def rnd(dtype, *s):
        return torch.randn(*s, generator=g).to("cuda", dtype)

    qo = torch.tensor([-5, 100, 290], dtype=torch.int32, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        for D in (64, 128):
            for Tq in (5, 130):
                q = rnd(dtype, 3, 8, Tq, D)
                k, v = rnd(dtype, 3, 2, 300, D), rnd(dtype, 3, 2, 300, D)
                for fn, plain in ((cuda_decode.attention_cuda_decode,
                                   cuda_decode.decode_plain),
                                  (cuda_attention.attention_cuda_fwd,
                                   cuda_attention.fwd_plain)):
                    a = fn(q, k, v, causal=True, q_offset=qo)
                    b = plain(q, k, v, causal=True, q_offset=qo)
                    torch.testing.assert_close(
                        a[0].float(), b[0].float(), atol=tol[dtype],
                        rtol=tol[dtype])
                    torch.testing.assert_close(a[1], b[1], atol=1e-3, rtol=0)
    q = rnd(torch.bfloat16, 3, 8, 5, 128)
    kp, vp = rnd(torch.bfloat16, 30, 2, 16, 128), rnd(torch.bfloat16, 30, 2,
                                                     16, 128)
    table = torch.stack([torch.randperm(30, generator=g)[:8]
                         for _ in range(3)]).to("cuda", torch.int32)
    a = cuda_decode.attention_cuda_decode_paged(q, kp, vp, table,
                                                q_offset=qo.clamp(max=120))
    b = cuda_decode.paged_decode_plain(q, kp, vp, table,
                                       q_offset=qo.clamp(max=120))
    torch.testing.assert_close(a[0].float(), b[0].float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(a[1], b[1], atol=1e-3, rtol=0)
