"""The port's attention backward against the JAX package's (CPU).

The plain versions of the CUDA kernels B6 (dQ) and B7 (dK/dV) are held
against the Pallas backward kernels they replace, run in interpret mode as
``tests/test_pallas_bwd.py`` runs them, on the same numpy inputs and the
same forward ``(out, lse)``, on that file's cases. The plain blockwise
backward is held against JAX's, and the gradients through
``FlashAttention`` against ``jax.grad`` through the JAX dispatcher and
against torch autograd of the port's ``attention_naive``, on both routes
(Tq >= 128: B3 then B6/B7; Tq < 128: B1 then the blockwise backward).

Tolerance: float32, 2e-4 absolute and relative, as ``test_pallas_bwd.py``
(both sides accumulate f32 products over different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tree_attention_tpu.ops import block_utils as jbu
from tree_attention_tpu.ops import flash_attention as jflash
from tree_attention_tpu.ops.pallas_attention import attention_pallas_fwd
from tree_attention_tpu.ops.pallas_bwd import attention_bwd_pallas
from tree_attention_tpu.ops.vjp import attention_bwd_blockwise as jbwd_blockwise

from tree_attention_tpu_torch.ops import attention_naive, block_utils
from tree_attention_tpu_torch.ops import cuda_attention, cuda_bwd
from tree_attention_tpu_torch.ops import flash_attention
from tree_attention_tpu_torch.ops.vjp import attention_bwd_blockwise
from tests.torch_threads import few_torch_threads  # noqa: F401

TOL = 2e-4



def _case(seed, B=1, Hq=4, Hkv=4, Tq=256, Tk=256, D=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, np.float32) for s in (
        (B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D), (B, Hq, Tq, D),
        (B, Hq, Tq))]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(port, ref, names=("dq", "dk", "dv")):
    for a, b, name in zip(port, ref, names):
        a = a.numpy()
        assert np.isfinite(a).all(), f"{name} has non-finite values"
        np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=TOL,
                                   err_msg=name)


# (case kwargs, causal, q_offset, kv_offset): the cases of
# tests/test_pallas_bwd.py — plain causal and not, GQA group reduction with
# the query chunk at 128, ragged Tq/Tk with +inf-padded rows, and a KV
# offset that is not tile-aligned (fully masked rows inside live tiles).
BWD_CASES = {
    "full": (dict(seed=0), False, 0, 0),
    "causal": (dict(seed=0), True, 0, 0),
    "gqa8x2": (dict(seed=1, Hq=8, Hkv=2, Tq=128, Tk=256), True, 128, 0),
    "gqa4x1": (dict(seed=1, Hq=4, Hkv=1, Tq=128, Tk=256, D=32), True, 128, 0),
    "ragged": (dict(seed=2, Tq=100, Tk=300, D=32), True, 200, 0),
    "unaligned": (dict(seed=4, D=32), True, 0, 100),
    # D = 128 past the tensor-core B6's 64-row and 64-key tile edges.
    "edges_d128": (dict(seed=11, Tq=130, Tk=300, D=128), True, 170, 0),
}


@pytest.fixture(scope="module", params=sorted(BWD_CASES))
def bwd_case(request):
    """Inputs, the Pallas forward's ``(out, lse)`` and the Pallas
    backward's grads (interpret mode) of one case, computed once."""
    kw, causal, qo, ko = BWD_CASES[request.param]
    q, k, v, dout, dlse = _case(**kw)
    jin = [jnp.asarray(x) for x in (q, k, v, dout, dlse)]
    out, lse = attention_pallas_fwd(*jin[:3], causal=causal, q_offset=qo,
                                    kv_offset=ko, block_size=128,
                                    block_q=128)
    ref = attention_bwd_pallas(*jin[:3], out, lse, *jin[3:], causal=causal,
                               scale=None, q_offset=qo, kv_offset=ko,
                               block_size=128, block_q=128)
    return dict(arrays=(q, k, v, np.asarray(out), np.asarray(lse), dout,
                        dlse), causal=causal, qo=qo, ko=ko, ref=ref)


def test_b6_b7_plain_match_pallas_bwd(bwd_case):
    q, k, v, out, lse, dout, dlse = _t(*bwd_case["arrays"])
    kw = dict(causal=bwd_case["causal"], q_offset=bwd_case["qo"],
              kv_offset=bwd_case["ko"])
    lse_f, delta = cuda_bwd.bwd_residuals(out, lse, dout, dlse)
    dq = cuda_bwd.dq_plain(q, k, v, dout, lse_f, delta, **kw)
    dk, dv = cuda_bwd.dkv_plain(q, k, v, dout, lse_f, delta, **kw)
    _close((dq, dk, dv), bwd_case["ref"])
    # The wrappers take exactly these plain versions for CPU tensors.
    _close((cuda_bwd.attention_cuda_dq(q, k, v, dout, lse_f, delta, **kw),
            *cuda_bwd.attention_cuda_dkv(q, k, v, dout, lse_f, delta, **kw)),
           (dq, dk, dv))


def test_blockwise_bwd_matches_jax(bwd_case):
    arrays = bwd_case["arrays"]
    kw = dict(causal=bwd_case["causal"], scale=None,
              q_offset=bwd_case["qo"], kv_offset=bwd_case["ko"])
    ref = jbwd_blockwise(*[jnp.asarray(x) for x in arrays], block_size=128,
                         **kw)
    port = attention_bwd_blockwise(*_t(*arrays), block_size=128, **kw)
    _close(port, ref)
    # ... and the Pallas kernels' grads, the same function.
    _close(port, bwd_case["ref"])


def test_blockwise_bwd_per_batch_offsets_match_per_row_calls():
    """(B,) offsets give each batch row its own causal frontier (no tile
    culling then): row b equals a call with row b's scalar offsets."""
    q, k, v, dout, dlse = _t(*_case(5, B=3, Hq=4, Hkv=2, Tq=8, Tk=64, D=16))
    qo = torch.tensor([0, 30, 56], dtype=torch.int32)
    out, lse = cuda_attention.fwd_plain(q, k, v, causal=True, q_offset=qo)
    got = attention_bwd_blockwise(q, k, v, out, lse, dout, dlse, causal=True,
                                  scale=None, q_offset=qo, block_size=16)
    for b in range(3):
        sl = slice(b, b + 1)
        want = attention_bwd_blockwise(
            q[sl], k[sl], v[sl], out[sl], lse[sl], dout[sl], dlse[sl],
            causal=True, scale=None, q_offset=int(qo[b]), block_size=16)
        for g, w in zip(got, want):
            torch.testing.assert_close(g[sl], w, atol=1e-6, rtol=1e-6)


# (case kwargs, q_offset, JAX impl): Tq >= 128 runs B3 -> B6/B7 in the port
# and "pallas" in JAX; Tq < 128 runs B1 -> blockwise and "pallas_decode".
GRAD_CASES = {
    "b3_causal": (dict(seed=3, Tq=128, Tk=128, D=32), 0, "pallas"),
    "b3_gqa_offset": (dict(seed=6, Hq=8, Hkv=2, Tq=128, Tk=256, D=32), 128,
                      "pallas"),
    "b1_gqa_offset": (dict(seed=7, B=2, Hq=4, Hkv=2, Tq=16, Tk=96, D=32), 80,
                      "pallas_decode"),
}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_flash_attention_grads_match_jax_and_naive(name):
    kw, qo, jimpl = GRAD_CASES[name]
    q, k, v, dout, dlse = _case(**kw)

    def jloss(q_, k_, v_):
        o, lse = jflash(q_, k_, v_, causal=True, q_offset=qo, impl=jimpl)
        return jnp.sum(o * dout) + jnp.sum(lse * dlse)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    def port_grads(fn):
        qt, kt, vt = (t.requires_grad_() for t in _t(q, k, v))
        o, lse = fn(qt, kt, vt, causal=True, q_offset=qo)
        loss = (o * torch.from_numpy(dout)).sum() + (
            lse * torch.from_numpy(dlse)).sum()
        if fn is flash_attention:
            assert type(o.grad_fn).__name__ == "FlashAttentionBackward"
        return torch.autograd.grad(loss, (qt, kt, vt))

    port = port_grads(flash_attention)
    _close(port, ref)
    _close(port, [g.numpy() for g in port_grads(attention_naive)])


def test_unused_lse_cotangent_none_or_zeros():
    """The model drops lse: its cotangent arrives as None; a loss that
    multiplies lse by 0 sends zeros. Both give the same grads, and a
    non-zero lse cotangent changes dq and dk (dv = p^T dO does not depend
    on it)."""
    q, k, v, dout, dlse = _case(8, Tq=128, Tk=128, D=32)

    def grads(lse_weight):
        qt, kt, vt = (t.requires_grad_() for t in _t(q, k, v))
        o, lse = flash_attention(qt, kt, vt, causal=True)
        loss = (o * torch.from_numpy(dout)).sum()
        if lse_weight is not None:
            loss = loss + (lse * lse_weight).sum()
        return torch.autograd.grad(loss, (qt, kt, vt))

    none, zeros = grads(None), grads(torch.zeros(dlse.shape))
    for a, b in zip(none, zeros):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    moved = grads(torch.from_numpy(dlse))
    assert all((a - b).abs().max() > 1e-3 for a, b in zip(none[:2], moved))
    torch.testing.assert_close(none[2], moved[2], atol=0, rtol=0)


def test_flash_attention_without_grad_stays_on_the_direct_call():
    q, k, v = (t.requires_grad_() for t in _t(*_case(9, Tq=128, Tk=128,
                                                      D=32)[:3]))
    with torch.no_grad():
        o, _ = flash_attention(q, k, v, causal=True)
    assert o.grad_fn is None and not o.requires_grad
    o, _ = flash_attention(q.detach(), k.detach(), v.detach(), causal=True)
    assert o.grad_fn is None


def test_plain_impl_grads_equal_auto_on_cpu():
    q, k, v, dout, _ = _case(10, Hq=4, Hkv=2, Tq=128, Tk=192, D=32)

    def grads(impl):
        qt, kt, vt = (t.requires_grad_() for t in _t(q, k, v))
        o, _ = flash_attention(qt, kt, vt, causal=True, q_offset=64,
                               impl=impl)
        return torch.autograd.grad((o * torch.from_numpy(dout)).sum(),
                                   (qt, kt, vt))

    for a, b in zip(grads("auto"), grads("plain")):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("bq,bk", [(32, 64), (128, 128), (128, 64),
                                   (64, 32)])
def test_tile_liveness_matches_jax(bq, bk):
    """B6's last live KV tile and B7's first live Q tile, as integers,
    against the JAX package's index-map helpers."""
    n_q, n_k = 6, 7
    for qo in (0, 5, 64, 130, 400):
        for ko in (0, 3, 100, 300):
            for qi in range(n_q):
                assert block_utils.last_live_k(qi, bq, bk, qo, ko, n_k) == int(
                    jbu.causal_last_live_k(qi, bq, bk, qo, ko, n_k))
            for ki in range(n_k):
                assert block_utils.first_live_q(ki, bq, bk, qo, ko, n_q) == int(
                    jbu.causal_first_live_q(ki, bq, bk, qo, ko, n_q))


@pytest.mark.parametrize("D", [32, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grad_gate_holds_one_key_rows_to_their_rounding_bound(dtype, D):
    """``cuda_bwd.grad_rows_close``, the row gate the backward kernels are
    held to on the card: the plain gradients against the plain gradients
    with the head dim permuted (a second correct f32 summation order) pass
    it; ``dq_one_key_bound`` names exactly the rows that see one key, and
    its bound there stays under 1e-2 of the median dq row's scale; the
    gate rejects a one-key dq row off by twice its bound, a no-key dq row
    off by 1e-6 and a dk row off by 3e-2 of its scale."""
    B, Hq, Hkv, Tq, Tk = 2, 4, 2, 40, 60
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s, np.float32)
                                    ).to(dtype)
                   for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D),
                             (B, Hq, Tq, D)))
    qo, ko = torch.tensor([-3, 10]), torch.tensor([0, 12])
    kw = dict(causal=True, q_offset=qo, kv_offset=ko)
    lse_f, delta = cuda_bwd.bwd_residuals(
        *cuda_attention.fwd_plain(q, k, v, **kw), do)
    want = (cuda_bwd.dq_plain(q, k, v, do, lse_f, delta, **kw),
            *cuda_bwd.dkv_plain(q, k, v, do, lse_f, delta, **kw))
    perm = torch.from_numpy(rng.permutation(D))
    inv = torch.argsort(perm)
    pq, pk, pv, pdo = (t[..., perm] for t in (q, k, v, do))
    got = (cuda_bwd.dq_plain(pq, pk, pv, pdo, lse_f, delta, **kw)[..., inv],
           *(t[..., inv] for t in cuda_bwd.dkv_plain(pq, pk, pv, pdo, lse_f,
                                                     delta, **kw)))
    one_key = cuda_bwd.dq_one_key_bound(q, k, v, do, delta, **kw)
    rows, bound = one_key
    seen = ((torch.arange(Tk) + ko[:, None, None])
            <= (qo[:, None] + torch.arange(Tq))[..., None]).sum(-1)
    assert torch.equal(rows[:, 0, :, 0], seen == 1) and int(rows.sum()) == 2
    assert cuda_bwd.grad_rows_close(got, want, 2e-2, one_key)[0]
    scale = want[0].float().abs().amax(-1)
    assert bound[rows.expand_as(bound)].max() < 1e-2 * scale[
        (seen > 1)[:, None].expand_as(scale)].median()

    def off(i, fn):
        t = [w.clone() for w in want]
        fn(t[i])
        return cuda_bwd.grad_rows_close(t, want, 2e-2, one_key)[0]

    b1 = int((seen[0] == 1).nonzero()[0])
    b0 = int((seen[0] == 0).nonzero()[0])
    assert not off(0, lambda t: t[0, 0, b1].add_(2 * bound[0, 0, b1]))
    assert not off(0, lambda t: t[0, 0, b0].add_(1e-6))
    assert not off(1, lambda t: t[0, 0, 5].add_(
        3e-2 * t[0, 0, 5].float().abs().max()))


@pytest.mark.gpu
def test_bwd_kernels_match_plain_on_gpu():
    """B6/B7 on the card against their plain versions, in bf16 (the
    tensor-core bodies) and f32 (the CUDA-core bodies), at D 64 and 128,
    with Tq = 130 and Tk = 300 off the bodies' 64-row and 64/128-key tile
    edges, under
    ``chip_smoke.py``'s gate (``cuda_bwd.grad_rows_close``): each row of
    dq/dk/dv within 2e-2 of that row's max |plain|, and the dq rows that
    see exactly one key within their rounding bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode (the plain versions are tested above)")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)

    def rnd(dtype, *s):
        return torch.randn(*s, generator=g).to("cuda", dtype)

    for dtype in (torch.bfloat16, torch.float32):
        for D in (64, 128):
            for Hq, Hkv, Tq, Tk, qo, ko in ((8, 2, 100, 300, 200, 0),
                                            (4, 4, 256, 256, 0, 100),
                                            (4, 2, 130, 300, 170, 0)):
                q, k, v, do = (rnd(dtype, 2, Hq, Tq, D),
                               rnd(dtype, 2, Hkv, Tk, D),
                               rnd(dtype, 2, Hkv, Tk, D),
                               rnd(dtype, 2, Hq, Tq, D))
                kw = dict(causal=True, q_offset=qo, kv_offset=ko)
                out, lse = cuda_attention.fwd_plain(q, k, v, **kw)
                lse_f, delta = cuda_bwd.bwd_residuals(out, lse, do)
                got = (cuda_bwd.attention_cuda_dq(q, k, v, do, lse_f, delta,
                                                  **kw),
                       *cuda_bwd.attention_cuda_dkv(q, k, v, do, lse_f,
                                                    delta, **kw))
                want = (cuda_bwd.dq_plain(q, k, v, do, lse_f, delta, **kw),
                        *cuda_bwd.dkv_plain(q, k, v, do, lse_f, delta, **kw))
                one_key = cuda_bwd.dq_one_key_bound(q, k, v, do, delta,
                                                    **kw)
                ok, _, rel = cuda_bwd.grad_rows_close(got, want, 2e-2,
                                                      one_key)
                assert ok, (dtype, D, Tq, Tk, rel)
