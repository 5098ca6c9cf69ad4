"""The port's transformer and decode step against the JAX package's (CPU).

Both packages run the SAME parameters (the JAX ``init_params`` pytree,
converted by ``params_from_jax``) on the same numpy token ids, in float32.
Tolerances: logits 2e-4 absolute + 1e-4 relative and written KV 1e-5 — f32
matmuls and attention accumulate in different orders on the two sides;
greedy generation must be token-identical.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tree_attention_tpu import models as jm

from tree_attention_tpu_torch import models as tm
from tests.torch_threads import few_torch_threads  # noqa: F401

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import __graft_entry__  # noqa: E402  (the JAX flagship config)

J_SMALL = jm.TransformerConfig(
    vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=192, dtype=jnp.float32,
)
T_SMALL = tm.TransformerConfig(
    vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=192, dtype=torch.float32,
)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def flagship():
    """The JAX flagship's parameters (bf16) as numpy, drawn once."""
    return _np_tree(jm.init_params(jax.random.PRNGKey(1),
                                   __graft_entry__._flagship()))


@pytest.fixture(scope="module")
def small():
    jp = jm.init_params(jax.random.PRNGKey(0), J_SMALL)
    return jp, tm.params_from_jax(_np_tree(jp), device="cpu")


def test_params_from_jax_round_trip(flagship):
    jp = flagship
    tp = tm.params_from_jax(jp, device="cpu")

    def bits(t):
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()

    flat_j = {"embed": jp["embed"], "ln_f": jp["ln_f"], "wout": jp["wout"],
              **{f"layers.{k}": v for k, v in jp["layers"].items()}}
    flat_t = {"embed": tp["embed"], "ln_f": tp["ln_f"], "wout": tp["wout"],
              **{f"layers.{k}": v for k, v in tp["layers"].items()}}
    assert flat_j.keys() == flat_t.keys()
    for name, a in flat_j.items():
        t = flat_t[name]
        assert str(t.dtype).split(".")[-1] == a.dtype.name, name
        assert tuple(t.shape) == a.shape, name
        ref = a.view(np.int16) if a.dtype.name == "bfloat16" else a
        np.testing.assert_array_equal(bits(t), ref, err_msg=name)


def test_forward_matches_jax_flagship(flagship):
    """The flagship in float32, on its bf16 parameters widened."""
    jcfg = dataclasses.replace(__graft_entry__._flagship(), dtype=jnp.float32)
    tcfg = tm.TransformerConfig(
        vocab_size=jcfg.vocab_size, d_model=jcfg.d_model,
        n_layers=jcfg.n_layers, n_heads=jcfg.n_heads,
        n_kv_heads=jcfg.n_kv_heads, d_head=jcfg.d_head, d_ff=jcfg.d_ff,
        dtype=torch.float32,
    )
    np_params = jax.tree.map(lambda a: a.astype(np.float32), flagship)
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = tm.params_from_jax(np_params, device="cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 48))
    ref = np.asarray(jm.forward(jp, jnp.asarray(toks, jnp.int32), jcfg))
    got = tm.forward(tp, torch.from_numpy(toks), tcfg).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-4)


def _caches(layout):
    B, cap, blk, N = 3, 48, 8, 20
    if layout == "contiguous":
        return (jm.init_cache(J_SMALL, B, cap),
                tm.init_cache(T_SMALL, B, cap, device="cpu"))
    table = np.random.default_rng(3).permutation(N)[:18].reshape(3, 6)
    jc = jm.init_paged_cache(J_SMALL, B, cap, N, block=blk)
    jc = dataclasses.replace(jc, table=jnp.asarray(table, jnp.int32))
    tc = tm.init_paged_cache(T_SMALL, B, cap, N, block=blk, device="cpu")
    tc.table.copy_(torch.from_numpy(table.astype(np.int32)))
    return jc, tc


def _kv(cache, layout):
    if layout == "contiguous":
        return cache.k.numpy(), cache.v.numpy()
    n = cache.blocks
    return cache.k[:, :n].numpy(), cache.v[:, :n].numpy()


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_forward_step_matches_jax(small, layout):
    """Mixed-Tq steps (prefill chunks beside decode rows and inert slots),
    then a plain decode step: logits of every valid row and the written KV
    match."""
    jp, tp = small
    jc, tc = _caches(layout)
    rng = np.random.default_rng(4)
    for tq, n in ((16, [16, 9, 0]), (16, [1, 16, 5]), (1, None)):
        toks = rng.integers(0, 256, (3, tq)).astype(np.int32)
        kw_j = {} if n is None else {"n_tokens": jnp.asarray(n, jnp.int32)}
        kw_t = {} if n is None else {
            "n_tokens": torch.tensor(n, dtype=torch.int32)}
        jl, jc = jm.forward_step(jp, jnp.asarray(toks), jc, J_SMALL, **kw_j)
        tl, tc = tm.forward_step(tp, torch.from_numpy(toks), tc, T_SMALL,
                                 **kw_t)
        valid = np.ones((3, tq), bool) if n is None else \
            np.arange(tq)[None] < np.asarray(n)[:, None]
        np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid],
                                   atol=2e-4, rtol=1e-4)
        np.testing.assert_array_equal(tc.length.numpy(),
                                      np.asarray(jc.length))
    jk, jv = np.asarray(jc.k), np.asarray(jc.v)
    tk, tv = _kv(tc, layout)
    np.testing.assert_allclose(tk, jk, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=1e-5)


def test_generate_greedy_token_identical(small):
    jp, tp = small
    prompt = np.random.default_rng(5).integers(0, 256, (2, 7)).astype(
        np.int32)
    ref = np.asarray(jm.generate(jp, jnp.asarray(prompt), 10, J_SMALL,
                                 temperature=0.0))
    got = tm.generate(tp, torch.from_numpy(prompt), 10, T_SMALL,
                      temperature=0.0).numpy()
    np.testing.assert_array_equal(got, ref)


def test_entry_points_default_to_cuda_and_refuse_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the CUDA default is taken")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_params(T_SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_cache(T_SMALL, 1, 8)
