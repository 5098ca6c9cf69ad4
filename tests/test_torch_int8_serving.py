"""Int8-KV serving of the port against the JAX package's (CPU).

- **The step**: ``forward_step`` over ``QuantKVCache`` and
  ``PagedQuantKVCache`` built from the same numpy cache (int8 pools,
  scales, a fragmented table, per-slot lengths), two decode steps, one of
  which enters new blocks. The per-block scales must be bit-equal (the
  anchor rule: an entered block's scale is a copy, not arithmetic); the
  int8 rows equal except codes one step apart where the f32 activations
  round differently (counted and bounded); logits within 1e-3 on the
  contiguous layout (q8q: the kernel's bf16 output may round one ulp apart
  on either side) and 1e-5 on the paged one (both packages attend over the
  dequantized view on the CPU, in f32).
- **The engine**: greedy ``SlotServer(quantize=True)`` serves
  token-identical to JAX's on the paged and the contiguous layouts, runs
  one int8-cache step per decode tick, and drains with no leak.
- **The CLI**: ``--kv-quant`` in ``--mode serve/decode/generate`` prints a
  record with ``kv_quant``; ``--kv-quant int8 --impl naive`` is refused.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tree_attention_tpu import models as jm
from tree_attention_tpu import serving as js

from tree_attention_tpu_torch import cli
from tree_attention_tpu_torch import models as tm
from tree_attention_tpu_torch import obs
from tree_attention_tpu_torch import serving as ts
from tests.torch_params import seeded_params
from tests.torch_threads import few_torch_threads  # noqa: F401

CFG = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_head=16, d_ff=192)
J_CFG = jm.TransformerConfig(**CFG, dtype=jnp.float32)
T_CFG = tm.TransformerConfig(**CFG, dtype=torch.float32)
L, HKV, D = 2, 2, 16


@pytest.fixture(scope="module")
def params():
    return seeded_params(T_CFG)


def _codes(rng, shape):
    return rng.integers(-60, 61, size=shape).astype(np.int8)


def _steps(jp, tp, jcache, tcache, n=2):
    """``n`` greedy decode steps on both packages from the same tokens."""
    tok = np.array([[3], [17], [101]], np.int32)
    out = []
    jstep = jax.jit(jm.forward_step, static_argnums=3)
    for _ in range(n):
        jl, jcache = jstep(jp, jnp.asarray(tok), jcache, J_CFG)
        tl, tcache = tm.forward_step(tp, torch.from_numpy(tok), tcache,
                                     T_CFG)
        out.append((np.asarray(jl), tl.numpy()))
        tok = np.array(jl[:, -1].argmax(-1), np.int32)[:, None]
    return out, jcache, tcache


def _codes_close(got, want):
    """int8 rows equal but for codes one step apart; returns how many."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1
    return int((d == 1).sum())


def test_forward_step_paged_int8_matches_jax(params):
    jp, tp = params
    rng = np.random.default_rng(0)
    N, blk, NB = 10, 4, 4
    k, v = _codes(rng, (L, N, HKV, blk, D)), _codes(rng, (L, N, HKV, blk, D))
    ks = rng.uniform(0.01, 0.05, size=(L, N, HKV)).astype(np.float32)
    vs = rng.uniform(0.01, 0.05, size=(L, N, HKV)).astype(np.float32)
    # Fragmented, non-monotone tables. Slot 0 (length 7) enters block 2 at
    # its second step, slot 1 (length 4) enters block 1 at its first, slot 2
    # (length 11) stays in block 2.
    table = np.array([[7, 2, 9, 0], [4, 1, 0, 0], [8, 3, 6, 5]], np.int32)
    length = np.array([7, 4, 11], np.int32)
    jc = jm.PagedQuantKVCache(
        k=jnp.asarray(k), v=jnp.asarray(v), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), table=jnp.asarray(table),
        length=jnp.asarray(length))

    def drop(x):  # the port's pools carry one drop block at index N
        return torch.from_numpy(np.concatenate(
            [x, np.zeros_like(x[:, :1])], axis=1))

    tc = tm.PagedQuantKVCache(
        k=drop(k), v=drop(v), k_scale=drop(ks), v_scale=drop(vs),
        table=torch.from_numpy(table), length=torch.from_numpy(length))
    steps, jc, tc = _steps(jp, tp, jc, tc)
    for jl, tl in steps:
        np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))
    for name in ("k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(tc, name)[:, :N].numpy(),
                                      np.asarray(getattr(jc, name)))
    # The entered blocks inherited their anchors' scales, in place.
    assert np.all(tc.k_scale[:, 1].numpy() == ks[:, 4])
    assert np.all(tc.k_scale[:, 9].numpy() == ks[:, 2])
    off = sum(_codes_close(getattr(tc, n)[:, :N].numpy(),
                           np.asarray(getattr(jc, n))) for n in ("k", "v"))
    assert off <= 4  # of 2 x 3 slots x 2 steps x L x Hkv x D = 768 codes


def test_forward_step_contiguous_int8_matches_jax(params):
    jp, tp = params
    rng = np.random.default_rng(1)
    T = 16
    k, v = _codes(rng, (L, 3, HKV, T, D)), _codes(rng, (L, 3, HKV, T, D))
    ks = rng.uniform(0.01, 0.05, size=(L, 3, HKV, 1, D)).astype(np.float32)
    vs = rng.uniform(0.01, 0.05, size=(L, 3, HKV, 1, D)).astype(np.float32)
    length = np.array([7, 4, 11], np.int32)
    jc = jm.QuantKVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                         k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                         length=jnp.asarray(length))
    tc = tm.QuantKVCache(k=torch.from_numpy(k.copy()),
                         v=torch.from_numpy(v.copy()),
                         k_scale=torch.from_numpy(ks),
                         v_scale=torch.from_numpy(vs),
                         length=torch.from_numpy(length))
    steps, jc, tc = _steps(jp, tp, jc, tc)
    for jl, tl in steps:
        np.testing.assert_allclose(tl, jl, atol=1e-3, rtol=0)
    off = sum(_codes_close(getattr(tc, n).numpy(), np.asarray(getattr(jc, n)))
              for n in ("k", "v"))
    assert off <= 8  # of 768 written codes


def _tokens(report):
    return {r.uid: list(map(int, r.tokens)) for r in report.results}


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_int8_slot_server_greedy_token_identical(params, layout):
    jp, tp = params
    engine_kw = dict(slots=2, cache_len=40, prefill_chunk=8,
                     kv_layout=layout, quantize=True,
                     **({"kv_block": 8} if layout == "paged" else {}))
    trace_kw = dict(n_requests=3, prompt_len=18, prompt_jitter=5,
                    max_new_tokens=6, vocab_size=256, seed=3)
    ref = js.SlotServer(jp, J_CFG, **engine_kw).serve(
        js.synthetic_trace(**trace_kw))
    server = ts.SlotServer(tp, T_CFG, **engine_kw)
    # Each decode tick runs one step over the int8 cache (staged chunks run
    # on the exact staging cache), so the report's decode ticks count them.
    steps = obs.REGISTRY.get("forward_step_dispatch_total").labels(
        cache="paged_quant" if layout == "paged" else "quant")
    before = steps.value()
    obs.enable()
    try:
        got = server.serve(ts.synthetic_trace(**trace_kw))
    finally:
        obs.disable()
    assert got.decode_ticks > 0
    assert steps.value() - before == got.decode_ticks
    assert _tokens(got) == _tokens(ref)
    assert got.outcomes == ref.outcomes == {"budget": 3}
    assert server.leak_report() == {
        "blocks_private": 0, "blocks_used": 0, "blocks_reserved": 0,
        "blocks_cached": 0, "pins": 0,
    }


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


SMALL = ["--device", "cpu", "--model-dim", "32", "--heads", "2",
         "--n-layers", "1", "--vocab-size", "64", "--dtype", "float32",
         "--temperature", "0", "--log-level", "warning"]


@pytest.mark.parametrize("quant", ["int8", "int8-cast"])
def test_cli_kv_quant_records(quant):
    rec = _cli(["--mode", "serve", "--slots", "2", "--requests", "3",
                "--prompt-len", "10", "--prompt-jitter", "3",
                "--max-new-tokens", "3", "--prefill-chunk", "8",
                "--kv-block", "8", "--kv-quant", quant, *SMALL])
    assert rec["kv_quant"] == quant and rec["outcomes"] == {"budget": 3}
    assert rec["leaks"]["blocks_used"] == 0
    rec = _cli(["--mode", "generate", "--q-len", "5", "--batch", "2",
                "--max-new-tokens", "4", "--kv-quant", quant, *SMALL])
    assert rec["kv_quant"] == quant and np.shape(rec["tokens"]) == (2, 4)
    rec = _cli(["--mode", "decode", "--seq-len", "96", "--heads", "4",
                "--head-dim", "16", "--iters", "1", "--warmup", "0",
                "--kv-quant", quant, "--device", "cpu", "--dtype",
                "float32"])
    assert rec["name"] == "decode_" + ("q8q" if quant == "int8" else "q8")
    assert rec["workload"]["kv_quant"] == quant
    assert rec["workload"]["impl"] == "plain"
    assert rec["kv_bytes"] == 2 * 96 * 4 * 16  # int8: one byte per value


def test_cli_kv_quant_refuses_naive_impl():
    with pytest.raises(SystemExit, match="cannot serve a quantized"):
        _cli(["--mode", "decode", "--seq-len", "64", "--kv-quant", "int8",
              "--impl", "naive", "--device", "cpu"])
