"""The port's serving engine against the JAX package's (CPU).

Greedy serving must be token-identical: both engines serve the same
``synthetic_trace`` (the port's generator is the JAX one, draw for draw)
with the same float32 parameters, on the paged and the contiguous layouts,
including a trace whose prompt chunks ride the Tq >= 128 bucket (the
gather-then-B3 route of the port). The block allocator is held against the
JAX allocator op for op, and every drained engine reports no leaked blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tree_attention_tpu import models as jm
from tree_attention_tpu import serving as js
from tree_attention_tpu.serving.block_pool import BlockAllocator as JAlloc

from tree_attention_tpu_torch import models as tm
from tree_attention_tpu_torch import serving as ts
from tree_attention_tpu_torch.serving.block_pool import (
    BlockAllocator as TAlloc,
)

J_CFG = jm.TransformerConfig(
    vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=192, dtype=jnp.float32,
)
T_CFG = tm.TransformerConfig(
    vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=192, dtype=torch.float32,
)

# (name, engine kwargs, trace kwargs)
CASES = {
    "paged": (dict(slots=3, cache_len=32, prefill_chunk=8, kv_block=8),
              dict(n_requests=6, prompt_len=20, prompt_jitter=6,
                   max_new_tokens=5)),
    "contiguous": (dict(slots=3, cache_len=32, prefill_chunk=8,
                        kv_layout="contiguous"),
                   dict(n_requests=6, prompt_len=20, prompt_jitter=6,
                        max_new_tokens=5)),
    "paged-chunk128": (dict(slots=2, cache_len=164, prefill_chunk=128,
                            kv_block=16),
                       dict(n_requests=3, prompt_len=150, prompt_jitter=10,
                            max_new_tokens=4)),
}


@pytest.fixture(scope="module")
def params():
    jp = jm.init_params(jax.random.PRNGKey(0), J_CFG)
    return jp, tm.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(report):
    return {r.uid: list(map(int, r.tokens)) for r in report.results}


@pytest.mark.parametrize("case", sorted(CASES))
def test_slot_server_greedy_token_identical(params, case):
    jp, tp = params
    engine_kw, trace_kw = CASES[case]
    jtrace = js.synthetic_trace(vocab_size=256, seed=1, **trace_kw)
    ttrace = ts.synthetic_trace(vocab_size=256, seed=1, **trace_kw)
    for a, b in zip(jtrace, ttrace):
        np.testing.assert_array_equal(a.prompt, b.prompt)
    ref = js.SlotServer(jp, J_CFG, **engine_kw).serve(jtrace)
    server = ts.SlotServer(tp, T_CFG, **engine_kw)
    got = server.serve(ttrace)
    assert _tokens(got) == _tokens(ref)
    assert got.outcomes == ref.outcomes == {"budget": trace_kw["n_requests"]}
    assert got.tokens_generated == ref.tokens_generated
    assert server.leak_report() == {
        "blocks_private": 0, "blocks_used": 0, "blocks_reserved": 0,
        "blocks_cached": 0, "pins": 0,
    }


def test_sampled_serving_reproducible_per_seed(params):
    _, tp = params
    kw = dict(slots=2, cache_len=32, prefill_chunk=8, kv_block=8,
              temperature=1.0, top_k=20)
    trace = ts.synthetic_trace(4, prompt_len=10, max_new_tokens=6,
                               vocab_size=256, seed=2)
    a = ts.SlotServer(tp, T_CFG, seed=3, **kw).serve(trace)
    b = ts.SlotServer(tp, T_CFG, seed=3, **kw).serve(trace)
    c = ts.SlotServer(tp, T_CFG, seed=4, **kw).serve(trace)
    assert _tokens(a) == _tokens(b)
    assert _tokens(a) != _tokens(c)
    assert all(len(r.tokens) == 6 for r in a.results)


def test_over_subscribed_pool_defers_and_drains(params):
    _, tp = params
    # Each request's worst case is 2 blocks; 3 blocks hold one at a time,
    # so admissions wait for retires instead of failing.
    server = ts.SlotServer(tp, T_CFG, slots=3, cache_len=32, prefill_chunk=8,
                           kv_block=8, kv_blocks=3)
    trace = ts.synthetic_trace(5, prompt_len=10, max_new_tokens=4,
                               vocab_size=256, seed=5)
    rep = server.serve(trace)
    assert rep.outcomes == {"budget": 5}
    assert rep.kv["peak_blocks_used"] <= 3
    assert server.leak_report()["blocks_used"] == 0
    with pytest.raises(ValueError, match="kv-blocks"):
        server.serve([ts.Request(uid=9, prompt=[1] * 30, max_new_tokens=2)])


def test_eos_retires_early(params):
    jp, tp = params
    trace_kw = dict(n_requests=3, prompt_len=8, max_new_tokens=6,
                    vocab_size=256, seed=6)
    probe = ts.SlotServer(tp, T_CFG, slots=2, cache_len=24,
                          prefill_chunk=8).serve(
        ts.synthetic_trace(**trace_kw))
    eos = probe.results[0].tokens[2]  # a token the model does emit
    ref = js.SlotServer(jp, J_CFG, slots=2, cache_len=24,
                        prefill_chunk=8).serve(
        js.synthetic_trace(eos_id=eos, **trace_kw))
    got = ts.SlotServer(tp, T_CFG, slots=2, cache_len=24,
                        prefill_chunk=8).serve(
        ts.synthetic_trace(eos_id=eos, **trace_kw))
    assert _tokens(got) == _tokens(ref)
    assert got.outcomes == ref.outcomes
    assert "eos" in got.outcomes


def test_serving_metrics_record_when_enabled(params):
    from tree_attention_tpu_torch import obs

    _, tp = params
    reg = obs.REGISTRY
    tokens0 = reg.get("serving_tokens_total").value()
    paged0 = reg.get("decode_dispatch_total").labels(
        path="paged_decode").value()
    obs.enable()
    try:
        ts.SlotServer(tp, T_CFG, slots=2, cache_len=32, prefill_chunk=8,
                      kv_block=8).serve(
            ts.synthetic_trace(2, prompt_len=10, max_new_tokens=3,
                               vocab_size=256, seed=8))
    finally:
        obs.disable()
    assert reg.get("serving_tokens_total").value() - tokens0 == 6
    assert reg.get("decode_dispatch_total").labels(
        path="paged_decode").value() > paged0
    assert reg.get("serving_requests_total").labels(
        outcome="budget").value() >= 2


def test_block_allocator_matches_jax_op_for_op():
    rng = np.random.default_rng(7)
    ja, ta = JAlloc(12), TAlloc(12)
    owned, cached = [], []
    for _ in range(400):
        op = rng.integers(0, 7)
        if op == 0:
            n = int(rng.integers(0, 5))
            assert ja.reserve(n) == ta.reserve(n)
        elif op == 1 and ja.reserved > 0 and ja.free_count > 0:
            b = ja.alloc()
            assert ta.alloc() == b
            owned.append(b)
        elif op == 2 and owned:
            b = owned.pop(int(rng.integers(len(owned))))
            ja.free_private(b)
            ta.free_private(b)
        elif op == 3 and ja.reserved > 0:
            n = int(rng.integers(1, ja.reserved + 1))
            ja.unreserve(n)
            ta.unreserve(n)
        elif op == 4 and owned:
            b = owned.pop(int(rng.integers(len(owned))))
            ja.publish(b)
            ta.publish(b)
            cached.append(b)
        elif op == 5 and cached:
            b = cached.pop(int(rng.integers(len(cached))))
            ja.free_cached(b)
            ta.free_cached(b)
        elif op == 6 and owned:
            b = owned.pop(int(rng.integers(len(owned))))
            ja.unmap_private(b)
            ta.unmap_private(b)
        assert (ja.used, ja.free_count, ja.reserved, ja.gen,
                ja.available()) == (ta.used, ta.free_count, ta.reserved,
                                    ta.gen, ta.available())
    with pytest.raises(AssertionError):
        ta.free_private(cached[0] if cached else ta._pop_free())
