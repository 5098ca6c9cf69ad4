"""The port's whole-prompt admission against the JAX package's (CPU).

Counterparts of the ``admission="whole"`` cases of ``tests/test_serving.py``,
``tests/test_serving_paged.py``, ``tests/test_serving_prefix.py`` and
``tests/test_serving_spec.py``, at their tiny model (f32, greedy: tokens
exact):

- **Serving.** One trace (cold prompts, a repeat, a prompt of
  whole blocks and its repeat, a looping prompt) through JAX's whole-
  admission ``SlotServer`` and the port's: paged exact and int8 with the
  prefix cache and chain n-gram speculation on (tokens, ``prefix`` stats,
  ``proposed``/``accepted``, leak report equal), contiguous int8 with both
  off. Each port engine also serves the trace with speculation off; the
  contiguous exact layout with the cache and the paged one without give
  JAX's paged exact stream (the JAX suite pins the layouts
  token-identical); contiguous int8 with the cache equals the port's
  chunked admission (held against JAX in ``tests/test_torch_prefix.py``).
  Whole equals chunked inside the port, chunk 4 and 5, exact and int8 (the
  int8 paged cold path's bytes are JAX's below).
- **Bytes.** The cold prefill's payload (K/V rows, int8 codes, per-block
  and per-channel scales, the first token) equals JAX's ``_prefill_fn`` to
  f32 rounding and one int8 step (XLA's and torch's f32 matmuls differ in
  the last bit; tokens are exact). A short
  prompt after a longer one through the same reused bucket cache gives the
  bytes a fresh cache gives (the stale-row hazard). The paged insert,
  exact and int8, is bit-identical to JAX's ``paged_insert_slot``.
- **The cancel and deadline arcs.** A cancel and a deadline fired from the
  first token's callback, the tick the slot leaves ``await``: outcomes and
  tokens equal JAX's, both engines hold nothing after.

One JAX engine per configuration, memoized: each pays its own compiles.
The sequence-sharded case lives with its harness in
``tests/test_torch_seq_shard.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tree_attention_tpu import models as jm
from tree_attention_tpu import serving as js
from tree_attention_tpu.models import decode as jd

from tree_attention_tpu_torch import models as tm
from tree_attention_tpu_torch import serving as ts
from tree_attention_tpu_torch.models import decode as td
from tests.torch_params import seeded_params
from tests.torch_threads import few_torch_threads  # noqa: F401

CFG = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_head=16, d_ff=128)
J_CFG = jm.TransformerConfig(**CFG, dtype=jnp.float32)
T_CFG = tm.TransformerConfig(**CFG, dtype=torch.float32)

# chunk == block == 4, as the JAX suites' prefix tests run.
ENGINE = dict(slots=2, cache_len=32, prefill_chunk=4, admission="whole")
PREFIX = dict(prefix_cache=True, prefix_block=4, prefix_pool_blocks=16)
SPEC = dict(speculate=True, drafter="ngram", draft_k=5)
# JAX's serves: (layout kwargs, prefix cache and speculation on).
JAX_CASES = {
    "paged": ({}, True),
    "paged-int8": ({"quantize": True}, True),
    "contig-int8-cold": ({"kv_layout": "contiguous", "quantize": True},
                         False),
}
N_NEW = 10


def _prompts():
    """(prompt, arrival tick) per uid: 0 cold (13 tokens, bucket 16), 1 a
    looping prompt (n-gram drafts accept), 2 the repeat of 0 (hit 12), 3 a
    prompt of 3 whole blocks, 4 its repeat (hit 8: one suffix token stays),
    5 a shorter cold prompt in the same bucket (one prefill program)."""
    rng = np.random.default_rng(7)
    cold = rng.integers(0, 128, 13).astype(np.int32)
    loop = np.tile(np.array([7, 9, 4], np.int32), 4)
    whole = rng.integers(0, 128, 12).astype(np.int32)
    short = rng.integers(0, 128, 9).astype(np.int32)
    return [(cold, 0), (loop, 0), (cold, 6), (whole, 6), (whole, 12),
            (short, 12)]


HIT_TOKENS = [0, 0, 12, 0, 8, 0]


def _reqs(mod, n_new=N_NEW):
    return [mod.Request(uid=i, prompt=p, max_new_tokens=n_new,
                        arrival_tick=t)
            for i, (p, t) in enumerate(_prompts())]


def _tokens(report):
    return {r.uid: list(map(int, r.tokens)) for r in report.results}


@pytest.fixture(scope="module")
def params():
    return seeded_params(T_CFG)


def _kw(layout, on, spec=True):
    return dict(**ENGINE, **layout, **(PREFIX if on else {}),
                **(SPEC if on and spec else {}))


_RUNS = {}


def _run(params, case):
    """The case's serves, once per module: JAX's, the port's with the same
    flags, and the port's with speculation off."""
    if case not in _RUNS:
        jp, tp = params
        layout, on = JAX_CASES[case]
        jserver = js.SlotServer(jp, J_CFG, **_kw(layout, on))
        jrep = jserver.serve(_reqs(js), max_ticks=500)
        server = ts.SlotServer(tp, T_CFG, **_kw(layout, on))
        rep = server.serve(_reqs(ts), max_ticks=500)
        plain = ts.SlotServer(tp, T_CFG, **_kw(layout, on, spec=False))
        prep = plain.serve(_reqs(ts), max_ticks=500)
        _RUNS[case] = dict(jserver=jserver, jax=jrep,
                           jleaks=jserver.leak_report(), port=rep,
                           server=server, plain=prep, plain_server=plain)
    return _RUNS[case]


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_whole_serve_matches_jax(params, case):
    run = _run(params, case)
    want = _tokens(run["jax"])
    assert _tokens(run["port"]) == want
    assert _tokens(run["plain"]) == want  # speculation off: the same stream
    assert run["port"].outcomes == {"budget": len(HIT_TOKENS)}
    assert run["port"].prefix == run["jax"].prefix
    # Without speculation's verify windows the reservations, and so the
    # evictions, differ: the reuse does not.
    for key in ("hits", "misses", "tokens_reused"):
        assert run["plain"].prefix.get(key) == run["jax"].prefix.get(key)
    if JAX_CASES[case][1]:
        hits = [r.prefix_hit_tokens for r in run["port"].results]
        assert hits == [r.prefix_hit_tokens for r in run["jax"].results]
        assert hits == HIT_TOKENS
        assert want[2] == want[0] and want[4] == want[3]  # hit == cold


@pytest.mark.parametrize("case", ["paged", "paged-int8"])
def test_whole_speculation_counts_match_jax(params, case):
    """Chain n-gram drafts over whole admission (the verify tick takes an
    ``await`` slot's row 0 from the device token vector): ``proposed``
    and ``accepted`` are JAX's. No acceptance floor: the oracle is the
    JAX run's own counts."""
    run = _run(params, case)
    got, want = run["port"].spec, run["jax"].spec
    assert (got["proposed"], got["accepted"]) == \
        (want["proposed"], want["accepted"])
    assert got["proposed"] > 0


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_whole_serve_drains_like_jax(params, case):
    run = _run(params, case)
    leaks = run["server"].leak_report()
    assert leaks == {k: run["jleaks"][k] for k in leaks}
    for key in ("server", "plain_server"):
        leaks = run[key].leak_report()
        assert leaks["blocks_private"] == leaks["blocks_reserved"] == 0
        assert leaks["pins"] == 0
        assert leaks["blocks_used"] == leaks["blocks_cached"]


@pytest.mark.parametrize("layout", [{}, {"kv_layout": "contiguous"}],
                         ids=["paged", "contig"])
def test_exact_layouts_serve_the_jax_stream(params, layout):
    """The port's exact serves, paged without the cache and contiguous with
    it, give JAX's paged exact stream (the JAX suite pins paged and
    contiguous token-identical under whole admission)."""
    _, tp = params
    on = bool(layout)
    rep = ts.SlotServer(tp, T_CFG, **_kw(layout, on, spec=False)).serve(
        _reqs(ts), max_ticks=500)
    assert _tokens(rep) == _tokens(_run(params, "paged")["jax"])
    if on:
        assert [r.prefix_hit_tokens for r in rep.results] == HIT_TOKENS


def test_contig_int8_with_the_cache_runs_the_staged_path(params):
    """Contiguous int8 with the cache on: whole admission runs the staged
    path to completion, so it emits chunked admission's tokens (chunked
    contiguous int8 with the cache equals JAX's: tests/test_torch_prefix.py)
    and its hits emit their cold prompts' tokens."""
    _, tp = params
    kw = dict(ENGINE, kv_layout="contiguous", quantize=True, **PREFIX)
    whole = ts.SlotServer(tp, T_CFG, **kw).serve(_reqs(ts), max_ticks=500)
    kw["admission"] = "chunked"
    chunked = ts.SlotServer(tp, T_CFG, **kw).serve(_reqs(ts), max_ticks=500)
    want = _tokens(chunked)
    assert _tokens(whole) == want and want[2] == want[0]
    assert [r.prefix_hit_tokens for r in whole.results] == HIT_TOKENS
    assert whole.prefix == chunked.prefix


@pytest.mark.parametrize("quant", [False, True], ids=["exact", "int8"])
@pytest.mark.parametrize("chunk", [4, 5])
def test_whole_equals_chunked_in_the_port(params, quant, chunk):
    """tests/test_serving.py's contract inside the port: chunked admission
    at 4 and 5 tokens (5 leaves a 2-token final chunk of the 12-token
    prompts) emits whole admission's tokens."""
    _, tp = params
    rng = np.random.default_rng(13)
    prompts = rng.integers(0, 128, (3, 12)).astype(np.int32)

    def serve(**kw):
        server = ts.SlotServer(tp, T_CFG, slots=3, cache_len=32,
                               quantize=quant, **kw)
        return _tokens(server.serve([
            ts.Request(uid=i, prompt=p, max_new_tokens=6)
            for i, p in enumerate(prompts)]))

    assert serve(admission="chunked", prefill_chunk=chunk,
                 prefill_budget=chunk) == serve(admission="whole")


# -- bytes --------------------------------------------------------------------

def _jax_engine(params, layout):
    """The JAX engine of the serve case with the same ``_prefill`` program
    (paged int8: the prefix-cache case, whose whole admission is staged, so
    its ``_prefill`` compiles here)."""
    case = {(): "paged", (("quantize", True),): "paged-int8"}.get(
        tuple(sorted(layout.items())), "contig-int8-cold")
    return _run(params, case)["jserver"]


def _jax_payload(jeng, prompt):
    bucket = js.engine._bucket(len(prompt), 32)
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :len(prompt)] = prompt
    payload, _ = jeng._prefill(jeng.params, jnp.asarray(padded),
                               jnp.int32(len(prompt)), jeng._keys[0],
                               jnp.float32(0.0), jnp.int32(0))
    return [np.asarray(x) for x in payload]


def _port_payload(server, prompt):
    mini = server._prefill(0, prompt)
    tok = int(server.tok[0])
    if server.quantize and server._paged:
        parts = td.quantize_paged_blocks(mini.k, mini.v, server.kv_block)
    elif server.quantize:
        qc = td.quantize_cache(mini)
        parts = (qc.k, qc.v, qc.k_scale, qc.v_scale)
    else:
        parts = (mini.k, mini.v)
    return [p.clone().numpy() for p in parts] + [tok]


def _payload_close(got, want):
    """f32 rows and scales within f32 rounding of JAX's (XLA's and torch's
    matmuls and norms round differently in the last bit), int8 codes
    within one step, at most 1% of them off."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.int8:
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() < 0.01
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout", [
    {}, {"quantize": True}, {"kv_layout": "contiguous", "quantize": True}],
    ids=["exact", "int8-paged", "int8-contig"])
def test_cold_prefill_payload_matches_jax(params, layout):
    """The cold prefill's payload (K/V rows with the pad rows zeroed, int8
    codes, per-block or per-channel scales, the first token) against JAX's
    ``_prefill_fn``, for a 13-token prompt and then a 9-token one through
    the same reused bucket-16 cache. The short prompt's payload is also
    bit-identical to the one a fresh cache gives: no row or scale
    inherits the longer occupant's bytes."""
    jeng = _jax_engine(params, layout)
    # The paged int8 payload's per-block scales follow the JAX engine's
    # block (the prefix case's 4).
    kw = dict(ENGINE, **layout, **({"kv_block": jeng.kv_block}
                                   if jeng._paged and layout else {}))
    server = ts.SlotServer(params[1], T_CFG, **kw)
    assert server._paged == jeng._paged
    rng = np.random.default_rng(21)
    for n in (13, 9):
        prompt = rng.integers(0, 128, n).astype(np.int32)
        want = _jax_payload(jeng, prompt)
        got = _port_payload(server, prompt)
        assert got[-1] == int(want[-2])  # the first token
        for g, w in zip(got[:-1], want):
            _payload_close(g, w)
        assert not got[0][:, :, :, n:].any()  # pad rows zero
    assert list(server._whole_caches) == [16]  # one cache, reused
    fresh = ts.SlotServer(params[1], T_CFG, **kw)
    for g, f in zip(got, _port_payload(fresh, prompt)):
        np.testing.assert_array_equal(g, f)


@pytest.mark.parametrize("quant", [False, True], ids=["exact", "int8"])
def test_paged_insert_slot_matches_jax(quant):
    """The paged insert through a table row, rows ``[lo, plen)`` only: the
    pool bytes (and block scales) equal JAX's ``paged_insert_slot``; pad
    rows reach only the port's drop block."""
    rng = np.random.default_rng(5)
    L, Hkv, D, blk, N, T = 2, 2, 8, 4, 10, 16
    table = np.array([[7, 2, 9, 4], [0, 0, 0, 0]], np.int32)
    if quant:
        rows_k = rng.integers(-127, 128, (L, 1, Hkv, T, D)).astype(np.int8)
        rows_v = rng.integers(-127, 128, (L, 1, Hkv, T, D)).astype(np.int8)
        ks = rng.uniform(0.01, 1, (L, T // blk, Hkv)).astype(np.float32)
        vs = rng.uniform(0.01, 1, (L, T // blk, Hkv)).astype(np.float32)
        pool = rng.integers(-127, 128, (L, N, Hkv, blk, D)).astype(np.int8)
        psc = rng.uniform(0.01, 1, (L, N, Hkv)).astype(np.float32)
    else:
        rows_k = rng.standard_normal((L, 1, Hkv, T, D)).astype(np.float32)
        rows_v = rng.standard_normal((L, 1, Hkv, T, D)).astype(np.float32)
        pool = rng.standard_normal((L, N, Hkv, blk, D)).astype(np.float32)
    for plen, lo in ((13, 0), (11, 8)):
        length = np.zeros((2,), np.int32)
        if quant:
            jc = jd.PagedQuantKVCache(
                k=jnp.asarray(pool), v=jnp.asarray(pool),
                k_scale=jnp.asarray(psc), v_scale=jnp.asarray(psc),
                table=jnp.asarray(table), length=jnp.asarray(length))
            jout = jax.jit(jd.paged_insert_slot)(
                jc, 0, jnp.asarray(rows_k), jnp.asarray(rows_v), plen,
                jnp.asarray(ks), jnp.asarray(vs), lo=lo)
        else:
            jc = jd.PagedKVCache(k=jnp.asarray(pool), v=jnp.asarray(pool),
                                 table=jnp.asarray(table),
                                 length=jnp.asarray(length))
            jout = jax.jit(jd.paged_insert_slot)(
                jc, 0, jnp.asarray(rows_k), jnp.asarray(rows_v), plen, lo=lo)
        drop = np.zeros((L, 1) + pool.shape[2:], pool.dtype)
        kw = dict(k=torch.from_numpy(np.concatenate([pool, drop], 1)),
                  v=torch.from_numpy(np.concatenate([pool, drop], 1)),
                  table=torch.from_numpy(table),
                  length=torch.from_numpy(length))
        args = [torch.from_numpy(rows_k), torch.from_numpy(rows_v), plen]
        if quant:
            sdrop = np.ones((L, 1, Hkv), np.float32)
            scale = np.concatenate([psc, sdrop], 1)
            tc = td.PagedQuantKVCache(
                **kw, k_scale=torch.from_numpy(scale),
                v_scale=torch.from_numpy(scale.copy()))
            args += [torch.from_numpy(ks), torch.from_numpy(vs)]
        else:
            tc = td.PagedKVCache(**kw)
        tout = td.paged_insert_slot(tc, 0, *args, lo=lo)
        names = ("k", "v", "k_scale", "v_scale") if quant else ("k", "v")
        for name in names:
            np.testing.assert_array_equal(
                getattr(tout, name)[:, :N].numpy(),
                np.asarray(getattr(jout, name)))
        assert int(tout.length[0]) == plen
    with pytest.raises(ValueError, match="scales"):
        # An int8 pool needs its block scales; an exact one takes none.
        td.paged_insert_slot(tc, 0, *args[:3], *(
            () if quant else (torch.ones(1), torch.ones(1))))


# -- cancel and deadline on an await slot -------------------------------------

def _arcs(mod, eng):
    """uid 0 is cancelled and uid 1's deadline expires from their first
    token's callback, the tick each leaves ``await``; uid 2 runs out its
    budget beside them."""
    prompts = _prompts()
    reqs = [mod.Request(uid=i, prompt=prompts[j][0], max_new_tokens=6)
            for i, j in enumerate((0, 5, 3))]

    def cancel_first(t):
        eng.cancel(0)

    def expire_first(t):
        reqs[1].deadline_s = 0.0

    reqs[0].on_token = cancel_first
    reqs[1].on_token = expire_first
    return reqs


def test_cancel_and_deadline_from_await_match_jax(params):
    """On the paged exact engines with the prefix cache (already compiled
    by the serve cases): outcomes and tokens equal JAX's; both engines hold
    no request's blocks, reservation or pin after."""
    run = _run(params, "paged")
    out = {}
    for side, eng in (("jax", run["jserver"]), ("port", run["server"])):
        mod = js if side == "jax" else ts
        rep = eng.serve(_arcs(mod, eng), max_ticks=200)
        out[side] = {r.uid: (r.outcome, list(map(int, r.tokens)))
                     for r in rep.results}
        leaks = eng.leak_report()
        assert leaks["blocks_private"] == leaks["blocks_reserved"] == 0
        assert leaks["pins"] == 0
        assert leaks["blocks_used"] == leaks["blocks_cached"]
    assert out["port"] == out["jax"]
    assert out["port"][0][0] == "cancelled" and len(out["port"][0][1]) == 1
    assert out["port"][1][0] == "deadline" and len(out["port"][1][1]) == 1
    assert out["port"][2][0] == "budget"
