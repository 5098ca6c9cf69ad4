"""The port's token-tree sibling decode against the JAX package's (CPU).

Counterparts of ``tests/test_serving_tree.py``'s family cases, at
``tests/test_torch_fork.py``'s tiny model (2 layers, 4 heads over 2 KV
heads, d_head 16, ``cache_len`` 32, ``kv_block`` 4, ``prefill_chunk`` 4;
f32, weights from ``seeded_params``). ``SlotServer(tree_sampling=True)`` is
the default in both packages: a family that fits the tree rule decodes in
ONE slot as a sibling bundle under an ancestor mask.

- **Against JAX (greedy).** One trace per engine, exact and int8: families
  on a block-aligned and an unaligned prompt, a best-of family and a
  ``fork_at`` request (a live tree conversion). Every ``(uid, index)``'s
  tokens, the tree family and fork counts equal JAX's; both drain.
- **Against the port's fork-slot path (sampled).** One seed: the tree
  family's branches equal the fork-slot family's token for token (the same
  per-branch keys), cumulative log-probabilities to f32 rounding, exact,
  int8, whole admission and a prefix hit; the tree peaks at no more pool
  blocks. ``fork_at`` conversion equals the fork-slot branch.
- **One slot.** ``n = 8`` on a one-slot engine; the fork-slot path refuses
  it. An oversized family falls back to fork slots or is refused.
- **Retire arcs.** A branch's EOS mid-tree (the survivor at rank > 0 is
  compacted to the front of the window and decodes on as the fork-slot
  branch does), a cancel before the start and mid-family, best-of
  streaming only the winner, and a seeded random walk of families,
  conversions and cancels: every one drains clean.

The replicated-pool mesh case and the sequence-sharded fallback ride
``tests/test_torch_seq_shard.py``'s rank spawn.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tree_attention_tpu import serving as js
from tree_attention_tpu_torch import serving as ts
from tree_attention_tpu_torch.models import decode as td
from tests.test_torch_fork import (  # noqa: F401  (params: a fixture)
    BASE,
    J_CFG,
    T_CFG,
    ScriptedSource,
    _prompt,
    drained,
    params,
)
from tests.torch_threads import few_torch_threads  # noqa: F401


def _branches(report):
    return {(r.uid, r.index): list(map(int, r.tokens))
            for r in report.results}


# -- against JAX: greedy families --------------------------------------------

def _trace(mod):
    """uid 0: 12 tokens (three whole blocks), n 4; 1: 13 tokens (ends
    mid-block), n 3; 2: best-of 3; 3: a request that forks itself after its
    2nd token (a live tree conversion)."""
    return [mod.Request(uid=0, prompt=_prompt(41, 12), max_new_tokens=5,
                        n=4),
            mod.Request(uid=1, prompt=_prompt(42, 13), max_new_tokens=6,
                        n=3),
            mod.Request(uid=2, prompt=_prompt(43, 9), max_new_tokens=4,
                        best_of=3, arrival_tick=2),
            mod.Request(uid=3, prompt=_prompt(44, 10), max_new_tokens=6,
                        fork_at=2, arrival_tick=3)]


_RUNS = {}


def _run(params, quant):
    if quant not in _RUNS:
        jp, tp = params
        kw = dict(slots=2, quantize=quant, **BASE)
        jeng = js.SlotServer(jp, J_CFG, **kw)
        jrep = jeng.serve(_trace(js), max_ticks=400)
        eng = ts.SlotServer(tp, T_CFG, **kw)
        rep = eng.serve(_trace(ts), max_ticks=400)
        _RUNS[quant] = (jrep, jeng.leak_report(), rep, eng)
    return _RUNS[quant]


@pytest.mark.parametrize("quant", [False, True], ids=["exact", "int8"])
def test_tree_families_match_jax(params, quant):
    jrep, jleaks, rep, eng = _run(params, quant)
    assert _branches(rep) == _branches(jrep)
    assert sorted(_branches(rep)) == (
        [(0, i) for i in range(4)] + [(1, i) for i in range(3)]
        + [(2, i) for i in range(3)] + [(3, 0), (3, 1)])
    for key in ("tree_families", "forks"):
        assert rep.kv[key] == jrep.kv[key], key
    assert rep.kv["tree_families"] == 4  # three families, one conversion
    # Every tree tick commits one token for every live branch.
    assert rep.kv["tree_branch_ticks"] == jrep.kv["tree_branch_ticks"]
    assert drained(eng)
    assert jleaks["blocks_used"] == jleaks["blocks_reserved"] == 0


# -- against the port's fork-slot path: sampled families ----------------------

_ENGINES = {}


def _engine(params, **kw):
    key = tuple(sorted(kw.items()))
    if key not in _ENGINES:
        _ENGINES[key] = ts.SlotServer(params[1], T_CFG, **{**BASE, **kw})
    return _ENGINES[key]


def tree_eng(params, **kw):
    return _engine(params, slots=2, temperature=1.0, **kw)


def fork_eng(params, slots=8, **kw):
    return _engine(params, slots=slots, temperature=1.0,
                   tree_sampling=False, **kw)


def _tree_vs_fork(params, reqs, **kw):
    t = tree_eng(params, **kw).serve(reqs(), max_ticks=400)
    f = fork_eng(params, **kw).serve(reqs(), max_ticks=400)
    assert t.kv["tree_families"] == len(reqs())
    assert "tree_families" not in f.kv
    assert _branches(t) == _branches(f)
    lt = {(r.uid, r.index): r.cum_logprob for r in t.results}
    for r in f.results:
        assert np.isclose(lt[(r.uid, r.index)], r.cum_logprob, rtol=1e-4,
                          atol=1e-5)
    assert drained(tree_eng(params, **kw))
    assert drained(fork_eng(params, **kw))
    return t, f


SAMPLED = {
    "exact": dict(),
    "int8": dict(quantize=True),
    "whole": dict(admission="whole"),
    "prefix": dict(prefix_cache=True, prefix_block=4),
}


@pytest.mark.parametrize("case", list(SAMPLED))
def test_tree_equals_fork_slot_family_under_one_seed(params, case):
    """n = 8 on a block-aligned prompt and n = 4 on an unaligned one: the
    tree's branches are the fork-slot path's, bit for bit; sampled
    siblings differ; the tree never needs more pool blocks. The prefix
    case admits the second family's prompt as a hit on the first's."""
    p8, p4 = _prompt(30, 8), _prompt(31, 7)
    if case == "prefix":
        p4 = np.concatenate([p8, p4[:3]])

    def reqs():
        return [ts.Request(uid=0, prompt=p8, max_new_tokens=4, n=8, seed=7),
                ts.Request(uid=1, prompt=p4, max_new_tokens=5, n=4, seed=3,
                           arrival_tick=8)]

    t, f = _tree_vs_fork(params, reqs, **SAMPLED[case])
    b = _branches(t)
    assert len({tuple(b[(0, i)]) for i in range(8)}) >= 2, (
        "sampled siblings never diverged: per-branch keys broken")
    assert t.kv["peak_blocks_used"] <= f.kv["peak_blocks_used"]
    if case == "prefix":
        assert t.prefix["hits"] == f.prefix["hits"] >= 1


def test_fork_at_conversion_equals_the_fork_slot_branch(params):
    def reqs():
        return [ts.Request(uid=0, prompt=_prompt(39), max_new_tokens=8,
                           fork_at=3, seed=6)]

    t = tree_eng(params).serve(reqs())
    f = fork_eng(params).serve(reqs())
    res = {r.index: r.tokens for r in t.results}
    assert sorted(res) == [0, 1]
    assert res[0][:3] == res[1][:3] and res[0] != res[1]
    assert _branches(t) == _branches(f)
    assert t.kv["tree_families"] == 1 and t.kv["forks"] == f.kv["forks"] == 1
    assert drained(tree_eng(params))


# -- one slot ------------------------------------------------------------------

def test_tree_n8_decodes_in_one_slot(params):
    one = _engine(params, slots=1, temperature=1.0)
    req = ts.Request(uid=0, prompt=_prompt(35, 8), max_new_tokens=4, n=8,
                     seed=2)
    rep = one.serve([req])
    assert sorted(r.index for r in rep.results) == list(range(8))
    assert rep.kv["tree_families"] == 1
    assert rep.kv["tree_ticks"] == 3  # 3 tokens past the first, one tick each
    assert drained(one)
    forked = _engine(params, slots=1, temperature=1.0, tree_sampling=False)
    with pytest.raises(ValueError, match="exceed the engine"):
        forked.serve([req])


def test_oversize_family_falls_back_or_rejects(params):
    """A family whose bundle would pass 32 rows never engages the tree:
    within the slot count it forks, beyond it validation refuses it."""
    eng = tree_eng(params)  # 2 slots
    with pytest.raises(ValueError, match="exceed the engine"):
        eng.serve([ts.Request(uid=0, prompt=_prompt(36, 4),
                              max_new_tokens=6, n=8)])  # 8 x 5 = 40 rows
    rep = eng.serve([ts.Request(uid=0, prompt=_prompt(36, 4),
                                max_new_tokens=24, n=2, seed=1)])
    assert sorted(r.index for r in rep.results) == [0, 1]
    assert "tree_families" not in rep.kv and rep.kv["forks"] == 1
    assert drained(eng)


# -- retire arcs ------------------------------------------------------------------

def test_branch_eos_mid_tree_and_the_survivor_at_rank_1(params):
    """Branch 0 of an n = 2 family stops on a token only it drew: it
    retires with the token, and branch 1, the survivor at rank 1, is
    compacted to the front of the window and decodes on exactly as the
    fork-slot path's branch 1 does."""
    for seed in range(40):
        base = tree_eng(params).serve([ts.Request(
            uid=0, prompt=_prompt(37, 9), max_new_tokens=8, n=2, seed=seed)])
        b = {r.index: r.tokens for r in base.results}
        eos = next((t for t in b[0][1:4] if t not in b[1]), None)
        if eos is not None:
            break
    assert eos is not None

    def reqs():
        return [ts.Request(uid=0, prompt=_prompt(37, 9), max_new_tokens=8,
                           n=2, seed=seed, eos_id=eos)]

    t, _ = _tree_vs_fork(params, reqs)
    got = {r.index: r for r in t.results}
    assert got[0].outcome == "eos" and got[0].tokens[-1] == eos
    assert got[1].outcome == "budget" and len(got[1].tokens) == 8
    assert got[1].tokens == b[1]


def test_cancel_before_the_start_and_mid_family(params):
    eng = tree_eng(params)
    early = ts.Request(uid=0, prompt=_prompt(15, 20), max_new_tokens=4, n=3)
    rep = eng.serve(ScriptedSource(eng, [early], cancels={1: [0]}),
                    max_ticks=200)
    assert sorted(r.index for r in rep.results) == [0, 1, 2]
    assert {r.outcome for r in rep.results} == {"cancelled"}
    assert drained(eng)
    mid = ts.Request(uid=1, prompt=_prompt(38, 8), max_new_tokens=7, n=4,
                     seed=4)
    rep = eng.serve(ScriptedSource(eng, [mid], cancels={4: [1]}),
                    max_ticks=200)
    assert sorted(r.index for r in rep.results) == [0, 1, 2, 3]
    assert {r.outcome for r in rep.results} == {"cancelled"}
    assert all(0 < len(r.tokens) < 7 for r in rep.results)
    assert not eng._tree_fams and drained(eng)


def test_best_of_streams_only_the_winner(params):
    eng = tree_eng(params)
    got = {"tok": [], "fin": []}
    rep = eng.serve([ts.Request(
        uid=0, prompt=_prompt(40, 8), max_new_tokens=4, best_of=4, seed=8,
        on_branch_token=lambda i, t: got["tok"].append((i, t)),
        on_branch_finish=lambda i, r: got["fin"].append((i, r)))])
    assert rep.kv["tree_families"] == 1 and len(rep.results) == 4
    assert len(got["fin"]) == 1 and got["fin"][0][0] == 0
    best = max(rep.results, key=lambda r: (r.cum_logprob, -r.index))
    assert got["fin"][0][1].tokens == best.tokens
    assert [t for _, t in got["tok"]] == best.tokens
    assert drained(eng)


def test_random_families_conversions_and_cancels_drain_clean(params):
    """n up to 6 and best-of families on 2 slots (the fork-slot path could
    not admit most of them), fork_at conversions and cancels aimed at
    anything: every uid finishes and the engine drains clean."""
    eng = tree_eng(params)
    rng = np.random.default_rng(777)
    arrivals, cancels = [], {}
    uid = tick = 0
    for _ in range(60):
        tick += int(rng.integers(0, 3))
        if rng.random() < 0.6 or uid == 0:
            kw = {}
            style = rng.random()
            if style < 0.45:
                kw["n"] = int(rng.integers(2, 7))
            elif style < 0.6:
                kw["best_of"] = int(rng.integers(2, 5))
            elif style < 0.75:
                kw["fork_at"] = int(rng.integers(1, 3))
            arrivals.append(ts.Request(
                uid=uid, prompt=rng.integers(
                    0, 128, size=int(rng.integers(2, 8))).astype(np.int32),
                max_new_tokens=int(rng.integers(2, 5)), arrival_tick=tick,
                seed=int(rng.integers(0, 99)), **kw))
            uid += 1
        else:
            cancels.setdefault(tick, []).append(int(rng.integers(0, uid + 2)))
    rep = eng.serve(ScriptedSource(eng, arrivals, cancels), max_ticks=40_000)
    assert sorted({r.uid for r in rep.results}) == list(range(uid))
    assert rep.kv["tree_families"] > 0
    assert not eng._tree_fams and drained(eng)


def test_sample_rows_takes_one_key_per_row():
    """A tree slot's rows draw under their branches' keys: a per-row key
    array gives each row the draw a one-key-per-slot call gives it."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(2, 3, 40, generator=g)
    temp = np.array([1.0, 0.8], np.float32)
    topk = np.array([0, 7], np.int32)
    idx = np.array([[0, 1, 2], [4, 4, 5]])
    rows = np.ones((2, 3), bool)
    keys = np.array([[11, 12, 13], [21, 22, 23]], np.int64)
    tok, lp = td.sample_rows(logits, temp, topk, keys, idx, rows)
    for i in range(2):
        for j in range(3):
            one, olp = td.sample_rows(logits[i:i + 1, j:j + 1], temp[i:i + 1],
                                      topk[i:i + 1], [int(keys[i, j])],
                                      idx[i:i + 1, j:j + 1],
                                      rows[i:i + 1, j:j + 1])
            assert int(one) == int(tok[i, j]) and float(olp) == float(lp[i, j])
