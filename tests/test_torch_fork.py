"""The port's copy-on-write fork families against the JAX package's (CPU).

Counterparts of ``tests/test_serving_fork.py``, at its tiny model (2
layers, 4 heads over 2 KV heads, d_head 16, ``cache_len`` 32, ``kv_block``
4, ``prefill_chunk`` 4; f32, weights from ``seeded_params``). The JAX
engines and the port's run the fork-slot path (``tree_sampling=False``);
the token-tree default is ``tests/test_torch_tree.py``'s.

- **The allocator.** One random operation sequence (reserve, alloc, free,
  publish, fork_shared, release_shared, and the audited misuses: sharing a
  free or cached block, releasing a block never shared) through the port's
  ``BlockAllocator`` and JAX's, step for step: the same ids, the same
  audits raised, the same free, shared and reserved counts.
- **The tail copy.** ``copy_pool_block`` against JAX's on exact and int8
  pools: the same bytes and block scales; ``src == dst`` changes nothing.
- **Greedy families.** One trace per engine (exact with the prefix cache,
  int8, whole admission): families on prompts that end mid-block and on a
  block edge, a family whose prompt is a prefix hit, and a ``fork_at``
  request. Every ``(uid, index)``'s tokens, the fork counts and the leak
  report (no shared block, no pin left) equal JAX's; each branch equals an
  independent request of its prompt. The sharded pool's family rides
  ``tests/test_torch_seq_shard.py``'s rank spawn.
- **Within the port.** Sampled families: one seed, the same tokens; the
  branches differ; branch 0 is the ``n = 1`` stream. ``fork_at`` shares
  its prefix then diverges; an unknown uid in the fork mailbox ages out; a
  fork issued while the request prefills waits; best-of streams only the
  winner. Validation raises JAX's messages on the same shapes. Every port
  engine here passes ``tree_sampling=False``: the token-tree path is
  ``tests/test_torch_tree.py``'s. Cancels before
  the fork and mid-family, and a seeded random fork/join/cancel walk, drain
  clean.
- **HTTP.** One loopback ``IngressServer``: ``n = 3`` over SSE (indexed
  branches equal to a direct serve of the same seed), best-of (one
  branch, the winner's tokens), a whole body with ``n = 2``, and invalid
  fork fields (400, or an ``error`` finish per branch where the engine
  rejects the family).
"""

from __future__ import annotations

import http.client
import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tree_attention_tpu import models as jm
from tree_attention_tpu import serving as js
from tree_attention_tpu.models import decode as jd
from tree_attention_tpu.serving import block_pool as jbp

from tree_attention_tpu_torch import models as tm
from tree_attention_tpu_torch import serving as ts
from tree_attention_tpu_torch.models import decode as td
from tree_attention_tpu_torch.serving import block_pool as tbp
from tests.torch_params import fresh_whole_scratch, seeded_params
from tests.torch_threads import few_torch_threads  # noqa: F401

CFG = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_head=16, d_ff=128)
J_CFG = jm.TransformerConfig(**CFG, dtype=jnp.float32)
T_CFG = tm.TransformerConfig(**CFG, dtype=torch.float32)
BASE = dict(cache_len=32, kv_block=4, prefill_chunk=4)
# The greedy engines' flags (the prefix hit happens where the cache is on).
CASES = {
    "exact-prefix": dict(slots=6, prefix_cache=True, prefix_block=4),
    "int8": dict(slots=5, quantize=True),
    "whole": dict(slots=4, admission="whole"),
}
N_NEW = 5


def _prompt(seed, n=13):
    return np.random.default_rng(seed).integers(0, 128, n).astype(np.int32)


def _trace(mod):
    """uid 0: 13 tokens (ends mid-block), n 3; 1: 10 tokens, n 4; 2: 12
    tokens (three whole blocks), n 2; 3: uid 0's prompt again once it is
    published (a prefix hit where the cache is on), n 2; 4: a greedy
    request that forks itself after its 3rd token."""
    a, b, c, d = _prompt(1), _prompt(2, 10), _prompt(3, 12), _prompt(4, 11)
    return [mod.Request(uid=0, prompt=a, max_new_tokens=N_NEW, n=3),
            mod.Request(uid=1, prompt=b, max_new_tokens=N_NEW, n=4),
            mod.Request(uid=2, prompt=c, max_new_tokens=N_NEW, n=2),
            mod.Request(uid=3, prompt=a, max_new_tokens=N_NEW, n=2,
                        arrival_tick=12),
            mod.Request(uid=4, prompt=d, max_new_tokens=7, fork_at=3,
                        arrival_tick=12)]


def _branches(report):
    return {(r.uid, r.index): list(map(int, r.tokens))
            for r in report.results}


def drained(eng) -> bool:
    lr = eng.leak_report()
    return (lr["blocks_private"] == lr["blocks_shared"]
            == lr["blocks_reserved"] == lr["pins"] == 0
            and lr["blocks_used"] == lr["blocks_cached"]
            and all(st == "free" for st in eng._slot_state)
            and not eng._families)


@pytest.fixture(scope="module")
def params():
    return seeded_params(T_CFG)


_RUNS = {}


def _run(params, case):
    """The case's trace through JAX's engine and the port's, once."""
    if case not in _RUNS:
        jp, tp = params
        jserver = fresh_whole_scratch(js.SlotServer(
            jp, J_CFG, tree_sampling=False, **BASE, **CASES[case]))
        jrep = jserver.serve(_trace(js), max_ticks=400)
        server = ts.SlotServer(tp, T_CFG, tree_sampling=False, **BASE,
                               **CASES[case])
        rep = server.serve(_trace(ts), max_ticks=400)
        _RUNS[case] = dict(jrep=jrep, jleaks=jserver.leak_report(), rep=rep,
                           server=server)
    return _RUNS[case]


# -- the allocator -----------------------------------------------------------

def _apply(pool, op, arg):
    """One allocator operation; an audit (AssertionError) is a result."""
    try:
        if op == "reserve":
            return pool.reserve(arg)
        if op == "alloc":
            return pool.alloc()
        if op == "free":
            return pool.free_private(arg)
        if op == "publish":
            return pool.publish(arg)
        if op == "share":
            return pool.fork_shared(arg)
        if op == "release":
            return pool.release_shared(arg)
        if op == "unreserve":
            return pool.unreserve(arg)
    except AssertionError:
        return "audit"
    raise AssertionError(op)


def test_allocator_shared_state_matches_jax_step_for_step():
    pools = [jbp.BlockAllocator(10), tbp.BlockAllocator(10)]
    rng = np.random.default_rng(0)
    private, shared, cached, freed = [], {}, [], []
    audits = 0
    for _ in range(400):
        r = rng.random()
        if r < 0.2:
            op, arg = "reserve", int(rng.integers(1, 3))
        elif r < 0.4:
            op, arg = "alloc", None
        elif r < 0.5 and private:
            op, arg = "free", private[int(rng.integers(len(private)))]
        elif r < 0.55 and private:
            op, arg = "publish", private[int(rng.integers(len(private)))]
        elif r < 0.75 and (private or shared):
            pick = list(private) + list(shared)
            k = int(rng.integers(1, min(3, len(pick)) + 1))
            op = "share"
            arg = [int(b) for b in rng.choice(pick, k, replace=False)]
        elif r < 0.9 and shared:
            op, arg = "release", list(shared)[int(rng.integers(len(shared)))]
        elif r < 0.95:
            # Misuse the audits must refuse: share a free or cached block,
            # release one that is not shared.
            bad = (freed + cached + private)
            if not bad:
                continue
            b = bad[int(rng.integers(len(bad)))]
            op, arg = ("release", b) if b in private else ("share", [b])
        else:
            if pools[1].reserved == 0:
                continue
            op, arg = "unreserve", 1
        out = [_apply(p, op, arg) for p in pools]
        assert out[0] == out[1], (op, arg, out)
        if out[1] == "audit":
            audits += 1
            continue
        if op == "alloc":
            private.append(out[1])
            if out[1] in freed:
                freed.remove(out[1])
        elif op == "free":
            private.remove(arg)
            freed.append(arg)
        elif op == "publish":
            private.remove(arg)
            cached.append(arg)
        elif op == "share":
            for b in arg:
                if b in private:
                    private.remove(b)
                    shared[b] = 2
                else:
                    shared[b] += 1
        elif op == "release":
            shared[arg] -= 1
            if not shared[arg]:
                del shared[arg]
                freed.append(arg)
        j, t = pools
        assert (t.free_count, t.used, t.reserved, t.shared_count, t.gen,
                t.fork_shares) == (j.free_count, j.used, j.reserved,
                                   j.shared_count, j.gen, j.fork_shares)
        assert all(t.shared_refs(b) == j.shared_refs(b) == n
                   for b, n in shared.items())
    assert audits > 10 and pools[1].fork_shares > 10


def test_shared_blocks_leave_eviction_and_demotion_alone():
    """A shared block is slot-owned: publishing, evicting or demoting it
    is an audit, exactly as in JAX's ledger."""
    for mod in (jbp, tbp):
        pool = mod.BlockAllocator(4)
        assert pool.reserve(2)
        a, b = pool.alloc(), pool.alloc()
        pool.fork_shared([a])
        for fn in (pool.publish, pool.free_cached, pool.demote_cached,
                   pool.free_private):
            with pytest.raises(AssertionError):
                fn(a)
        pool.publish(b)
        with pytest.raises(AssertionError, match="fork-shared"):
            pool.fork_shared([b])
        pool.release_shared(a)
        assert pool.shared_count == 1 and pool.shared_refs(a) == 1
        gen = pool.gen
        pool.release_shared(a)
        assert pool.shared_count == 0 and pool.gen == gen + 1
        assert pool.free_count == 3


# -- the tail copy -----------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["exact", "int8"])
def test_copy_pool_block_matches_jax(quant):
    rng = np.random.default_rng(5)
    L, N, H, blk, D = 2, 6, 2, 4, 16
    shape = (L, N + 1, H, blk, D)
    if quant:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.01, 0.05, (L, N + 1, H)).astype(np.float32)
        vs = rng.uniform(0.01, 0.05, (L, N + 1, H)).astype(np.float32)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
    table = np.zeros((2, 8), np.int32)
    length = np.zeros((2,), np.int32)
    if quant:
        jc = jd.PagedQuantKVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                                  k_scale=jnp.asarray(ks),
                                  v_scale=jnp.asarray(vs),
                                  table=jnp.asarray(table),
                                  length=jnp.asarray(length))
        tc = td.PagedQuantKVCache(k=torch.from_numpy(k.copy()),
                                  v=torch.from_numpy(v.copy()),
                                  table=torch.from_numpy(table),
                                  length=torch.from_numpy(length),
                                  k_scale=torch.from_numpy(ks.copy()),
                                  v_scale=torch.from_numpy(vs.copy()))
        names = ("k", "v", "k_scale", "v_scale")
    else:
        jc = jd.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                             table=jnp.asarray(table),
                             length=jnp.asarray(length))
        tc = td.PagedKVCache(k=torch.from_numpy(k.copy()),
                             v=torch.from_numpy(v.copy()),
                             table=torch.from_numpy(table),
                             length=torch.from_numpy(length))
        names = ("k", "v")
    before = {n: getattr(tc, n).clone() for n in names}
    tc = td.copy_pool_block(tc, 3, 3)  # src == dst: the same bytes
    for n in names:
        assert torch.equal(getattr(tc, n), before[n])
    for src, dst in ((1, 4), (5, 0)):
        jc = jd.copy_pool_block(jc, src, dst)
        tc = td.copy_pool_block(tc, src, dst)
        for n in names:
            np.testing.assert_array_equal(getattr(tc, n).numpy(),
                                          np.asarray(getattr(jc, n)),
                                          err_msg=n)
        assert torch.equal(tc.k[:, dst], tc.k[:, src])


# -- greedy families against JAX ---------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_greedy_families_match_jax(params, case):
    run = _run(params, case)
    got, want = _branches(run["rep"]), _branches(run["jrep"])
    assert got == want
    # Every requested completion finished once, with its budget.
    assert sorted(got) == ([(0, i) for i in range(3)]
                           + [(1, i) for i in range(4)]
                           + [(2, i) for i in range(2)]
                           + [(3, i) for i in range(2)] + [(4, 0), (4, 1)])
    assert run["rep"].outcomes == run["jrep"].outcomes == {"budget": 13}
    # Greedy branches are the same stream; the fork_at branch shares it.
    for uid in range(5):
        assert len({tuple(t) for (u, _), t in got.items() if u == uid}) == 1
    for key in ("forks", "fork_blocks_shared"):
        assert run["rep"].kv[key] == run["jrep"].kv[key], key
    leaks = run["server"].leak_report()
    assert leaks == {k: run["jleaks"][k] for k in leaks}
    assert drained(run["server"])
    hits = {(r.uid, r.index): r.prefix_hit_tokens
            for r in run["rep"].results}
    jhits = {(r.uid, r.index): r.prefix_hit_tokens
             for r in run["jrep"].results}
    assert hits == jhits
    if case == "exact-prefix":
        assert hits[(3, 0)] == 12  # the hit: three whole blocks


def test_branches_equal_independent_requests(params):
    """Each branch equals an independent request of its prompt (one
    engine, the exact pool)."""
    run = _run(params, "exact-prefix")
    server = run["server"]
    trace = _trace(ts)
    rep = server.serve([ts.Request(uid=100 + r.uid, prompt=r.prompt,
                                   max_new_tokens=r.max_new_tokens)
                        for r in trace])
    got = _branches(run["rep"])
    for r in rep.results:
        assert got[(r.uid - 100, 0)] == list(map(int, r.tokens))
    assert drained(server)


# -- within the port: sampled families, forks, best-of ------------------------

_ENGINES = {}


def _engine(params, **kw):
    key = tuple(sorted(kw.items()))
    if key not in _ENGINES:
        _ENGINES[key] = ts.SlotServer(params[1], T_CFG,
                                      **{"tree_sampling": False, **BASE,
                                         **kw})
    return _ENGINES[key]


def sampled(params):
    return _engine(params, slots=6, temperature=1.0, top_k=50)


def greedy(params):
    return _engine(params, slots=6)


def test_sampled_family_reproducible_diverse_and_branch0_plain(params):
    eng = sampled(params)
    req = dict(prompt=_prompt(7), max_new_tokens=6, seed=11)
    r1 = eng.serve([ts.Request(uid=0, n=4, **req)])
    r2 = eng.serve([ts.Request(uid=5, n=4, **req)])
    b1 = {r.index: r.tokens for r in r1.results}
    b2 = {r.index: r.tokens for r in r2.results}
    assert b1 == b2, "one seed, two serves: the same branches"
    assert len({tuple(t) for t in b1.values()}) >= 2, "branches never differ"
    plain = eng.serve([ts.Request(uid=9, **req)])
    assert plain.results[0].tokens == b1[0]
    assert all(r.cum_logprob < 0.0 for r in r1.results)
    assert drained(eng)


def test_fork_at_shares_the_prefix_then_diverges(params):
    eng = sampled(params)
    rep = eng.serve([ts.Request(uid=0, prompt=_prompt(10),
                                max_new_tokens=8, fork_at=3, seed=2)])
    res = {r.index: r.tokens for r in rep.results}
    assert sorted(res) == [0, 1]
    assert res[0][:3] == res[1][:3]
    assert res[0] != res[1]
    assert rep.kv["forks"] == 1
    assert drained(eng)


def test_fork_mailbox_unknown_uid_ages_out(params):
    eng = greedy(params)
    eng.fork(987654)
    rep = eng.serve([ts.Request(uid=0, prompt=_prompt(11),
                                max_new_tokens=4)])
    assert rep.outcomes == {"budget": 1} and len(rep.results) == 1
    assert not eng._fork_carry
    assert drained(eng)


def test_fork_issued_while_prefilling_waits_until_live(params):
    eng = greedy(params)
    eng.fork(0)  # in the mailbox before the request is even admitted
    rep = eng.serve([ts.Request(uid=0, prompt=_prompt(21, n=24),
                                max_new_tokens=6)])
    res = {r.index: r.tokens for r in rep.results}
    assert sorted(res) == [0, 1]
    assert res[0] == res[1]  # greedy branches stay identical
    assert not eng._fork_carry
    assert drained(eng)


def test_best_of_streams_only_the_winner(params):
    eng = sampled(params)
    got = {"tok": [], "fin": []}
    rep = eng.serve([ts.Request(
        uid=0, prompt=_prompt(12), max_new_tokens=5, best_of=3, seed=4,
        on_branch_token=lambda i, t: got["tok"].append((i, t)),
        on_branch_finish=lambda i, r: got["fin"].append((i, r)))])
    assert len(rep.results) == 3  # the report keeps every branch
    assert len(got["fin"]) == 1 and got["fin"][0][0] == 0
    best = max(rep.results, key=lambda r: (r.cum_logprob, -r.index))
    assert got["fin"][0][1].tokens == best.tokens
    assert [t for _, t in got["tok"]] == best.tokens
    assert all(i == 0 for i, _ in got["tok"])
    assert drained(eng)


def test_validation_matches_jax(params):
    jp, tp = params
    jeng = js.SlotServer(jp, J_CFG, slots=3, tree_sampling=False,
                         kv_blocks=12, **BASE)
    teng = ts.SlotServer(tp, T_CFG, slots=3, tree_sampling=False,
                         kv_blocks=12, **BASE)
    jcon = js.SlotServer(jp, J_CFG, slots=3, kv_layout="contiguous", **BASE)
    tcon = ts.SlotServer(tp, T_CFG, slots=3, kv_layout="contiguous", **BASE)
    p = _prompt(13)
    shapes = [dict(n=0), dict(n=2, best_of=3), dict(n=4), dict(best_of=4),
              dict(fork_at=0), dict(n=3, max_new_tokens=19)]
    for kw in shapes:
        kw = {"max_new_tokens": 5, **kw}
        msgs = []
        for mod, eng in ((js, jeng), (ts, teng)):
            with pytest.raises(ValueError) as e:
                eng._validate(mod.Request(uid=0, prompt=p, **kw))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], kw
    msgs = []
    for mod, eng in ((js, jcon), (ts, tcon)):
        with pytest.raises(ValueError, match="paged") as e:
            eng._validate(mod.Request(uid=0, prompt=p, max_new_tokens=5,
                                      n=2))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    spec = ts.SlotServer(tp, T_CFG, slots=3, speculate=True, **BASE)
    with pytest.raises(ValueError, match="speculate"):
        spec._validate(ts.Request(uid=0, prompt=p, max_new_tokens=5, n=2))


@pytest.mark.parametrize("kw", [dict(n=3), dict(best_of=4),
                                dict(fork_at=2), dict(n=1, best_of=1)],
                         ids=["n", "best_of", "fork_at", "plain"])
def test_synthetic_trace_stamps_fork_fields_like_jax(kw):
    trace = dict(prompt_len=9, prompt_jitter=3, vocab_size=128, seed=3,
                 **kw)
    got, want = ts.synthetic_trace(4, **trace), js.synthetic_trace(4, **trace)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert (a.n, a.best_of, a.fork_at) == (b.n, b.best_of, b.fork_at)


# -- cancels and the random walk ---------------------------------------------

class ScriptedSource(ts.RequestSource):
    """Arrivals by tick plus cancel and fork actions through the engine's
    mailboxes."""

    def __init__(self, eng, arrivals, cancels=None, forks=None):
        self.eng = eng
        self._arr = sorted(arrivals, key=lambda r: (r.arrival_tick, r.uid))
        self._pos = 0
        self._cancels = dict(cancels or {})
        self._forks = dict(forks or {})

    def poll(self, tick):
        for t in sorted(k for k in self._cancels if k <= tick):
            for uid in self._cancels.pop(t):
                self.eng.cancel(uid)
        for t in sorted(k for k in self._forks if k <= tick):
            for uid in self._forks.pop(t):
                self.eng.fork(uid)
        out = []
        while (self._pos < len(self._arr)
               and self._arr[self._pos].arrival_tick <= tick):
            out.append(self._arr[self._pos])
            self._pos += 1
        return out

    def next_arrival(self):
        ticks = list(self._cancels) + list(self._forks)
        if self._pos < len(self._arr):
            ticks.append(self._arr[self._pos].arrival_tick)
        return min(ticks) if ticks else None

    @property
    def exhausted(self):
        return (self._pos >= len(self._arr) and not self._cancels
                and not self._forks)


def test_cancel_before_the_family_forks_releases_everything(params):
    eng = greedy(params)
    req = ts.Request(uid=0, prompt=_prompt(15, n=24), max_new_tokens=4, n=3)
    rep = eng.serve(ScriptedSource(eng, [req], cancels={1: [0]}),
                    max_ticks=200)
    assert sorted(r.index for r in rep.results) == [0, 1, 2]
    assert {r.outcome for r in rep.results} == {"cancelled"}
    assert drained(eng)


def test_cancel_mid_family_retires_every_branch(params):
    eng = greedy(params)
    req = ts.Request(uid=0, prompt=_prompt(16), max_new_tokens=12, n=3)
    rep = eng.serve(ScriptedSource(eng, [req], cancels={6: [0]}),
                    max_ticks=200)
    assert sorted(r.index for r in rep.results) == [0, 1, 2]
    assert {r.outcome for r in rep.results} == {"cancelled"}
    assert all(0 < len(r.tokens) < 12 for r in rep.results)
    assert drained(eng)


def test_random_fork_join_cancel_walk_drains_clean(params):
    """Family admissions (n up to 3, some best_of), fork_at requests,
    mailboxed forks and cancels aimed at anything, on the prefix-cached
    pool; every uid finishes and the engine drains clean."""
    eng = _engine(params, slots=6, prefix_cache=True, prefix_block=4)
    rng = np.random.default_rng(4321)
    arrivals, cancels, forks = [], {}, {}
    uid = tick = 0
    for _ in range(150):
        r = rng.random()
        tick += int(rng.integers(0, 3))
        if r < 0.5 or uid == 0:
            kw = {}
            style = rng.random()
            if style < 0.35:
                kw["n"] = int(rng.integers(2, 4))
            elif style < 0.5:
                kw["best_of"] = int(rng.integers(2, 4))
            elif style < 0.7:
                kw["fork_at"] = int(rng.integers(1, 4))
            arrivals.append(ts.Request(
                uid=uid, prompt=rng.integers(
                    0, 128, size=int(rng.integers(2, 14))).astype(np.int32),
                max_new_tokens=int(rng.integers(2, 7)), arrival_tick=tick,
                **kw))
            uid += 1
        elif r < 0.8:
            cancels.setdefault(tick, []).append(int(rng.integers(0, uid + 3)))
        else:
            forks.setdefault(tick, []).append(int(rng.integers(0, uid + 3)))
    rep = eng.serve(ScriptedSource(eng, arrivals, cancels, forks),
                    max_ticks=20_000)
    assert sorted({r.uid for r in rep.results}) == list(range(uid))
    assert rep.outcomes.get("cancelled", 0) > 0
    assert rep.kv.get("forks", 0) > 0
    assert not eng._fork_carry
    assert drained(eng)


# -- HTTP --------------------------------------------------------------------

LIVE = dict(slots=6, temperature=0.8, seed=5, tree_sampling=False)


@pytest.fixture(scope="module")
def live(params):
    srv = ts.IngressServer(ts.SlotServer(params[1], T_CFG, **BASE, **LIVE),
                           max_queue=8, default_max_tokens=4,
                           keepalive_s=0.05)
    srv.start()
    yield srv
    if srv.running:
        srv.stop()


def _post(port, body, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/v1/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    return conn, conn.getresponse()


def _read_sse_indexed(resp):
    tokens, finishes = {}, {}
    while True:
        line = resp.readline()
        if not line:
            break
        line = line.strip()
        if not line.startswith(b"data: "):
            continue
        if line[6:] == b"[DONE]":
            break
        ch = json.loads(line[6:])["choices"][0]
        tokens.setdefault(ch["index"], []).extend(ch["token_ids"])
        if ch["finish_reason"] is not None:
            finishes[ch["index"]] = ch["finish_reason"]
    return tokens, finishes


def _settled(eng, timeout=15.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if drained(eng):
            return True
        time.sleep(0.05)
    return False


def _direct(params, **kw):
    """The same request served directly by an engine like the live one."""
    eng = _engine(params, **LIVE)
    return eng.serve([ts.Request(uid=123, **kw)]).results


def test_http_n3_streams_indexed_branches(params, live):
    prompt = _prompt(18)
    body = {"prompt": [int(t) for t in prompt], "max_tokens": 4, "n": 3,
            "seed": 7}
    conn, resp = _post(live.port, body)
    assert resp.status == 200
    tokens, finishes = _read_sse_indexed(resp)
    conn.close()
    assert sorted(tokens) == sorted(finishes) == [0, 1, 2]
    assert set(finishes.values()) == {"length"}
    want = _direct(params, prompt=prompt, max_new_tokens=4, n=3, seed=7)
    assert tokens == {r.index: r.tokens for r in want}
    assert _settled(live.engine)


def test_http_best_of_streams_one_winner(params, live):
    prompt = _prompt(19)
    conn, resp = _post(live.port, {"prompt": [int(t) for t in prompt],
                                   "max_tokens": 4, "best_of": 3,
                                   "seed": 8})
    assert resp.status == 200
    tokens, finishes = _read_sse_indexed(resp)
    conn.close()
    assert sorted(tokens) == sorted(finishes) == [0]
    want = _direct(params, prompt=prompt, max_new_tokens=4, best_of=3,
                   seed=8)
    best = max(want, key=lambda r: (r.cum_logprob, -r.index))
    assert tokens[0] == best.tokens
    assert _settled(live.engine)


def test_http_whole_body_n2_choices(live):
    conn, resp = _post(live.port, {"prompt": [int(t) for t in _prompt(20)],
                                   "max_tokens": 3, "n": 2,
                                   "stream": False, "temperature": 0.0})
    assert resp.status == 200
    body = json.loads(resp.read())
    conn.close()
    assert [c["index"] for c in body["choices"]] == [0, 1]
    assert body["choices"][0]["token_ids"] == body["choices"][1]["token_ids"]
    assert body["usage"]["completion_tokens"] == 6
    assert _settled(live.engine)


def test_http_rejects_bad_fork_fields(live):
    for bad, frag in (({"n": 0}, "n must be >= 1"),
                      ({"n": "x"}, "non-numeric"),
                      ({"best_of": 0}, "best_of must be >= 1"),
                      ({"fork_at": 0}, "fork_at must be >= 1"),
                      ({"n": 2, "best_of": 3}, "requires n == 1")):
        conn, resp = _post(live.port, {"prompt": [1, 2, 3],
                                       "max_tokens": 2, **bad})
        assert resp.status == 400, bad
        assert frag in json.loads(resp.read())["error"]["message"], bad
        conn.close()
    # More branches than slots: the engine rejects the family, one
    # ``error`` finish per requested completion.
    conn, resp = _post(live.port, {"prompt": [1, 2, 3], "max_tokens": 2,
                                   "n": 7})
    assert resp.status == 200
    tokens, finishes = _read_sse_indexed(resp)
    conn.close()
    assert finishes == {i: "error" for i in range(7)}
    assert live.queue_depth == 0
    assert _settled(live.engine)
