"""The port's radix prefix cache against the JAX package's (CPU).

Counterparts of ``tests/test_serving_prefix.py`` and the prefix cases of
``tests/test_serving_paged.py``:

- **Serving.** One JAX ``SlotServer`` run per (layout, quantization) serves
  one trace that holds a cold request, its hit, a prompt of whole blocks
  (its hit keeps one suffix token) and three prompts sharing a prefix with
  diverging suffixes; the port serves the same trace with the cache on and
  off. Greedy tokens are exact on the CPU (float32): equal to JAX's and to
  the cache-off serve. The prefix stats, every request's
  ``prefix_hit_tokens`` and the drained leak report equal JAX's. Eviction
  pressure runs against JAX too, on both layouts.
- **The radix index.** ``PagedPrefixIndex`` over a ``BlockAllocator`` and
  the contiguous ``PrefixCache`` run op for op beside JAX's under random
  admissions, publishes and retirements (hypothesis): every match, adopted
  block, eviction and ledger count equal.
- **KV moves.** The gathers and scatters of a hit and a publish equal JAX's
  bit for bit (pure copies, and int8 x f32 scale products).
- **Contracts.** A paged exact hit moves zero device bytes (the shared
  blocks' bytes are read back unchanged); the metrics flow; the CLI flags
  and the record; the prefix cache on a mesh, left to a later slice,
  raises.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tree_attention_tpu import models as jm
from tree_attention_tpu import serving as js
from tree_attention_tpu.models import decode as jd
from tree_attention_tpu.serving.block_pool import BlockAllocator as JAlloc
from tree_attention_tpu.serving.prefix_cache import (
    PagedPrefixIndex as JIndex,
    PrefixCache as JCache,
)

from tree_attention_tpu_torch import cli
from tree_attention_tpu_torch import models as tm
from tree_attention_tpu_torch import obs
from tree_attention_tpu_torch import serving as ts
from tree_attention_tpu_torch.models import decode as td
from tree_attention_tpu_torch.serving.block_pool import (
    BlockAllocator as TAlloc,
)
from tree_attention_tpu_torch.serving.prefix_cache import (
    PagedPrefixIndex as TIndex,
    PrefixCache as TCache,
)
from tests.torch_params import seeded_params
from tests.torch_threads import few_torch_threads  # noqa: F401

CFG = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_head=16, d_ff=128)
J_CFG = jm.TransformerConfig(**CFG, dtype=jnp.float32)
T_CFG = tm.TransformerConfig(**CFG, dtype=torch.float32)

# chunk == block == 4, as the JAX suite's prefix tests run.
ENGINE = dict(slots=2, cache_len=32, prefill_chunk=4, prefill_budget=4)
PREFIX = dict(prefix_cache=True, prefix_block=4, prefix_pool_blocks=16)
CASES = {
    "paged": {},
    "paged-int8": {"quantize": True},
    "contig": {"kv_layout": "contiguous"},
    "contig-int8": {"kv_layout": "contiguous", "quantize": True},
}
N_NEW = 4


def _prompts():
    """(prompt, arrival tick) per uid: 0 cold (13 tokens: 3 whole blocks
    publish), 1 its repeat (hit 12), 2 a prompt of 3 whole blocks, 3 its
    repeat (hit 8: one suffix token stays), 4-6 a shared 12-token prefix
    with diverging suffixes (4 publishes it, 5 and 6 hit 12 each, admitted
    together). Arrivals leave each publisher time to reach its final
    chunk."""
    rng = np.random.default_rng(4)
    cold = rng.integers(0, 128, 13).astype(np.int32)
    whole = rng.integers(0, 128, 12).astype(np.int32)
    shared = rng.integers(0, 128, 12).astype(np.int32)
    div = [np.concatenate([shared, rng.integers(0, 128, k).astype(np.int32)])
           for k in (3, 5, 2)]
    return [(cold, 0), (cold, 8), (whole, 16), (whole, 24), (div[0], 32),
            (div[1], 40), (div[2], 40)]


HIT_TOKENS = [0, 12, 0, 8, 0, 12, 12]


def _reqs(mod, prompts=None, n_new=N_NEW):
    return [mod.Request(uid=i, prompt=p, max_new_tokens=n_new,
                        arrival_tick=t)
            for i, (p, t) in enumerate(prompts or _prompts())]


def _tokens(report):
    return {r.uid: list(map(int, r.tokens)) for r in report.results}


@pytest.fixture(scope="module")
def params():
    return seeded_params(T_CFG)


_RUNS = {}


def _run(params, case):
    """The case's three serves of the trace, once per module: JAX with the
    cache on, the port with it on and off."""
    if case not in _RUNS:
        jp, tp = params
        kw = dict(**ENGINE, **CASES[case])
        jserver = js.SlotServer(jp, J_CFG, **kw, **PREFIX)
        jrep = jserver.serve(_reqs(js), max_ticks=500)
        server = ts.SlotServer(tp, T_CFG, **kw, **PREFIX)
        rep = server.serve(_reqs(ts), max_ticks=500)
        off = ts.SlotServer(tp, T_CFG, **kw).serve(_reqs(ts), max_ticks=500)
        _RUNS[case] = dict(jax=jrep, jleaks=jserver.leak_report(), port=rep,
                           server=server, off=off)
    return _RUNS[case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefix_tokens_match_jax_and_cache_off(params, case):
    run = _run(params, case)
    assert _tokens(run["port"]) == _tokens(run["jax"])
    assert _tokens(run["port"]) == _tokens(run["off"])
    assert run["port"].outcomes == {"budget": 7}


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefix_stats_match_jax(params, case):
    """Hits, misses, tokens reused, evictions, pool occupancy and the hit
    bytes (0 on the exact paged pool) are JAX's; so is every request's
    ``prefix_hit_tokens``."""
    run = _run(params, case)
    assert run["port"].prefix == run["jax"].prefix
    hits = [r.prefix_hit_tokens for r in run["port"].results]
    assert hits == [r.prefix_hit_tokens for r in run["jax"].results]
    assert hits == HIT_TOKENS
    assert run["port"].prefix["tokens_reused"] == sum(HIT_TOKENS)
    moved = run["port"].prefix["hit_bytes_moved"]
    assert (moved == 0) == (case == "paged")


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefix_hit_equals_cold_and_keeps_one_suffix_token(params, case):
    """The hit of a 13-token prompt reuses 12 tokens and emits the cold
    run's tokens; a prompt of whole blocks matches all but its last
    block."""
    toks = _tokens(_run(params, case)["port"])
    assert toks[1] == toks[0]
    assert toks[3] == toks[2]


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefix_shared_prefix_diverging_suffixes(params, case):
    res = _run(params, case)["port"].results[4:]
    assert sum(r.prefix_hit_tokens > 0 for r in res) == 2
    assert sum(r.prefix_hit_tokens for r in res) == 24


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefix_drained_server_holds_only_tree_blocks(params, case):
    run = _run(params, case)
    leaks = run["server"].leak_report()
    assert leaks == {k: run["jleaks"][k] for k in leaks}
    assert leaks["blocks_private"] == leaks["blocks_reserved"] == 0
    assert leaks["pins"] == 0 and leaks["blocks_cached"] > 0
    paged = not case.startswith("contig")
    assert leaks["blocks_used"] == (leaks["blocks_cached"] if paged else 0)


@pytest.mark.parametrize("layout", ["paged", "contig"])
def test_prefix_with_speculation_equals_cache_off(params, layout):
    """Speculative serving with the cache on (as the JAX engine accepts on
    one device) commits the cache-off stream; rollback never unmaps a
    shared block (``_spec_unmap`` asserts it)."""
    _, tp = params
    kw = dict(**ENGINE, **CASES[layout])
    server = ts.SlotServer(tp, T_CFG, **kw, **PREFIX, speculate=True,
                           drafter="ngram-tree")
    rep = server.serve(_reqs(ts), max_ticks=500)
    assert _tokens(rep) == _tokens(_run(params, layout)["off"])
    assert rep.prefix["tokens_reused"] == sum(HIT_TOKENS)
    assert server.leak_report()["pins"] == 0


def _pressure_prompts():
    rng = np.random.default_rng(6)
    base = rng.integers(0, 128, 8).astype(np.int32)
    out = []
    for i in range(8):
        n = int(rng.integers(2, 14))
        p = rng.integers(0, 128, n).astype(np.int32)
        if i % 2:  # every other prompt shares a head, so hits happen
            p = np.concatenate([base, p])[:max(n, 9)]
        out.append((p, i))
    return out


@pytest.mark.parametrize("layout", ["paged", "contig"])
def test_prefix_under_eviction_pressure(params, layout):
    """A pool far below the working set: the paged tree's blocks recycle
    through the allocator's evictor (10 blocks under two slots), the
    contiguous pool holds 2 blocks. Tokens equal JAX's and the cache-off
    serve's; evictions and hits equal JAX's."""
    jp, tp = params
    kw = dict(slots=2, cache_len=32, prefill_chunk=4, prefix_cache=True,
              prefix_block=4)
    kw.update({"kv_blocks": 10} if layout == "paged" else
              {"kv_layout": "contiguous", "prefix_pool_blocks": 2})
    prompts = _pressure_prompts()
    jrep = js.SlotServer(jp, J_CFG, **kw).serve(_reqs(js, prompts, 3),
                                               max_ticks=800)
    server = ts.SlotServer(tp, T_CFG, **kw)
    rep = server.serve(_reqs(ts, prompts, 3), max_ticks=800)
    off_kw = {k: v for k, v in kw.items() if not k.startswith("prefix")}
    off = ts.SlotServer(tp, T_CFG, **off_kw).serve(_reqs(ts, prompts, 3),
                                                   max_ticks=800)
    assert _tokens(rep) == _tokens(jrep) == _tokens(off)
    assert rep.prefix == jrep.prefix
    assert rep.prefix["evictions"] > 0
    assert server.leak_report()["pins"] == 0


# -- the radix index, op for op against JAX ---------------------------------

def _nodes(index):
    out, stack = [], list(index._root.children.values())
    while stack:
        n = stack.pop()
        out.append(n)
        stack.extend(n.children.values())
    return out


def _shape(index):
    """The tree as comparable data: (key path, block id, refs) per node."""
    def walk(node, prefix):
        for key, c in sorted(node.children.items()):
            yield prefix + (key,), c.block_id, c.refs
            yield from walk(c, prefix + (key,))
    return sorted(walk(index._root, ()))


_OP = st.tuples(st.sampled_from(["admit", "publish", "retire"]),
                st.lists(st.integers(0, 2), min_size=1, max_size=12),
                st.integers(0, 7))


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(ops=st.lists(_OP, min_size=1, max_size=60),
       max_cached=st.sampled_from([None, 3]))
def test_paged_index_matches_jax_op_for_op(ops, max_cached):
    """The engine's protocol on both sides in lockstep: match (unrecorded),
    reserve the total less the matched blocks (releasing the pins on
    refusal), allocate the prompt's blocks, adopt at publish, release and
    free at retire. Every result and the ledger agree; pinned nodes are
    never evicted; the drained tree holds no pin."""
    sides = []
    for Alloc, Index in ((JAlloc, JIndex), (TAlloc, TIndex)):
        alloc = Alloc(8)
        sides.append((alloc, Index(block=2, alloc=alloc,
                                   max_cached=max_cached), []))
    for kind, toks, pick in ops:
        outs = []
        for alloc, idx, live in sides:
            if kind == "admit":
                prompt = np.asarray(toks, np.int32)
                matched, nodes = idx.match(prompt, record=False)
                need = -(-(len(prompt) + 1) // 2) - len(nodes)
                if not alloc.reserve(need):
                    idx.release(nodes)
                    outs.append(("deferred", matched))
                    continue
                idx.record_match(matched)
                table = [n.block_id for n in nodes]
                private = set()
                for _ in range(-(-len(prompt) // 2) - len(nodes)):
                    b = alloc.alloc()
                    table.append(b)
                    private.add(b)
                live.append(dict(prompt=prompt, nodes=nodes, table=table,
                                 private=private, reserve=need - len(private),
                                 published=False))
                outs.append(("admitted", matched, tuple(table)))
            elif kind == "publish" and live:
                req = live[pick % len(live)]
                if req["published"]:
                    continue
                phys = {j: b for j, b in enumerate(req["table"])
                        if b in req["private"]}
                path, adopted = idx.adopt(req["prompt"], phys, req["nodes"])
                for j in adopted:
                    req["private"].discard(req["table"][j])
                req["nodes"], req["published"] = path, True
                outs.append(("adopted", tuple(adopted),
                             tuple(n.block_id for n in path)))
            elif kind == "retire" and live:
                req = live.pop(pick % len(live))
                idx.release(req["nodes"])
                for b in req["private"]:
                    alloc.free_private(b)
                alloc.unreserve(req["reserve"])
                outs.append("retired")
            outs.append((alloc.used, alloc.free_count, alloc.reserved,
                         alloc.available(), idx.evictable_blocks(),
                         idx.total_pins(), idx.stats(), _shape(idx)))
            current = {id(n) for n in _nodes(idx)}
            assert all(id(n) in current for r in live for n in r["nodes"])
        if outs:
            half = len(outs) // 2
            assert outs[:half] == outs[half:]
    for alloc, idx, live in sides:
        for req in live:
            idx.release(req["nodes"])
            for b in req["private"]:
                alloc.free_private(b)
            alloc.unreserve(req["reserve"])
        assert idx.total_pins() == 0 and alloc.reserved == 0
        assert alloc.used == idx.blocks_used


_TINY = dict(vocab_size=16, d_model=8, n_layers=1, n_heads=2, n_kv_heads=1,
             d_head=4, d_ff=16)


@settings(max_examples=40, deadline=None)
@given(ops=st.lists(st.tuples(st.booleans(),
                              st.lists(st.integers(0, 2), min_size=1,
                                       max_size=12),
                              st.integers(0, 7)), min_size=1, max_size=80))
def test_prefix_cache_matches_jax_op_for_op(ops):
    """The contiguous pool's radix tree: random match + insert admissions
    and retirements over a 5-block pool, both sides in lockstep — matches,
    inserted paths, new pool rows, evictions and the free list agree, and
    the pool never over-commits."""
    jc = JCache(jm.TransformerConfig(**_TINY, dtype=jnp.float32), block=2,
                blocks=5)
    tc = TCache(tm.TransformerConfig(**_TINY, dtype=torch.float32),
                block=2, blocks=5, device="cpu")
    live = {id(jc): [], id(tc): []}
    for admit, toks, pick in ops:
        outs = []
        for pc in (jc, tc):
            mine = live[id(pc)]
            if admit or not mine:
                prompt = np.asarray(toks, np.int32)
                matched, path = pc.match(prompt)
                full, new_ids, start = pc.insert(prompt)
                pc.release(path)  # the admission's pins swap for the path
                mine.append(full)
                outs.append((matched, [n.block_id for n in full], new_ids,
                             start))
            else:
                pc.release(mine.pop(pick % len(mine)))
            held = {n.block_id for n in _nodes(pc)}
            assert not held & set(pc._free)
            assert held | set(pc._free) == set(range(pc.blocks))
            outs.append((sorted(pc._free), pc.stats(), _shape(pc)))
        assert outs[:len(outs) // 2] == outs[len(outs) // 2:]


def test_radix_lru_evicts_least_recently_used_leaf():
    pc = TCache(tm.TransformerConfig(**_TINY, dtype=torch.float32), block=2,
                blocks=2, device="cpu")
    a, b, c = (np.asarray([x, x, 9], np.int32) for x in (0, 1, 2))
    pa, _, _ = pc.insert(a)
    pb, _, _ = pc.insert(b)
    pc.release(pa)
    pc.release(pb)
    _, path = pc.match(a)  # a match refreshes A: B is the LRU leaf
    pc.release(path)
    pcc, _, _ = pc.insert(c)
    pc.release(pcc)
    assert pc.match(a)[0] == 2
    pc.release(pc.match(a)[1])
    assert pc.match(b)[0] == 0
    assert pc.evictions == 1


def test_radix_pinned_pool_stops_publish():
    pc = TCache(tm.TransformerConfig(**_TINY, dtype=torch.float32), block=2,
                blocks=2, device="cpu")
    path, new_ids, start = pc.insert(np.arange(8, dtype=np.int32))
    assert len(new_ids) == 2 and start == 0  # pool-bound
    p2, ids2, _ = pc.insert(np.asarray([7, 6, 5, 4], np.int32))
    assert ids2 == [] and p2 == []
    pc.release(path)
    p3, ids3, _ = pc.insert(np.asarray([7, 6, 5, 4], np.int32))
    assert len(ids3) == 2
    pc.release(p3)


def test_adopt_budget_eviction_never_orphans():
    """Adoption under a full one-block retention budget stops rather than
    evict the node its walk stands on; JAX's index does the same."""
    for Alloc, Index in ((JAlloc, JIndex), (TAlloc, TIndex)):
        alloc = Alloc(4)
        idx = Index(block=2, alloc=alloc, max_cached=1)
        assert alloc.reserve(1)
        a = alloc.alloc()
        p1, _ = idx.adopt(np.asarray([0, 1, 9], np.int32), {0: a}, [])
        idx.release(p1)
        assert alloc.reserve(2)
        b, c = alloc.alloc(), alloc.alloc()
        p2, adopted = idx.adopt(np.asarray([0, 1, 2, 3, 9], np.int32),
                                {0: b, 1: c}, [])
        assert adopted == [] and p2 == []
        alloc.free_private(b)
        alloc.free_private(c)
        assert idx.evictable_blocks() == 1
        matched, nodes = idx.match(np.asarray([0, 1, 9], np.int32))
        assert matched == 2
        idx.release(nodes)
        assert alloc.used == 1 and alloc.free_count == 3


def test_allocator_reserve_then_evict():
    """A reservation backed only by evictable leaves succeeds; the alloc
    recycles the LRU leaf; a hit whose pins would strand a reservation is
    refused until they are released."""
    alloc = TAlloc(2)
    idx = TIndex(block=2, alloc=alloc)
    assert alloc.reserve(2)
    a, b = alloc.alloc(), alloc.alloc()
    path, adopted = idx.adopt(np.asarray([0, 1, 2, 3], np.int32),
                              {0: a, 1: b}, [])
    assert adopted == [0, 1]
    idx.release(path)
    assert alloc.free_count == 0 and alloc.evictable() == 2
    assert alloc.reserve(2)
    c = alloc.alloc()
    assert idx.evictions == 1 and c == b
    _, nodes = idx.match(np.asarray([0, 1, 9], np.int32))
    assert alloc.available() < 0 and not alloc.reserve(0)
    idx.release(nodes)
    assert alloc.available() == 0
    assert alloc.alloc() == a and idx.evictions == 2


# -- the KV moves of a hit and a publish, against JAX -----------------------

def _rand(rng, *shape, dtype=np.float32):
    if dtype == np.int8:
        return rng.integers(-127, 128, shape).astype(np.int8)
    return rng.standard_normal(shape).astype(dtype)


def test_kv_block_moves_match_jax():
    """Every hit/publish move on the same numbers: the paged pool's gather
    and scatter (exact and int8 with scales), the int8 hit's dequantized
    prefix, the contiguous pool's insert and extract (an id past the pool
    dropped, a window past the capacity), and the staged insert with
    ``lo`` leaving the shared blocks and their scales alone. Bit for bit
    (copies; the dequantization is one f32 product either side). The JAX
    side runs jitted, as the engine runs it."""
    rng = np.random.default_rng(0)
    L, N, H, B, D, T = 2, 6, 2, 4, 8, 24
    t = torch.from_numpy
    pk, pv = _rand(rng, L, N, H, B, D, dtype=np.int8), \
        _rand(rng, L, N, H, B, D, dtype=np.int8)
    ks, vs = (np.abs(_rand(rng, L, N, H)) + 0.1 for _ in range(2))
    ids = np.asarray([4, 1, 5, 1], np.int32)

    def port_pool(x, fill=0):  # the port's pools carry a drop block at N
        pad = np.full((L, 1) + x.shape[2:], fill, x.dtype)
        return np.concatenate([x, pad], 1)

    want = jax.jit(jd.gather_kv_blocks)(jnp.asarray(pk), jnp.asarray(pv),
                               jnp.asarray(ids), jnp.asarray(ks),
                               jnp.asarray(vs))
    got = td.gather_kv_blocks(t(port_pool(pk)), t(port_pool(pv)), t(ids),
                              t(port_pool(ks)), t(port_pool(vs)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    rows = [_rand(rng, 4, L, H, B, D, dtype=np.int8) for _ in range(2)] + \
        [_rand(rng, 4, L, H) for _ in range(2)]
    sids = np.asarray([2, 0, N, N + 3], np.int32)  # the last two drop
    want = jax.jit(jd.scatter_kv_blocks)(jnp.asarray(pk), jnp.asarray(pv),
                                jnp.asarray(sids), *map(jnp.asarray,
                                                        rows[:2]),
                                jnp.asarray(ks), jnp.asarray(vs),
                                *map(jnp.asarray, rows[2:]))
    got = td.scatter_kv_blocks(t(port_pool(pk)), t(port_pool(pv)), t(sids),
                               *map(t, rows[:2]), t(port_pool(ks)),
                               t(port_pool(vs)), *map(t, rows[2:]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[:, :N], np.asarray(w))

    staging = _rand(rng, L, 1, H, T, D)
    j_st = jm.KVCache(k=jnp.asarray(staging), v=jnp.asarray(staging),
                      length=jnp.zeros((1,), jnp.int32))
    want = jax.jit(jd.insert_dequant_prefix)(j_st, jnp.asarray(pk), jnp.asarray(pv),
                                    jnp.asarray(ks), jnp.asarray(vs),
                                    jnp.asarray(ids), jnp.int32(13))
    t_st = tm.KVCache(k=t(staging.copy()), v=t(staging.copy()),
                      length=torch.zeros((1,), dtype=torch.int32))
    got = td.insert_dequant_prefix(t_st, t(port_pool(pk)), t(port_pool(pv)),
                                   t(port_pool(ks)), t(port_pool(vs)),
                                   t(ids), 13)
    for g, w in ((got.k, want.k), (got.v, want.v), (got.length,
                                                    want.length)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    P = 5
    pool = [_rand(rng, P, L, H, B, D) for _ in range(2)]
    cache = _rand(rng, L, 3, H, T, D)
    j_c = jm.KVCache(k=jnp.asarray(cache), v=jnp.asarray(cache),
                     length=jnp.zeros((3,), jnp.int32))
    pids = np.asarray([4, 1, 3, 1], np.int32)
    want = jax.jit(jd.insert_prefix_blocks)(j_c, *map(jnp.asarray, pool),
                                   jnp.asarray(pids), jnp.int32(10),
                                   jnp.int32(1))
    t_c = tm.KVCache(k=t(cache.copy()), v=t(cache.copy()),
                     length=torch.zeros((3,), dtype=torch.int32))
    got = td.insert_prefix_blocks(
        t_c, *(t(np.concatenate([p, np.zeros_like(p[:1])])) for p in pool),
        t(pids), 10, 1)
    for g, w in ((got.k, want.k), (got.v, want.v), (got.length,
                                                    want.length)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    for start, pids in ((1, [3, 0, P, P]), (4, [2, P, P, P])):
        pids = np.asarray(pids, np.int32)
        want = jax.jit(jd.extract_prefix_blocks)(
            *map(jnp.asarray, pool), jnp.asarray(cache), jnp.asarray(cache),
            jnp.int32(2), jnp.asarray(pids), jnp.int32(start))
        tp = [t(np.concatenate([p, np.zeros_like(p[:1])])) for p in pool]
        got = td.extract_prefix_blocks(*tp, t(cache), t(cache), 2,
                                       t(pids), start)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy()[:P], np.asarray(w))

    table = np.asarray([[4, 1, 5, 0, 2, 3]], np.int32)
    k_rows, v_rows = (_rand(rng, L, 1, H, T, D, dtype=np.int8)
                      for _ in range(2))
    r_ks, r_vs = (np.abs(_rand(rng, L, T // B, H)) for _ in range(2))
    jc = jd.PagedQuantKVCache(k=jnp.asarray(pk), v=jnp.asarray(pv),
                              k_scale=jnp.asarray(ks),
                              v_scale=jnp.asarray(vs),
                              table=jnp.asarray(table),
                              length=jnp.zeros((1,), jnp.int32))
    want = jax.jit(jd.paged_insert_slot)(jc, jnp.int32(0), jnp.asarray(k_rows),
                                jnp.asarray(v_rows), jnp.int32(19),
                                jnp.asarray(r_ks), jnp.asarray(r_vs), lo=8)
    tc = td.PagedQuantKVCache(k=t(port_pool(pk)), v=t(port_pool(pv)),
                              k_scale=t(port_pool(ks)),
                              v_scale=t(port_pool(vs)), table=t(table),
                              length=torch.zeros((1,), dtype=torch.int32))
    got = td.paged_insert_slot(tc, 0, t(k_rows), t(v_rows), 19, t(r_ks),
                               t(r_vs), lo=8)
    for g, w in ((got.k, want.k), (got.v, want.v), (got.k_scale,
                                                    want.k_scale),
                 (got.v_scale, want.v_scale)):
        np.testing.assert_array_equal(g.numpy()[:, :N], np.asarray(w))
    # The shared blocks (table entries 0 and 1) kept their bytes and scales.
    for b in (4, 1):
        np.testing.assert_array_equal(got.k.numpy()[:, b], pk[:, b])
        np.testing.assert_array_equal(got.k_scale.numpy()[:, b], ks[:, b])
    assert int(got.length[0]) == 19


# -- contracts ---------------------------------------------------------------

def _prompt(seed, n=13):
    return np.random.default_rng(seed).integers(0, 128, n).astype(np.int32)


def test_paged_hit_moves_zero_bytes(params):
    """An exact paged hit is a table update: ``hit_bytes_moved`` is 0, the
    hit's table row names the published blocks, and their K/V bytes (read
    from the pool) are the first request's prefill, unchanged after the
    hit's serve."""
    _, tp = params
    server = ts.SlotServer(tp, T_CFG, **ENGINE, **PREFIX)
    prompt = _prompt(13)
    cold = server.serve([ts.Request(uid=0, prompt=prompt, max_new_tokens=5)])
    assert cold.prefix["misses"] == 1 and cold.prefix["pool_blocks_used"] == 3
    tree = torch.tensor([n.block_id for n in _nodes(server._prefix)])
    before = td.gather_kv_blocks(server.cache.k, server.cache.v, tree)
    hit = server.serve([ts.Request(uid=1, prompt=prompt, max_new_tokens=5)])
    assert hit.prefix["hits"] == 1 and hit.prefix["tokens_reused"] == 12
    assert hit.prefix["hit_bytes_moved"] == 0
    assert hit.results[0].tokens == cold.results[0].tokens
    after = td.gather_kv_blocks(server.cache.k, server.cache.v, tree)
    for a, b in zip(before, after):
        assert torch.equal(a, b)


def test_prefix_metrics_flow(params):
    _, tp = params
    prompt = _prompt(8)
    reg = obs.REGISTRY
    names = ("serving_prefix_hits_total", "serving_prefix_misses_total",
             "serving_prefix_tokens_reused_total")
    obs.enable()
    try:
        before = [reg.get(n).value() for n in names]
        server = ts.SlotServer(tp, T_CFG, slots=1, cache_len=32,
                               prefill_chunk=4, prefill_budget=4, **PREFIX)
        for uid in (0, 1):
            server.serve([ts.Request(uid=uid, prompt=prompt,
                                     max_new_tokens=5)])
        assert [reg.get(n).value() - b for n, b in zip(names, before)] == \
            [1, 1, 12]
        assert reg.get("serving_prefix_pool_blocks_used").value() == 3
    finally:
        obs.disable()


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


SMALL = ["--mode", "serve", "--device", "cpu", "--model-dim", "32",
         "--heads", "2", "--n-layers", "1", "--vocab-size", "64",
         "--dtype", "float32", "--temperature", "0", "--log-level",
         "warning", "--slots", "2", "--requests", "4", "--prompt-len", "20",
         "--prompt-jitter", "2", "--max-new-tokens", "3",
         "--prefill-chunk", "8"]


def test_cli_prefix_flags_and_record(params):
    """``--prefix-cache --prefix-block --prefix-share --prefix-len``: the
    record's ``prefix_cache`` block and a ``prefix`` block with the JAX
    report's keys, hits on the shared-prefix trace, a drained pool."""
    rec = _cli(SMALL + ["--prefix-cache", "--prefix-block", "8",
                        "--prefix-share", "1.0", "--prefix-len", "16"])
    assert rec["prefix_cache"] == {"block": 8}
    assert set(rec["prefix"]) == set(_run(params, "paged")["jax"].prefix)
    assert rec["prefix"]["hits"] > 0 and rec["outcomes"] == {"budget": 4}
    leaks = rec["leaks"]
    assert leaks["blocks_used"] == leaks["blocks_cached"] > 0
    assert leaks["pins"] == leaks["blocks_private"] == 0


@pytest.mark.parametrize("flags,match", [
    (["--prefix-share", "1.5"], "prefix-share"),
    (["--prefix-cache", "--prefix-block", "6"], "power of two"),
    (["--prefix-cache", "--prefix-block", "8", "--kv-block", "16"],
     "must equal --kv-block"),
    (["--prefix-cache", "--prefix-block", "64"], "exceeds"),
    (["--prefix-cache", "--kv-layout", "contiguous", "--prefix-block", "64"],
     "exceeds"),
])
def test_cli_prefix_flag_errors(flags, match):
    with pytest.raises(SystemExit, match=match):
        _cli(SMALL + flags)


def test_prefix_block_checks(params):
    _, tp = params
    tcfg = tm.TransformerConfig(**_TINY, dtype=torch.float32)
    with pytest.raises(ValueError, match="power of two"):
        TCache(tcfg, block=3, blocks=2, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        TCache(tcfg, block=2, blocks=0, device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        TIndex(block=6, alloc=TAlloc(4))
    with pytest.raises(ValueError, match="power of two"):
        ts.SlotServer(tp, T_CFG, slots=1, cache_len=32, prefix_cache=True,
                      prefix_block=3, kv_layout="contiguous")
    with pytest.raises(ValueError, match="kv_block"):
        ts.SlotServer(tp, T_CFG, slots=1, cache_len=32, prefix_cache=True,
                      prefix_block=8, kv_block=4)
    with pytest.raises(ValueError, match="exceeds cache_len"):
        ts.SlotServer(tp, T_CFG, slots=1, cache_len=32, prefix_cache=True,
                      prefix_block=64, kv_layout="contiguous")


def test_shared_prefix_index_checks(params):
    """A caller's index must sit on the caller's allocator at kv_block
    granularity, paged only; with both, the engine serves from them."""
    _, tp = params
    alloc = TAlloc(16)
    idx = TIndex(block=4, alloc=alloc)
    with pytest.raises(ValueError, match="same shared"):
        ts.SlotServer(tp, T_CFG, **ENGINE, kv_block=4, prefix_index=idx)
    with pytest.raises(ValueError, match="must equal kv_block"):
        ts.SlotServer(tp, T_CFG, **ENGINE, kv_block=8, block_pool=alloc,
                      prefix_index=idx)
    with pytest.raises(ValueError, match="paged"):
        ts.SlotServer(tp, T_CFG, **ENGINE, kv_layout="contiguous",
                      block_pool=alloc)
    with pytest.raises(ValueError, match="contradicts"):
        ts.SlotServer(tp, T_CFG, **ENGINE, kv_block=4, kv_blocks=8,
                      block_pool=alloc)
    server = ts.SlotServer(tp, T_CFG, **ENGINE, kv_block=4,
                           block_pool=alloc, prefix_index=idx)
    prompt = _prompt(3)
    for uid in (0, 1):
        rep = server.serve([ts.Request(uid=uid, prompt=prompt,
                                       max_new_tokens=3)])
    assert rep.prefix["hits"] == 1 and idx.blocks_used == 3


def test_out_of_slice_combinations_raise(params):
    """The prefix cache on a mesh, and so KV tiering there, is refused at
    construction, naming its ROADMAP item. Whole-prompt admission and the
    host tier, refused here before they were ported, now construct (their
    parity: tests/test_torch_whole.py, tests/test_torch_tiered.py)."""
    from tree_attention_tpu_torch.parallel.mesh import make_mesh
    from tree_attention_tpu_torch.serving.host_pool import HostBlockPool

    _, tp = params
    with pytest.raises(NotImplementedError, match="ROADMAP queue A, item 2"):
        ts.SlotServer(tp, T_CFG, **ENGINE, **PREFIX,
                      mesh=make_mesh({"seq": 1}))
    with pytest.raises(NotImplementedError, match="ROADMAP queue A, item 2"):
        ts.SlotServer(tp, T_CFG, **ENGINE, **PREFIX, host_blocks=4,
                      mesh=make_mesh({"seq": 1}))
    whole = ts.SlotServer(tp, T_CFG, **ENGINE, **PREFIX, admission="whole")
    assert whole.admission == "whole"
    tiered = ts.SlotServer(tp, T_CFG, **ENGINE, **PREFIX, host_blocks=4)
    assert tiered._host_pool.blocks == 4 and tiered._prefix.host is \
        tiered._host_pool
    hp = HostBlockPool(2, n_layers=1, n_kv_heads=1, block=4, d_head=2,
                       dtype=torch.float32)
    assert TIndex(block=4, alloc=TAlloc(4), host_pool=hp).host is hp
