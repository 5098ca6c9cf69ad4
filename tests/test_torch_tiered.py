"""The port's host-RAM KV tier against the JAX package's (CPU).

Counterparts of ``tests/test_serving_tiered.py``, at its tiny model (f32,
greedy: tokens exact):

- **Bookkeeping.** ``HostBlockPool`` and the allocator's ``demoted`` state
  take the JAX tests' call sequences on both implementations; rows, block
  ids, ``pending`` and ``stats`` are equal after every call, the dry
  allocator's forced flush and the refusal to demote a block the tree does
  not own included.
- **Round trip.** gather -> commit -> read -> scatter gives back the
  original pool bytes, exact (bf16 compared as 16-bit integers) and int8
  with its per-block scales, on both sides.
- **Radix tier transitions.** ``PagedPrefixIndex(host_pool=)`` driven
  directly beside JAX's: eviction demotes, a hit on a pending demotion
  cancels it, a flushed restore takes fresh blocks, a full host tier drops
  its LRU leaf, ``evictable_blocks`` counts the device tier only; tiers and
  ids equal.
- **Engine parity through forced cycles.** Serial cold and revisit rounds
  on the JAX file's ``TIER_KW`` (a 12-block pool under 4 prompts), exact
  and int8: tokens, ``demotions``, ``restores`` and ``host_drops`` equal
  JAX's, the revisit equals the cold pass, the pools drain with nothing
  staged. Tiering off is the old behaviour; the layout, cache and mesh
  refusals carry the JAX messages (the mesh's names ROADMAP queue A item
  2). The CLI's flags and record, one subprocess.

One JAX engine per configuration, memoized: each pays its own compiles.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tree_attention_tpu import models as jm
from tree_attention_tpu import serving as js
from tree_attention_tpu.models import decode as jd
from tree_attention_tpu.serving.block_pool import BlockAllocator as JAlloc
from tree_attention_tpu.serving.host_pool import HostBlockPool as JHost
from tree_attention_tpu.serving.prefix_cache import (
    PagedPrefixIndex as JIndex,
)

from tree_attention_tpu_torch import cli
from tree_attention_tpu_torch import models as tm
from tree_attention_tpu_torch import serving as ts
from tree_attention_tpu_torch.models import decode as td
from tree_attention_tpu_torch.serving import TIER_DEVICE, TIER_HOST
from tree_attention_tpu_torch.serving.block_pool import (
    BlockAllocator as TAlloc,
)
from tree_attention_tpu_torch.serving.host_pool import HostBlockPool as THost
from tree_attention_tpu_torch.serving.prefix_cache import (
    PagedPrefixIndex as TIndex,
)
from tests.torch_params import seeded_params
from tests.torch_threads import few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_serving_tiered.py's CFG and TIER_KW.
CFG = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_head=16, d_ff=128, max_seq_len=256)
J_CFG = jm.TransformerConfig(**CFG, dtype=jnp.float32,
                             attn_impl="blockwise", attn_block_size=16)
T_CFG = tm.TransformerConfig(**CFG, dtype=torch.float32)
TIER_KW = dict(
    slots=2, cache_len=32, prefill_chunk=4, prefill_budget=4,
    prefix_cache=True, prefix_block=4, kv_layout="paged", kv_block=4,
    kv_blocks=12, host_blocks=16,
)


@pytest.fixture(scope="module")
def params():
    return seeded_params(T_CFG)


def _prompt(seed, n=13):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG["vocab_size"], size=n).astype(np.int32)


# -- bookkeeping --------------------------------------------------------------

def _pools(blocks=4, quantized=False):
    geo = dict(n_layers=1, n_kv_heads=1, block=2, d_head=2,
               quantized=quantized)
    return (JHost(blocks, dtype=np.int8 if quantized else np.float32, **geo),
            THost(blocks, dtype=torch.int8 if quantized else torch.float32,
                  **geo))


def _same_pool_state(jp, tp):
    assert jp.pending == tp.pending
    assert jp.stats() == tp.stats()
    assert (jp.used, jp.free_count) == (tp.used, tp.free_count)
    assert jp._free == tp._free


def _same_alloc_state(ja, ta):
    assert ja._state == ta._state and ja._free == ta._free
    assert (ja.reserved, ja.gen, ja.available()) == \
        (ta.reserved, ta.gen, ta.available())


def test_host_pool_call_sequences_match_jax():
    """The JAX tests' sequences (alloc/enqueue/flush/release, cancel of a
    pending demotion, drop of a pending one, a double stage, the scales of
    a quantized pool), call for call on both pools."""
    for quantized in (False, True):
        jp, tp = _pools(quantized=quantized)
        rows = [(jp.alloc(), tp.alloc()) for _ in range(3)]
        assert [a for a, _ in rows] == [b for _, b in rows]
        _same_pool_state(jp, tp)
        for i, (r, _) in enumerate(rows):
            jp.enqueue(r, device_bid=10 + i)
            tp.enqueue(r, device_bid=10 + i)
            _same_pool_state(jp, tp)
        items = jp.take_pending()
        assert tp.take_pending() == items
        _same_pool_state(jp, tp)
        n = len(items)
        dt = np.int8 if quantized else np.float32
        k = np.arange(n * 4, dtype=np.float32).reshape(n, 1, 1, 2, 2)
        sc = [np.full((n, 1, 1), 0.5, np.float32),
              np.full((n, 1, 1), 0.25, np.float32)] if quantized else []
        jp.commit([r for r, _ in items], k.astype(dt), (-k).astype(dt), *sc)
        tp.commit([r for r, _ in items],
                  torch.from_numpy(k.astype(dt)),
                  torch.from_numpy((-k).astype(dt)),
                  *[torch.from_numpy(s) for s in sc])
        for a, b in zip(jp.read([r for r, _ in items]),
                        tp.read([r for r, _ in items])):
            np.testing.assert_array_equal(a, b.numpy())
        jp.release(rows[0][0], restored=True)
        tp.release(rows[0][0], restored=True)
        jp.release(rows[1][0], restored=False)
        tp.release(rows[1][0], restored=False)
        _same_pool_state(jp, tp)
        # A pending demotion cancels (its block comes back), once.
        r = jp.alloc()
        assert tp.alloc() == r
        jp.enqueue(r, device_bid=7)
        tp.enqueue(r, device_bid=7)
        assert jp.cancel_pending(r) == tp.cancel_pending(r) == 7
        assert jp.cancel_pending(r) is tp.cancel_pending(r) is None
        _same_pool_state(jp, tp)
        with pytest.raises(AssertionError, match="double-staged"):
            r = tp.alloc()
            tp.enqueue(r, device_bid=1)
            tp.enqueue(r, device_bid=2)
    # A full tier, and the drop of a pending demotion.
    jp, tp = _pools(blocks=1)
    r = jp.alloc()
    assert tp.alloc() == r and jp.alloc() is tp.alloc() is None
    jp.enqueue(r, device_bid=3)
    tp.enqueue(r, device_bid=3)
    assert jp.drop(r) == tp.drop(r) == 3
    _same_pool_state(jp, tp)


def test_allocator_demoted_state_matches_jax():
    """demote -> free_demoted, undemote, the refusal of a private block,
    and the dry allocator's forced flush, on both ledgers."""
    for mod in (JAlloc, TAlloc):
        alloc = mod(2)
        assert alloc.reserve(1)
        bid = alloc.alloc()
        with pytest.raises(AssertionError, match="not tree-owned"):
            alloc.demote_cached(bid)  # private, not the tree's
    ja, ta = JAlloc(2), TAlloc(2)
    for a in (ja, ta):
        assert a.reserve(1)
        bid = a.alloc()
        a.publish(bid)
        a.demote_cached(bid)
        assert a.available() == 1  # staged: not reusable, not available
    _same_alloc_state(ja, ta)
    for a in (ja, ta):
        a.undemote(bid)
        a.demote_cached(bid)
        a.free_demoted(bid)
    _same_alloc_state(ja, ta)

    def dry(mod):
        alloc = mod(1)
        assert alloc.reserve(1)
        b = alloc.alloc()
        alloc.publish(b)
        tree, staged, flushed = [b], [], []

        def evict_one():
            if not tree:
                return False
            x = tree.pop()
            alloc.demote_cached(x)  # demotes, does NOT free
            staged.append(x)
            return True

        def flush():
            n = len(staged)
            for x in staged:
                alloc.free_demoted(x)
            flushed.extend(staged)
            staged.clear()
            return n

        alloc.set_evictor(evict_one, lambda: len(tree))
        alloc.set_demote_flusher(flush)
        assert alloc.reserve(1)
        got = alloc.alloc()  # demote -> flush -> free -> alloc
        return got, flushed, alloc

    (jg, jf, ja), (tg, tf, ta) = dry(JAlloc), dry(TAlloc)
    assert (jg, jf) == (tg, tf) == (0, [0])
    _same_alloc_state(ja, ta)


# -- round trip ---------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_gather_commit_read_scatter_round_trip(quant):
    """The flush's gather and commit, then the restore's read and scatter,
    give back the original pool bytes (and scales), on both sides; the
    port's host rows equal JAX's."""
    rng = np.random.default_rng(1 if quant else 0)
    L, N, Hkv, blk, D = 2, 6, 2, 4, 8
    shape = (L, N + 1, Hkv, blk, D)  # the port's pool: N blocks + drop
    if quant:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.01, 1.0, shape[:3]).astype(np.float32)
        vs = rng.uniform(0.01, 1.0, shape[:3]).astype(np.float32)
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
        tks, tvs = torch.from_numpy(ks), torch.from_numpy(vs)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
        tk = torch.from_numpy(k).to(torch.bfloat16)
        tv = torch.from_numpy(v).to(torch.bfloat16)
        k = tk.view(torch.int16).numpy()  # the bf16 bits, for JAX's side
        v = tv.view(torch.int16).numpy()
    bids = [1, 4, 5]
    geo = dict(n_layers=L, n_kv_heads=Hkv, block=blk, d_head=D,
               quantized=quant)
    jh = JHost(4, dtype=np.int8 if quant else np.int16, **geo)
    th = THost(4, dtype=torch.int8 if quant else torch.bfloat16, **geo)
    rows = [jh.alloc() for _ in bids]
    assert [th.alloc() for _ in bids] == rows
    ids = np.array(bids + [0], np.int32)  # padded to 4, as a flush pads
    extra = (ks, vs) if quant else ()
    jout = jax.jit(jd.gather_kv_blocks)(
        *[jnp.asarray(x) for x in (k[:, :N], v[:, :N], ids, *extra)])
    jh.commit(rows, *[np.asarray(x) for x in jout])
    tout = td.gather_kv_blocks(tk, tv, torch.from_numpy(ids),
                               *((tks, tvs) if quant else ()))
    th.commit(rows, *tout)
    for a, b in zip(jh.read(rows), th.read(rows)):
        b = b.view(torch.int16) if b.dtype == torch.bfloat16 else b
        np.testing.assert_array_equal(a, b.numpy())
    # The flush freed the blocks: zero them, then restore from the host.
    z = [x.clone() for x in ((tk, tv, tks, tvs) if quant else (tk, tv))]
    for x, fill in zip(z, (0, 0, 1.0, 1.0)):
        x[:, bids] = fill
    nb = 4
    staged = th.read(rows, pad_to=nb)
    sids = torch.tensor(bids + [N], dtype=torch.long)  # pad: the drop block
    if quant:
        td.scatter_kv_blocks(z[0], z[1], sids, staged[0], staged[1], z[2],
                             z[3], staged[2], staged[3])
        want = (tk, tv, tks, tvs)
    else:
        td.scatter_kv_blocks(z[0], z[1], sids, staged[0], staged[1])
        want = (tk, tv)
    for got, w in zip(z, want):
        if got.dtype == torch.bfloat16:
            got, w = got.view(torch.int16), w.view(torch.int16)
        assert torch.equal(got[:, :N], w[:, :N])  # pad went to the drop block
    for row in rows:
        th.release(row, restored=True)
    assert th.used == 0 and th.restores == 3


def test_pinned_pool_needs_a_gpu():
    """A pinned host tier is page-locked or the constructor raises: no
    silent fallback to pageable memory."""
    if torch.cuda.is_available():
        hp = THost(2, n_layers=1, n_kv_heads=1, block=2, d_head=2,
                   dtype=torch.bfloat16, pin_memory=True)
        assert hp.k.is_pinned() and hp.v.is_pinned()
    else:
        with pytest.raises(RuntimeError):
            THost(2, n_layers=1, n_kv_heads=1, block=2, d_head=2,
                  dtype=torch.bfloat16, pin_memory=True)


# -- radix tier transitions ---------------------------------------------------

def _build(side, kv_blocks=6, host_blocks=4):
    if side == "jax":
        alloc = JAlloc(kv_blocks)
        hp = JHost(host_blocks, n_layers=1, n_kv_heads=1, block=4, d_head=2,
                   dtype=np.float32)
        return alloc, hp, JIndex(block=4, alloc=alloc, host_pool=hp)
    alloc = TAlloc(kv_blocks)
    hp = THost(host_blocks, n_layers=1, n_kv_heads=1, block=4, d_head=2,
               dtype=torch.float32)
    return alloc, hp, TIndex(block=4, alloc=alloc, host_pool=hp)


def _publish_chain(idx, alloc, prompt, block=4):
    nb = len(prompt) // block
    assert alloc.reserve(nb)
    phys = {j: alloc.alloc() for j in range(nb)}
    path, _ = idx.adopt(np.asarray(prompt, np.int32), phys, [])
    return path


def _tree(idx):
    """(path of keys' first tokens, tier, block id, refs) of every node."""
    out = []
    stack = [((), n) for n in idx._root.children.values()]
    while stack:
        pre, n = stack.pop()
        key = pre + (n.key[0],)
        out.append((key, n.tier, n.block_id, n.refs))
        stack.extend((key, c) for c in n.children.values())
    return sorted(out)


def _transitions(side):
    """The JAX tests' transition sequences on one side; returns a log of
    every observable after each step."""
    log = []
    # Eviction demotes; the demoted path still matches across the tiers.
    alloc, hp, idx = _build(side)
    p1, p2 = list(range(8)), [50 + t for t in range(8)]
    idx.release(_publish_chain(idx, alloc, p1))
    path2 = _publish_chain(idx, alloc, p2)
    log.append(("demote", idx.evict_one(), hp.demotions, _tree(idx)))
    matched, nodes = idx.match(np.asarray(p1 + [99], np.int32))
    log.append(("match", matched, [n.tier for n in nodes]))
    idx.release(nodes)
    idx.release(path2)
    # A hit on a pending demotion cancels it: zero copies.
    alloc, hp, idx = _build(side)
    path = _publish_chain(idx, alloc, p1)
    idx.release(path)
    old = [n.block_id for n in path]
    assert idx.evict_one()
    matched, nodes = idx.match(np.asarray(p1 + [99], np.int32))
    demoted = idx.demoted_in(nodes)

    def no_alloc():
        raise AssertionError("no alloc on a cancelled demotion")

    rows, bids = idx.restore_nodes(demoted, no_alloc)
    log.append(("cancel", len(demoted), rows, bids, old,
                [n.block_id for n in nodes], hp.stats(), alloc._state))
    idx.release(nodes)
    # A flushed restore takes fresh blocks.
    alloc, hp, idx = _build(side)
    idx.release(_publish_chain(idx, alloc, p1))
    assert idx.evict_one() and idx.evict_one()
    for row, bid in hp.take_pending():
        z = np.zeros((1, 1, 1, 4, 2), np.float32)
        hp.commit([row], *((z, z) if side == "jax" else
                           (torch.from_numpy(z), torch.from_numpy(z))))
        alloc.free_demoted(bid)
    matched, nodes = idx.match(np.asarray(p1 + [99], np.int32))
    demoted = idx.demoted_in(nodes)
    assert alloc.reserve(len(demoted))
    rows, bids = idx.restore_nodes(demoted, alloc.alloc)
    for row in rows:
        hp.release(row, restored=True)
    idx.release(nodes)
    log.append(("restore", rows, bids, alloc.free_count, _tree(idx),
                idx.evictable_blocks(), hp.stats()))
    # A full host tier drops its LRU leaf.
    alloc, hp, idx = _build(side, kv_blocks=8, host_blocks=1)
    idx.release(_publish_chain(idx, alloc, p1))
    idx.release(_publish_chain(idx, alloc, p2))
    log.append(("drop", [idx.evict_one() for _ in range(3)], hp.stats(),
                idx.stats(), _tree(idx), alloc._state))
    # evictable_blocks counts the device tier only.
    alloc, hp, idx = _build(side)
    idx.release(_publish_chain(idx, alloc, p1))
    before = idx.evictable_blocks()
    idx.evict_one()
    log.append(("evictable", before, idx.evictable_blocks()))
    return log


def test_radix_tier_transitions_match_jax():
    jlog, tlog = _transitions("jax"), _transitions("port")
    assert tlog == jlog
    assert tlog[1] == ("match", 8, [TIER_DEVICE, TIER_HOST])
    assert tlog[2][2] == [] and tlog[2][4] == tlog[2][5]  # zero copies
    assert len(tlog[3][1]) == 2 and tlog[3][5] == 2
    assert tlog[4][1] == [True] * 3 and tlog[4][2]["host_drops"] >= 2
    assert tlog[5][1:] == (2, 1)


# -- engine parity through forced demote/restore cycles -----------------------

def _req(mod, uid, prompt, n_new=5):
    return mod.Request(uid=uid, prompt=np.asarray(prompt, np.int32),
                       max_new_tokens=n_new)


def _serve_rounds(server, mod, prompts, uid0=0):
    """Each prompt in its own serve (serial revisits: the LRU worst case);
    returns the tokens and the summed tier counters."""
    toks, kv = {}, {"demotions": 0, "restores": 0, "host_drops": 0}
    for i, p in enumerate(prompts):
        rep = server.serve([_req(mod, uid0 + i, p)])
        toks[i] = list(map(int, rep.results[0].tokens))
        for k in kv:
            kv[k] += rep.kv.get(k, 0)
    return toks, kv


def _drained(server):
    leak = server.leak_report()
    assert leak["blocks_private"] == leak["blocks_reserved"] == 0, leak
    assert leak["pins"] == 0, leak
    assert leak["blocks_used"] == leak["blocks_cached"], leak
    assert not server._host_pool.pending, "demotions staged after a drain"
    return leak


_RUNS = {}


def _run(params, quant):
    """Cold and revisit rounds over 4 prompts, once per configuration and
    side: JAX's engine and the port's."""
    if quant not in _RUNS:
        jp, tp = params
        prompts = [_prompt(s) for s in range(4)]
        out = {"prompts": prompts}
        for side, mod, p, cfg in (("jax", js, jp, J_CFG),
                                  ("port", ts, tp, T_CFG)):
            server = mod.SlotServer(p, cfg, quantize=quant, **TIER_KW)
            cold, kv1 = _serve_rounds(server, mod, prompts)
            warm, kv2 = _serve_rounds(server, mod, prompts, uid0=10)
            out[side] = dict(server=server, cold=cold, warm=warm, kv1=kv1,
                             kv2=kv2, leaks=server.leak_report())
        _RUNS[quant] = out
    return _RUNS[quant]


@pytest.mark.parametrize("quant", [False, True], ids=["exact", "int8"])
def test_forced_cycles_match_jax(params, quant):
    run = _run(params, quant)
    j, t = run["jax"], run["port"]
    assert t["cold"] == j["cold"] and t["warm"] == j["warm"]
    assert t["kv1"] == j["kv1"] and t["kv2"] == j["kv2"]
    assert t["kv1"]["demotions"] + t["kv2"]["demotions"] > 0
    assert t["kv2"]["restores"] > 0
    assert t["warm"] == t["cold"]  # restore is a copy: the revisit is cold
    leaks = _drained(t["server"])
    assert leaks == {k: j["leaks"][k] for k in leaks}
    assert leaks["host_blocks_used"] > 0  # the tier holds prefixes


def test_another_cycle_keeps_the_tree_consistent(params):
    """One more revisit round after the demote/restore churn: cold tokens
    again, restores again, drained."""
    run = _run(params, False)
    server = run["port"]["server"]
    again, kv = _serve_rounds(server, ts, run["prompts"], uid0=20)
    assert kv["restores"] > 0 and again == run["port"]["cold"]
    _drained(server)


def test_tiering_off_is_the_old_behaviour(params):
    """host_blocks=0 keeps classic eviction: no tier, no tier fields in the
    report, the cold tokens."""
    run = _run(params, False)
    server = ts.SlotServer(params[1], T_CFG, **{**TIER_KW, "host_blocks": 0})
    cold, _ = _serve_rounds(server, ts, run["prompts"])
    assert server._host_pool is None and cold == run["jax"]["cold"]
    rep = server.serve([_req(ts, 40, run["prompts"][0])])
    assert "demotions" not in rep.kv
    assert "host_blocks_used" not in server.leak_report()


def test_tiering_refusals_carry_the_jax_messages(params):
    from tree_attention_tpu_torch.parallel.mesh import make_mesh

    jp, tp = params
    for mod, p, cfg in ((js, jp, J_CFG), (ts, tp, T_CFG)):
        with pytest.raises(ValueError, match="kv_layout='paged'"):
            mod.SlotServer(p, cfg, slots=1, cache_len=32,
                           kv_layout="contiguous", host_blocks=4)
        with pytest.raises(ValueError, match="prefix_cache=True"):
            mod.SlotServer(p, cfg, slots=1, cache_len=32,
                           kv_layout="paged", host_blocks=4)
    alloc = TAlloc(16)
    with pytest.raises(ValueError, match="own host_pool"):
        ts.SlotServer(tp, T_CFG, slots=1, cache_len=32, kv_block=4,
                      block_pool=alloc, host_blocks=4, prefix_cache=True,
                      prefix_block=4,
                      prefix_index=TIndex(block=4, alloc=alloc))
    with pytest.raises(NotImplementedError, match="ROADMAP queue A, item 2"):
        ts.SlotServer(tp, T_CFG, mesh=make_mesh({"seq": 1}), **TIER_KW)


def test_cli_flags_and_record():
    """``--admission whole --prefix-cache --host-blocks`` in one subprocess
    at one intra-op thread (the record carries ``kv_tiering`` and the
    tier's ``kv`` fields); ``--kv-tiering off`` and the flag checks in
    process."""
    small = ["--mode", "serve", "--device", "cpu", "--slots", "1",
             "--requests", "4", "--prompt-len", "16", "--prompt-jitter", "0",
             "--max-new-tokens", "2", "--model-dim", "32", "--heads", "2",
             "--n-layers", "1", "--vocab-size", "64", "--dtype", "float32",
             "--temperature", "0", "--prefill-chunk", "8", "--prefix-cache",
             "--prefix-block", "8", "--prefix-share", "1.0", "--prefix-len",
             "8", "--kv-blocks", "4", "--log-level", "warning"]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("CUDA_VISIBLE_DEVICES", None)
    out = subprocess.run(
        [sys.executable, "-m", "tree_attention_tpu_torch", *small,
         "--admission", "whole", "--host-blocks", "8"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["admission"] == "whole"
    assert rec["kv_tiering"] == {"host_blocks": 8}
    assert rec["kv"]["host_blocks"] == 8
    assert {"host_blocks_used", "demotions", "restores",
            "host_drops"} <= set(rec["kv"])
    assert rec["outcomes"] == {"budget": 4}
    assert rec["leaks"]["blocks_used"] == rec["leaks"]["blocks_cached"]
    assert rec["leaks"]["host_blocks_used"] == rec["kv"]["host_blocks_used"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(small + ["--host-blocks", "8", "--kv-tiering",
                                 "off"]) == 0
    off = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert "kv_tiering" not in off and "demotions" not in off["kv"]
    assert off["admission"] == "chunked"
    for bad, msg in ((["--host-blocks", "-1"], ">= 0"),
                     (["--host-blocks", "4", "--kv-layout", "contiguous"],
                      "paged")):
        with pytest.raises(SystemExit, match=msg):
            cli.main(small + bad)
    no_cache = [a for a in small if a != "--prefix-cache"]
    with pytest.raises(SystemExit, match="--prefix-cache"):
        cli.main(no_cache + ["--host-blocks", "4"])
