"""Speculative serving in the port against the JAX package's (CPU).

- **Host**: every function of ``serving/speculation.py`` against the JAX
  module on the same inputs: proposals and their truncation / chain prefix,
  ``pack_proposal``, both accept walks, ``pack_siblings``, both n-gram
  drafters, the draft-model drafter's greedy chain, ``make_drafter``.
- **Engine**: greedy ``SlotServer(speculate=True)`` with the ``ngram``,
  ``ngram-tree`` and an oracle drafter (the true continuation with a wrong
  token every 3rd call and a decoy branch packed before it, so every tree
  commit compacts) serves token-identical to JAX's
  ``SlotServer(speculate=True)`` and to the port's own non-speculative
  serve, on the paged and contiguous layouts, exact and int8; the pool
  drains. Plus: an EOS inside a burst retires the same tick, a drafter
  proposing past ``max_new_tokens`` is clamped, a tree draft beside a
  prefill chunk wider than 32 rows falls back to its chain, draft-less
  ticks run at Tq 1, the sampled speculative stream equals the sampled
  non-speculative one under one seed (every draw keyed by request and
  stream index), the registry's spec counters, and the refusals.
- **Pool**: ``unmap_private`` returns the block and restores the
  reservation.
- **CLI**: ``--speculate --draft-k --drafter`` parse and the serve record
  carries the ``speculate`` and ``spec`` blocks.

Module-scoped references keep the JAX engines to one per layout; the
contiguous layouts' JAX engines run with ``-m slow``.
"""

import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tree_attention_tpu import models as jm
from tree_attention_tpu import serving as js
from tree_attention_tpu.serving import speculation as jspec
from tree_attention_tpu.serving.block_pool import BlockAllocator as JAlloc

from tree_attention_tpu_torch import cli
from tree_attention_tpu_torch import models as tm
from tree_attention_tpu_torch import obs
from tree_attention_tpu_torch import serving as ts
from tree_attention_tpu_torch.serving import speculation as tspec
from tree_attention_tpu_torch.serving.block_pool import (
    BlockAllocator as TAlloc,
)
from tree_attention_tpu_torch.utils.config import parse_args
from tests.torch_params import seeded_params
from tests.torch_threads import few_torch_threads  # noqa: F401

CFG = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_head=16, d_ff=128)
J_CFG = jm.TransformerConfig(**CFG, dtype=jnp.float32)
T_CFG = tm.TransformerConfig(**CFG, dtype=torch.float32)

# Prompts whose greedy continuation settles into a loop on the tiny random
# model: the workload prompt lookup is for.
LOOP_PROMPT = np.tile(np.array([7, 9, 4], np.int32), 6)[:16]
ALT_PROMPT = np.tile(np.array([3, 5], np.int32), 8)
PROMPTS = {0: LOOP_PROMPT, 1: ALT_PROMPT}
N_NEW = 24
ENGINE = dict(slots=2, cache_len=64)
LAYOUTS = {
    "paged": {},
    "paged-int8": {"quantize": True},
    "contig": {"kv_layout": "contiguous"},
    "contig-int8": {"kv_layout": "contiguous", "quantize": True},
}
CLEAN = {"blocks_private": 0, "blocks_used": 0, "blocks_reserved": 0,
         "blocks_shared": 0, "blocks_cached": 0, "pins": 0}


@pytest.fixture(scope="module")
def params():
    return seeded_params(T_CFG)


def _reqs(mod, n_new=N_NEW, eos=None, **kw):
    return [mod.Request(uid=u, prompt=p, max_new_tokens=n_new, eos_id=eos,
                        **kw) for u, p in PROMPTS.items()]


def _tokens(report):
    return {r.uid: list(map(int, r.tokens)) for r in report.results}


_REFS = {}


def _port_ref(tp, layout, n_new=N_NEW, eos=None, **kw):
    """The port's non-speculative serve, memoized per shape."""
    key = (layout, n_new, eos, tuple(sorted(kw.items())))
    if key not in _REFS:
        _REFS[key] = _tokens(ts.SlotServer(
            tp, T_CFG, **ENGINE, **LAYOUTS[layout], **kw).serve(
                _reqs(ts, n_new, eos)))
    return _REFS[key]


def _jax_spec(jp, layout):
    """JAX's speculative serve (one engine per layout)."""
    key = ("jax", layout)
    if key not in _REFS:
        _REFS[key] = _tokens(js.SlotServer(
            jp, J_CFG, **ENGINE, **LAYOUTS[layout], speculate=True,
            draft_k=5, drafter="ngram-tree").serve(_reqs(js)))
    return _REFS[key]


class OracleDrafter(tspec.Drafter):
    """Proposes each request's true continuation (a reference serve's) with
    controlled poison: a wrong second token every ``wrong_every``-th call,
    and with ``tree`` a decoy branch packed BEFORE the true chain, so an
    accepted path is never contiguous rows and every commit compacts."""

    def __init__(self, refs, wrong_every=0, tree=False, always_k=None):
        self.full = {u: np.concatenate([PROMPTS[u], np.asarray(refs[u],
                                                               np.int32)])
                     for u in refs}
        self.wrong_every = wrong_every
        self.tree = tree
        self.always_k = always_k
        self.calls = 0

    def propose(self, history, k):
        self.calls += 1
        if self.always_k is not None:
            k = self.always_k  # adversarial: ignore the engine's budget
        uid = next(u for u, p in PROMPTS.items()
                   if np.array_equal(history[:len(p)], p))
        full = self.full[uid]
        cont = full[len(history):len(history) + k].copy()
        if len(cont) == 0:
            cont = np.full((max(k, 1),), 3, np.int32)  # past the reference
        if self.wrong_every and self.calls % self.wrong_every == 0 \
                and len(cont) > 1:
            cont[1] = (cont[1] + 1) % CFG["vocab_size"]
        if not self.tree:
            return tspec.DraftProposal(
                cont, np.arange(-1, len(cont) - 1, dtype=np.int32))
        tokens = [int((cont[0] + 1) % CFG["vocab_size"])]
        parents = [-1]
        prev = -1
        for t in cont[:max(len(cont) - 1, 1)]:
            parents.append(prev)
            prev = len(tokens)
            tokens.append(int(t))
        return tspec.DraftProposal(np.asarray(tokens, np.int32),
                                   np.asarray(parents, np.int32))


def _serve(tp, layout, drafter, n_new=N_NEW, eos=None, **kw):
    server = ts.SlotServer(tp, T_CFG, **ENGINE, **LAYOUTS[layout],
                           speculate=True, draft_k=5, drafter=drafter, **kw)
    rep = server.serve(_reqs(ts, n_new, eos))
    assert server.leak_report() == CLEAN
    return server, rep


# -- host --------------------------------------------------------------------

def _same_pack(a, b):
    for f in ("row_tokens", "row_parents", "depth", "anc"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_host_proposals_packs_and_accept_walks_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        m = int(rng.integers(0, 9))
        parents = np.array([int(rng.integers(-1, i)) for i in range(m)],
                           np.int32)
        toks = rng.integers(0, 20, m).astype(np.int32)
        jp_, tp_ = (jspec.DraftProposal(toks, parents),
                    tspec.DraftProposal(toks, parents))
        assert jp_.is_chain == tp_.is_chain
        for a, b in ((jp_.chain_prefix(), tp_.chain_prefix()),
                     (jp_.truncated(3), tp_.truncated(3))):
            np.testing.assert_array_equal(a.tokens, b.tokens)
            np.testing.assert_array_equal(a.parents, b.parents)
        jpk, tpk = jspec.pack_proposal(5, jp_), tspec.pack_proposal(5, tp_)
        _same_pack(jpk, tpk)
        draws = rng.integers(0, 20, tpk.rows)
        # Make some draws follow the tree so walks go deep.
        draws[rng.random(tpk.rows) < 0.6] = 0
        for j in range(1, tpk.rows):
            if rng.random() < 0.7:
                draws[tpk.row_parents[j]] = tpk.row_tokens[j]
        for jf, tf in ((jspec.accept_longest_path, tspec.accept_longest_path),
                       (jspec.accept_stochastic_path,
                        tspec.accept_stochastic_path)):
            assert jf(jpk, draws) == tf(tpk, draws)
    with pytest.raises(ValueError, match="topological"):
        tspec.DraftProposal(np.array([1, 2]), np.array([-1, 1]))
    for sfx in ([[1, 2, 3]], [[1, 2], [3, 4], [5, 6]]):
        _same_pack(jspec.pack_siblings(sfx), tspec.pack_siblings(sfx))
    with pytest.raises(ValueError, match="equal length"):
        tspec.pack_siblings([[1, 2], [3]])
    with pytest.raises(AssertionError, match="32-row"):
        tspec.pack_siblings([[0] * 11] * 3)


def test_host_drafters_match_jax(params):
    rng = np.random.default_rng(1)
    hists = [np.tile(np.array([7, 9, 4], np.int32), 5),
             np.array([1, 2, 3, 1, 2, 4, 1, 2, 5, 1, 2], np.int32),
             rng.integers(0, 6, 40).astype(np.int32),
             np.array([1, 2, 3], np.int32)]
    pairs = [(jspec.PromptLookupDrafter(), tspec.PromptLookupDrafter()),
             (jspec.PromptLookupTreeDrafter(width=3),
              tspec.PromptLookupTreeDrafter(width=3)),
             (jspec.PromptLookupTreeDrafter(ngram_max=2, width=2),
              tspec.PromptLookupTreeDrafter(ngram_max=2, width=2))]
    for jd, td in pairs:
        for h in hists:
            for k in (1, 2, 5):
                a, b = jd.propose(h, k), td.propose(h, k)
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a.tokens, b.tokens)
                    np.testing.assert_array_equal(a.parents, b.parents)
    # The draft model's greedy chain: the same half-depth model in both.
    jp, tp = params
    dcfg = dict(CFG, n_layers=1)
    jdp, tdp = seeded_params(tm.TransformerConfig(**dcfg,
                                                  dtype=torch.float32), 3)
    jd = jspec.DraftModelDrafter(
        jdp, jm.TransformerConfig(**dcfg, dtype=jnp.float32))
    td = tspec.DraftModelDrafter(
        tdp, tm.TransformerConfig(**dcfg, dtype=torch.float32))
    for h in hists[:2]:
        a, b = jd.propose(h, 4), td.propose(h, 4)
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert b.is_chain
    for name, cls in (("ngram", tspec.PromptLookupDrafter),
                      ("ngram-tree", tspec.PromptLookupTreeDrafter)):
        assert type(tspec.make_drafter(name)) is cls
    assert isinstance(tspec.make_drafter("model", params=tdp, cfg=T_CFG),
                      tspec.DraftModelDrafter)
    with pytest.raises(ValueError, match="params= and cfg="):
        tspec.make_drafter("model")
    with pytest.raises(ValueError, match="unknown drafter"):
        tspec.make_drafter("beam")


def test_block_allocator_unmap_private_restores_reservation():
    for alloc in (JAlloc(4), TAlloc(4)):
        assert alloc.reserve(3)
        b1, b2, b3 = alloc.alloc(), alloc.alloc(), alloc.alloc()
        assert alloc.reserved == 0 and alloc.free_count == 1
        gen = alloc.gen
        alloc.unmap_private(b3)  # rollback: free and re-reserved
        assert alloc.reserved == 1 and alloc.free_count == 2
        assert alloc.gen == gen
        assert alloc.alloc() == b3  # the reservation backs re-allocation
        for b in (b1, b2, b3):
            alloc.free_private(b)
        assert alloc.used == 0 and alloc.reserved == 0


# -- engine ------------------------------------------------------------------

@pytest.mark.parametrize("layout", [
    "paged", "paged-int8",
    # A JAX speculative engine costs ~6 s of compiles on a CPU: the
    # contiguous pair runs with -m slow.
    pytest.param("contig", marks=pytest.mark.slow),
    pytest.param("contig-int8", marks=pytest.mark.slow)])
def test_jax_spec_serve_equals_port_plain(params, layout):
    """JAX's greedy ``SlotServer(speculate=True)`` (``ngram-tree``) commits
    the port's non-speculative stream, which every speculative serve of the
    port is held to below."""
    jp, tp = params
    assert _jax_spec(jp, layout) == _port_ref(tp, layout)


@pytest.mark.parametrize("drafter", ["ngram", "ngram-tree", "oracle-tree"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_spec_greedy_token_identical(params, layout, drafter):
    _, tp = params
    ref = _port_ref(tp, layout)
    d = (OracleDrafter(ref, wrong_every=3, tree=True)
         if drafter == "oracle-tree" else drafter)
    _, rep = _serve(tp, layout, d)
    assert _tokens(rep) == ref
    assert rep.outcomes == {"budget": 2}
    assert rep.spec["proposed"] > 0
    if drafter == "oracle-tree":
        assert rep.spec["accepted"] > 0
        assert rep.spec["tokens_per_verify"] > 1.0


def test_eos_inside_burst_retires_same_tick(params):
    _, tp = params
    base = _port_ref(tp, "paged")
    eos = base[0][len(base[0]) // 2]  # a token uid 0 emits mid-stream
    ref = _port_ref(tp, "paged", eos=eos)
    # The oracle drafts the no-EOS continuation, so the EOS lands inside
    # an accepted burst.
    _, rep = _serve(tp, "paged", OracleDrafter(base), eos=eos)
    assert _tokens(rep) == ref
    for r in rep.results:
        if eos in r.tokens:
            assert r.outcome == "eos" and r.tokens[-1] == eos


def test_drafter_past_max_new_tokens_is_clamped(params):
    _, tp = params
    ref = _port_ref(tp, "paged", n_new=10)
    _, rep = _serve(tp, "paged", OracleDrafter(ref, always_k=31), n_new=10)
    assert _tokens(rep) == ref
    assert all(len(r.tokens) == 10 for r in rep.results)


class _NeverDrafter(tspec.Drafter):
    def propose(self, history, k):
        return None


def test_draftless_ticks_run_narrow(params):
    _, tp = params
    ref = _port_ref(tp, "paged", n_new=8)
    obs.enable()
    try:
        steps = obs.REGISTRY.get("forward_step_dispatch_total").labels(
            cache="paged")
        before = steps.value()
        server, rep = _serve(tp, "paged", _NeverDrafter(), n_new=8)
    finally:
        obs.disable()
    assert _tokens(rep) == ref
    assert rep.spec["proposed"] == 0 and rep.spec["verify_ticks"] == 0
    assert steps.value() - before == rep.steps


def test_tree_draft_beside_wide_prefill_chunk(params):
    """A live slot's tree draft shares ticks with another slot's 64-row
    prefill chunks (past the 32-row tree cap): the tree falls back to its
    chain for those ticks, and the stream still matches."""
    _, tp = params
    a = np.tile(np.array([7, 9, 4], np.int32), 8)
    b = np.tile(np.array([3, 5], np.int32), 50)

    def reqs():
        return [ts.Request(uid=0, prompt=a, max_new_tokens=16),
                ts.Request(uid=1, prompt=b, max_new_tokens=6,
                           arrival_tick=3)]

    kw = dict(slots=2, cache_len=128, prefill_chunk=64)
    ref = _tokens(ts.SlotServer(tp, T_CFG, **kw).serve(reqs()))
    rep = ts.SlotServer(tp, T_CFG, speculate=True, draft_k=5,
                        drafter="ngram-tree", **kw).serve(reqs())
    assert _tokens(rep) == ref


@pytest.mark.parametrize("drafter", ["ngram", "oracle"])
def test_sampled_spec_stream_equals_sampled_nonspec(params, drafter):
    """Every draw is keyed by the request and the token's stream index, so
    a sampled speculative serve commits the sampled plain serve's stream
    (the oracle makes sampled drafts accept and reject)."""
    _, tp = params
    kw = dict(temperature=0.9, top_k=20, seed=5)
    ref = _port_ref(tp, "paged", **kw)
    d = OracleDrafter(ref, wrong_every=3) if drafter == "oracle" else drafter
    _, rep = _serve(tp, "paged", d, **kw)
    assert _tokens(rep) == ref
    if drafter == "oracle":
        assert rep.spec["accepted"] > 0
    assert ref != _port_ref(tp, "paged")  # the draws are not greedy


def test_spec_metrics_and_report(params):
    _, tp = params
    ref = _port_ref(tp, "paged")
    obs.enable()
    try:
        p0 = obs.REGISTRY.get("serving_spec_proposed_total").value()
        a0 = obs.REGISTRY.get("serving_spec_accepted_total").value()
        _, rep = _serve(tp, "paged", OracleDrafter(ref, wrong_every=3))
        prop = obs.REGISTRY.get("serving_spec_proposed_total").value() - p0
        acc = obs.REGISTRY.get("serving_spec_accepted_total").value() - a0
        ratio = obs.REGISTRY.get("serving_spec_acceptance_ratio").value()
    finally:
        obs.disable()
    assert prop == rep.spec["proposed"] > 0
    assert acc == rep.spec["accepted"] > 0
    assert 0.0 < ratio <= 1.0
    assert rep.as_dict()["spec"] == rep.spec
    assert rep.spec["drafter"] == "OracleDrafter"
    assert ts.SlotServer(tp, T_CFG, **ENGINE).serve(
        _reqs(ts, 2)).spec == {}


def test_spec_refusals(params):
    _, tp = params
    for k in (0, 32):
        with pytest.raises(ValueError, match="draft_k"):
            ts.SlotServer(tp, T_CFG, **ENGINE, speculate=True, draft_k=k)
    from tree_attention_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="under a mesh"):
        ts.SlotServer(tp, T_CFG, **ENGINE, speculate=True,
                      mesh=Mesh.__new__(Mesh))


# -- CLI ---------------------------------------------------------------------

def test_cli_spec_flags_and_record():
    cfg = parse_args(["--mode", "serve", "--speculate", "--draft-k", "7",
                      "--drafter", "ngram-tree"])
    assert cfg.speculate and cfg.draft_k == 7 and cfg.drafter == "ngram-tree"
    cfg = parse_args(["--mode", "serve"])
    assert not cfg.speculate and cfg.drafter == "ngram" and cfg.draft_k == 4
    small = ["--mode", "serve", "--device", "cpu", "--model-dim", "32",
             "--heads", "2", "--n-layers", "2", "--vocab-size", "64",
             "--dtype", "float32", "--temperature", "0", "--slots", "2",
             "--requests", "3", "--prompt-len", "12", "--prompt-jitter", "3",
             "--max-new-tokens", "6", "--prefill-chunk", "8", "--kv-block",
             "8", "--log-level", "warning", "--speculate"]
    for extra in (["--drafter", "ngram-tree"],
                  ["--drafter", "model", "--kv-quant", "int8"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(small + extra) == 0
        rec = json.loads(buf.getvalue().strip().splitlines()[-1])
        assert rec["speculate"] == {"draft_k": 4, "drafter": extra[1]}
        assert rec["spec"]["verify_ticks"] >= 0
        assert rec["outcomes"] == {"budget": 3}
        assert rec["leaks"]["blocks_used"] == 0
    with pytest.raises(SystemExit, match="draft_k must be in"):
        cli.main(small + ["--draft-k", "0"])
