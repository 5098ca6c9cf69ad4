"""The port's per-request cost ledger against the JAX package's (CPU).

Counterparts of ``tests/test_request_telemetry.py``'s ledger cases:

- **The table.** One scripted sequence of ``open``, ``note``, ``blocks``,
  ``first_token``, ``park``, ``resume``, ``finish``, ``drop``, ``get`` and
  ``snapshot`` calls, with fixed ``now``, on a JAX ``ReqLog`` and a port
  ``ReqLog``: every dict equal; ``aggregate_ledgers`` equal on the
  finished ledgers; a disarmed log records nothing.
- **Serves, armed.** Two traces through JAX's ``SlotServer`` and the
  port's with both ledgers armed (f32, greedy: tokens exact): paged exact
  with the prefix cache (a cold prompt, its prefix hit, a token-tree
  family of 2 and a fork-slot family of 2, one too long for the tree
  rule), and paged int8 with chain n-gram speculation (a looping prompt
  the drafter proposes from). Per request the ledger's token and block counts
  (prompt, prefix-hit, prefilled and decoded tokens, speculation proposed
  and accepted, fork-shared blocks, outcome, the branch that closed it)
  equal JAX's, and every ledger's wall segments reconcile with its span
  (wall seconds are not compared across frameworks).
- **The pair.** ``DisaggServer`` armed: every request charges its handoff
  segment and still reconciles; the report's aggregates are
  ``aggregate_ledgers`` of its results.
- **Disarmed**, ``ServeReport.requests`` is ``{}`` and no result carries a
  ledger.
- **The endpoint.** ``/requests`` and ``/request/{uid}`` on a loopback
  ``MetricsHTTPServer``: an unknown uid 404, a non-integer 400.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tree_attention_tpu import models as jm
from tree_attention_tpu import obs as jobs
from tree_attention_tpu import serving as js
from tree_attention_tpu.obs import reqlog as jreqlog

from tree_attention_tpu_torch import models as tm
from tree_attention_tpu_torch import obs
from tree_attention_tpu_torch import serving as ts
from tree_attention_tpu_torch.obs import reqlog as treqlog
from tree_attention_tpu_torch.obs.http import MetricsHTTPServer
from tests.torch_params import seeded_params
from tests.torch_threads import few_torch_threads  # noqa: F401

CFG = dict(vocab_size=64, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2,
           d_head=16, d_ff=64, max_seq_len=64)
J_CFG = jm.TransformerConfig(**CFG, dtype=jnp.float32)
T_CFG = tm.TransformerConfig(**CFG, dtype=torch.float32)
ENGINE = dict(slots=4, cache_len=48, prefill_chunk=8, kv_block=8)
# The ledger's fields that do not read a clock.
COUNTS = ("uid", "trace_id", "parent_span_id", "phase", "outcome",
          "arrival_tick", "admit_tick", "finish_tick", "prompt_tokens",
          "prefix_hit_tokens", "tokens_prefilled", "tokens_decoded",
          "host_demotes", "host_restores", "spec_proposed", "spec_accepted",
          "fork_shared_blocks")


@pytest.fixture(scope="module")
def params():
    return seeded_params(T_CFG)


@pytest.fixture
def armed():
    """Both packages' ledgers armed for one test, disarmed after."""
    jobs.REQLOG.arm()
    obs.REQLOG.arm()
    try:
        yield
    finally:
        jobs.REQLOG.disarm()
        obs.REQLOG.disarm()


def reconciles(lg):
    """In-span segments sum to the span (``as_dict`` rounds each field to
    6 decimals, so the three-term sum may miss the rounded wall by 2e-6)."""
    return lg["prefill_s"] + lg["handoff_s"] + lg["decode_s"] \
        == pytest.approx(lg["wall_s"], abs=5e-6)


# -- the table ----------------------------------------------------------------

def _script(mod):
    """One sequence of ledger calls at fixed times; returns every dict the
    log handed back along the way."""
    log = mod.ReqLog(ring=3)
    out = [log.snapshot()]
    log.open(1, now=0.0)  # disarmed: nothing recorded
    out.append(log.get(1))
    log.arm()
    log.open(1, trace_id="a" * 32, span_id="b" * 16, parent_span_id="c" * 16,
             prompt_tokens=20, prefix_hit_tokens=8, arrival_tick=2,
             admit_tick=3, queue_wait_s=0.25, nblocks=1, now=10.0)
    log.open(2, prompt_tokens=5, admit_tick=4, now=10.5)
    log.open(3, prompt_tokens=7, now=10.6)
    log.note(1, spec_proposed=4, spec_accepted=3, host_restores=1)
    log.note(1, spec_proposed=2, bogus=9)  # unknown counters are ignored
    log.note(99, spec_proposed=1)  # unknown uid
    log.blocks(1, 3, now=11.0)
    log.first_token(1, now=11.5)
    log.first_token(1, now=12.0)  # only the first closes prefill
    log.park(1, now=12.5)
    out.append(log.get(1))
    log.resume(1, now=13.25)
    log.blocks(1, 4, now=14.0)
    out.append(log.finish(1, outcome="budget", finish_tick=9,
                          tokens_decoded=6, nblocks=0, now=15.0))
    out.append(log.finish(1, outcome="budget", now=16.0))  # closed already
    log.park(2, now=11.0)  # parked, never adopted: finish closes it
    out.append(log.finish(2, outcome="cancelled", finish_tick=5, now=12.0))
    log.drop(3)
    out.append(log.get(3))
    for uid in (4, 5, 6):  # the ring holds 3
        log.open(uid, now=20.0 + uid)
        out.append(log.finish(uid, outcome="eos", now=21.0 + uid))
    out.append(log.get(1))  # evicted
    out.append(log.get(6))
    out.append(log.snapshot())
    log.arm(ring=2)
    out.append(log.snapshot())
    log.disarm()
    out.append(log.snapshot())
    return out


def test_reqlog_matches_jax():
    got, want = _script(treqlog), _script(jreqlog)
    # A live ledger's as_dict reads the clock for wall_s: the parked
    # ledger's view is held apart.
    live_got, live_want = got.pop(2), want.pop(2)
    assert got == want
    for d in (live_got, live_want):
        assert d.pop("wall_s") >= 0.0
    assert live_got == live_want
    assert live_got["phase"] == "handoff" and live_got["prefill_s"] == 1.5
    ledger = got[2]
    assert ledger["handoff_s"] == 0.75 and ledger["decode_s"] == 2.75
    assert ledger["kv_block_seconds"] == 1 * 1.0 + 3 * 3.0 + 4 * 1.0
    assert reconciles(ledger)


def test_aggregate_ledgers_matches_jax():
    ledgers = [d for d in _script(treqlog)[-3]["recent"]] + [
        {"prefill_s": 0.1, "decode_s": 0.4, "tokens_decoded": 4},
        {"prefill_s": 0.3, "decode_s": 0.2, "tokens_decoded": 6,
         "spec_proposed": 3}]
    got = treqlog.aggregate_ledgers(ledgers)
    assert got == jreqlog.aggregate_ledgers(ledgers)
    assert got["count"] == 5 and got["tokens_decoded_total"] == 10
    assert treqlog.aggregate_ledgers([]) is None


# -- serves, armed --------------------------------------------------------------

def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 64, n).astype(np.int32)


SHARED = _prompt(1, 16)
TRACES = {
    # A cold prompt, its prefix hit (two shared blocks), a token-tree
    # family (2 x 4 rows) and a fork-slot family (2 x 19 rows: past the
    # tree rule's 32).
    "exact-prefix-families": (
        dict(prefix_cache=True, prefix_block=8),
        lambda mod: [
            mod.Request(uid=0, prompt=np.concatenate([SHARED, _prompt(2, 3)]),
                        max_new_tokens=5),
            mod.Request(uid=1, prompt=np.concatenate([SHARED, _prompt(3, 2)]),
                        max_new_tokens=6, arrival_tick=4),
            mod.Request(uid=2, prompt=_prompt(4, 11), max_new_tokens=5, n=2),
            mod.Request(uid=3, prompt=_prompt(5, 9), max_new_tokens=20, n=2,
                        arrival_tick=2)]),
    # Chain n-gram drafts over an int8 pool: a looping prompt (drafts are
    # proposed from its repeats) and a cold one.
    "int8-speculative": (
        dict(quantize=True, speculate=True, drafter="ngram", draft_k=3),
        lambda mod: [
            mod.Request(uid=0, prompt=np.tile(np.array([7, 9, 4], np.int32),
                                              5), max_new_tokens=12),
            mod.Request(uid=1, prompt=_prompt(6, 13), max_new_tokens=8,
                        arrival_tick=1)]),
}
_SERVES = {}


def _serve(params, name):
    """The trace through JAX's engine and the port's, both ledgers armed;
    once per module."""
    if name not in _SERVES:
        kw, trace = TRACES[name]
        jobs.REQLOG.arm()
        obs.REQLOG.arm()
        try:
            jrep = js.SlotServer(params[0], J_CFG, **ENGINE, **kw).serve(
                trace(js), max_ticks=300)
            rep = ts.SlotServer(params[1], T_CFG, **ENGINE, **kw).serve(
                trace(ts), max_ticks=300)
        finally:
            jobs.REQLOG.disarm()
            obs.REQLOG.disarm()
        _SERVES[name] = jrep, rep
    return _SERVES[name]


def _by_uid(report):
    """uid -> (index of the branch that carries the ledger, the ledger)."""
    out = {}
    for r in report.results:
        if r.ledger is not None:
            assert r.uid not in out, "one ledger per request"
            out[r.uid] = (r.index, r.ledger)
    return out


@pytest.mark.parametrize("name", sorted(TRACES))
def test_served_ledgers_match_jax(params, name):
    jrep, rep = _serve(params, name)
    assert [list(r.tokens) for r in rep.results] == \
        [list(r.tokens) for r in jrep.results]
    got, want = _by_uid(rep), _by_uid(jrep)
    assert sorted(got) == sorted(want) == sorted({r.uid for r in rep.results})
    for uid, (index, lg) in got.items():
        jindex, jlg = want[uid]
        assert index == jindex, uid
        assert {k: lg[k] for k in COUNTS} == {k: jlg[k] for k in COUNTS}
        assert lg["phase"] == "done" and lg["handoff_s"] == 0.0
        assert lg["kv_block_seconds"] > 0.0
        assert lg["prompt_tokens"] == \
            lg["prefix_hit_tokens"] + lg["tokens_prefilled"]
        assert reconciles(lg), lg
    agg = obs.aggregate_ledgers([lg for _, lg in got.values()])
    assert rep.requests == agg
    assert rep.as_dict()["request_ledgers"] == agg


def test_served_ledgers_cover_each_seam(params):
    """What each trace is there for: a prefix hit, both family paths, and
    speculation's notes."""
    _, rep = _serve(params, "exact-prefix-families")
    led = _by_uid(rep)
    assert led[1][1]["prefix_hit_tokens"] == 16
    assert rep.kv["tree_families"] == 1
    # The token-tree family closes with its last branch, over both
    # branches' tokens; the fork-slot family with its first branch.
    assert led[2][1]["tokens_decoded"] == 2 * 5
    assert led[3][1]["tokens_decoded"] == 20
    assert led[3][1]["fork_shared_blocks"] >= 1
    _, rep = _serve(params, "int8-speculative")
    led = [lg for _, lg in _by_uid(rep).values()]
    assert sum(lg["spec_proposed"] for lg in led) == rep.spec["proposed"] > 0
    assert sum(lg["spec_accepted"] for lg in led) == rep.spec["accepted"]


def test_disagg_pair_charges_handoff(params, armed):
    pair = ts.DisaggServer(params[1], T_CFG, prefill_slots=1, decode_slots=2,
                           cache_len=48, prefill_chunk=8, kv_block=8)
    report = pair.serve([ts.Request(uid=10 + i, prompt=_prompt(7 + i, 10),
                                    max_new_tokens=4, arrival_tick=2 * i)
                         for i in range(3)])
    ledgers = [r.ledger for r in report.results]
    assert all(lg is not None for lg in ledgers)
    for lg in ledgers:
        assert lg["outcome"] == "budget" and lg["tokens_decoded"] == 4
        assert lg["handoff_s"] > 0.0 and lg["kv_block_seconds"] > 0.0
        assert reconciles(lg), lg
    agg = report.as_dict()["request_ledgers"]
    assert agg == obs.aggregate_ledgers(ledgers)
    assert agg["count"] == 3 and agg["tokens_decoded_total"] == 12


def test_report_is_empty_when_disarmed(params):
    assert not obs.REQLOG.enabled
    report = ts.SlotServer(params[1], T_CFG, **ENGINE).serve(
        [ts.Request(uid=0, prompt=_prompt(9, 8), max_new_tokens=2)])
    assert report.requests == {}
    assert report.results[0].ledger is None
    assert "request_ledgers" not in report.as_dict()


# -- the endpoint -----------------------------------------------------------------

def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_requests_endpoints():
    log = treqlog.ReqLog()
    log.arm()
    log.open(5, prompt_tokens=4, now=1.0)
    log.open(6, prompt_tokens=3, now=1.0)
    log.finish(6, outcome="eos", tokens_decoded=2, now=2.0)
    srv = MetricsHTTPServer(reqlog=log)
    port = srv.start()
    try:
        status, snap = _get(port, "/requests")
        assert status == 200 and snap["enabled"]
        assert [d["uid"] for d in snap["live"]] == [5]
        assert [d["uid"] for d in snap["recent"]] == [6]
        status, detail = _get(port, "/request/6")
        assert status == 200 and detail == log.get(6)
        assert [p["phase"] for p in detail["phases"]] == [
            "queue", "prefill", "handoff", "decode"]
        status, live = _get(port, "/request/5")
        assert status == 200 and live["outcome"] is None
        assert _get(port, "/request/999")[0] == 404
        assert _get(port, "/request/nope")[0] == 400
    finally:
        srv.stop()
