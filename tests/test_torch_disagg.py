"""The port's disaggregated prefill/decode serving against the fused engine
and the JAX package's (CPU).

Counterparts of ``tests/test_serving_disagg.py``, at the tiny model of
``tests/test_torch_fork.py`` (f32, ``seeded_params``) with ``cache_len``
64, ``kv_block`` 8 and ``prefill_chunk`` 8; one prefill slot and two
decode slots.

- **Parity.** The three-request trace (staggered arrivals, so requests
  wait to admit and park for handoff) through ``DisaggServer`` gives the
  fused ``SlotServer``'s tokens: exact with the shared radix cache on from
  birth, exact with EOS (on either worker), int8, int8 with the shared
  radix cache (held against the port's cache-off int8 run: the JAX
  package's own case is red), and with speculation on the decode pool.
  The exact pair also gives JAX's ``DisaggServer``'s tokens and handoff
  counts. Both workers' caches are views of one pool (``data_ptr``), each
  handoff moves no KV byte and transfers exactly the handed-off private
  blocks, and the decode worker only ever steps at Tq 1.
- **Exit arcs.** A cancel while parked for handoff (it retires on the
  prefill worker with its one token), a cancel mid-prefill, a deadline
  expired in the queue, a drain, ``fork_at`` on the decode pool (and
  ``n > 1`` refused), a fork mailboxed before admission that waits through
  prefill and handoff.
- **The allocator's audit.** ``transfer_private`` moves only private
  blocks and leaves availability, reservations and the generation alone;
  the engine's shared-pool refusals.
- **HTTP and the CLI.** The ingress drives the pair unchanged; the CLI's
  refusals. The JAX package's two flight-recorder cases wait for the
  flight recorder (ROADMAP A4.4).
"""

from __future__ import annotations

import http.client
import json
import time

import numpy as np
import pytest

from tree_attention_tpu import serving as js
from tree_attention_tpu_torch import cli
from tree_attention_tpu_torch import serving as ts
from tree_attention_tpu_torch.serving.block_pool import (
    BlockAllocator,
    ShardedBlockAllocator,
)
from tests.test_torch_fork import (  # noqa: F401  (params: a fixture)
    J_CFG,
    T_CFG,
    params,
)
from tests.torch_threads import few_torch_threads  # noqa: F401

KW = dict(cache_len=64, prefill_chunk=8, kv_block=8)
LOOP_PROMPT = np.tile(np.array([7, 9, 4], np.int32), 6)[:16]
ALT_PROMPT = np.tile(np.array([3, 5], np.int32), 8)
RAND_PROMPT = np.array([11, 90, 33, 5, 72, 18, 101, 64, 9, 40, 2, 77],
                       np.int32)


def _trace(mod, n_new=12, eos=None):
    return [mod.Request(uid=0, prompt=LOOP_PROMPT, max_new_tokens=n_new,
                        eos_id=eos),
            mod.Request(uid=1, prompt=ALT_PROMPT, max_new_tokens=n_new,
                        arrival_tick=2, eos_id=eos),
            mod.Request(uid=2, prompt=RAND_PROMPT, max_new_tokens=n_new,
                        arrival_tick=4, eos_id=eos)]


def _tokens(rep):
    return {r.uid: list(map(int, r.tokens)) for r in rep.results}


_REF = {}


def _fused(params, n_new=12, eos=None, **kw):
    """The fused engine's streams of the trace, once per shape."""
    key = (n_new, eos, tuple(sorted(kw.items())))
    if key not in _REF:
        rep = ts.SlotServer(params[1], T_CFG, slots=3, **KW, **kw).serve(
            _trace(ts, n_new, eos))
        _REF[key] = _tokens(rep)
    return _REF[key]


_PAIRS = {}


def _disagg(params, name, **kw):
    """One DisaggServer per configuration (serve() is reusable)."""
    if name not in _PAIRS:
        _PAIRS[name] = ts.DisaggServer(params[1], T_CFG, prefill_slots=1,
                                       decode_slots=2, **KW, **kw)
    return _PAIRS[name]


def main_pair(params):
    return _disagg(params, "main", prefix_cache=True, prefix_block=8)


def assert_drained(srv):
    leak = srv.leak_report()
    assert leak["blocks_private"] == leak["blocks_reserved"] == 0, leak
    assert leak["blocks_shared"] == leak["pins"] == 0, leak
    assert leak["blocks_used"] == leak["blocks_cached"], leak
    assert srv.all_slots_free
    assert srv.pool_shared()


# -- parity ----------------------------------------------------------------------

class TestParity:
    def test_exact_tokens_identical_and_leak_free(self, params):
        srv = main_pair(params)
        ptrs = [srv.prefill.cache.k.data_ptr(), srv.prefill.cache.v.data_ptr()]
        rep = srv.serve(_trace(ts))
        assert _tokens(rep) == _fused(params)
        assert rep.outcomes == {"budget": 3}
        assert rep.handoff["handoffs"] == 3
        assert rep.handoff["kv_bytes_moved"] == 0
        assert rep.handoff["blocks_transferred"] > 0
        # One pool, never reallocated: both workers still name it.
        assert [srv.decode.cache.k.data_ptr(),
                srv.decode.cache.v.data_ptr()] == ptrs
        assert_drained(srv)

    def test_exact_pair_matches_jax(self, params):
        """The JAX package's DisaggServer on the same weights: the same
        tokens, handoffs and transferred blocks."""
        jsrv = js.DisaggServer(params[0], J_CFG, prefill_slots=1,
                               decode_slots=2, **KW)
        jrep = jsrv.serve(_trace(js))
        srv = _disagg(params, "plain")
        rep = srv.serve(_trace(ts))
        assert _tokens(rep) == _tokens(jrep) == _fused(params)
        for key in ("handoffs", "blocks_transferred", "kv_bytes_moved"):
            assert rep.handoff[key] == jrep.handoff[key], key
        assert_drained(srv)

    def test_exact_eos_arcs_identical(self, params):
        srv = main_pair(params)
        rep = srv.serve(_trace(ts, eos=9))
        assert _tokens(rep) == _fused(params, eos=9)
        assert_drained(srv)

    def test_shared_radix_hits_across_the_pair(self, params):
        srv = main_pair(params)
        srv.serve(_trace(ts))  # publish pass (a no-op when already warm)
        rep = srv.serve(_trace(ts))
        assert rep.prefix["hits"] == 3 and rep.prefix["tokens_reused"] > 0
        assert rep.prefix["hit_bytes_moved"] == 0  # reference in place
        assert _tokens(rep) == _fused(params)
        assert_drained(srv)

    def test_int8_tokens_identical(self, params):
        srv = _disagg(params, "int8", quantize=True)
        sc = srv.prefill.cache.k_scale
        rep = srv.serve(_trace(ts))
        assert _tokens(rep) == _fused(params, quantize=True)
        assert srv.decode.cache.k_scale is sc is srv.prefill.cache.k_scale
        assert rep.handoff["handoffs"] == 3
        assert_drained(srv)

    def test_int8_shared_radix_hits_across_the_pair(self, params):
        """Held against the port's cache-off int8 run (the JAX package's
        case of this name is red)."""
        srv = _disagg(params, "int8_prefix", quantize=True,
                      prefix_cache=True, prefix_block=8)
        srv.serve(_trace(ts))
        rep = srv.serve(_trace(ts))
        assert rep.prefix["hits"] == 3 and rep.prefix["tokens_reused"] > 0
        assert rep.prefix["hit_bytes_moved"] > 0  # the dequant gather
        assert _tokens(rep) == _fused(params, quantize=True)
        assert_drained(srv)

    def test_speculation_on_decode_pool_parity(self, params):
        srv = _disagg(params, "spec", speculate=True, draft_k=4)
        rep = srv.serve(_trace(ts, n_new=24))
        assert _tokens(rep) == _fused(params, n_new=24)
        assert rep.spec["accepted"] > 0
        assert rep.spec["tokens_per_verify"] > 1.0
        assert_drained(srv)

    def test_decode_worker_steps_one_row_and_prefill_no_decode_row(
            self, params):
        """Every decode-worker step is one row a slot; the prefill worker
        never holds a live slot, so its steps carry chunks only."""
        srv = _disagg(params, "probe")
        seen = {"decode": [], "prefill": []}
        for name, eng in (("decode", srv.decode), ("prefill", srv.prefill)):
            step = eng._step

            def spy(tokens, n_vec, reset, reset_val, emit, verify=None,
                    _step=step, _name=name, _eng=eng):
                seen[_name].append((tokens.shape[1],
                                    "live" in _eng._slot_state))
                return _step(tokens, n_vec, reset, reset_val, emit, verify)

            eng._step = spy
        rep = srv.serve(_trace(ts))
        assert _tokens(rep) == _fused(params)
        assert seen["decode"] and {tq for tq, _ in seen["decode"]} == {1}
        assert seen["prefill"] and not any(lv for _, lv in seen["prefill"])
        assert_drained(srv)


# -- exit arcs ---------------------------------------------------------------------

class TestExitArcs:
    def test_cancel_while_queued_for_handoff(self, params):
        """Both decode slots hold long residents, so the victim parks in
        its prefill slot after its first token; its cancel retires it on
        the prefill worker, one token delivered, nothing leaked."""
        srv = main_pair(params)
        victim = 7
        reqs = [ts.Request(uid=0, prompt=LOOP_PROMPT, max_new_tokens=30),
                ts.Request(uid=1, prompt=ALT_PROMPT, max_new_tokens=30),
                ts.Request(uid=victim, prompt=RAND_PROMPT, max_new_tokens=20,
                           arrival_tick=2,
                           on_token=lambda _t: srv.cancel(victim))]
        rep = srv.serve(reqs)
        out = {r.uid: r for r in rep.results}
        assert out[victim].outcome == "cancelled"
        assert len(out[victim].tokens) == 1
        assert out[0].outcome == out[1].outcome == "budget"
        assert rep.handoff["handoffs"] == 2
        assert_drained(srv)

    def test_deadline_while_queued_for_handoff(self, params):
        srv = main_pair(params)
        victim = 8
        reqs = [ts.Request(uid=0, prompt=LOOP_PROMPT, max_new_tokens=30),
                ts.Request(uid=1, prompt=ALT_PROMPT, max_new_tokens=30),
                ts.Request(uid=victim, prompt=RAND_PROMPT, max_new_tokens=20,
                           arrival_tick=2)]

        def expire(_tok, r=reqs[2]):
            r.deadline_s = time.monotonic() - 1.0

        reqs[2].on_token = expire
        rep = srv.serve(reqs)
        out = {r.uid: r for r in rep.results}
        assert out[victim].outcome == "deadline"
        assert len(out[victim].tokens) == 1
        assert rep.handoff["handoffs"] == 2
        assert_drained(srv)

    def test_cancel_mid_prefill_on_prefill_worker(self, params):
        srv = main_pair(params)
        victim, fired = 9, []

        def cancel_once(_tok):
            if not fired:
                fired.append(1)
                srv.cancel(victim)

        reqs = [ts.Request(uid=0, prompt=LOOP_PROMPT, max_new_tokens=20,
                           on_token=cancel_once),
                ts.Request(uid=victim, prompt=np.tile(RAND_PROMPT, 4),
                           max_new_tokens=8, arrival_tick=3)]
        rep = srv.serve(reqs)
        out = {r.uid: r for r in rep.results}
        assert out[victim].outcome == "cancelled" and out[victim].tokens == []
        assert_drained(srv)

    def test_deadline_expired_in_queue_rejected_unserved(self, params):
        srv = main_pair(params)
        rep = srv.serve([
            ts.Request(uid=0, prompt=LOOP_PROMPT, max_new_tokens=6),
            ts.Request(uid=1, prompt=ALT_PROMPT, max_new_tokens=6,
                       deadline_s=time.monotonic() - 1.0)])
        out = {r.uid: r for r in rep.results}
        assert out[1].outcome == "deadline" and out[1].tokens == []
        assert out[1].admit_tick == -1 and out[0].outcome == "budget"
        assert_drained(srv)

    def test_drain_sheds_queue_and_finishes_inflight(self, params):
        srv = main_pair(params)
        fired = []

        def drain_once(_tok):
            if not fired:
                fired.append(1)
                srv.request_drain()

        rep = srv.serve([
            ts.Request(uid=0, prompt=LOOP_PROMPT, max_new_tokens=10,
                       on_token=drain_once),
            ts.Request(uid=1, prompt=ALT_PROMPT, max_new_tokens=10,
                       arrival_tick=1)])
        out = {r.uid: r for r in rep.results}
        assert out[0].outcome == "budget" and len(out[0].tokens) == 10
        assert out[1].outcome == "shed" and out[1].tokens == []
        assert_drained(srv)

    def test_fork_mid_generation_on_decode_pool(self, params):
        srv = main_pair(params)
        rep = srv.serve([ts.Request(uid=60, prompt=RAND_PROMPT,
                                    max_new_tokens=8, fork_at=2)])
        res = {r.index: r.tokens for r in rep.results}
        assert sorted(res) == [0, 1] and res[0] == res[1]  # greedy twins
        assert rep.kv["forks"] == 1
        assert srv.leak_report()["blocks_shared"] == 0
        assert_drained(srv)
        with pytest.raises(ValueError, match="not supported on this engine"):
            srv.serve([ts.Request(uid=61, prompt=RAND_PROMPT,
                                  max_new_tokens=4, n=2)])
        assert_drained(srv)

    def test_fork_waits_through_prefill_and_handoff(self, params):
        srv = main_pair(params)
        srv.fork(70)  # mailboxed before the request even admits
        rep = srv.serve([ts.Request(uid=70, prompt=LOOP_PROMPT,
                                    max_new_tokens=8)])
        res = {r.index: r.tokens for r in rep.results}
        assert sorted(res) == [0, 1] and res[0] == res[1]
        assert not srv._fork_carry
        assert_drained(srv)


# -- the allocator's audit and the shared-pool contracts -----------------------

class TestTransferAudit:
    @pytest.mark.parametrize("alloc", [lambda: BlockAllocator(4),
                                       lambda: ShardedBlockAllocator(4, 2)],
                             ids=["flat", "sharded"])
    def test_transfer_private_moves_only_private_blocks(self, alloc):
        a = alloc()
        assert a.reserve(2)
        x, y = a.alloc(), a.alloc()
        assert a.transfer_private([x, y]) == 2 and a.transferred == 2
        a.free_private(x)
        a.free_private(y)
        assert a.used == 0

    def test_transfer_of_free_block_raises(self):
        with pytest.raises(AssertionError, match="not privately owned"):
            BlockAllocator(4).transfer_private([0])

    def test_transfer_of_cached_block_raises(self):
        a = BlockAllocator(4)
        assert a.reserve(1)
        bid = a.alloc()
        a.publish(bid)
        with pytest.raises(AssertionError, match="not privately owned"):
            a.transfer_private([bid])

    def test_transfer_keeps_reservations_and_availability(self):
        a = BlockAllocator(8)
        assert a.reserve(4)
        bids = [a.alloc() for _ in range(2)]
        before = (a.available(), a.reserved, a.gen)
        a.transfer_private(bids)
        assert (a.available(), a.reserved, a.gen) == before

    def test_engine_rejects_contiguous_shared_pool(self, params):
        with pytest.raises(ValueError, match="paged"):
            ts.SlotServer(params[1], T_CFG, slots=1, cache_len=64,
                          kv_layout="contiguous",
                          block_pool=BlockAllocator(4))

    def test_engine_rejects_mismatched_kv_blocks(self, params):
        with pytest.raises(ValueError, match="contradicts"):
            ts.SlotServer(params[1], T_CFG, slots=1, cache_len=64,
                          kv_blocks=8, block_pool=BlockAllocator(4))

    def test_disagg_tiering_requires_prefix_cache(self, params):
        with pytest.raises(ValueError, match="prefix_cache"):
            ts.DisaggServer(params[1], T_CFG, prefill_slots=1,
                            decode_slots=1, cache_len=64, host_blocks=8)


# -- HTTP and the CLI ----------------------------------------------------------------

def test_http_ingress_over_disagg(params):
    srv = main_pair(params)
    ing = ts.IngressServer(srv, max_queue=8, default_max_tokens=6,
                           keepalive_s=0.05)
    port = ing.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/v1/completions", json.dumps(
            {"prompt": [int(t) for t in LOOP_PROMPT], "max_tokens": 6,
             "stream": False}), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
        assert resp.status == 200
        assert body["choices"][0]["token_ids"] == _fused(params)[0][:6]
        assert body["choices"][0]["finish_reason"] == "length"
    finally:
        ing.drain()
        ing.join(timeout=30)
        ing.stop()
    assert_drained(srv)


SERVE = ["--mode", "serve", "--device", "cpu", "--serve-disagg",
         "--model-dim", "32", "--heads", "2", "--vocab-size", "64",
         "--n-layers", "1", "--dtype", "float32"]


@pytest.mark.parametrize("args,match", [
    (["--kv-layout", "contiguous"], "paged"),
    (["--admission", "whole"], "chunked"),
    (["--slots", "1", "--prefill-slots", "1"], "decode slot"),
    (["--prefill-slots", "0"], "prefill-slots"),
    (["--host-blocks", "8"], "prefix-cache"),
], ids=["paged", "chunked", "decode-slot", "prefill-slots", "tiering"])
def test_cli_refusals(args, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(SERVE + args)


def test_cli_has_no_fleet_to_combine_with():
    """``--serve-fleet`` beside ``--serve-disagg`` is refused, as the JAX
    CLI refuses it: no disaggregated fleet tier exists."""
    with pytest.raises(SystemExit, match="--serve-disagg and --serve-fleet "
                       "are exclusive"):
        cli.main(SERVE + ["--serve-fleet"])


def test_cli_serve_disagg_record(capsys):
    assert cli.main(SERVE + ["--slots", "3", "--prefill-slots", "1",
                             "--requests", "4", "--prompt-len", "12",
                             "--max-new-tokens", "4",
                             "--prefill-chunk", "8"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["disagg"] == {"prefill_slots": 1, "decode_slots": 2}
    assert rec["handoff"]["handoffs"] == 4
    assert rec["handoff"]["kv_bytes_moved"] == 0
    assert rec["leaks"]["blocks_used"] == rec["leaks"]["blocks_reserved"] \
        == 0
