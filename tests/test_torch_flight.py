"""The port's tick flight recorder against the JAX engine's (CPU).

- **Record parity.** One shared trace through JAX's paged chunked exact
  greedy ``SlotServer`` and the port's, both recorders armed: six requests
  on staggered arrivals (the queue fills and drains), one deadline that
  expires in flight, one cancel, and a late request dead on arrival (a
  sweep-only tick after a fast-forward). Every record equals JAX's key for
  key and value for value but ``t_s``; the JAX side runs once, in a
  module fixture.
- **Each feature's fields**, the port alone, each a counterpart of the
  reference test that holds them, with its assertions:
  ``test_serving_paged.py::test_paged_obs_gauges_and_flight``,
  ``test_serving_ingress.py::
  test_sweep_only_tick_still_records_flight_counters``,
  ``test_serving_fork.py::test_fork_telemetry_counters_flight_and_instants``,
  ``test_serving_tree.py::
  test_tree_telemetry_gauge_flight_and_accept_counter``,
  ``test_serving_prefix.py::test_prefix_flight_fields``,
  ``test_serving_tiered.py::test_tier_metrics_and_flight_fields``,
  ``test_serving_spec.py::test_spec_metrics_flight_and_report``, and the
  pair's ``test_serving_disagg.py::TestExitArcs::
  test_flight_records_carry_robustness_counters`` and
  ``::test_sweep_only_tick_still_records_flight_counters``.
- **Errors**: a tick that raises dumps the armed ring (``engine_error:`` /
  ``disagg_error:``) and the error reaches the caller.
- **The CLI**: ``--flight-out`` with ``--metrics-port 0`` writes one record
  per tick; under ``--serve-http`` SIGUSR1 dumps and the server keeps
  serving, and SIGTERM drains (the drain's handler over the crash
  handlers) and exits 0 through the final dump.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tree_attention_tpu import models as jm
from tree_attention_tpu import serving as js
from tree_attention_tpu.obs.flight import FLIGHT as JFLIGHT

from tree_attention_tpu_torch import cli
from tree_attention_tpu_torch import models as tm
from tree_attention_tpu_torch import obs
from tree_attention_tpu_torch import serving as ts
from tree_attention_tpu_torch.obs import FLIGHT
from tree_attention_tpu_torch.serving.speculation import (
    DraftModelDrafter,
    DraftProposal,
    Drafter,
)
from tests.torch_params import seeded_params
from tests.torch_threads import few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The reference serving tests' model (f32, greedy: tokens exact).
CFG = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_head=16, d_ff=128, max_seq_len=256)
J_CFG = jm.TransformerConfig(**CFG, dtype=jnp.float32)
T_CFG = tm.TransformerConfig(**CFG, dtype=torch.float32)
PARITY_ENGINE = dict(slots=3, cache_len=64, prefill_chunk=8, kv_block=8)
LATE_TICK = 60


@pytest.fixture(scope="module")
def params():
    return seeded_params(T_CFG)


def _prompt(seed, n=13):
    rng = np.random.default_rng(seed)
    return rng.integers(0, CFG["vocab_size"], size=n).astype(np.int32)


@contextlib.contextmanager
def armed(flight=FLIGHT, path=None, capacity=4096):
    """The recorder armed (and cleared) for the block, disarmed after."""
    flight.clear()
    flight.arm(path, capacity=capacity)
    try:
        yield flight
    finally:
        flight.disarm()


@contextlib.contextmanager
def registry_on():
    obs.enable()
    try:
        yield obs.REGISTRY
    finally:
        obs.disable()


def drained(eng) -> bool:
    lr = eng.leak_report()
    return (lr["blocks_private"] == 0 and lr["blocks_reserved"] == 0
            and lr["blocks_shared"] == 0 and lr["pins"] == 0
            and lr["blocks_used"] == lr["blocks_cached"])


# -- record parity on one shared trace -----------------------------------------


def parity_trace(mod, eng):
    """Six requests on staggered arrivals: uid 1's deadline expires in
    flight after its third token, uid 3 cancels itself after its second,
    uid 5 arrives long after the rest drained with its deadline passed."""
    got = {1: 0, 3: 0}
    reqs = {}

    def expire(tok):
        got[1] += 1
        if got[1] == 3:
            reqs[1].deadline_s = 0.0  # the next sweep retires it

    def cancel(tok):
        got[3] += 1
        if got[3] == 2:
            eng.cancel(3)

    spec = [(0, 20, 6, 0, {}), (1, 9, 8, 0, {"on_token": expire}),
            (2, 13, 5, 1, {}), (3, 5, 10, 2, {"on_token": cancel}),
            (4, 17, 4, 3, {}),
            (5, 7, 3, LATE_TICK, {"deadline_s": time.monotonic() - 1.0})]
    for uid, plen, n_new, tick, kw in spec:
        reqs[uid] = mod.Request(uid=uid, prompt=_prompt(uid, plen),
                                max_new_tokens=n_new, arrival_tick=tick,
                                **kw)
    return [reqs[u] for u in sorted(reqs)]


def _serve_recorded(mod, eng, flight):
    with armed(flight):
        rep = eng.serve(parity_trace(mod, eng))
        snap = flight.snapshot()
    flight.clear()
    return rep, snap


@pytest.fixture(scope="module")
def jax_run(params):
    eng = js.SlotServer(params[0], J_CFG, **PARITY_ENGINE)
    return _serve_recorded(js, eng, JFLIGHT)


@pytest.fixture(scope="module")
def port_engine(params):
    return ts.SlotServer(params[1], T_CFG, **PARITY_ENGINE)


@pytest.fixture(scope="module")
def port_run(port_engine):
    return _serve_recorded(ts, port_engine, FLIGHT)


def _outcomes(rep):
    return {r.uid: (r.outcome, list(map(int, r.tokens))) for r in rep.results}


def test_records_equal_jax_but_wall_time(jax_run, port_run):
    (jrep, jsnap), (trep, tsnap) = jax_run, port_run
    assert _outcomes(trep) == _outcomes(jrep)
    assert {u: o for u, (o, _) in _outcomes(trep).items()} == {
        0: "budget", 1: "deadline", 2: "budget", 3: "cancelled",
        4: "budget", 5: "deadline"}
    jrecs, trecs = jsnap["records"], tsnap["records"]
    assert tsnap["ticks_recorded"] == jsnap["ticks_recorded"] == len(trecs)
    assert len(trecs) == len(jrecs)
    for j, t in zip(jrecs, trecs):
        assert set(t) == set(j)
        assert {k: v for k, v in t.items() if k != "t_s"} == \
            {k: v for k, v in j.items() if k != "t_s"}, t["tick"]
    # The trace moves every field it is meant to.
    ticks = [r for r in trecs if not r.get("sweep_only")]
    assert {r["host_sync"] for r in ticks} == {True, False}
    assert max(r["queue_depth"] for r in ticks) >= 2
    assert len({len(r["chunk_plan"]) for r in ticks}) >= 3
    assert len({r["kv_frag"] for r in ticks}) > 5
    assert sum(r["cancelled"] for r in trecs) == 1
    assert sum(r["deadline_expired"] for r in trecs) == 2
    assert all("spec_verify" not in r for r in trecs)


def test_recorded_ticks_are_executed_ticks(port_run, port_engine):
    rep, snap = port_run
    recs = snap["records"]
    swept = [r for r in recs if r.get("sweep_only")]
    ticks = [r for r in recs if not r.get("sweep_only")]
    # The idle fast-forward to the late arrival records nothing; its
    # sweep records one sweep-only dict at that tick.
    assert [r["tick"] for r in swept] == [LATE_TICK]
    assert swept[0]["deadline_expired"] == 1 and swept[0]["occupancy"] == 0
    assert [r["tick"] for r in ticks] == list(range(len(ticks)))
    assert rep.steps == len(ticks)
    assert sum(r["tokens_emitted"] for r in ticks) == rep.tokens_generated
    assert ticks[-1]["kv_blocks_used"] == port_engine._pool.used == 0
    assert FLIGHT.idle and not FLIGHT.enabled
    assert drained(port_engine)


def test_sweep_only_tick_still_records_flight_counters(port_engine):
    req = ts.Request(uid=610, prompt=_prompt(3, 8), max_new_tokens=4,
                     deadline_s=time.monotonic() - 1.0)  # dead on arrival
    with armed():
        rep = port_engine.serve([req])
    recs = FLIGHT.snapshot()["records"]
    FLIGHT.clear()
    assert rep.results[0].outcome == "deadline"
    swept = [r for r in recs if r.get("sweep_only")]
    assert len(swept) == 1 and swept[0]["deadline_expired"] == 1
    assert drained(port_engine)


# -- each feature's fields ------------------------------------------------------


def test_paged_obs_gauges_and_flight(params):
    server = ts.SlotServer(params[1], T_CFG, slots=2, cache_len=32,
                           prefill_chunk=4, prefill_budget=8,
                           kv_layout="paged", kv_block=4)
    with registry_on() as reg, armed():
        server.serve([ts.Request(uid=0, prompt=_prompt(17),
                                 max_new_tokens=5)])
        assert reg.gauge("serving_kv_blocks_used").value() == 0
        assert reg.gauge("serving_kv_blocks_free").value() == \
            server.kv_blocks
    recs = FLIGHT.snapshot()["records"]
    FLIGHT.clear()
    assert {"kv_blocks_used", "kv_blocks_free", "kv_frag"} <= set(recs[0])
    assert max(r["kv_blocks_used"] for r in recs) > 0
    assert all(0.0 <= r["kv_frag"] <= 1.0 for r in recs)


FORK_KW = dict(cache_len=32, kv_block=4, prefill_chunk=4)


def test_fork_telemetry_counters_flight_and_instants(params, tmp_path):
    eng = ts.SlotServer(params[1], T_CFG, slots=6, prefix_cache=True,
                        prefix_block=4, **FORK_KW)
    trace_file = tmp_path / "trace.jsonl"
    obs.TRACER.start(str(trace_file))
    try:
        with registry_on() as reg, armed():
            forks0 = reg.counter("serving_forks_total").value()
            shared0 = reg.counter(
                "serving_fork_blocks_shared_total").value()
            eng.serve([ts.Request(uid=0, prompt=_prompt(17),
                                  max_new_tokens=4, n=3)])
            assert reg.counter("serving_forks_total").value() - forks0 == 2
            assert reg.counter(
                "serving_fork_blocks_shared_total").value() - shared0 >= 2
            recs = FLIGHT.snapshot()["records"]
    finally:
        obs.TRACER.close()
        FLIGHT.clear()
    assert {"forks", "shared_blocks"} <= set(recs[0])
    assert sum(r["forks"] for r in recs) == 2
    assert sum(r["shared_blocks"] for r in recs) >= 2
    events = [json.loads(ln) for ln in open(trace_file) if ln.strip()]
    fork_events = [e for e in events
                   if e["ph"] == "i" and e["name"] == "fork"]
    assert len(fork_events) == 2
    assert {e["args"]["index"] for e in fork_events} == {1, 2}
    assert all(e["args"]["shared_blocks"] >= 1 for e in fork_events)
    assert drained(eng)


def test_tree_telemetry_gauge_flight_and_accept_counter(params):
    tree = ts.SlotServer(params[1], T_CFG, slots=2, temperature=1.0,
                         **FORK_KW)
    spec = ts.SlotServer(params[1], T_CFG, slots=2, speculate=True,
                         draft_k=3, drafter=DraftModelDrafter(params[1],
                                                              T_CFG),
                         **FORK_KW)
    with registry_on() as reg, armed():
        samples0 = reg.counter("serving_spec_accept_samples_total").value()
        tree.serve([ts.Request(uid=0, prompt=_prompt(41, n=8),
                               max_new_tokens=4, n=5, seed=3)])
        recs = FLIGHT.snapshot()["records"]
        assert {"tree_branches", "branch_retired"} <= set(recs[0])
        # Every decode tick replays all live branches; every branch
        # retires exactly once.
        assert max(r["tree_branches"] for r in recs) == 5
        assert sum(r["branch_retired"] for r in recs) == 5
        assert reg.gauge("serving_tree_branches").value() == 0.0
        # The stochastic accept walk counts its ratio-test samples.
        spec.serve([ts.Request(uid=1, prompt=np.asarray([5, 6, 7, 8] * 4,
                                                        np.int32),
                               max_new_tokens=6, temperature=0.8, seed=2)])
        assert reg.counter(
            "serving_spec_accept_samples_total").value() > samples0
    FLIGHT.clear()
    assert drained(tree) and drained(spec)


def test_prefix_flight_fields(params):
    prompt = _prompt(9)
    server = ts.SlotServer(params[1], T_CFG, slots=1, cache_len=32,
                           prefill_chunk=4, prefill_budget=4,
                           prefix_cache=True, prefix_block=4,
                           prefix_pool_blocks=16)
    server.serve([ts.Request(uid=0, prompt=prompt, max_new_tokens=5)])
    with armed():
        server.serve([ts.Request(uid=1, prompt=prompt, max_new_tokens=5)])
    recs = FLIGHT.snapshot()["records"]
    FLIGHT.clear()
    assert {"prefix_hits", "prefix_reused"} <= set(recs[0])
    assert sum(r["prefix_hits"] for r in recs) == 1
    assert sum(r["prefix_reused"] for r in recs) == 12


TIER_KW = dict(slots=2, cache_len=32, prefill_chunk=4, prefill_budget=4,
               prefix_cache=True, prefix_block=4, kv_layout="paged",
               kv_block=4, kv_blocks=12, host_blocks=16)


def _serve_rounds(server, prompts, uid0=0):
    """Each prompt in its own run: the revisit order LRU likes least."""
    for i, p in enumerate(prompts):
        server.serve([ts.Request(uid=uid0 + i, prompt=p, max_new_tokens=5)])


def test_tier_metrics_and_flight_fields(params):
    server = ts.SlotServer(params[1], T_CFG, **TIER_KW)
    prompts = [_prompt(s) for s in range(4)]
    _serve_rounds(server, prompts)  # cold: publishes, demotes
    with registry_on() as reg, armed():
        dem0 = reg.counter("serving_kv_demotions_total").value()
        res0 = reg.counter("serving_kv_restores_total").value()
        _serve_rounds(server, prompts, uid0=30)
        assert reg.counter("serving_kv_demotions_total").value() > dem0
        assert reg.counter("serving_kv_restores_total").value() > res0
        used = reg.gauge("serving_kv_host_blocks_used").value()
        assert used == server._host_pool.used
    recs = FLIGHT.snapshot()["records"]
    FLIGHT.clear()
    assert {"host_blocks_used", "restored_blocks"} <= set(recs[0])
    assert max(r["restored_blocks"] for r in recs) > 0
    rep = server.serve([ts.Request(uid=99, prompt=prompts[0],
                                   max_new_tokens=5)])
    for key in ("host_blocks", "host_blocks_used", "demotions", "restores",
                "host_drops"):
        assert key in rep.kv, rep.kv


LOOP_PROMPT = np.tile(np.array([7, 9, 4], np.int32), 8)
ALT_PROMPT = np.tile(np.array([3, 5], np.int32), 8)


class _Oracle(Drafter):
    """Proposes each request's true continuation, its second token wrong
    every third call (so some drafts are rejected)."""

    def __init__(self, full):
        self.full, self.calls = full, 0

    def propose(self, history, k):
        self.calls += 1
        full = next(f for f in self.full
                    if np.array_equal(history, f[:len(history)]))
        cont = full[len(history):len(history) + k].copy()
        if len(cont) == 0:
            cont = np.full((max(k, 1),), 3, np.int32)
        if self.calls % 3 == 0 and len(cont) > 1:
            cont[1] = (cont[1] + 1) % CFG["vocab_size"]
        return DraftProposal(cont, np.arange(-1, len(cont) - 1,
                                             dtype=np.int32))


def test_spec_metrics_flight_and_report(params):
    def reqs():
        return [ts.Request(uid=u, prompt=p, max_new_tokens=12)
                for u, p in enumerate((LOOP_PROMPT, ALT_PROMPT))]

    plain = ts.SlotServer(params[1], T_CFG, slots=2, cache_len=64)
    ref = {r.uid: r.tokens for r in plain.serve(reqs()).results}
    d = _Oracle([np.concatenate([p, np.asarray(ref[u], np.int32)])
                 for u, p in enumerate((LOOP_PROMPT, ALT_PROMPT))])
    s = ts.SlotServer(params[1], T_CFG, slots=2, cache_len=64,
                      speculate=True, draft_k=5, drafter=d)
    with registry_on() as reg, armed():
        p0 = reg.get("serving_spec_proposed_total").value()
        a0 = reg.get("serving_spec_accepted_total").value()
        rep = s.serve(reqs())
        prop = reg.get("serving_spec_proposed_total").value() - p0
        acc = reg.get("serving_spec_accepted_total").value() - a0
        assert prop == rep.spec["proposed"] > 0
        assert acc == rep.spec["accepted"] > 0
        ratio = reg.get("serving_spec_acceptance_ratio").value()
        assert 0.0 < ratio <= 1.0
        assert 0.0 < rep.spec["acceptance_rate"] <= 1.0
        assert rep.spec["tokens_per_verify"] > 1.0
        assert rep.as_dict()["spec"] == rep.spec
        recs = FLIGHT.snapshot()["records"]
    FLIGHT.clear()
    spec_recs = [r for r in recs if "spec_verify" in r]
    assert spec_recs, "no spec_verify flight fields recorded"
    assert sum(r["spec_verify"]["proposed"] for r in spec_recs) == prop
    assert sum(r["spec_verify"]["accepted"] for r in spec_recs) == acc
    assert {r.uid: r.tokens for r in rep.results} == ref


# -- the disaggregated pair ------------------------------------------------------


@pytest.fixture(scope="module")
def pair(params):
    return ts.DisaggServer(params[1], T_CFG, prefill_slots=1, decode_slots=2,
                           cache_len=64, prefill_chunk=8, prefix_cache=True,
                           prefix_block=8)


def test_pair_flight_records_carry_robustness_counters(pair):
    reqs = [ts.Request(uid=20, prompt=LOOP_PROMPT[:16], max_new_tokens=4),
            ts.Request(uid=21, prompt=ALT_PROMPT, max_new_tokens=4,
                       deadline_s=time.monotonic() - 1.0)]  # already dead
    with armed():
        rep = pair.serve(reqs)
    recs = FLIGHT.snapshot()["records"]
    FLIGHT.clear()
    assert {r["worker"] for r in recs} == {"prefill", "decode"}
    # The prefill worker's record holds the pair's sweep stats.
    pre = [r for r in recs if r["worker"] == "prefill"]
    dec = [r for r in recs if r["worker"] == "decode"]
    # Each executed tick records both workers' dicts.
    assert [r["tick"] for r in dec] == [r["tick"] for r in pre] == \
        list(range(len(dec)))
    for key in ("cancelled", "deadline_expired", "shed"):
        assert all(key in r for r in pre), key
    assert sum(r["deadline_expired"] for r in pre) == 1
    assert sum(r["cancelled"] for r in pre) == 0
    assert sum(r["shed"] for r in pre) == 0
    # The first token of a request is sampled by the prefill worker (as
    # in the JAX pair): the decode records emit the rest.
    firsts = sum(1 for r in rep.results if r.tokens)
    assert sum(r["tokens_emitted"] for r in dec) + firsts == \
        rep.tokens_generated
    assert set(dec[0]) == {"worker", "tick", "t_s", "occupancy", "states",
                           "tokens_emitted", "handoff_queue",
                           "kv_blocks_used", "kv_blocks_free", "draining"}
    assert dec[-1]["kv_blocks_used"] == pair.pool.used
    assert pair.all_slots_free and drained(pair)


def test_pair_sweep_only_tick_still_records_flight_counters(pair):
    reqs = [ts.Request(uid=22, prompt=ALT_PROMPT, max_new_tokens=4,
                       deadline_s=time.monotonic() - 1.0)]
    with armed():
        pair.serve(reqs)
    recs = FLIGHT.snapshot()["records"]
    FLIGHT.clear()
    recs = [r for r in recs if r.get("worker") == "prefill"]
    swept = [r for r in recs if r.get("sweep_only")]
    assert len(swept) == 1 and swept[0]["deadline_expired"] == 1
    assert drained(pair)


# -- an error in the tick loop ----------------------------------------------------


class _Boom(RuntimeError):
    pass


def _raise_on_step(eng, n):
    """The engine's ``n``-th step raises."""
    step, calls = eng._step, [0]

    def boom(*a, **kw):
        calls[0] += 1
        if calls[0] == n:
            raise _Boom("planted")
        return step(*a, **kw)

    eng._step = boom


@pytest.mark.parametrize("kind", ["fused", "pair"])
def test_engine_error_dumps_the_ring_and_reraises(params, tmp_path, kind):
    if kind == "fused":
        eng = ts.SlotServer(params[1], T_CFG, slots=2, cache_len=32,
                            prefill_chunk=8)
        _raise_on_step(eng, 4)
    else:
        eng = ts.DisaggServer(params[1], T_CFG, prefill_slots=1,
                              decode_slots=1, cache_len=32, prefill_chunk=8)
        _raise_on_step(eng.decode, 3)
    path = tmp_path / "flight.json"
    reqs = [ts.Request(uid=u, prompt=_prompt(u, 12), max_new_tokens=8)
            for u in range(2)]
    with armed(path=str(path)):
        with pytest.raises(_Boom):
            eng.serve(reqs)
    FLIGHT.clear()
    data = json.loads(path.read_text())
    prefix = "engine_error:" if kind == "fused" else "disagg_error:"
    assert data["reason"] == prefix + "_Boom"
    # The last ticks before the raise, each in order.
    ticks = [r["tick"] for r in data["records"]
             if r.get("worker", "decode") == "decode"]
    assert len(ticks) >= 2 and ticks == list(range(len(ticks)))


# -- the CLI -----------------------------------------------------------------------


SMALL = ["--mode", "serve", "--device", "cpu", "--slots", "2",
         "--prompt-len", "16", "--prompt-jitter", "0", "--max-new-tokens",
         "4", "--model-dim", "32", "--heads", "2", "--n-layers", "1",
         "--vocab-size", "64", "--dtype", "float32", "--temperature", "0",
         "--log-level", "warning"]


@contextlib.contextmanager
def _own_signal_handlers():
    """The CLI installs the crash handlers into this process: put the
    previous ones back after."""
    prev = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGUSR1)}
    installed = obs._HANDLERS["installed"]
    try:
        yield
    finally:
        for s, h in prev.items():
            signal.signal(s, h)
        obs._HANDLERS["installed"] = installed


def test_cli_flight_out_records_every_tick(tmp_path):
    path = tmp_path / "flight.json"
    buf = io.StringIO()
    with _own_signal_handlers(), contextlib.redirect_stdout(buf):
        assert cli.main(SMALL + ["--requests", "3", "--flight-out",
                                 str(path), "--metrics-port", "0"]) == 0
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    data = json.loads(path.read_text())
    assert data["reason"] == "shutdown"
    assert len(data["records"]) == data["ticks_recorded"] == rec["ticks"]
    assert sum(r["tokens_emitted"] for r in data["records"]) == \
        rec["tokens_generated"] == 12
    # shutdown disarmed everything the run armed.
    assert not FLIGHT.enabled and not obs.REGISTRY.enabled
    assert cli._start_metrics_http(cli.parse_args(SMALL), 0) is None
    cfg = cli.parse_args(SMALL + ["--metrics-port", "0"])
    try:
        # Under a mesh only rank 0 binds the port; every rank records.
        assert cli._start_metrics_http(cfg, 1) is None
        assert FLIGHT.enabled and obs.REGISTRY.enabled
    finally:
        obs.shutdown()


def _dump_reason(path):
    """The dump's reason once the file is whole, else None."""
    try:
        return json.loads(path.read_text())["reason"]
    except (OSError, ValueError, KeyError):
        return None


def _wait_for(pred, timeout=60.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.02)
    return False


def test_cli_serve_http_sigusr1_dumps_and_sigterm_drains(tmp_path):
    flight = tmp_path / "flight.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "tree_attention_tpu_torch", *SMALL,
         "--log-level", "info", "--serve-http", "0", "--flight-out",
         str(flight), "--metrics-port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**{k: v for k, v in os.environ.items()
                if not k.startswith("TA_")}, "JAX_PLATFORMS": "cpu"})
    try:
        ports = {}
        for line in proc.stderr:
            if "telemetry endpoint: http://127.0.0.1:" in line:
                ports["obs"] = int(line.split("127.0.0.1:")[1].split("/")[0])
            if "serving HTTP on http://127.0.0.1:" in line:
                ports["http"] = int(line.split("127.0.0.1:")[1].split("/")[0])
                break
        assert set(ports) == {"obs", "http"}, "the CLI never logged a port"
        body = json.dumps({"prompt": [3, 1, 4, 1, 5], "max_tokens": 4,
                           "stream": False}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{ports['http']}/v1/completions",
                data=body), timeout=60) as r:
            assert json.loads(r.read())["choices"][0]["finish_reason"] == \
                "length"
        base = f"http://127.0.0.1:{ports['obs']}"
        with urllib.request.urlopen(base + "/slots", timeout=10) as r:
            assert len(json.loads(r.read())) == 2
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            assert "serving_tokens_total 4" in r.read().decode().splitlines()
        proc.send_signal(signal.SIGUSR1)
        assert _wait_for(lambda: _dump_reason(flight) == "flush")
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert r.status == 200  # still serving after the dump
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err
    rec = json.loads(out.strip().splitlines()[-1])
    data = json.loads(flight.read_text())
    assert data["reason"] == "shutdown"
    assert len(data["records"]) == rec["ticks"]
    assert sum(r["tokens_emitted"] for r in data["records"]) == 4
