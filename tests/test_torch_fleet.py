"""The port's in-process fleet against the JAX package's (CPU).

Counterparts of ``tests/test_serving_fleet.py``:

- **Decisions.** ``ReplicaTree`` and ``FleetRouter.choose``/``finish``
  driven directly (no HTTP) through the same scripts on JAX's router and
  the port's: every decision (replica, reason, predicted match), every
  tree answer and every ``stats()`` equal, and each script's own point
  asserted (affinity after a cold pick, round-robin ties, affinity off,
  hysteresis, the min-match floor, failover exclusion, drain / down /
  rejoin, TTL decay, feedback truncation, in-flight accounting), plus
  seeded random sequences of prompts, feedback, drains and downs.
- **Federation.** ``federate_metrics`` on the same sections: equal text.
- **The CLI.** ``--serve-fleet``'s flags and exclusions, and one
  ``--serve-fleet --replicas 2 --prefix-cache --metrics-port 0`` process
  on the CPU: a request through the router, the ledger at ``/requests``,
  SIGTERM drains the fleet to its record.
- **A live fleet.** One module-scoped fleet of 2 tiny replicas with the
  ledger armed: routed streams token-identical to JAX's direct greedy
  serve of the same requests, a repeat prefix routed to the replica that
  holds it and reported as a hit, the client's trace id kept through the
  router into the ledger, ``/requests`` federated once per uid with the
  replica that served it, and a rolling restart under traffic that drops
  nothing and leaves clean pools.
"""

from __future__ import annotations

import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tree_attention_tpu import models as jm
from tree_attention_tpu import serving as js
from tree_attention_tpu.serving import router as jrouter

from tree_attention_tpu_torch import cli
from tree_attention_tpu_torch import models as tm
from tree_attention_tpu_torch import obs
from tree_attention_tpu_torch import serving as ts
from tree_attention_tpu_torch.serving import router as trouter
from tree_attention_tpu_torch.utils.config import parse_args
from tests.torch_params import seeded_params
from tests.torch_threads import few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# -- decisions -----------------------------------------------------------------

PROMPT_A = list(range(16))  # 4 full blocks of 4


def _router(m, **kw):
    """A router used as a scoring object only (never started)."""
    kw.setdefault("block", 4)
    r = m.FleetRouter(**kw)
    for i in range(3):
        r.add_replica(f"r{i}", 1001 + i)
    return r


def _ok(r, name, prompt, reason, predicted, hit=None):
    r.finish(name, prompt, reason=reason, predicted=predicted,
             hit_tokens=predicted if hit is None else hit)


def tree_block_granular(m):
    t = m.ReplicaTree(block=4)
    t.insert(list(range(10)), now=1.0)
    out = [t.blocks, t.match(list(range(10))),
           t.match(list(range(4)) + [99] * 4), t.match([77] * 4),
           t.match(list(range(3)))]
    assert out == [2, 8, 4, 0, 0]
    return out


def tree_lru_cap(m):
    t = m.ReplicaTree(block=2, max_blocks=3)
    for i, p in enumerate(([1, 1, 2, 2], [3, 3], [4, 4])):
        t.insert(p, now=1.0 + i)
    out = [t.blocks, t.match([1, 1, 2, 2]), t.match([3, 3]), t.match([4, 4])]
    assert out == [3, 2, 2, 2]  # the LRU leaf went, its parent stayed
    return out


def tree_ttl_decay(m):
    t = m.ReplicaTree(block=2, ttl_s=10.0)
    t.insert([1, 1, 2, 2], now=0.0)
    t.insert([5, 5], now=8.0)
    out = [t.decay(now=11.0), t.match([1, 1, 2, 2]), t.match([5, 5]),
           t.blocks]
    assert out == [2, 0, 2, 1]
    return out


def tree_truncate_and_clear(m):
    t = m.ReplicaTree(block=2)
    t.insert([1, 1, 2, 2, 3, 3], now=1.0)
    t.truncate([1, 1, 2, 2, 3, 3], keep_tokens=2)
    out = [t.match([1, 1, 2, 2, 3, 3]), t.blocks]
    t.truncate([1, 1], keep_tokens=6)  # past the tracked length: no-op
    out.append(t.match([1, 1]))
    t.clear()
    out += [t.blocks, t.match([1, 1])]
    assert out == [2, 1, 2, 0, 0]
    return out


def cold_then_affinity(m):
    r = _router(m)
    n0, why0, m0 = r.choose(PROMPT_A, now=1.0)
    _ok(r, n0, PROMPT_A, why0, m0)
    n1, why1, m1 = r.choose(PROMPT_A, now=2.0)
    _ok(r, n1, PROMPT_A, why1, m1)
    assert (why0, m0) == (m.REASON_LEAST_LOADED, 0)
    assert (n1, why1, m1) == (n0, m.REASON_AFFINITY, 16)
    return [(n0, why0, m0), (n1, why1, m1), r.stats()]


def round_robin_ties(m):
    r = _router(m, affinity=False)
    picks = []
    for i in range(3):
        picks.append(r.choose([50 + i] * 8, now=float(i)))
        _ok(r, picks[-1][0], [50 + i] * 8, picks[-1][1], 0)
    assert sorted(p[0] for p in picks) == ["r0", "r1", "r2"]
    return [picks, r.stats()]


def affinity_off(m):
    r = _router(m, affinity=False)
    picks = [r.choose(PROMPT_A, now=1.0)]
    _ok(r, picks[0][0], PROMPT_A, m.REASON_LEAST_LOADED, 0)
    for i in range(3):
        picks.append(r.choose(PROMPT_A, now=2.0 + i))
        _ok(r, picks[-1][0], PROMPT_A, picks[-1][1], 0)
    assert all(p[1:] == (m.REASON_LEAST_LOADED, 0) for p in picks)
    assert len({p[0] for p in picks[1:]}) == 3  # scattered
    return [picks, r.stats()]


def hysteresis(m):
    r = _router(m, hysteresis=2)
    n0, _, _ = r.choose(PROMPT_A, now=1.0)
    _ok(r, n0, PROMPT_A, m.REASON_LEAST_LOADED, 0)
    held = [r.choose(PROMPT_A, now=2.0 + i) for i in range(3)]  # no finish
    n4 = r.choose(PROMPT_A, now=6.0)
    assert all(h[:2] == (n0, m.REASON_AFFINITY) for h in held)
    assert n4[0] != n0 and n4[1] == m.REASON_LEAST_LOADED
    return [n0, held, n4, r.stats()]


def min_match_floor(m):
    r = _router(m, min_match=8)
    p0, p1 = PROMPT_A[:4] + [7] * 4, PROMPT_A[:4] + [8] * 4
    n0 = r.choose(p0, now=1.0)
    _ok(r, n0[0], p0, m.REASON_LEAST_LOADED, 0)
    n1 = r.choose(p1, now=2.0)  # one block matches: below the floor
    _ok(r, n1[0], p1, n1[1], 0)
    assert n1[1:] == (m.REASON_LEAST_LOADED, 0)
    return [n0, n1, r.stats()]


def failover_exclusion(m):
    r = _router(m)
    n0 = r.choose(PROMPT_A, now=1.0)
    _ok(r, n0[0], PROMPT_A, m.REASON_LEAST_LOADED, 0)
    n1 = r.choose(PROMPT_A, exclude={n0[0]}, now=2.0)
    _ok(r, n1[0], PROMPT_A, n1[1], 0)
    assert n1[0] != n0[0] and n1[1] == m.REASON_FAILOVER
    return [n0, n1, r.stats()]


def drain_down_rejoin(m):
    r = _router(m)
    log = [r.choose(PROMPT_A, now=1.0)]
    n0 = log[0][0]
    _ok(r, n0, PROMPT_A, m.REASON_LEAST_LOADED, 0)
    r.set_draining(n0)
    log.append(r.choose(PROMPT_A, now=2.0))
    n1 = log[1][0]
    _ok(r, n1, PROMPT_A, log[1][1], 0)
    r.mark_down(n1)
    log.append(r.choose(PROMPT_A, now=3.0))
    n2 = log[2][0]
    _ok(r, n2, PROMPT_A, m.REASON_LEAST_LOADED, 0)
    log.append(r.stats())
    r.rejoin(n0)
    log.append(r.stats())
    log.append(r.choose(PROMPT_A, exclude={n0, n1, n2}, now=4.0))
    assert n1 != n0 and n2 not in (n0, n1)
    assert log[4]["replicas"][n0]["tree_blocks"] == 0
    assert log[5][0] is None
    return log


def ttl_decay_in_choose(m):
    r = _router(m, tree_ttl_s=10.0)
    n0 = r.choose(PROMPT_A, now=1.0)
    _ok(r, n0[0], PROMPT_A, m.REASON_LEAST_LOADED, 0)
    n1 = r.choose(PROMPT_A, now=5.0)
    _ok(r, n1[0], PROMPT_A, n1[1], 16)
    n2 = r.choose(PROMPT_A, now=60.0)
    _ok(r, n2[0], PROMPT_A, n2[1], 0)
    assert n1[:2] == (n0[0], m.REASON_AFFINITY)
    assert n2[1:] == (m.REASON_LEAST_LOADED, 0)
    return [n0, n1, n2, r.stats()]


def feedback_truncates(m):
    r = _router(m)
    n0 = r.choose(PROMPT_A, now=1.0)
    _ok(r, n0[0], PROMPT_A, m.REASON_LEAST_LOADED, 0)
    n1 = r.choose(PROMPT_A, now=2.0)
    r.finish(n0[0], PROMPT_A, reason=m.REASON_AFFINITY, predicted=16,
             hit_tokens=4)  # the replica evicted all but one block
    n2 = r.choose(PROMPT_A, now=3.0)
    _ok(r, n0[0], PROMPT_A, m.REASON_AFFINITY, n2[2])
    assert n1[2] == 16 and n2[2] == 4
    return [n0, n1, n2, r.stats()]


def inflight_accounting(m):
    r = _router(m)
    n0 = r.choose(PROMPT_A, now=1.0)
    s0 = r.stats()
    _ok(r, n0[0], PROMPT_A, n0[1], n0[2])
    s1 = r.stats()
    assert s0["replicas"][n0[0]]["inflight"] == 1
    assert s1["replicas"][n0[0]]["inflight"] == 0
    assert s1["routed"][m.REASON_LEAST_LOADED] == 1
    return [n0, s0, s1]


def _random_ops(seed):
    """A seeded script: prompts from 4 shared heads with random tails,
    some held in flight, finishes with full, partial or no hits, drains,
    downs and rejoins."""

    def run(m):
        rng = np.random.default_rng(seed)
        r = _router(m, hysteresis=int(rng.integers(0, 3)),
                    max_tree_blocks=12, tree_ttl_s=40.0)
        heads = [rng.integers(0, 50, 8).tolist() for _ in range(4)]
        held, log = [], []
        for step in range(60):
            now = float(step)
            op = rng.random()
            if op < 0.6 or not held:
                prompt = heads[int(rng.integers(0, 4))] + rng.integers(
                    0, 50, int(rng.integers(0, 9))).tolist()
                ex = ({f"r{int(rng.integers(0, 3))}"} if rng.random() < 0.15
                      else set())
                pick = r.choose(prompt, exclude=ex, now=now)
                log.append(("choose", pick))
                if pick[0] is not None:
                    held.append((pick, prompt))
            elif op < 0.85:
                (name, why, pred), prompt = held.pop(
                    int(rng.integers(0, len(held))))
                hit = int(rng.choice([pred, pred // 2, 0]))
                r.finish(name, prompt, reason=why, predicted=pred,
                         hit_tokens=hit)
                log.append(("finish", name, hit))
            else:
                name = f"r{int(rng.integers(0, 3))}"
                what = ("set_draining", "mark_down", "rejoin")[
                    int(rng.integers(0, 3))]
                getattr(r, what)(name)
                log.append((what, name))
            log.append(r.stats())
        return log

    run.__name__ = f"random_{seed}"
    return run


SCRIPTS = [tree_block_granular, tree_lru_cap, tree_ttl_decay,
           tree_truncate_and_clear, cold_then_affinity, round_robin_ties,
           affinity_off, hysteresis, min_match_floor, failover_exclusion,
           drain_down_rejoin, ttl_decay_in_choose, feedback_truncates,
           inflight_accounting] + [_random_ops(s) for s in (3, 11, 29)]


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda f: f.__name__)
def test_router_decisions_match_jax(script):
    assert script(trouter) == script(jrouter)


# -- federation ------------------------------------------------------------------

SECTIONS = [
    {},
    {"r0": "# HELP x_total help\n# TYPE x_total counter\n"
           'x_total{a="b"} 1\nplain 2\n',
     "r1": '# HELP x_total help\nx_total{a="b"} 3\n'},
    {"r0": "<html>\nx_total 1\ngarbage-no-space\n",
     "r1": "\n\n# TYPE y gauge\ny 4.5\n"},
]


@pytest.mark.parametrize("sections", SECTIONS,
                         ids=["empty", "labels", "malformed"])
def test_federate_metrics_matches_jax(sections):
    got = trouter.federate_metrics(sections)
    assert got == jrouter.federate_metrics(sections)
    if sections:
        assert all("replica=" in ln for ln in got.splitlines()
                   if not ln.startswith("#"))


# -- the CLI -----------------------------------------------------------------------

def test_fleet_flags_parse_and_default():
    cfg = parse_args(["--mode", "serve", "--serve-fleet", "--replicas", "4",
                      "--router-port", "8123", "--affinity", "off"])
    assert (cfg.serve_fleet, cfg.replicas, cfg.router_port,
            cfg.affinity) == (True, 4, 8123, "off")
    d = parse_args(["--mode", "serve"])
    assert (d.serve_fleet, d.replicas, d.affinity) == (False, 2, "on")
    assert d.device == "cuda"  # the fleet serves on the GPU by default


@pytest.mark.parametrize("args,match", [
    (["--serve-http", "0"], "exclusive"),
    (["--replicas", "0"], "--replicas"),
    (["--serve-disagg"], "exclusive"),
])
def test_fleet_exclusions(args, match):
    cfg = parse_args(["--mode", "serve", "--device", "cpu", "--serve-fleet",
                      *args])
    with pytest.raises(SystemExit, match=match):
        cli.build_server(cfg, torch.device("cpu"))
    with pytest.raises(SystemExit, match="one device"):
        cli.check_fleet(parse_args(["--mode", "serve", "--serve-fleet"]),
                        mesh=object())


SMALL = ["--mode", "serve", "--device", "cpu", "--slots", "2",
         "--prompt-len", "16", "--prompt-jitter", "0", "--max-new-tokens",
         "4", "--model-dim", "32", "--heads", "2", "--n-layers", "1",
         "--vocab-size", "64", "--dtype", "float32", "--temperature", "0"]


def test_cli_serve_fleet_routes_and_drains():
    proc = subprocess.Popen(
        [sys.executable, "-m", "tree_attention_tpu_torch", *SMALL,
         "--log-level", "info", "--serve-fleet", "--replicas", "2",
         "--prefix-cache", "--prefix-block", "8", "--metrics-port", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**{k: v for k, v in os.environ.items()
                if not k.startswith("TA_")}, "OMP_NUM_THREADS": "1"})
    try:
        ports = {}
        for line in proc.stderr:
            if "telemetry endpoint: http://127.0.0.1:" in line:
                ports["obs"] = int(line.split("127.0.0.1:")[1].split("/")[0])
            if "serving fleet on http://127.0.0.1:" in line:
                ports["router"] = int(
                    line.split("127.0.0.1:")[1].split("/")[0])
                break
        assert set(ports) == {"obs", "router"}, "no port was logged"
        prompt = list(range(1, 13))  # one full block of 8, then a tail
        for _ in range(2):
            res = _post(ports["router"], {"prompt": prompt, "max_tokens": 4,
                                          "stream": False})
            assert res["status"] == 200 and len(res["tokens"]) == 4
        assert res["usage"]["prefix_hit_tokens"] == 8  # affinity, a hit
        snap = _get_json(ports["router"], "/requests")
        uids = [e["uid"] for e in snap["live"] + snap["recent"]]
        assert len(uids) == len(set(uids)) == 2
        assert {e["replica"] for e in snap["recent"]} <= {"r0", "r1"}
        assert _get_json(ports["obs"], "/requests")["enabled"]
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err
    rec = json.loads(out.strip().splitlines()[-1])
    fleet = rec["fleet"]
    assert rec["device"] == "cpu" and fleet["replicas"] == 2
    assert sum(fleet["router"]["routed"].values()) == 2
    assert fleet["router"]["routed"]["affinity"] == 1
    assert all(lk["blocks_private"] == 0 and lk["blocks_reserved"] == 0
               for lk in fleet["leaks"].values())


# -- a live fleet ---------------------------------------------------------------------

CFG = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_head=16, d_ff=128, max_seq_len=64)
J_CFG = jm.TransformerConfig(**CFG, dtype=jnp.float32)
T_CFG = tm.TransformerConfig(**CFG, dtype=torch.float32)
BLOCK = 8
ENGINE = dict(slots=2, cache_len=64, prefill_chunk=BLOCK, prefix_cache=True,
              prefix_block=BLOCK, kv_block=BLOCK, kv_blocks=2 * 8 + 16)
TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"


def _prompts(seed, n, heads=3):
    """``n`` prompts over ``heads`` shared 2-block heads, distinct tails."""
    rng = np.random.default_rng(seed)
    hs = [rng.integers(0, 128, 2 * BLOCK).tolist() for _ in range(heads)]
    return [hs[i % heads] + rng.integers(0, 128, 3 + i % 4).tolist()
            for i in range(n)]


def _post(port, body, headers=None, timeout=60.0):
    """One completion; returns its status, tokens, finish reason and
    usage (SSE or whole body)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/v1/completions", json.dumps(body),
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        if not body.get("stream", True):
            d = json.loads(resp.read())
            ch = (d.get("choices") or [{}])[0]
            return {"status": resp.status, "tokens": ch.get("token_ids"),
                    "finish_reason": ch.get("finish_reason"),
                    "usage": d.get("usage"), "id": d.get("id")}
        out = {"status": resp.status, "tokens": [], "finish_reason": None,
               "usage": None, "id": None}
        for line in resp:
            line = line.strip()
            if not line.startswith(b"data: ") or line[6:] == b"[DONE]":
                continue
            d = json.loads(line[6:])
            ch = (d.get("choices") or [{}])[0]
            out["tokens"] += ch.get("token_ids") or []
            if ch.get("finish_reason") is not None:
                out.update(finish_reason=ch["finish_reason"],
                           usage=d.get("usage"), id=d.get("id"))
        return out
    finally:
        conn.close()


def _get_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return json.loads(r.read())


def _settle(router):
    """The router's in-flight counts drop on its handler threads a beat
    after the client reads ``[DONE]``."""
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and any(
            v["inflight"] for v in router.stats()["replicas"].values()):
        time.sleep(0.01)


@pytest.fixture(scope="module")
def fleet():
    jp, tp = seeded_params(T_CFG)
    prompts = _prompts(5, 6)
    jrep = js.SlotServer(jp, J_CFG, **ENGINE).serve(
        [js.Request(uid=i, prompt=np.asarray(p, np.int32), max_new_tokens=5)
         for i, p in enumerate(prompts)], max_ticks=400)
    refs = {r.uid: [int(t) for t in r.tokens] for r in jrep.results}
    reps = [ts.LocalReplica(f"r{i}", lambda: ts.SlotServer(tp, T_CFG,
                                                           **ENGINE),
                            default_max_tokens=5, keepalive_s=0.05)
            for i in range(2)]
    router = ts.FleetRouter(block=BLOCK, affinity=True, hysteresis=2)
    sup = ts.FleetSupervisor(reps, router=router, monitor_interval_s=0)
    obs.REQLOG.arm()
    port = sup.start()
    try:
        yield {"sup": sup, "router": router, "port": port,
               "prompts": prompts, "refs": refs}
    finally:
        sup.stop()
        obs.REQLOG.disarm()


def test_routed_streams_equal_jax_direct_and_ride_affinity(fleet):
    port, router = fleet["port"], fleet["router"]
    got, served = [], {}
    for i, p in enumerate(fleet["prompts"]):
        r = _post(port, {"prompt": p, "max_tokens": 5, "stream": i % 2 == 0})
        _settle(router)
        assert r["status"] == 200 and r["finish_reason"] == "length", r
        got.append(r)
    assert {i: r["tokens"] for i, r in enumerate(got)} == fleet["refs"]
    snap = _get_json(port, "/requests")
    ledgers = {e["uid"]: e for e in snap["recent"]}
    for i, r in enumerate(got):
        uid = int(r["id"].split("-")[1])
        lg = ledgers[uid]
        served[i] = lg["replica"]
        assert r["usage"]["ledger"]["uid"] == uid
        assert lg["prompt_tokens"] == \
            lg["prefix_hit_tokens"] + lg["tokens_prefilled"]
        assert lg["tokens_decoded"] == 5
        # Each head's repeats (i >= 3) ride affinity to its first's
        # replica and hit both of its blocks there.
        if i >= 3:
            assert served[i] == served[i - 3]
            assert r["usage"]["prefix_hit_tokens"] == 2 * BLOCK
        else:
            assert r["usage"]["prefix_hit_tokens"] == 0
    assert router.stats()["routed"]["affinity"] >= 3
    assert set(served.values()) == {"r0", "r1"}


def test_trace_id_reaches_the_ledger(fleet):
    parent = "00f067aa0ba902b7"
    r = _post(fleet["port"], {"prompt": fleet["prompts"][0], "max_tokens": 3,
                              "stream": False},
              headers={"traceparent": f"00-{TRACE_ID}-{parent}-01"})
    _settle(fleet["router"])
    uid = int(r["id"].split("-")[1])
    lg = r["usage"]["ledger"]
    assert lg["trace_id"] == TRACE_ID
    # The router forwards its own routing span as the replica's parent.
    assert lg["parent_span_id"] not in ("", parent)
    entries = [e for s in ("live", "recent")
               for e in _get_json(fleet["port"], "/requests")[s]
               if e["uid"] == uid]
    assert len(entries) == 1 and entries[0]["trace_id"] == TRACE_ID
    assert entries[0]["replica"] in ("r0", "r1")


def test_requests_federated_once_per_uid(fleet):
    snap = _get_json(fleet["port"], "/requests")
    uids = [e["uid"] for e in snap["live"] + snap["recent"]]
    assert len(uids) == len(set(uids)) >= 7
    assert all(e["replica"] in ("r0", "r1") for e in snap["recent"])
    assert obs.REQLOG.get(uids[0])["uid"] == uids[0]


def test_rolling_restart_under_traffic_drops_nothing(fleet):
    sup, router, port = fleet["sup"], fleet["router"], fleet["port"]
    prompts = _prompts(9, 8)
    res, roll = [None] * len(prompts), {}

    def client(i):
        time.sleep(0.02 * i)
        res[i] = _post(port, {"prompt": prompts[i], "max_tokens": 4,
                              "stream": i % 2 == 0})

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    time.sleep(0.05)
    roll.update(sup.rolling_restart())
    for t in threads:
        t.join(60)
    _settle(router)
    assert sorted(roll) == ["r0", "r1"] and all(
        v["drained"] for v in roll.values())
    assert all(r["status"] == 200 and r["finish_reason"] == "length"
               for r in res), res
    for info in roll.values():
        lk = info["leak"]
        assert lk["blocks_private"] == lk["blocks_reserved"] == 0, lk
    st = router.stats()
    assert st["dropped"] == 0
    assert [v["state"] for v in st["replicas"].values()] == ["up", "up"]
    assert all(lk["blocks_private"] == 0
               for lk in sup.leak_reports().values())
