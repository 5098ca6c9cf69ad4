"""The port's live serving against the JAX package's (CPU).

Counterparts of ``tests/test_serving_ingress.py``, at its tiny model (f32,
greedy: tokens exact):

- **Engine layer.** One scripted source (arrivals, cancels and a drain by
  tick; cancels and deadlines fired from ``on_token`` on the engine thread,
  the reentrancy a disconnect produces) goes through JAX's ``SlotServer``
  and the port's. Each uid's outcome and tokens are equal: cancel
  mid-prefill, mid-decode, mid-int8-staging and under speculation; a
  deadline in the queue, in flight and on the EOS tick; drain sheds the
  queue; an invalid live request finishes with ``error``; a cancel of an
  unknown uid is a no-op. Both engines end every case leak-free. A random
  cancel/admit walk on the port alone drains clean.
- **HTTP layer.** One loopback :class:`IngressServer` over the port's
  engine: SSE and whole bodies agree and equal JAX's tokens; bad bodies
  (the fork fields among them) get 400; a disconnect cancels and frees; a
  deadline is shed over the wire; 429 with ``Retry-After``;
  ``/ingress/stats``; a traceparent rides the request into the trace; the
  drain lifecycle (202, 503, ``join()``).
- **Tracing and the CLI.** ``parse_traceparent``/``make_traceparent``
  against JAX's; the span file loads as JSON lines; ``--serve-http`` on
  the CPU answers an SSE completion and drains on SIGTERM with exit 0; a
  crashed engine thread exits 1; the flags' checks.

One engine per flag shape on each side, module-cached: each JAX engine pays
its own jit compiles.
"""

from __future__ import annotations

import http.client
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tree_attention_tpu import models as jm
from tree_attention_tpu import serving as js
from tree_attention_tpu.obs import tracing as jtracing

from tree_attention_tpu_torch import cli
from tree_attention_tpu_torch import models as tm
from tree_attention_tpu_torch import obs
from tree_attention_tpu_torch import serving as ts
from tree_attention_tpu_torch.serving import ingress as ting
from tests.torch_params import seeded_params
from tests.torch_threads import few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_serving_ingress.py's model: serving_model_config(d_model=64,
# vocab_size=128, max_seq_len=64), f32.
CFG = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
           d_head=16, d_ff=256, max_seq_len=64)
J_CFG = jm.TransformerConfig(**CFG, dtype=jnp.float32)
T_CFG = tm.TransformerConfig(**CFG, dtype=torch.float32)
ENGINE = dict(slots=2, cache_len=64, prefill_chunk=8)
PREFIX = dict(prefix_cache=True, prefix_block=16)

rng = np.random.default_rng(11)
SHORT_PROMPT = rng.integers(0, 128, size=8).astype(np.int32)
LONG_PROMPT = rng.integers(0, 128, size=40).astype(np.int32)
LOOP_PROMPT = np.tile(np.array([7, 9, 4], np.int32), 8)  # spec-friendly

# One engine per flag shape and side: exact with the prefix cache, and int8
# with speculation (its staged admission and its verify ticks both).
SHAPES = {
    "base": PREFIX,
    "int8-spec": {"quantize": True, "speculate": True, "draft_k": 4},
}


@pytest.fixture(scope="module")
def params():
    return seeded_params(T_CFG)


_ENGINES = {}


def engine(params, side, shape):
    """Memoized engines per (side, flag shape)."""
    key = (side, shape)
    if key not in _ENGINES:
        jp, tp = params
        _ENGINES[key] = (
            js.SlotServer(jp, J_CFG, **ENGINE, **SHAPES[shape])
            if side == "jax" else
            ts.SlotServer(tp, T_CFG, **ENGINE, **SHAPES[shape]))
    return _ENGINES[key]


_REFS = {}


def ref_tokens(params, prompt, n_new):
    """JAX's greedy stream of one request, alone on the base engine."""
    key = (tuple(int(t) for t in prompt), n_new)
    if key not in _REFS:
        rep = engine(params, "jax", "base").serve(
            [js.Request(uid=900, prompt=np.asarray(prompt, np.int32),
                        max_new_tokens=n_new)])
        _REFS[key] = list(map(int, rep.results[0].tokens))
    return _REFS[key]


def leak_free(eng):
    lr = eng.leak_report()
    return (lr["blocks_private"] == 0 and lr["blocks_reserved"] == 0
            and lr["pins"] == 0 and lr["blocks_used"] == lr["blocks_cached"])


class _Scripted:
    """Deterministic single-threaded source: arrivals by tick, and cancels
    and a drain applied at their tick through the engine's mailboxes (what
    an ingress handler thread does, minus the thread)."""

    def __init__(self, eng, arrivals, cancels=None, drain_at=None):
        self.eng = eng
        self._arr = sorted(arrivals, key=lambda r: (r.arrival_tick, r.uid))
        self._pos = 0
        self._cancels = dict(cancels or {})  # tick -> [uids]
        self._drain_at = drain_at

    def poll(self, tick):
        for t in sorted(k for k in self._cancels if k <= tick):
            for uid in self._cancels.pop(t):
                self.eng.cancel(uid)
        if self._drain_at is not None and tick >= self._drain_at:
            self._drain_at = None
            self.eng.request_drain()
        out = []
        while (self._pos < len(self._arr)
               and self._arr[self._pos].arrival_tick <= tick):
            out.append(self._arr[self._pos])
            self._pos += 1
        return out

    def next_arrival(self):
        ticks = list(self._cancels)
        if self._pos < len(self._arr):
            ticks.append(self._arr[self._pos].arrival_tick)
        if self._drain_at is not None:
            ticks.append(self._drain_at)
        return min(ticks) if ticks else None

    @property
    def exhausted(self):
        return (self._pos >= len(self._arr) and not self._cancels
                and self._drain_at is None)


class JScripted(_Scripted, js.RequestSource):
    pass


class TScripted(_Scripted, ts.RequestSource):
    pass


# -- the scripted cases: (engine shape, script(mod, eng) -> source) --------


def _cancel_mid_prefill(mod, eng, src):
    a = mod.Request(uid=0, prompt=LONG_PROMPT, max_new_tokens=8)
    b = mod.Request(uid=1, prompt=SHORT_PROMPT, max_new_tokens=6,
                    on_token=lambda t: eng.cancel(0))  # A still prefills
    return src(eng, [a, b])


def _cancel_mid_decode(mod, eng, src):
    streamed = []

    def on_tok(t):
        streamed.append(t)
        if len(streamed) == 3:
            eng.cancel(5)

    return src(eng, [mod.Request(uid=5, prompt=SHORT_PROMPT,
                                 max_new_tokens=24, on_token=on_tok)])


def _cancel_mid_staging(mod, eng, src):
    # Tick 2: A is mid-staging (5 chunks of 8), B queued behind the staging
    # latch; the cancel must free both.
    a = mod.Request(uid=0, prompt=LONG_PROMPT, max_new_tokens=4)
    b = mod.Request(uid=1, prompt=SHORT_PROMPT, max_new_tokens=4)
    return src(eng, [a, b], cancels={2: [0]})


def _cancel_under_spec(mod, eng, src):
    streamed = []

    def on_tok(t):
        streamed.append(t)
        if len(streamed) == 6:  # inside a verify tick's commit walk
            eng.cancel(3)

    return src(eng, [mod.Request(uid=3, prompt=LOOP_PROMPT,
                                 max_new_tokens=24, on_token=on_tok)])


def _deadline_in_queue(mod, eng, src):
    # A and A2 hold both slots: B queues, and A's second token expires it.
    b = mod.Request(uid=2, prompt=SHORT_PROMPT, max_new_tokens=4)
    seen = []

    def on_tok(t):
        seen.append(t)
        if len(seen) == 2:
            b.deadline_s = 0.0

    a = mod.Request(uid=0, prompt=SHORT_PROMPT, max_new_tokens=20,
                    on_token=on_tok)
    a2 = mod.Request(uid=1, prompt=LONG_PROMPT[:12], max_new_tokens=20)
    return src(eng, [a, a2, b])


def _deadline_in_flight(mod, eng, src):
    req = mod.Request(uid=7, prompt=SHORT_PROMPT, max_new_tokens=50)
    seen = []

    def on_tok(t):
        if len(seen) >= 3:
            req.deadline_s = 0.0  # the next sweep sees it
        seen.append(t)

    req.on_token = on_tok
    return src(eng, [req])


def _eos_at(params, k):
    ref = ref_tokens(params, SHORT_PROMPT, 12)
    return int(ref[k])


def _deadline_on_eos_tick(params):
    def script(mod, eng, src):
        eos = _eos_at(params, 4)
        req = mod.Request(uid=8, prompt=SHORT_PROMPT, max_new_tokens=12,
                          eos_id=eos)

        def on_tok(t):
            if t == eos:
                req.deadline_s = 0.0  # expires on the EOS tick itself

        req.on_token = on_tok
        return src(eng, [req])
    return script


def _deadline_before_eos(params):
    def script(mod, eng, src):
        eos = _eos_at(params, 6)
        k = ref_tokens(params, SHORT_PROMPT, 12).index(eos)
        req = mod.Request(uid=9, prompt=SHORT_PROMPT, max_new_tokens=12,
                          eos_id=eos)
        seen = []

        def on_tok(t):
            seen.append(t)
            if len(seen) == k:  # the tick before EOS would be sampled
                req.deadline_s = 0.0

        req.on_token = on_tok
        return src(eng, [req])
    return script


def _drain(mod, eng, src):
    # A and A2 hold both slots; B is still queued when the drain lands.
    a = mod.Request(uid=0, prompt=SHORT_PROMPT, max_new_tokens=10)
    a2 = mod.Request(uid=1, prompt=LONG_PROMPT[:12], max_new_tokens=10)
    b = mod.Request(uid=2, prompt=SHORT_PROMPT, max_new_tokens=4)
    return src(eng, [a, a2, b], drain_at=3)


def _invalid(mod, eng, src):
    bad = mod.Request(uid=0, prompt=SHORT_PROMPT, max_new_tokens=1000)
    good = mod.Request(uid=1, prompt=SHORT_PROMPT, max_new_tokens=4)
    return src(eng, [bad, good])


def _unknown_cancel(mod, eng, src):
    return src(eng, [mod.Request(uid=0, prompt=SHORT_PROMPT,
                                 max_new_tokens=4)], cancels={0: [424242]})


CASES = {
    "cancel-mid-prefill": ("base", _cancel_mid_prefill,
                           {0: "cancelled", 1: "budget"}),
    "cancel-mid-decode": ("base", _cancel_mid_decode, {5: "cancelled"}),
    "cancel-mid-int8-staging": ("int8-spec", _cancel_mid_staging,
                                {0: "cancelled", 1: "budget"}),
    "cancel-under-speculation": ("int8-spec", _cancel_under_spec,
                                 {3: "cancelled"}),
    "deadline-in-queue": ("base", _deadline_in_queue,
                          {0: "budget", 1: "budget", 2: "deadline"}),
    "deadline-in-flight": ("base", _deadline_in_flight, {7: "deadline"}),
    "deadline-on-eos-tick": ("base", _deadline_on_eos_tick, {8: "eos"}),
    "deadline-before-eos": ("base", _deadline_before_eos, {9: "deadline"}),
    "drain-sheds-queue": ("base", _drain,
                          {0: "budget", 1: "budget", 2: "shed"}),
    "invalid-live-request": ("base", _invalid, {0: "error", 1: "budget"}),
    "cancel-unknown-uid": ("base", _unknown_cancel, {0: "budget"}),
}


def _outcomes(rep):
    return {r.uid: (r.outcome, list(map(int, r.tokens)), r.admit_tick == -1)
            for r in rep.results}


@pytest.mark.parametrize("case", list(CASES))
def test_scripted_case_matches_jax_and_ends_leak_free(params, case):
    shape, script, want = CASES[case]
    if script in (_deadline_on_eos_tick, _deadline_before_eos):
        script = script(params)
    out = {}
    for side, mod, src in (("jax", js, JScripted), ("port", ts, TScripted)):
        eng = engine(params, side, shape)
        out[side] = _outcomes(eng.serve(script(mod, eng, src),
                                        max_ticks=2000))
        assert leak_free(eng), (side, eng.leak_report())
    assert out["port"] == out["jax"]
    assert {u: o for u, (o, _, _) in out["port"].items()} == want
    if case == "cancel-mid-decode":
        assert 3 <= len(out["port"][5][1]) < 24
    if case == "cancel-under-speculation":
        # The partial burst stands and is the head of the uncancelled
        # stream.
        toks = out["port"][3][1]
        assert 6 <= len(toks) < 24
        eng = engine(params, "port", "int8-spec")
        full = eng.serve([ts.Request(uid=4, prompt=LOOP_PROMPT,
                                     max_new_tokens=24)])
        assert toks == list(full.results[0].tokens)[:len(toks)]
    if case in ("deadline-in-queue", "drain-sheds-queue"):
        assert out["port"][2][2]  # never admitted
    if case == "drain-sheds-queue":
        assert len(out["port"][0][1]) == 10  # finished, not truncated
    if case == "cancel-mid-int8-staging":
        # The next admission overwrites the cancelled prompt's staged rows.
        eng = engine(params, "port", "int8-spec")
        again = eng.serve([ts.Request(uid=2, prompt=SHORT_PROMPT,
                                      max_new_tokens=4)])
        assert list(again.results[0].tokens) == out["port"][1][1]
        assert leak_free(eng)


def test_static_trace_raises_and_resets_stale_mailboxes(params):
    """A static trace still validates up front, and a stale cancel or drain
    from a previous run never touches a fresh trace (uids recycle)."""
    eng = engine(params, "port", "base")
    with pytest.raises(ValueError):
        eng.serve([ts.Request(uid=0, prompt=SHORT_PROMPT,
                              max_new_tokens=1000)])
    eng.cancel(0)
    eng.request_drain()
    rep = eng.serve([ts.Request(uid=0, prompt=SHORT_PROMPT,
                                max_new_tokens=4)])
    assert rep.outcomes == {"budget": 1}
    assert not eng.draining
    snap = eng.slots_snapshot()
    assert [s["state"] for s in snap] == ["free", "free"]
    assert set(snap[0]) == {"slot", "state", "uid", "tokens", "clen",
                            "nblocks"}


def test_raising_callbacks_are_dropped_and_misses_counted(params):
    """A callback that raises is logged and dropped (the request keeps
    running); deadline misses count against goodput, cancels do not."""
    eng = engine(params, "port", "base")

    def boom(*_):
        raise RuntimeError("client bug")

    retired0 = eng.slo.snapshot()["requests_retired"]
    good0 = eng.slo.goodput()
    rep = eng.serve(TScripted(eng, [
        ts.Request(uid=0, prompt=SHORT_PROMPT, max_new_tokens=4,
                   on_token=boom, on_finish=boom),
        ts.Request(uid=1, prompt=SHORT_PROMPT, max_new_tokens=4,
                   deadline_s=0.0),
    ]))
    assert {r.uid: r.outcome for r in rep.results} == {0: "budget",
                                                       1: "deadline"}
    assert rep.results[0].tokens == ref_tokens(params, SHORT_PROMPT, 4)
    assert eng.slo.snapshot()["requests_retired"] == retired0 + 2
    assert eng.slo.goodput() < good0 or good0 < 1.0


def test_random_cancel_admit_walk_drains_clean(params):
    """Random scripted admissions (some sharing radix prefixes), cancels
    aimed at queued, live, finished and unknown uids, and scattered
    deadlines: every request gets one result and the engine holds no slot
    block, reservation or pin afterwards."""
    eng = engine(params, "port", "base")
    prng = np.random.default_rng(1234)
    prefixes = [prng.integers(0, 128, size=16).astype(np.int32)
                for _ in range(3)]
    arrivals, cancels = [], {}
    uid = tick = 0
    for _ in range(80):
        tick += int(prng.integers(0, 3))
        if prng.random() < 0.55 or uid == 0:
            suffix = prng.integers(0, 128, size=int(prng.integers(2, 9))
                                   ).astype(np.int32)
            prompt = (np.concatenate([prefixes[int(prng.integers(0, 3))],
                                      suffix])
                      if prng.random() < 0.7 else suffix)
            arrivals.append(ts.Request(
                uid=uid, prompt=prompt,
                max_new_tokens=int(prng.integers(2, 7)), arrival_tick=tick,
                deadline_s=(time.monotonic() + float(prng.uniform(0.2, 30))
                            if prng.random() < 0.2 else None)))
            uid += 1
        else:
            cancels.setdefault(tick, []).append(int(prng.integers(0,
                                                                  uid + 3)))
    rep = eng.serve(TScripted(eng, arrivals, cancels=cancels),
                    max_ticks=20_000)
    assert sorted(r.uid for r in rep.results) == list(range(uid))
    assert leak_free(eng), eng.leak_report()
    assert set(rep.outcomes) <= {"budget", "cancelled", "deadline"}
    assert rep.outcomes.get("cancelled", 0) > 0


# -- HTTP layer: one loopback server over the port's engine ----------------


@pytest.fixture(scope="module")
def live(params):
    eng = ts.SlotServer(params[1], T_CFG, **ENGINE, **PREFIX)
    srv = ts.IngressServer(eng, max_queue=8, default_max_tokens=6,
                           keepalive_s=0.05)
    srv.start()
    yield srv
    if srv.running:
        srv.stop()


def _post(port, body, headers=None, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/v1/completions", json.dumps(body),
                 {"Content-Type": "application/json", **(headers or {})})
    return conn, conn.getresponse()


def _read_sse(resp):
    tokens, finish, uid = [], None, None
    while True:
        line = resp.readline()
        if not line:
            break
        line = line.strip()
        if not line.startswith(b"data: "):
            continue
        if line[6:] == b"[DONE]":
            break
        ev = json.loads(line[6:])
        uid = ev["id"]
        ch = ev["choices"][0]
        tokens.extend(ch["token_ids"])
        if ch["finish_reason"] is not None:
            finish = ch["finish_reason"]
    return tokens, finish, uid


def _settled(eng, timeout=15.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if eng.all_slots_free and leak_free(eng):
            return True
        time.sleep(0.02)
    return False


def test_http_sse_and_whole_agree_with_jax(params, live):
    prompt = [int(t) for t in SHORT_PROMPT]
    conn, resp = _post(live.port, {"prompt": prompt, "max_tokens": 6})
    assert resp.status == 200
    assert resp.getheader("Content-Type").startswith("text/event-stream")
    toks, finish, _ = _read_sse(resp)
    conn.close()
    assert finish == "length"
    conn, resp = _post(live.port, {"prompt": prompt, "max_tokens": 6,
                                   "stream": False})
    body = json.loads(resp.read())
    conn.close()
    assert resp.status == 200
    assert body["choices"][0]["token_ids"] == toks
    assert body["choices"][0]["finish_reason"] == "length"
    assert body["usage"] == {"prompt_tokens": len(prompt),
                             "completion_tokens": 6,
                             "prefix_hit_tokens": 0}
    assert toks == ref_tokens(params, SHORT_PROMPT, 6)


def test_http_bad_requests_rejected(live):
    for body, frag in [
        ({"prompt": "a string"}, "token ids"),
        ({"prompt": []}, "non-empty"),
        ({}, "non-empty"),
        ({"prompt": [1], "max_tokens": "abc"}, "non-numeric"),
        ({"prompt": [1], "deadline_s": "soon"}, "non-numeric"),
        ({"prompt": [1], "n": 0}, ">= 1"),
        ({"prompt": [1], "n": 2}, "queue A, item 4"),
        ({"prompt": [1], "best_of": 3}, "queue A, item 4"),
        ({"prompt": [1], "fork_at": 2}, "queue A, item 4"),
        ({"prompt": [1], "temperature": -1}, "temperature"),
    ]:
        conn, resp = _post(live.port, body)
        assert resp.status == 400, body
        assert frag in json.loads(resp.read())["error"]["message"], body
        conn.close()
    assert live.queue_depth == 0
    # n = 1 and best_of = 1 are one completion: served.
    conn, resp = _post(live.port, {"prompt": [1, 2], "max_tokens": 2,
                                   "n": 1, "best_of": 1})
    assert resp.status == 200 and _read_sse(resp)[1] == "length"
    conn.close()


def test_http_disconnect_cancels_and_frees(live):
    conn, resp = _post(live.port, {"prompt": [int(t) for t in LONG_PROMPT],
                                   "max_tokens": 20})
    assert resp.status == 200
    while not resp.readline().startswith(b"data: "):
        pass  # up to the first token, then vanish
    resp.close()
    conn.close()
    assert _settled(live.engine), live.engine.leak_report()
    conn, resp = _post(live.port, {"prompt": [1, 2, 3], "max_tokens": 3})
    toks, finish, _ = _read_sse(resp)
    conn.close()
    assert finish == "length" and len(toks) == 3


def test_http_deadline_sheds_over_the_wire(live):
    conn, resp = _post(live.port, {"prompt": [int(t) for t in LONG_PROMPT],
                                   "max_tokens": 20, "deadline_s": 0.001})
    assert resp.status == 200
    _, finish, _ = _read_sse(resp)
    conn.close()
    assert finish == "deadline"
    assert _settled(live.engine)


def test_http_429_backpressure_with_retry_after(live):
    live.max_queue = 1
    conns, results = [], []

    def fire():
        c, r = _post(live.port, {"prompt": [int(t) for t in LONG_PROMPT],
                                 "max_tokens": 16})
        results.append((r.status, r.getheader("Retry-After")))
        conns.append((c, r))

    try:
        threads = [threading.Thread(target=fire) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        codes = [s for s, _ in results]
        assert 429 in codes, codes
        for status, retry in results:
            if status == 429:
                assert retry is not None and int(retry) >= 1
    finally:
        live.max_queue = 8
        for c, r in conns:
            if r.status == 200:
                _read_sse(r)
            c.close()
    assert _settled(live.engine)


def test_http_stats_endpoint(live):
    conn = http.client.HTTPConnection("127.0.0.1", live.port, timeout=10)
    conn.request("GET", "/ingress/stats")
    body = json.loads(conn.getresponse().read())
    conn.request("GET", "/nowhere")
    missing = conn.getresponse()
    missing.read()
    conn.close()
    assert body["max_queue"] == 8 and body["draining"] is False
    assert body["slots"] == 2 and body["ready"] is True
    assert body["queue_depth"] == 0 and body["engine_alive"] is True
    assert missing.status == 404


def test_http_traceparent_rides_the_request(live, tmp_path):
    """An inbound traceparent's trace id reaches the ingress's submit span
    and the engine's request span; the sink loads as JSON lines."""
    trace_id, span_id = obs.new_trace_id(), obs.new_span_id()
    path = tmp_path / "t.jsonl"
    obs.TRACER.start(str(path))
    try:
        conn, resp = _post(live.port, {"prompt": [4, 5, 6], "max_tokens": 2},
                           {"traceparent": obs.make_traceparent(trace_id,
                                                                span_id)})
        _, finish, cid = _read_sse(resp)
        conn.close()
        assert _settled(live.engine)
    finally:
        obs.TRACER.close()
    assert finish == "length"
    events = [json.loads(line) for line in path.read_text().splitlines()]
    uid = int(cid.split("-")[1])
    submit = [e for e in events if e["name"] == "ingress_submit"]
    assert submit and submit[0]["args"]["trace_id"] == trace_id
    assert submit[0]["args"]["adopted"] is True
    req = [e for e in events if e["name"] == f"request:{uid}"]
    assert req and req[0]["args"]["trace_id"] == trace_id
    assert req[0]["args"]["outcome"] == "budget"
    fid = obs.flow_id(trace_id)
    # Adopted: the ingress steps the client's flow ("t"), the engine's
    # admission steps it, its retire finishes it.
    assert sorted(e["ph"] for e in events if e.get("id") == fid) == [
        "f", "t", "t"]
    assert any(e["name"] == "serving:tick" for e in events)


def test_zz_http_drain_lifecycle(live):
    """Last: drain answers 202, later POSTs get 503, ``join()`` returns the
    report with the outcome vocabulary, and the engine ends leak-free."""
    conn = http.client.HTTPConnection("127.0.0.1", live.port, timeout=10)
    conn.request("POST", "/admin/drain", "")
    resp = conn.getresponse()
    assert resp.status == 202 and json.loads(resp.read()) == {
        "draining": True}
    conn.close()
    conn, resp = _post(live.port, {"prompt": [1, 2], "max_tokens": 2})
    assert resp.status == 503
    conn.close()
    report = live.join(timeout=60)
    assert report is not None and live.engine_error is None
    assert set(report.outcomes) <= set(ts.OUTCOMES)
    assert report.outcomes.get("cancelled", 0) >= 1  # the disconnect
    assert report.outcomes.get("deadline", 0) >= 1
    assert leak_free(live.engine)
    live.stop()


class _FakeReq:
    """What ``IngressServer.handle`` touches of a request handler: the
    headers, the body in ``rfile``, the reply in ``wfile``."""

    def __init__(self, path, body):
        self.path = path
        self.headers = {"Content-Length": str(len(body))}
        self.rfile = io.BytesIO(body)
        self.wfile = io.BytesIO()
        self.status = None

    def send_response(self, code):
        self.status = code

    def send_header(self, key, value):
        pass

    def end_headers(self):
        pass


def test_routes_read_the_request_body_they_ignore(params):
    """Every route but completions reads its request body to the end
    before it replies: a socket closed with unread bytes is reset, and the
    reset can take the reply with it (a drain POSTed with a JSON body lost
    its 202 that way)."""
    srv = ts.IngressServer(ts.SlotServer(params[1], T_CFG, **ENGINE),
                           max_queue=2)
    body = json.dumps({"stream": False, "pad": "x" * 4096}).encode()
    for method, path, code in (("GET", "/ingress/stats", 200),
                               ("POST", "/nowhere", 404),
                               ("POST", "/admin/drain", 202)):
        req = _FakeReq(path, body)
        srv.handle(method, req)
        assert req.status == code and req.rfile.tell() == len(body), path
    assert srv.draining


# -- tracing and the CLI ----------------------------------------------------


def test_traceparent_round_trips_against_jax(tmp_path):
    for _ in range(4):
        tid, sid = obs.new_trace_id(), obs.new_span_id()
        header = obs.make_traceparent(tid, sid)
        assert header == jtracing.make_traceparent(tid, sid)
        assert obs.parse_traceparent(header) == \
            jtracing.parse_traceparent(header) == (tid, sid)
        assert obs.flow_id(tid) == jtracing.flow_id(tid)
    for bad in ("", None, "00-xyz", "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
                "00-" + "g" * 32 + "-" + "1" * 16 + "-01",
                "00-" + "1" * 31 + "-" + "1" * 16 + "-01"):
        assert obs.parse_traceparent(bad) is None
        assert jtracing.parse_traceparent(bad) is None
    tracer = obs.SpanTracer()
    path = tmp_path / "spans.jsonl"
    tracer.start(str(path))
    with tracer.span("outer", args={"k": 1}):
        tracer.instant("mark")
        tracer.flow("s", 7)
    tracer.close()
    events = [json.loads(line) for line in path.read_text().splitlines()]
    assert [e["ph"] for e in events] == ["M", "M", "i", "s", "X"]
    assert events[-1]["name"] == "outer" and events[-1]["args"] == {"k": 1}


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "CUDA_VISIBLE_DEVICES")}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"  # tiny shapes: one intra-op thread
    return env


SERVE_HTTP = ["--mode", "serve", "--device", "cpu", "--serve-http", "0",
              "--slots", "2", "--prompt-len", "16", "--prompt-jitter", "0",
              "--max-new-tokens", "8", "--model-dim", "32", "--heads", "2",
              "--n-layers", "1", "--vocab-size", "64", "--dtype", "float32",
              "--temperature", "0", "--max-queue", "2"]


def test_cli_serve_http_answers_and_drains_on_sigterm(tmp_path):
    metrics, trace = tmp_path / "m.json", tmp_path / "t.jsonl"
    proc = subprocess.Popen(
        [sys.executable, "-m", "tree_attention_tpu_torch", *SERVE_HTTP,
         "--metrics-out", str(metrics), "--trace-events", str(trace)],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        port = None
        for line in proc.stderr:
            if "serving HTTP on http://127.0.0.1:" in line:
                port = int(line.split("127.0.0.1:")[1].split("/")[0])
                break
        assert port, "the CLI never logged its port"
        conn, resp = _post(port, {"prompt": [3, 1, 4, 1, 5],
                                  "max_tokens": 4})
        toks, finish, _ = _read_sse(resp)
        conn.close()
        assert finish == "length" and len(toks) == 4
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["ingress"]["port"] == port and rec["ingress"]["max_queue"] == 2
    assert rec["outcomes"] == {"budget": 1} and rec["tokens_generated"] == 4
    assert rec["leaks"]["blocks_used"] == 0
    snap = json.loads(metrics.read_text())
    names = {m["name"]: m for m in snap["metrics"]}
    assert names["serving_http_requests_total"]["samples"] == [
        {"labels": {"route": "completions", "code": "200"}, "value": 1}]
    assert names["serving_requests_total"]["samples"] == [
        {"labels": {"outcome": "budget"}, "value": 1}]
    events = [json.loads(line) for line in trace.read_text().splitlines()]
    assert any(e["name"].startswith("request:") for e in events)


def test_cli_engine_crash_exits_non_zero(monkeypatch):
    def crash(self, requests, max_ticks=None):
        raise RuntimeError("planted engine crash")

    monkeypatch.setattr(ts.SlotServer, "serve", crash)
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    try:
        assert cli.main(SERVE_HTTP) == 1
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)


def test_cli_serve_http_flag_checks():
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main([a for a in SERVE_HTTP if a not in ("--device", "cpu")])
    for extra, frag in ((["--max-queue", "0"], "--max-queue"),
                        (["--default-deadline", "0"], "--default-deadline")):
        with pytest.raises(SystemExit, match=frag):
            cli.main(SERVE_HTTP + extra)


def test_ingress_refuses_a_bad_queue_bound(params):
    with pytest.raises(ValueError):
        ting.IngressServer(engine(params, "port", "base"), max_queue=0)
