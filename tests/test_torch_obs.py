"""The port's telemetry plane against the JAX package's (CPU).

Counterparts of ``tests/test_obs.py``'s flight-recorder, export, endpoint,
crash-safety and overhead cases:

- **Ring.** ``FlightRecorder`` semantics (``TestFlightRecorder``) and
  ``flight_health``'s three verdicts, each against JAX's.
- **Prometheus.** One sequence of counter, gauge, labelled-counter and
  histogram operations (a label value that needs escaping among them) on a
  fresh JAX registry and a fresh port registry: their ``to_prometheus()``
  texts are equal byte for byte (``TestExports``).
- **Endpoints.** A loopback ``MetricsHTTPServer`` (``TestHTTPEndpoints``):
  ``/metrics``, ``/metrics.json``, ``/healthz``, ``/flight``, ``/slots``,
  the index, 405 on POST, and 404 for unknown paths and for a uid the
  request ledger does not hold (the ledger's routes themselves:
  ``tests/test_torch_reqlog.py``).
- **Signals.** SIGTERM flushes every armed sink and the process still dies
  by SIGTERM (143); SIGUSR1 dumps and keeps running: each one short
  subprocess that imports only the port's ``obs`` (no torch).
- **Disabled overhead.** The disarmed hot path allocates nothing
  (``TestDisabledOverhead``), the engine's new metrics and
  ``FLIGHT.record`` included.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
import tracemalloc
import urllib.error
import urllib.request

import pytest

from tree_attention_tpu.obs import flight as jflight
from tree_attention_tpu.obs import http as jhttp
from tree_attention_tpu.obs import metrics as jmetrics

from tree_attention_tpu_torch.obs import flight as tflight
from tree_attention_tpu_torch.obs import http as thttp
from tree_attention_tpu_torch.obs import metrics as tmetrics
from tree_attention_tpu_torch.obs import reqlog as treqlog
from tree_attention_tpu_torch.obs.tracing import SpanTracer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"jax": jflight, "port": tflight}


# -- the ring ---------------------------------------------------------------


@pytest.mark.parametrize("side", ["jax", "port"])
def test_disarmed_record_is_noop(side):
    fr = SIDES[side].FlightRecorder(capacity=4)
    fr.record({"tick": 0})
    assert fr.ticks_recorded == 0
    assert fr.last_tick_age() is None
    assert fr.snapshot()["records"] == []


def test_ring_keeps_last_capacity_records_in_order():
    snaps = []
    for mod in (jflight, tflight):
        fr = mod.FlightRecorder(capacity=3)
        fr.arm()
        for i in range(7):
            fr.record({"tick": i})
        snaps.append(fr.snapshot())
    for snap in snaps:
        assert snap["ticks_recorded"] == 7
        assert [r["tick"] for r in snap["records"]] == [4, 5, 6]
        assert snap["capacity"] == 3
        assert snap["last_tick_age_s"] is not None
    assert set(snaps[0]) == set(snaps[1])
    assert tflight.DEFAULT_CAPACITY == jflight.DEFAULT_CAPACITY == 256


def test_arm_resizes_and_keeps_the_newest():
    fr = tflight.FlightRecorder(capacity=8)
    fr.arm()
    for i in range(6):
        fr.record({"tick": i})
    fr.arm(capacity=2)
    assert fr.capacity == 2
    assert [r["tick"] for r in fr.snapshot()["records"]] == [4, 5]


def test_dump_writes_valid_json(tmp_path):
    fr = tflight.FlightRecorder(capacity=8)
    fr.arm()
    fr.record({"tick": 0, "states": ["live"]})
    path = tmp_path / "sub" / "flight.json"  # parent dir created
    fr.dump(str(path), reason="test")
    data = json.loads(path.read_text())
    assert data["reason"] == "test"
    assert data["records"] == [{"tick": 0, "states": ["live"]}]


def test_dump_if_armed_needs_a_sink(tmp_path):
    fr = tflight.FlightRecorder()
    fr.arm()  # memory-only
    fr.record({"tick": 0})
    assert fr.dump_if_armed("x") is None
    path = str(tmp_path / "f.json")
    fr.arm(path)
    assert fr.dump_path == path
    assert fr.dump_if_armed("err") == path
    assert json.loads(open(path).read())["reason"] == "err"
    fr.disarm()
    assert fr.dump_if_armed("late") is None
    # A sink that cannot be written is swallowed (the black box must not
    # kill the run it records).
    fr.arm(str(tmp_path / "f.json" / "under_a_file.json"))
    assert fr.dump_if_armed("unwritable") is None


def test_clear_resets_liveness():
    fr = tflight.FlightRecorder()
    fr.arm()
    fr.record({"tick": 0})
    assert not fr.idle
    fr.clear()
    assert fr.ticks_recorded == 0
    assert fr.last_tick_age() is None
    assert fr.idle


@pytest.mark.parametrize("side", ["jax", "port"])
def test_bad_capacity_rejected(side):
    with pytest.raises(ValueError):
        SIDES[side].FlightRecorder(capacity=0)


def _health_case(mod, health, case):
    fr = mod.FlightRecorder(capacity=4)
    fr.arm()
    if case != "none":
        fr.record({"tick": 0})
    if case in ("stalled", "drained"):
        fr._last_tick_t = time.monotonic() - 120.0
    if case == "drained":
        fr.mark_idle()
    code, body = health(fr, 30.0)
    return code, body["status"], body["ticks_recorded"], body["stall_after_s"]


@pytest.mark.parametrize("case,want", [
    ("none", (200, "idle")), ("fresh", (200, "ok")),
    ("stalled", (503, "stalled")), ("drained", (200, "idle"))])
def test_flight_health_verdicts_match_jax(case, want):
    got = _health_case(tflight, thttp.flight_health, case)
    assert got[:2] == want
    assert got == _health_case(jflight, jhttp.flight_health, case)
    assert thttp.DEFAULT_STALL_AFTER == jhttp.DEFAULT_STALL_AFTER


# -- the Prometheus exposition ----------------------------------------------


def _drive(mod):
    """One sequence of registry operations; the registry's texts."""
    reg = mod.MetricsRegistry(enabled=True)
    c = reg.counter("tok_total", "tokens", labels=("mode",))
    c.labels(mode="decode").inc(7)
    c.labels(mode='oops "quoted"\nnewline\\slash').inc(2.5)
    reg.counter("plain_total").inc()
    g = reg.gauge("cap", "capacity in blocks")
    g.set(4096)
    reg.gauge("ratio").set(0.125)
    reg.gauge("nan_gauge").set(float("nan"))
    reg.gauge("inf_gauge").set(float("-inf"))
    h = reg.histogram("lat_seconds", "latency", buckets=(0.5, 5.0))
    h.observe(0.1)
    h.observe(1.0)
    h.observe(7.25)
    lh = reg.histogram("step_seconds", labels=("phase",), buckets=(1e-4,))
    lh.labels(phase="decode").observe(3e-5)
    reg.counter("never_touched_total", "declared only")
    return reg.to_prometheus(), json.loads(reg.to_json())


def test_prometheus_text_equals_jax_byte_for_byte():
    jtext, jsnap = _drive(jmetrics)
    ttext, tsnap = _drive(tmetrics)
    assert ttext == jtext
    assert [m["samples"] for m in tsnap["metrics"]] == \
        [m["samples"] for m in jsnap["metrics"]]
    # One line per sample even with an escaped newline in a label value.
    (line,) = [ln for ln in ttext.splitlines()
               if ln.startswith('tok_total{mode="oops')]
    assert '\\"quoted\\"' in line and "\\n" in line and "\\\\slash" in line
    assert 'lat_seconds_bucket{le="+Inf"} 3' in ttext.splitlines()
    assert "cap 4096" in ttext.splitlines()


# -- the endpoints ----------------------------------------------------------


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def _status(port, path, method="GET", data=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method)
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(req, timeout=10)
    return err.value.code, err.value.read().decode()


class _Engine:
    def slots_snapshot(self):
        return [{"slot": 0, "state": "live", "uid": 3, "index": 0,
                 "tokens": 2, "clen": 9, "nblocks": 3}]


@pytest.fixture(scope="module")
def _loopback():
    srv = thttp.MetricsHTTPServer(0, stall_after=30.0)
    srv.start()  # one server (its stop waits out a 0.5 s poll)
    yield srv
    srv.stop()


@pytest.fixture()
def server(_loopback):
    """The loopback exporter over a fresh registry, flight recorder and
    (disarmed) request ledger."""
    reg = tmetrics.MetricsRegistry(enabled=True)
    reg.counter("http_test_total", "h").inc(7)
    reg.gauge("http_cap").set(4)
    fr = tflight.FlightRecorder(capacity=4)
    fr.arm()
    srv = _loopback
    srv._registry, srv._flight, srv._engine = reg, fr, None
    srv._reqlog = treqlog.ReqLog()
    return srv, reg, fr


def test_metrics_text_matches_registry_live(server):
    srv, reg, _ = server
    status, ctype, body = _get(srv.port, "/metrics")
    assert status == 200 and body == reg.to_prometheus()
    assert ctype == "text/plain; version=0.0.4; charset=utf-8"
    assert "http_test_total 7" in body
    reg.counter("http_test_total").inc(5)
    assert "http_test_total 12" in _get(srv.port, "/metrics")[2]


def test_metrics_json_matches_snapshot(server):
    srv, reg, _ = server
    status, ctype, body = _get(srv.port, "/metrics.json")
    assert status == 200 and ctype == "application/json"
    assert {m["name"] for m in json.loads(body)["metrics"]} == {
        m["name"] for m in reg.snapshot()["metrics"]}


def test_healthz_idle_ok_stalled_idle(server):
    srv, _, fr = server
    status, _, body = _get(srv.port, "/healthz")
    assert status == 200 and json.loads(body)["status"] == "idle"
    fr.record({"tick": 0})
    status, _, body = _get(srv.port, "/healthz")
    body = json.loads(body)
    assert status == 200 and body["status"] == "ok"
    assert body["ticks_recorded"] == 1 and body["last_tick_age_s"] < 30.0
    fr._last_tick_t = time.monotonic() - 120.0
    code, body = _status(srv.port, "/healthz")
    assert code == 503 and json.loads(body)["status"] == "stalled"
    # A drained run (mark_idle) does not age into a stall.
    fr.mark_idle()
    status, _, body = _get(srv.port, "/healthz")
    assert status == 200 and json.loads(body)["status"] == "idle"


def test_flight_endpoint_serves_ring(server):
    srv, _, fr = server
    fr.record({"tick": 0, "occupancy": 2})
    status, _, body = _get(srv.port, "/flight")
    assert status == 200
    assert json.loads(body)["records"] == [{"tick": 0, "occupancy": 2}]


def test_slots_404_until_an_engine_is_attached(server):
    srv, _, _ = server
    assert _status(srv.port, "/slots")[0] == 404
    srv.attach_engine(_Engine())
    status, _, body = _get(srv.port, "/slots")
    assert status == 200 and json.loads(body) == _Engine().slots_snapshot()


@pytest.mark.parametrize("path", ["/nope", "/requests/3", "/request/3"])
def test_unserved_paths_404(server, path):
    assert _status(server[0].port, path)[0] == 404


def test_index_lists_only_served_routes(server):
    status, _, body = _get(server[0].port, "/")
    assert status == 200
    for route in ("/metrics", "/metrics.json", "/healthz", "/flight",
                  "/requests", "/request/{uid}", "/slots"):
        assert route in body.split()


def test_post_is_405(server):
    code, _ = _status(server[0].port, "/metrics", "POST", b'{"x": 1}')
    assert code == 405


# -- crash-safe sinks ---------------------------------------------------------


_CRASH_SCRIPT = """
import os, sys, time
sys.path.insert(0, {repo!r})
from tree_attention_tpu_torch import obs

obs.configure(metrics_out={metrics!r}, trace_events={trace!r},
              flight_out={flight!r})
assert obs.install_crash_handlers()
assert obs.install_crash_handlers()  # idempotent
assert "torch" not in sys.modules
obs.counter("crash_test_total").inc(3)
with obs.span("crash_phase"):
    pass
for i in range(5):
    obs.FLIGHT.record({{"tick": i}})
print("READY", flush=True)
{tail}
"""


def _spawn(tmp_path, tail, metrics=None, trace=None):
    flight = str(tmp_path / "f.json")
    proc = subprocess.Popen(
        [sys.executable, "-c", _CRASH_SCRIPT.format(
            repo=ROOT, metrics=metrics, trace=trace, flight=flight,
            tail=tail)],
        stdout=subprocess.PIPE, text=True, cwd=str(tmp_path),
        env={k: v for k, v in os.environ.items()
             if not k.startswith("TA_")})
    return proc, flight


def test_sigterm_flushes_all_sinks(tmp_path):
    metrics = str(tmp_path / "m.json")
    trace = str(tmp_path / "t.jsonl")
    proc, flight = _spawn(tmp_path, "time.sleep(60)", metrics, trace)
    try:
        assert proc.stdout.readline().strip() == "READY"
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    finally:
        proc.kill()
    assert rc == -signal.SIGTERM  # the kill stayed a kill (143 in a shell)
    data = json.loads(open(metrics).read())
    (c,) = [m for m in data["metrics"] if m["name"] == "crash_test_total"]
    assert c["samples"][0]["value"] == 3
    events = [json.loads(ln) for ln in open(trace).read().splitlines()]
    assert any(e.get("name") == "crash_phase" for e in events)
    fdata = json.loads(open(flight).read())
    assert [r["tick"] for r in fdata["records"]] == [0, 1, 2, 3, 4]
    assert fdata["reason"] == "flush"


def test_sigusr1_dumps_and_keeps_running(tmp_path):
    flight = str(tmp_path / "f.json")
    tail = (f"t0 = time.time()\n"
            f"while not os.path.exists({flight!r}) and time.time() - t0 < 30:"
            f"\n    time.sleep(0.02)\n"
            f"print('DUMPED' if os.path.exists({flight!r}) else 'TIMEOUT', "
            f"flush=True)\n"
            f"obs.FLIGHT.record({{'tick': 5}})\n"
            f"print(obs.shutdown()['flight_out'] is not None, flush=True)\n")
    proc, _ = _spawn(tmp_path, tail)
    try:
        assert proc.stdout.readline().strip() == "READY"
        proc.send_signal(signal.SIGUSR1)
        assert proc.stdout.readline().strip() == "DUMPED"
        assert proc.stdout.readline().strip() == "True"
        assert proc.wait(timeout=30) == 0  # survived the signal
    finally:
        proc.kill()
    fdata = json.loads(open(flight).read())
    # The run went on after the dump: the exit's shutdown rewrote it.
    assert fdata["reason"] == "shutdown"
    assert [r["tick"] for r in fdata["records"]] == [0, 1, 2, 3, 4, 5]


# -- the disarmed hot path ----------------------------------------------------


def test_no_per_call_allocation_when_disabled():
    from tree_attention_tpu_torch.serving.engine import (
        _FORK_SHARED,
        _FORKS,
        _SPEC_ACCEPT_RATIO,
        _SPEC_ACCEPT_SAMPLES,
        _SPEC_ACCEPTED,
        _SPEC_PROPOSED,
        _TREE_BRANCHES,
    )

    reg = tmetrics.MetricsRegistry()  # disabled
    c = reg.counter("c_total")
    child = reg.counter("l_total", labels=("a",)).labels(a="x")
    g = reg.gauge("g")
    h = reg.histogram("h_seconds")
    tracer = SpanTracer()  # inactive
    flight = tflight.FlightRecorder()  # disarmed
    tick_rec = {"tick": 0}  # prebuilt, as the engine's guard requires
    was = tmetrics.REGISTRY.enabled
    tmetrics.REGISTRY.disable()  # the engine's metrics are the global's

    def hot_path():
        c.inc()
        child.inc(3)
        g.set(2.0)
        h.observe(0.5)
        _SPEC_PROPOSED.inc(4)
        _SPEC_ACCEPTED.inc(2)
        _SPEC_ACCEPT_RATIO.set(0.5)
        _FORKS.inc()
        _FORK_SHARED.inc(7)
        _TREE_BRANCHES.set(8)
        _SPEC_ACCEPT_SAMPLES.inc(4)
        with tracer.span("phase"):
            pass
        tracer.instant("event")
        flight.record(tick_rec)
        flight.record(None)  # the disarmed guard's calling shape

    try:
        hot_path()  # warm any lazy caches before measuring
        tracemalloc.start()
        try:
            base = tracemalloc.get_traced_memory()[0]
            for _ in range(5000):
                hot_path()
            grown = tracemalloc.get_traced_memory()[0] - base
        finally:
            tracemalloc.stop()
    finally:
        if was:
            tmetrics.REGISTRY.enable()
    assert grown < 4096, f"disabled hot path allocated {grown} B"
    assert c.value() == 0 and child.value() == 0
    assert flight.ticks_recorded == 0
