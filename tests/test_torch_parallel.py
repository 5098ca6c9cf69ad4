"""The port's tree merge across ranks against the JAX package's (CPU).

The port is SPMD: each rank is a process, and the collectives are gloo
all-reduces. Here W ranks are spawned (``multiprocessing`` "spawn", a gloo
group over a ``file://`` rendezvous under the test's temporary directory),
each computes its shard's partial and the merge, and the merged result is
held against the JAX function on ``cpu_mesh(W)`` over the same numpy inputs:

- ``tree_decode`` at W = 2 and 4: causal and not, GQA, a per-slot ``(B,)``
  ``q_position``, both merge payload formats; 1 MAX + 1 SUM issued, and the
  accounted bytes equal JAX's. Tolerance: JAX's own for f32, 2e-5.
- ``tree_decode_q8`` (q8q and q8) at W = 2 and 4 over channel scales of the
  whole sequence; tolerance of the q8 kernels' port tests: out within 1e-2
  of each row's largest |out| (P rounds to bf16), lse within 1e-4.
- ``paged_tree_decode`` at W = 2 over a pool sharded on the block axis:
  1 MAX + 2 SUM (``pmax``/``psum_num``/``psum_den``), bytes equal to JAX's,
  out and lse within 2e-5 of JAX's; the int8 slices within 2e-5 of the
  unsharded int8 partial.

Every rank's merged result is bit-identical (it comes out of an
all-reduce): asserted, not assumed. JAX is imported inside the tests, so a
spawned rank imports torch only. Every join has a timeout that fails the
test and kills the ranks.
"""

import datetime
import multiprocessing
import os
import queue
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tree_attention_tpu_torch.ops.cuda_decode import quantize_kv_channelwise
from tree_attention_tpu_torch.parallel import mesh as tmesh
from tests.torch_threads import few_torch_threads  # noqa: F401

TOL_F32 = 2e-5
TOL_OUT_ROW, TOL_LSE_Q8 = 1e-2, 1e-4
RANK_TIMEOUT_S = 120


# -- spawning ranks ----------------------------------------------------------

def _rank_main(rank, world, init, fn, args, out_q):
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=init, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out_q.put((rank, True, result))
    except BaseException:  # reported to the test, which fails
        out_q.put((rank, False, traceback.format_exc()))


def run_ranks(world, fn, tmpdir, *args, timeout=RANK_TIMEOUT_S):
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes that
    form a gloo group; returns the per-rank results in rank order. A rank
    that raises, dies or outlives ``timeout`` fails the test, and every
    rank still running is killed."""
    ctx = multiprocessing.get_context("spawn")
    out_q = ctx.Queue()
    init = f"file://{os.path.join(str(tmpdir), 'rendezvous')}"
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, init, fn, args, out_q), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                pytest.fail(f"ranks {sorted(set(range(world)) - set(results))}"
                            f" did not finish within {timeout} s")
            try:
                rank, ok, payload = out_q.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    pytest.fail(f"ranks {dead} died (exit codes "
                                f"{[procs[r].exitcode for r in dead]})")
                continue
            if not ok:
                pytest.fail(f"rank {rank} raised:\n{payload}")
            results[rank] = payload
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [results[r] for r in range(world)]


def assert_ranks_identical(results, key):
    """Every rank's ``key`` arrays are bit-identical to rank 0's."""
    for r in results[1:]:
        for a, b in zip(r[key], results[0][key]):
            np.testing.assert_array_equal(a, b)


# -- cases (made from numpy seeds, on both sides) ----------------------------

# name -> (B, Hq, Hkv, Tq, Tk, causal, q_position); every case merges under
# both payload formats on the port's side.
TREE_CASES = {
    "gqa-causal-ragged": (2, 4, 2, 2, 32, True, [25, 9]),
    "mha-noncausal": (1, 2, 2, 1, 32, False, None),
    "mha-causal-default": (2, 2, 2, 3, 32, True, None),
}
# name -> (kernel, B, Hq, Hkv, Tq, Tk, q_position)
Q8_CASES = {
    "q8q-gqa-causal-ragged": ("q8q", 2, 4, 2, 1, 64, [50, 13]),
    "q8-gqa-causal-ragged": ("q8", 2, 4, 2, 1, 64, [50, 13]),
}
# The (case, W) pairs held against JAX: each JAX call on cpu_mesh(W)
# compiles its own program (seconds each), so each case runs at one or
# both of W = 2, 4 rather than every one at both.
TREE_PAIRS = [("gqa-causal-ragged", 2), ("gqa-causal-ragged", 4),
              ("mha-noncausal", 2), ("mha-causal-default", 4)]
Q8_PAIRS = [("q8q-gqa-causal-ragged", 2), ("q8q-gqa-causal-ragged", 4),
            ("q8-gqa-causal-ragged", 4)]
PAYLOADS = ("split", "packed")
D = 16


def tree_case(name):
    B, Hq, Hkv, Tq, Tk, causal, qpos = TREE_CASES[name]
    rng = np.random.default_rng(sorted(TREE_CASES).index(name))
    q = rng.standard_normal((B, Hq, Tq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32)
    qpos = None if qpos is None else np.asarray(qpos, np.int32)
    return q, k, v, causal, qpos


def q8_case(name):
    """Int8 K/V quantized per channel over the WHOLE sequence (the port's
    quantizer, bit-identical to JAX's)."""
    kernel, B, Hq, Hkv, Tq, Tk, qpos = Q8_CASES[name]
    rng = np.random.default_rng(10 + sorted(Q8_CASES).index(name))
    q = rng.standard_normal((B, Hq, Tq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32)
    kq, vq, ks, vs = (x.numpy() for x in quantize_kv_channelwise(
        torch.from_numpy(k), torch.from_numpy(v)))
    return kernel, q, kq, vq, ks, vs, np.asarray(qpos, np.int32)


# name -> (Tq, int8)
PAGED_CASES = {"exact-tq1": (1, False), "int8-tq2": (2, True)}


def paged_case(name):
    """A pool of 8 blocks, tables straddling both halves (W = 2 holds [0,
    4) and [4, 8)), ragged positions."""
    Tq, quant = PAGED_CASES[name]
    rng = np.random.default_rng(20 + sorted(PAGED_CASES).index(name))
    B, Hq, Hkv, blk, N = 2, 4, 2, 4, 8
    if quant:
        k = rng.integers(-127, 128, size=(N, Hkv, blk, D)).astype(np.int8)
        v = rng.integers(-127, 128, size=(N, Hkv, blk, D)).astype(np.int8)
        ks = rng.uniform(0.005, 0.03, size=(N, Hkv)).astype(np.float32)
        vs = rng.uniform(0.005, 0.03, size=(N, Hkv)).astype(np.float32)
    else:
        k = rng.standard_normal((N, Hkv, blk, D)).astype(np.float32)
        v = rng.standard_normal((N, Hkv, blk, D)).astype(np.float32)
        ks = vs = None
    table = np.asarray([[0, 5, 2], [7, 1, 4]], np.int32)
    qpos = np.asarray([11 - Tq + 1, 7 - Tq + 1], np.int32)
    q = rng.standard_normal((B, Hq, Tq, D)).astype(np.float32)
    return q, k, v, table, qpos, ks, vs


# -- the ranks' side ---------------------------------------------------------

def _bytes():
    from tree_attention_tpu_torch.parallel.accounting import PAYLOAD_BYTES

    return {k: c.value() for k, c in PAYLOAD_BYTES._children.items()}


def _delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}


def _rank_cases(rank, world, paged):
    """Every case on this rank: its shard, the merge, the collectives it
    issued and the bytes it accounted."""
    from tree_attention_tpu_torch import obs
    from tree_attention_tpu_torch.parallel import (
        COLLECTIVES,
        make_mesh,
        paged_tree_decode,
        shard_along,
        tree_decode,
        tree_decode_q8,
    )

    obs.enable()
    mesh = make_mesh({"seq": world})
    t = torch.from_numpy
    out = {}

    def run(name, fn):
        b0, c0 = _bytes(), dict(COLLECTIVES)
        o, lse = fn()
        out[name] = {"res": (o.numpy(), lse.numpy()),
                     "bytes": _delta(_bytes(), b0),
                     "colls": _delta(dict(COLLECTIVES), c0)}

    for name in TREE_CASES:
        q, k, v, causal, qpos = tree_case(name)
        for payload in PAYLOADS:
            run((name, payload), lambda: tree_decode(
                t(q), shard_along(mesh, t(k), "seq", 2),
                shard_along(mesh, t(v), "seq", 2), mesh=mesh, causal=causal,
                q_position=None if qpos is None else t(qpos),
                merge_payload=payload))
    for name in Q8_CASES:
        kernel, q, kq, vq, ks, vs, qpos = q8_case(name)
        run(name, lambda: tree_decode_q8(
            t(q), shard_along(mesh, t(kq), "seq", 2),
            shard_along(mesh, t(vq), "seq", 2), t(ks), t(vs), mesh=mesh,
            causal=True, q_position=t(qpos), kernel=kernel))
    if paged:
        for name in PAGED_CASES:
            q, k, v, table, qpos, ks, vs = paged_case(name)
            sc = {} if ks is None else dict(
                k_scale=shard_along(mesh, t(ks), "seq", 0),
                v_scale=shard_along(mesh, t(vs), "seq", 0))
            run(name, lambda: paged_tree_decode(
                t(q), shard_along(mesh, t(k), "seq", 0),
                shard_along(mesh, t(v), "seq", 0), t(table), mesh=mesh,
                q_position=t(qpos), **sc))
        # Only the seq axis shards in this slice.
        try:
            make_mesh({"data": 2, "seq": world // 2})
            out["data_axis_error"] = None
        except NotImplementedError as e:
            out["data_axis_error"] = str(e)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(W)``: every case's per-rank results at W ranks, spawned once
    per W for the module."""
    runs = {}

    def get(world):
        if world not in runs:
            runs[world] = run_ranks(world, _rank_cases,
                                    tmp_path_factory.mktemp(f"w{world}"),
                                    world == 2)
        return runs[world]

    return get


# -- the JAX side ------------------------------------------------------------

def _jax_bytes():
    from tree_attention_tpu.parallel.accounting import PAYLOAD_BYTES

    return {k: c.value() for k, c in PAYLOAD_BYTES._children.items()}


def _jax_accounted(fn):
    """Run ``fn`` with JAX's registry on; returns its result and the bytes
    it accounted."""
    from tree_attention_tpu import obs as jobs

    was = jobs.REGISTRY.enabled
    jobs.REGISTRY.enable()
    try:
        b0 = _jax_bytes()
        res = fn()
        return res, _delta(_jax_bytes(), b0)
    finally:
        if not was:
            jobs.REGISTRY.disable()


def _close(port, ref, atol):
    (o, l), (ro, rl) = port, ref
    ro = np.asarray(ro, np.float32)
    rl = np.asarray(rl)
    np.testing.assert_allclose(o, ro, atol=atol, rtol=0)
    np.testing.assert_array_equal(np.isneginf(l), np.isneginf(rl))
    fin = np.isfinite(rl)
    np.testing.assert_allclose(l[fin], rl[fin], atol=atol, rtol=0)


def _close_rows(port, ref):
    (o, l), (ro, rl) = port, ref
    ro = np.asarray(ro, np.float32)
    rl = np.asarray(rl)
    row = np.abs(ro).max(-1, keepdims=True)
    assert np.all(np.abs(o - ro) <= TOL_OUT_ROW * row + 1e-30)
    np.testing.assert_array_equal(np.isneginf(l), np.isneginf(rl))
    fin = np.isfinite(rl)
    np.testing.assert_allclose(l[fin], rl[fin], atol=TOL_LSE_Q8, rtol=0)


@pytest.mark.parametrize("name,world", TREE_PAIRS)
def test_tree_decode_matches_jax(ranks, name, world):
    import jax.numpy as jnp

    from tree_attention_tpu.parallel.mesh import cpu_mesh
    from tree_attention_tpu.parallel.tree import tree_decode

    res = ranks(world)
    q, k, v, causal, qpos = tree_case(name)
    # JAX accounts the same bytes under either format; one JAX run holds
    # both of the port's.
    ref, jbytes = _jax_accounted(lambda: tree_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mesh=cpu_mesh(world), causal=causal,
        q_position=None if qpos is None else jnp.asarray(qpos)))
    for payload in PAYLOADS:
        cases = [r[(name, payload)] for r in res]
        assert_ranks_identical(cases, "res")
        _close(cases[0]["res"], ref, TOL_F32)
        for c in cases:  # 1 MAX + 1 SUM, the bytes JAX accounts
            assert c["colls"] == {("tree_decode", "pmax"): 1,
                                  ("tree_decode", "psum"): 1}
            assert c["bytes"] == jbytes


@pytest.mark.parametrize("name,world", Q8_PAIRS)
def test_tree_decode_q8_matches_jax(ranks, name, world):
    import jax.numpy as jnp

    from tree_attention_tpu.parallel.mesh import cpu_mesh
    from tree_attention_tpu.parallel.tree import tree_decode_q8

    res = ranks(world)
    kernel, q, kq, vq, ks, vs, qpos = q8_case(name)
    ref, jbytes = _jax_accounted(lambda: tree_decode_q8(
        *(jnp.asarray(x) for x in (q, kq, vq, ks, vs)), mesh=cpu_mesh(world),
        causal=True, q_position=jnp.asarray(qpos), kernel=kernel))
    cases = [r[name] for r in res]
    assert_ranks_identical(cases, "res")
    _close_rows(cases[0]["res"], ref)
    for c in cases:
        assert c["colls"] == {("tree_decode", "pmax"): 1,
                              ("tree_decode", "psum"): 1}
        assert c["bytes"] == jbytes


def _paged_check(res, name):
    """The ranks agree bit for bit, issued exactly the monoid's collectives
    — one MAX, two SUMs — and equal this module's unsharded partial over
    the whole pool (every block held). Returns the merged result and the
    accounted bytes."""
    from tree_attention_tpu_torch.ops.decode import paged_local_partial

    q, k, v, table, qpos, ks, vs = paged_case(name)
    t = torch.from_numpy
    sc = {} if ks is None else dict(k_scale=t(ks), v_scale=t(vs))
    whole = paged_local_partial(t(q), t(k), t(v), t(table),
                                q_position=t(qpos), **sc)
    cases = [r[name] for r in res]
    assert_ranks_identical(cases, "res")
    _close(cases[0]["res"], (whole[0].numpy(), whole[1].numpy()), TOL_F32)
    for c in cases:
        assert c["colls"] == {("paged_tree_decode", "pmax"): 1,
                              ("paged_tree_decode", "psum_num"): 1,
                              ("paged_tree_decode", "psum_den"): 1}
        assert c["bytes"] == cases[0]["bytes"]
        assert sorted(k[1] for k in c["bytes"]) == ["pmax", "psum_den",
                                                    "psum_num"]
    return cases[0]["res"], cases[0]["bytes"]


def test_paged_tree_decode_matches_jax_in_three_collectives(ranks):
    import jax.numpy as jnp

    from tree_attention_tpu.parallel.mesh import cpu_mesh
    from tree_attention_tpu.parallel.tree import paged_tree_decode

    got, nbytes = _paged_check(ranks(2), "exact-tq1")
    q, k, v, table, qpos, _, _ = paged_case("exact-tq1")
    ref, jbytes = _jax_accounted(lambda: paged_tree_decode(
        *(jnp.asarray(x) for x in (q, k, v, table)), mesh=cpu_mesh(2),
        q_position=jnp.asarray(qpos)))
    _close(got, ref, TOL_F32)
    assert nbytes == jbytes


def test_paged_tree_decode_int8_matches_unsharded(ranks):
    """The int8 slices (per-block scales sharded with the pool) merge to
    the unsharded int8 partial, which ``test_torch_seq_shard`` holds
    against JAX's ``paged_local_partial``."""
    _paged_check(ranks(2), "int8-tq2")


def test_mesh_shards_seq_only(ranks):
    for r in ranks(2):
        assert "slice 4b" in r["data_axis_error"]


# -- one process: the mesh rules ---------------------------------------------

def test_single_process_mesh_and_its_errors():
    m = tmesh.make_mesh()
    assert m.shape == {"seq": 1} and m.coords == {"seq": 0}
    assert m.group("seq") is None and m.size == 1
    assert tmesh.make_mesh({"data": 1, "seq": -1}).shape == {"data": 1,
                                                             "seq": 1}
    with pytest.raises(ValueError, match="need 2 ranks"):
        tmesh.make_mesh({"seq": 2})
    x = torch.arange(12).reshape(3, 4)
    assert torch.equal(tmesh.shard_along(m, x, "seq", 1), x)
    assert tmesh.prune_axes(m, {"data": "data", "seq": "seq",
                                "model": None}) == {
        "data": None, "seq": "seq", "model": None}


def test_rank_device_rules(monkeypatch):
    info = tmesh.DistInfo(rank=1, world_size=2, local_rank=1,
                          local_world_size=2, init_method="env://")
    assert tmesh.rank_device("cpu", "gloo", info) == torch.device("cpu")
    with pytest.raises(ValueError, match="nccl backend needs CUDA"):
        tmesh.rank_device("cpu", "nccl", info)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    # NCCL: one card per rank, else an error; gloo may share the card.
    with pytest.raises(RuntimeError, match="one card per rank"):
        tmesh.rank_device("cuda", "nccl", info)
    assert tmesh.rank_device("cuda", "gloo", info) == torch.device("cuda", 0)


def test_dist_info_reads_both_launch_contracts(monkeypatch):
    for n in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "TA_COORDINATOR", "TA_NUM_PROCESSES", "JAX_PROCESS_INDEX"):
        monkeypatch.delenv(n, raising=False)
    assert tmesh.dist_info() == tmesh.DistInfo(0, 1, 0, 1, None)
    monkeypatch.setenv("TA_COORDINATOR", "localhost:1234")
    with pytest.raises(RuntimeError, match="missing"):
        tmesh.dist_info()
    monkeypatch.setenv("TA_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_INDEX", "3")
    assert tmesh.dist_info() == tmesh.DistInfo(3, 4, 3, 4,
                                               "tcp://localhost:1234")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert tmesh.dist_info() == tmesh.DistInfo(1, 2, 1, 2, "env://")
