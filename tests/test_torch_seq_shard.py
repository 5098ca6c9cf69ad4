"""The port's sequence-sharded paged pool against the JAX package's (CPU).

Rank ``r`` of ``W`` holds global block ids ``[r N/W, (r+1) N/W)``; each rank
runs B2 with ``local_blocks`` over its own blocks under a signed local table
and the partials merge across ranks (``tests/test_torch_parallel.py`` holds
the merge). Here:

- ``ShardedBlockAllocator`` hands out the same ids as JAX's under one
  alloc/free sequence (richest shard first, global reservations);
- B2's plain ``local_blocks`` version, the wrapper on a CPU tensor and
  ``paged_local_partial`` (exact, and int8 under per-block scales) against
  JAX's ``paged_local_partial`` and ``attention_pallas_decode(local_blocks=
  True, interpret=True)``: signed tables, an all-remote row exactly ``(0,
  -inf)``. Tolerance: JAX's own for f32, 2e-5;
- the seq-sharded ``SlotServer`` at W = 2 (two spawned ranks over gloo) is
  token-identical to the port's replicated serve and to JAX's
  ``SlotServer(mesh=cpu_mesh(2), kv_shard="seq")``, exact and int8, with
  both ranks' tokens equal, each rank's pool half the whole pool's, the
  pools drained, and exactly 1 MAX + 2 SUM per layer and step issued (int8:
  plus the one SUM per step that carries the anchor scales); int8 under
  whole-prompt admission equals JAX's ``admission="whole"`` on the mesh;
- ``--mode serve --mesh seq=2 --kv-shard seq`` and ``--mode decode --mesh
  seq=2`` through the CLI on two processes: only rank 0 prints.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import run_ranks
from tree_attention_tpu_torch import models as tm
from tree_attention_tpu_torch import serving as ts
from tree_attention_tpu_torch.ops import cuda_decode as cd
from tree_attention_tpu_torch.ops.decode import paged_local_partial
from tree_attention_tpu_torch.serving.block_pool import (
    ShardedBlockAllocator as TSharded,
)
from tests.torch_threads import few_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_F32 = 2e-5

T_CFG = tm.TransformerConfig(
    vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=192, dtype=torch.float32,
)
# Chunks of two 4-token blocks: each chunk's blocks land on both ranks
# (richest shard first), so every slot's keys are split over the ranks.
ENGINE_KW = dict(slots=2, cache_len=32, prefill_chunk=8, prefill_budget=16,
                 kv_block=4)
TRACE_KW = dict(n_requests=3, prompt_len=12, prompt_jitter=3,
                max_new_tokens=5, vocab_size=256, seed=1)


def _tokens(report):
    return {r.uid: list(map(int, r.tokens)) for r in report.results}


# -- the ledger --------------------------------------------------------------

def test_sharded_allocator_hands_out_jax_ids():
    from tree_attention_tpu.serving.block_pool import (
        ShardedBlockAllocator as JSharded,
    )

    rng = np.random.default_rng(0)
    pools = [JSharded(12, 3), TSharded(12, 3)]
    held = [[], []]
    for _ in range(60):
        grow = not held[0] or (len(held[0]) < 12 and rng.random() < 0.6)
        pick = int(rng.integers(len(held[0]))) if held[0] else 0
        for a, h in zip(pools, held):
            if grow:
                assert a.reserve(1)
                h.append(a.alloc())
            else:
                a.free_private(h.pop(pick))
        assert held[0] == held[1]
        assert pools[0].free_per_shard() == pools[1].free_per_shard()
        assert pools[0].used_per_shard() == pools[1].used_per_shard()
    t = pools[1]
    assert [t.shard_of(b) for b in range(12)] == [0] * 4 + [1] * 4 + [2] * 4
    # Richest first: a growing slot interleaves over the shards.
    a = TSharded(8, 2)
    assert a.reserve(6)
    assert [a.shard_of(a.alloc()) for _ in range(6)] == [0, 1, 0, 1, 0, 1]
    with pytest.raises(ValueError, match="does not split"):
        TSharded(10, 4)


# -- B2 local_blocks and the per-rank partial --------------------------------

def _local_case(seed, Tq, quant):
    """A rank's slice of 6 blocks under a signed table: held entries mixed
    with -1 (another rank's block); row 1 is all remote."""
    rng = np.random.default_rng(seed)
    B, Hq, Hkv, D, blk, Nl = 3, 4, 2, 16, 4, 6
    if quant:
        k = rng.integers(-127, 128, size=(Nl, Hkv, blk, D)).astype(np.int8)
        v = rng.integers(-127, 128, size=(Nl, Hkv, blk, D)).astype(np.int8)
        ks = rng.uniform(0.005, 0.03, size=(Nl, Hkv)).astype(np.float32)
        vs = rng.uniform(0.005, 0.03, size=(Nl, Hkv)).astype(np.float32)
    else:
        k = rng.standard_normal((Nl, Hkv, blk, D)).astype(np.float32)
        v = rng.standard_normal((Nl, Hkv, blk, D)).astype(np.float32)
        ks = vs = None
    tbl = np.asarray([[0, -1, 3, -1], [-1, -1, -1, -1], [5, 2, -1, 1]],
                     np.int32)
    q = rng.standard_normal((B, Hq, Tq, D)).astype(np.float32)
    qpos = np.asarray([9, 4, 15 - Tq + 1], np.int32)
    return q, k, v, tbl, qpos, ks, vs


def _close(port, ref, atol=TOL_F32):
    (o, l), (ro, rl) = port, ref
    o, l = o.numpy(), l.numpy()
    ro, rl = np.asarray(ro, np.float32), np.asarray(rl)
    np.testing.assert_allclose(o, ro, atol=atol, rtol=0)
    np.testing.assert_array_equal(np.isneginf(l), np.isneginf(rl))
    fin = np.isfinite(rl)
    np.testing.assert_allclose(l[fin], rl[fin], atol=atol, rtol=0)


@pytest.mark.parametrize("tq", [1, 3])
def test_b2_local_blocks_plain_matches_jax(tq):
    import jax
    import jax.numpy as jnp

    from tree_attention_tpu.ops.decode import paged_local_partial as jplp
    from tree_attention_tpu.ops.pallas_decode import attention_pallas_decode

    q, k, v, tbl, qpos, _, _ = _local_case(0, tq, False)
    jx = [jnp.asarray(x) for x in (q, k, v, tbl, qpos)]
    ref = jax.jit(jplp)(*jx[:4], q_position=jx[4])
    ker = attention_pallas_decode(*jx[:3], causal=True, q_offset=jx[4],
                                  kv_offset=0, block_table=jx[3],
                                  local_blocks=True, interpret=True)
    t = [torch.from_numpy(x) for x in (q, k, v, tbl, qpos)]
    plain = cd.paged_decode_plain(*t[:4], q_offset=t[4], local_blocks=True)
    _close(plain, ref)
    _close(plain, ker)
    # The wrapper on a CPU tensor is the plain version; so is the partial.
    wrap = cd.attention_cuda_decode_paged(*t[:4], q_offset=t[4],
                                          local_blocks=True)
    part = paged_local_partial(*t[:4], q_position=t[4])
    for got in (wrap, part):
        assert all(torch.equal(a, b) for a, b in zip(got, plain))
    # The all-remote row is the merge identity, exactly.
    assert torch.all(plain[0][1] == 0)
    assert torch.all(torch.isneginf(plain[1][1]))
    # Without the flag the remote entries would be read as block 0: the
    # comparison has teeth.
    wrong = cd.paged_decode_plain(*t[:2], t[2], t[3].clamp(min=0),
                                  q_offset=t[4])
    assert (wrong[0] - plain[0]).abs().max() > 0.1


def test_paged_local_partial_int8_matches_jax():
    import jax
    import jax.numpy as jnp

    from tree_attention_tpu.ops.decode import paged_local_partial as jplp

    q, k, v, tbl, qpos, ks, vs = _local_case(1, 2, True)
    jx = [jnp.asarray(x) for x in (q, k, v, tbl, qpos, ks, vs)]
    ref = jax.jit(jplp)(*jx[:4], q_position=jx[4], k_scale=jx[5],
                        v_scale=jx[6])
    t = [torch.from_numpy(x) for x in (q, k, v, tbl, qpos, ks, vs)]
    got = paged_local_partial(*t[:4], q_position=t[4], k_scale=t[5],
                              v_scale=t[6])
    _close(got, ref)
    assert torch.all(torch.isneginf(got[1][1]))


# -- the seq-sharded engine --------------------------------------------------

def _rank_serve(rank, world, np_params):
    """Serve the trace exact and int8 (and int8 under whole-prompt
    admission) from this rank's slice of the pool; returns per mode the
    tokens, the collectives per layer and step, the
    pool bytes and the leak report."""
    from tree_attention_tpu_torch.parallel import COLLECTIVES, make_mesh

    mesh = make_mesh({"seq": world})
    params = tm.params_from_jax(np_params, device="cpu")
    out = {}
    for quant in (False, True, "whole"):
        c0 = dict(COLLECTIVES)
        # "whole": int8 under whole-prompt admission (the B=1 prefill is
        # whole on each rank; the insert writes the rank's blocks).
        server = ts.SlotServer(params, T_CFG, mesh=mesh, kv_shard="seq",
                               quantize=bool(quant),
                               admission="whole" if quant == "whole"
                               else "chunked", **ENGINE_KW)
        rep = server.serve(ts.synthetic_trace(**TRACE_KW))
        colls = {k: v - c0.get(k, 0) for k, v in COLLECTIVES.items()
                 if v - c0.get(k, 0)}
        out[quant] = {"tokens": _tokens(rep), "outcomes": rep.outcomes,
                      "steps": rep.steps, "colls": colls,
                      "pool_bytes": server.pool_bytes(),
                      "blocks": server.cache.blocks,
                      "leaks": server.leak_report(), "kv": rep.kv}
    return out


@pytest.fixture(scope="module")
def jax_params():
    import jax

    from tree_attention_tpu import models as jm
    from tests.torch_params import seeded_params, to_numpy

    cfg = jm.TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=192, dtype=jax.numpy.float32)
    jp, tp = seeded_params(T_CFG)
    return cfg, jp, jax.tree.map(to_numpy, tp)


@pytest.fixture(scope="module")
def sharded_serves(jax_params, tmp_path_factory):
    return run_ranks(2, _rank_serve, tmp_path_factory.mktemp("serve"),
                     jax_params[2])


@pytest.mark.parametrize("quant", [False, True], ids=["exact", "int8"])
def test_seq_sharded_server_matches_replicated_and_jax(jax_params,
                                                       sharded_serves,
                                                       quant):
    from tree_attention_tpu import serving as js
    from tree_attention_tpu.parallel.mesh import cpu_mesh

    jcfg, jp, np_params = jax_params
    ranks = [r[quant] for r in sharded_serves]
    tparams = tm.params_from_jax(np_params, device="cpu")
    rep_server = ts.SlotServer(tparams, T_CFG, quantize=quant, **ENGINE_KW)
    rep = rep_server.serve(ts.synthetic_trace(**TRACE_KW))
    jref = js.SlotServer(jp, jcfg, mesh=cpu_mesh(2), kv_shard="seq",
                         quantize=quant, **ENGINE_KW).serve(
        js.synthetic_trace(**TRACE_KW))
    want = _tokens(rep)
    assert want == _tokens(jref)
    for r in ranks:
        assert r["tokens"] == want  # both ranks, the same tokens
        assert r["outcomes"] == {"budget": TRACE_KW["n_requests"]}
        assert r["leaks"] == {"blocks_private": 0, "blocks_used": 0,
                              "blocks_reserved": 0, "blocks_cached": 0,
                              "pins": 0}
        # Half the whole pool on each rank.
        assert 2 * r["pool_bytes"] == rep_server.pool_bytes()
        assert r["blocks"] == rep_server.kv_blocks // 2
        assert r["kv"]["free_per_shard"] == [r["blocks"]] * 2
        # 1 MAX + 2 SUM per layer and step; int8 adds the anchor SUM.
        n = T_CFG.n_layers * r["steps"]
        want_colls = {("paged_tree_decode", "pmax"): n,
                      ("paged_tree_decode", "psum_num"): n,
                      ("paged_tree_decode", "psum_den"): n}
        if quant:
            want_colls[("paged_anchor_scales", "psum")] = r["steps"]
        assert r["colls"] == want_colls


def test_seq_sharded_whole_admission_matches_jax(jax_params,
                                                 sharded_serves):
    """Whole-prompt admission on the sharded int8 pool (tests/
    test_serving_seq_shard.py's ``(True, "whole")`` case): both ranks'
    tokens equal JAX's ``SlotServer(mesh=cpu_mesh(2), kv_shard="seq",
    admission="whole")``; the prefill runs on each rank's whole B=1 cache,
    so every collective is the decode steps' (1 MAX + 2 SUM per layer, the
    anchor SUM per step); the pools drain."""
    from tree_attention_tpu import serving as js
    from tree_attention_tpu.parallel.mesh import cpu_mesh

    jcfg, jp, _ = jax_params
    jref = js.SlotServer(jp, jcfg, mesh=cpu_mesh(2), kv_shard="seq",
                         quantize=True, admission="whole",
                         **ENGINE_KW).serve(js.synthetic_trace(**TRACE_KW))
    for r in (x["whole"] for x in sharded_serves):
        assert r["tokens"] == _tokens(jref)
        assert r["outcomes"] == {"budget": TRACE_KW["n_requests"]}
        assert r["leaks"]["blocks_used"] == r["leaks"]["blocks_reserved"] == 0
        n = T_CFG.n_layers * r["steps"]
        assert r["colls"] == {("paged_tree_decode", "pmax"): n,
                              ("paged_tree_decode", "psum_num"): n,
                              ("paged_tree_decode", "psum_den"): n,
                              ("paged_anchor_scales", "psum"): r["steps"]}


def test_seq_shard_rejects_the_contiguous_layout():
    params = tm.init_params(T_CFG, 0, "cpu")
    with pytest.raises(ValueError, match="paged"):
        ts.SlotServer(params, T_CFG, kv_shard="seq", kv_layout="contiguous",
                      slots=2, cache_len=16)


# -- the CLI on two processes ------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cli_pair(args, timeout=120):
    """Run the CLI as ranks 0 and 1 of a gloo job (torchrun's
    environment); returns both processes' stdout. A rank that fails or
    hangs fails the test."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items()
               if k not in ("PYTHONPATH", "CUDA_VISIBLE_DEVICES")}
        env.update(PYTHONPATH=ROOT, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tree_attention_tpu_torch", *args],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


SMALL = ["--device", "cpu", "--model-dim", "32", "--heads", "2",
         "--n-layers", "1", "--vocab-size", "64", "--dtype", "float32",
         "--temperature", "0", "--log-level", "warning", "--mesh", "seq=2"]


def test_cli_on_a_two_rank_mesh_prints_from_rank_zero_only():
    out0, out1 = _cli_pair(SMALL + [
        "--mode", "serve", "--kv-shard", "seq", "--kv-quant", "int8",
        "--slots", "2", "--requests", "3", "--prompt-len", "12",
        "--prompt-jitter", "4", "--max-new-tokens", "3", "--prefill-chunk",
        "8", "--kv-block", "8"])
    assert out1.strip() == ""
    rec = json.loads(out0.strip().splitlines()[-1])
    assert rec["mesh"] == {"seq": 2} and rec["kv_shard"] == "seq"
    assert rec["dist_backend"] == "gloo" and rec["kv_quant"] == "int8"
    assert rec["outcomes"] == {"budget": 3}
    assert rec["kv"]["shards"] == 2 and rec["leaks"]["blocks_used"] == 0
    out0, out1 = _cli_pair(SMALL + [
        "--mode", "decode", "--seq-len", "64", "--head-dim", "16",
        "--kv-quant", "int8", "--iters", "2", "--warmup", "1"])
    assert out1.strip() == ""
    rec = json.loads(out0.strip().splitlines()[-1])
    assert rec["name"] == "tree_decode_q8q"
    assert rec["workload"]["mesh"] == {"seq": 2}
    # Each rank streams its own half of the 64-token int8 cache.
    assert rec["kv_bytes"] == 2 * 1 * 2 * 32 * 16


# -- on the card -------------------------------------------------------------

@pytest.mark.gpu
def test_b2_local_blocks_kernel_matches_plain_on_gpu():
    """B2 with local_blocks on the card against its plain version (bf16;
    each query row within 2e-2 of its largest |out|, lse within 1e-3), exact
    and int8 with per-block scales; the all-remote row exactly (0, -inf)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode (the plain versions are tested above)")
    for quant in (False, True):
        q, k, v, tbl, qpos, ks, vs = _local_case(2, 1, quant)
        dev = torch.device("cuda")
        qt = torch.from_numpy(q).to(dev, torch.bfloat16)
        kt, vt = (torch.from_numpy(x).to(dev) for x in (k, v))
        if not quant:
            kt, vt = kt.to(torch.bfloat16), vt.to(torch.bfloat16)
        sc = {} if ks is None else {"block_scales": (
            torch.from_numpy(ks).to(dev), torch.from_numpy(vs).to(dev))}
        args = (qt, kt, vt, torch.from_numpy(tbl).to(dev))
        qo = torch.from_numpy(qpos).to(dev)
        o, lse = cd.attention_cuda_decode_paged(*args, q_offset=qo,
                                                local_blocks=True, **sc)
        po, pl = cd.paged_decode_plain(*args, q_offset=qo, local_blocks=True,
                                       **sc)
        torch.cuda.synchronize()
        row = po.float().abs().amax(-1, keepdim=True)
        assert torch.all((o.float() - po.float()).abs() <= 2e-2 * row)
        fin = torch.isfinite(pl)
        assert torch.equal(torch.isneginf(lse), torch.isneginf(pl))
        assert (lse[fin] - pl[fin]).abs().max() <= 1e-3
        assert torch.all(o[1] == 0) and torch.all(torch.isneginf(lse[1]))
