"""On-card smoke test of the PyTorch + CUDA port (one NVIDIA H100).

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, any
failure exits non-zero:

1. Build the CUDA kernels from ``tree_attention_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together), print the card, each
   kernel's registers and spills, and the HGMMA instructions in the SASS
   of the tensor-core bodies of B3 and B6 (``cuobjdump -sass``; none is a
   failure).
2. Hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (bf16; each query row's out within 2e-2 of that row's
   largest |out|, i.e. about two bf16 ulps, and lse within 1e-3 — P is
   rounded to bf16 on both sides; at the reference shape the gate is shown
   to reject an output halved and one split's keys dropped) and time kernel,
   plain
   version, and ``scaled_dot_product_attention`` on the same function as a
   yardstick (the port never calls it) — device time of each call's kernels
   from ``torch.profiler``, the larger of two traced runs (CUDA events if
   it traces nothing or reads below the bound), L2 flushed before each
   call — beside the least time the card could take (bytes /
   3.35 TB/s or FLOPs / 989 TFLOP/s, the larger). B3 also at the training
   shape (B2 H16 T4096 causal); at the serve-chunk shape the gate is shown
   to reject each row's causal frontier shifted by one key.
   Then the backward kernels B6 (dq) and B7 (dk, dv) against their plain
   versions at the training shape, a GQA shape with a query offset, a
   ragged Tq/Tk shape and a KV offset that is not tile-aligned (each row of
   each gradient within 2e-2 of that row's largest |plain value|, a dq row
   whose query sees exactly one key within the f32 rounding bound of its
   cancellation instead, their |d| printed beside it; at the training
   shape the gate is shown to reject dv halved, B7 skipping each KV tile's
   first live Q tile and B6's causal frontier shifted by one key), timed
   beside SDPA's backward; then every body that ships off its tile edges
   (B3, B6, B7 in bf16 and f32, D 64 and 128, Tq 5 and 130 against Tk
   300, GQA, a negative and an unaligned offset, causal and not) under the
   same gates; and
   B3, B6, B7 timed at B1 H16 T16384 causal (no plain version there); and
   the gradients of the Tq < 128 training route (B1 forward, blockwise
   backward) against its plain forward, under the same row gate.
   The int8 routes under the same row gate: B4 at the reference workload
   and at GQA Hq32 Hkv8 Tq16 with per-batch offsets and a ragged Tk, B5 at
   the serve decode tick with per-block and with channel scales, B1 over
   int8 K/V (the cast route) at the reference workload and B2 over int8
   pools with per-block scales at the serve tick. Bound: the visible int8
   K+V bytes (plus Q, scales, output) / 3.35 TB/s, or the products at the
   int8 (q8q q.k) and bf16 rates; no PyTorch call computes int8-KV
   attention, so SDPA over the dequantized bf16 K/V is timed as a labelled
   yardstick. At B5's serve shape the gate is shown to reject per-block
   scales read by logical block, the V scalar applied before the softmax
   sum, and an output halved.
   B2 with ``local_blocks`` (one rank's slice of a sequence-sharded pool
   under a signed table) at the serve tick (B8 H16 Tq1, 640-token slots)
   and a 64-row chunk, exact bf16 and int8 with per-block scales, over 80
   blocks sharded W = 2 and 4 ways with tables drawn as
   ``ShardedBlockAllocator`` hands blocks out: every rank's call under the
   row gate, rank 0's timed against its bound (the keys it holds / 3.35
   TB/s), the W partials merged by the in-process monoid against unsharded
   B2, an all-remote row exactly ``(0, -inf)``, and the gate shown
   rejecting remote entries read as block 0. Per-shard ``tree_decode`` at
   the reference workload: B1 over W = 2 and 4 KV shards with their
   offsets, and B4 over the shards of the channel-quantized K/V, merged
   against the unsharded B1 / B4 under the same gate.
3. Serve 16 requests through the paged, chunked SlotServer (the CLI's
   ``--mode serve`` entry point) at the reference attention width (d_model
   2048, 16 heads x 128, d_ff 5504, vocab 32768, bf16, depth cut to 4
   layers, random weights from a seed); check every request retires with
   its budget, the pool drains, the paged decode (B2) and Q-tiled (B3)
   kernels ran, and one mixed step's logits and written KV match the plain
   path on the same cache (logits within 0.1: bf16 activations, relative
   precision ~4e-3, through 4 layers at a logit scale ~1; KV within 2e-2 of
   the pool's largest |value|). The serve step's device time is split by
   kernel group from a traced wave, against the same wave's untraced wall.
   Then int8: 16 requests through ``cli.main --mode serve --kv-quant
   int8`` (staged admission, the paged int8 cache): every request retires
   with its budget, the pool drains, B5 launched once per layer and int8
   step, B1/B3 for the staged chunks; 4 requests on the contiguous int8
   cache (B4 once per layer and int8 step) and 4 through ``--kv-quant
   int8-cast`` (B2 with per-block scales once per layer and int8 step);
   the 8-request wave again on an
   int8 cache, its device time split (B5 apart) and its greedy tokens
   against the exact wave's (reported); and one int8 decode step, kernel
   path against plain path on clones of one per-block-quantized cache, for
   both q8 routes (logits within 0.1, block scales equal, written codes
   equal in layer 0 and within 2 codes beyond it; the code gate shown
   rejecting new rows quantized under the next head's block scale). The
   int8 serves run with the metrics registry off, as the exact serve does;
   their int8 steps are the report's decode ticks (one step over the int8
   cache each).
   Then two ranks on the one card (spawned processes on ``cuda:0`` over
   gloo; NCCL refuses two ranks on one device): ``--mesh seq=2 --kv-shard
   seq`` at the same width, exact and ``--kv-quant int8`` (16 requests
   each): every request retires with its budget, each rank's pool drains
   and holds half the whole pool's bytes, B2 ``local_blocks`` launches
   once per layer and step on each rank (nothing else reads the sharded
   pool), exactly 1 MAX + 2 SUM all-reduces per layer and step (int8: plus
   one SUM per step for the anchor scales), both ranks' tokens equal; one
   mixed step's merged logits within 0.1 of the single-rank path on the
   same logical cache; greedy agreement with the single-rank serve
   reported; and ``--mode decode --mesh seq=2`` at the reference workload
   (its time: two ranks sharing one card, not a scaling figure).
4. Time ``--mode decode`` at the reference workload (B=1, 16 heads x 128,
   64000 KV tokens, one query) through the contiguous decode kernel (B1),
   and with ``--kv-quant int8`` (B4) and ``int8-cast`` (B1 over int8 K/V);
   each step's median at or above its KV bytes / 3.35 TB/s.
5. Train through the CLI's ``--mode train`` (``cli.main`` in process) at
   the serve phase's model (T 4096, B 2, 4 steps, then 1 + 3 timed): every
   loss finite, and B6/B7 launched exactly once per layer per step, B3
   twice (forward and its recomputation under remat).
6. One step's gradients at depth 2, kernel path against plain path on the
   same parameters and batch: every parameter's |g_kernel - g_plain| /
   |g_plain| within 2e-2, the losses within 1e-2.
7. Split one training step's device time by kernel group from a traced
   step, against the median wall of three untraced steps (the idle share),
   with the steps' peak device memory.
8. Print the total wall, the kernels line, then ``{"ok": true, "device":
   {...}}`` last.

Extra per-case numbers go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
INT8_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor-core peak
TOL_OUT_REL, TOL_LSE = 2e-2, 1e-3  # out: relative to each row's max |out|
TOL_LOGITS = 0.1
TOL_KV_REL = 2e-2  # written KV: relative to the pool's max |value|
# Written int8 codes of one step, kernel path vs plain path: equal in layer
# 0 (same inputs), and beyond it, where the bf16 activations entering a
# layer differ by the previous layers' attention rounding, within the
# written-KV gate above in codes: 2e-2 of a block's 127-code range, 2 codes.
TOL_CODES = int(TOL_KV_REL * 127)
# dq/dk/dv: each row within 2e-2 of that row's largest |plain value| (about
# two bf16 ulps: both sides round ds and p to bf16 before the products).
# A dq row whose query sees exactly one key is 0 by cancellation (p = 1 and
# O = V there, so dO.V^T - delta = 0) and holds only f32 rounding, which two
# correct summation orders do not share: those rows alone are held to the
# rounding bound of cuda_bwd.dq_one_key_bound instead. The rule lives in
# cuda_bwd.grad_rows_close, which the GPU tests hold too.
TOL_GRAD_REL = 2e-2
# One training step, kernel path vs plain path: per-parameter gradient norm
# ratio, and the loss.
TOL_STEP_GRAD, TOL_STEP_LOSS = 2e-2, 1e-2
SERVE_ARGS = [
    "--mode", "serve", "--model-dim", "2048", "--heads", "16",
    "--n-layers", "4", "--vocab-size", "32768", "--dtype", "bfloat16",
    "--slots", "8", "--requests", "16", "--prompt-len", "512",
    "--prompt-jitter", "64", "--max-new-tokens", "64",
    "--prefill-chunk", "256", "--kv-layout", "paged", "--kv-block", "64",
    "--temperature", "0",
]
TRAIN_ARGS = [
    "--mode", "train", "--model-dim", "2048", "--heads", "16",
    "--n-layers", "4", "--vocab-size", "32768", "--seq-len", "4096",
    "--batch", "2", "--steps", "4", "--dtype", "bfloat16", "--iters", "3",
]


def causal_pairs(B: int, Hq: int, Tq: int, Tk: int, q_offset: int,
                 kv_offset: int) -> int:
    """Visible (query, key) pairs of causal attention with scalar offsets,
    summed over batch rows and query heads."""
    return B * Hq * sum(min(Tk, max(0, q_offset + i - kv_offset + 1))
                        for i in range(Tq))


def ptxas_summary(build) -> dict:
    """``{kernel<dtype,D>: [registers, spill-store bytes]}`` of the forward
    and backward kernels (B3, B6, B7), from the ``-Xptxas -v`` log the
    build keeps beside each library. The tensor-core bodies are bf16 only
    (``*_wgmma_kernel<D>``)."""
    import re

    out = {}
    for lib in ("flash_fwd", "flash_bwd"):
        log = build._target(lib).with_suffix(".log").read_text()
        for block in log.split("Compiling entry function")[1:]:
            name = re.search(r"(flash_(?:fwd|dq|dkv)(?:_wgmma)?_kernel)I"
                             r"(13__nv_bfloat16|f|)Li(\d+)E", block)
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            if name and regs:
                dtype = "f32" if name.group(2) == "f" else "bf16"
                key = f"{name.group(1)}<{dtype},{name.group(3)}>"
                out[key] = [int(regs.group(1)),
                            int(spill.group(1)) if spill else 0]
    return out


def hgmma_counts(build) -> dict:
    """``{mangled kernel name: HGMMA instructions}`` of the tensor-core
    bodies (``*_wgmma_kernel``) in the built B3 and B6 libraries, from the
    toolkit's ``cuobjdump -sass``: the proof that their products run on
    the tensor cores."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for lib in ("flash_fwd", "flash_bwd"):
        sass = subprocess.run([tool, "-sass", str(build._target(lib))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        for block in sass.split("Function : ")[1:]:
            name = block.split(None, 1)[0]
            if "wgmma_kernel" in name:
                out[name] = sum("HGMMA" in line
                                for line in block.splitlines())
    return out


MESH_ARGS = ["--mesh", "seq=2", "--dist-backend", "gloo"]
DECODE_MESH_ARGS = ["--mode", "decode", "--iters", "20"]
SHARDED_TIMEOUT_S = 600


def _sharded_rank(rank: int, world: int, port: int, device: str,
                  serve_args: list, decode_args: list) -> dict:
    """One rank of the two-rank phase: the sharded serve exact and int8
    through ``cli.run_serve`` (what ``cli.main`` runs once the group
    forms), one mixed step against the single-rank path on the same
    logical cache, and ``cli.main --mode decode`` on the mesh. ``device``
    "cpu" with small arguments rehearses it without the card."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch
    import torch.distributed as dist

    from tree_attention_tpu_torch import cli
    from tree_attention_tpu_torch.models import (
        forward_step,
        init_paged_cache,
    )
    from tree_attention_tpu_torch.ops import cuda_attention, cuda_decode
    from tree_attention_tpu_torch.parallel import (
        COLLECTIVES,
        initialize_distributed,
        make_mesh,
    )
    from tree_attention_tpu_torch.serving import ShardedBlockAllocator
    from tree_attention_tpu_torch.utils.config import parse_args

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, created = initialize_distributed("gloo", device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    mesh = make_mesh({"seq": world})
    b2 = cuda_decode.attention_cuda_decode_paged
    counters = {
        "flash_decode": (cuda_decode.attention_cuda_decode, "launches"),
        "flash_decode_paged": (b2, "launches"),
        "flash_decode_paged_local": (b2, "local_launches"),
        "flash_decode_paged_q8q": (
            cuda_decode.attention_cuda_decode_paged_q8q, "launches"),
        "flash_fwd": (cuda_attention.attention_cuda_fwd, "launches"),
    }
    out = {}
    try:
        for label, extra in (("exact", []), ("int8", ["--kv-quant", "int8"])):
            cfg = parse_args(serve_args + MESH_ARGS + ["--kv-shard", "seq"]
                             + extra)
            for fn, attr in counters.values():
                setattr(fn, attr, 0)
            c0 = dict(COLLECTIVES)
            t0 = time.monotonic()
            rec, server, rep = cli.run_serve(cfg, dev, mesh)
            sync()
            wall = time.monotonic() - t0
            tcfg = server.cfg
            elem = (1 if server.quantize
                    else torch.empty(0, dtype=tcfg.dtype).element_size())
            whole = (2 * tcfg.n_layers * server.kv_blocks * tcfg.n_kv_heads
                     * server.kv_block * tcfg.d_head * elem
                     + (2 * tcfg.n_layers * server.kv_blocks
                        * tcfg.n_kv_heads * 4 if server.quantize else 0))
            out[label] = {
                "rec": rec, "wall_s": wall,
                "launches": {n: getattr(fn, a)
                             for n, (fn, a) in counters.items()},
                "colls": {f"{a}/{c}": v - c0.get((a, c), 0)
                          for (a, c), v in COLLECTIVES.items()
                          if v - c0.get((a, c), 0)},
                "tokens": {r.uid: r.tokens for r in rep.results},
                "pool_bytes": server.pool_bytes(),
                "whole_pool_bytes": whole,
            }
            if label == "exact":
                params = server.params
            del server
        # One mixed step on the same logical cache: the whole pool filled by
        # the single-rank path, this rank's slice copied out of it, then
        # decode rows, a 256-row chunk, a short chunk and an inert slot.
        B, nb, blk = 8, 10, 64
        npool = B * nb
        alloc = ShardedBlockAllocator(npool, world)
        alloc.reserve(npool)
        table = torch.tensor([[alloc.alloc() for _ in range(nb)]
                              for _ in range(B)], dtype=torch.int32,
                             device=dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        pre = torch.randint(0, tcfg.vocab_size, (B, 256), generator=gen,
                            device=dev)
        toks = torch.randint(0, tcfg.vocab_size, (B, 256), generator=gen,
                             device=dev)
        n0 = torch.tensor([256, 17, 0, 200, 64, 1, 256, 128], device=dev,
                          dtype=torch.int32)
        n1 = torch.tensor([1, 1, 256, 40, 0, 1, 100, 1], device=dev,
                          dtype=torch.int32)
        whole = init_paged_cache(tcfg, B, nb * blk, npool, block=blk,
                                 device=dev)
        whole.table.copy_(table)
        _, whole = forward_step(params, pre, whole, tcfg, n_tokens=n0)
        kw = dict(mesh=mesh, kv_shard="seq")
        part = init_paged_cache(tcfg, B, nb * blk, npool, block=blk,
                                device=dev, **kw)
        nl = part.blocks
        lo = mesh.axis_index("seq") * nl
        part.k[:, :nl] = whole.k[:, lo:lo + nl]
        part.v[:, :nl] = whole.v[:, lo:lo + nl]
        part.table.copy_(table)
        part.length.copy_(whole.length)
        lg_sharded, _ = forward_step(params, toks, part, tcfg, n_tokens=n1,
                                     **kw)
        lg_single, _ = forward_step(params, toks, whole, tcfg, n_tokens=n1)
        valid = torch.arange(256, device=dev)[None] < n1[:, None]
        out["mixed"] = {"logits_err": (lg_sharded[valid] - lg_single[valid]
                                       ).abs().max().item()}
        del whole, part, params
        # The reference workload's decode on the mesh through cli.main (the
        # group exists, so main leaves it to this function).
        b1 = cuda_decode.attention_cuda_decode
        b1.launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(decode_args + MESH_ARGS)
        sync()
        lines = buf.getvalue().strip().splitlines()
        out["decode"] = json.loads(lines[-1]) if rank == 0 else None
        out["decode_printed"] = bool(lines)
        out["decode_launches"] = b1.launches
    finally:
        if created:
            dist.destroy_process_group()
    return out


def _sharded_rank_main(rank, world, port, out_q, *args) -> None:
    try:
        out_q.put((rank, True, _sharded_rank(rank, world, port, *args)))
    except BaseException:  # reported to the parent, which fails
        import traceback

        out_q.put((rank, False, traceback.format_exc()))


def run_sharded_ranks(world: int = 2, device: str = "cuda",
                      serve_args: list = SERVE_ARGS,
                      decode_args: list = DECODE_MESH_ARGS) -> list:
    """Spawn ``world`` ranks on ``cuda:0`` over gloo and return their
    results in rank order; a rank that raises, dies or outlives
    ``SHARDED_TIMEOUT_S`` fails the script, and every rank still running
    is killed."""
    import multiprocessing
    import queue
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=_sharded_rank_main,
                         args=(r, world, port, out_q, device, serve_args,
                               decode_args))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + SHARDED_TIMEOUT_S
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                fail(f"sharded ranks did not finish within "
                     f"{SHARDED_TIMEOUT_S} s")
            try:
                rank, ok, payload = out_q.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    fail(f"sharded ranks {dead} died")
                continue
            if not ok:
                fail(f"sharded rank {rank} raised:\n{payload}")
            results[rank] = payload
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
            if p.exitcode != 0:
                fail(f"a sharded rank exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    if results[1]["decode_printed"]:
        fail("rank 1 printed a decode record: only rank 0 prints")
    return [results[r] for r in range(world)]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    t_start = time.monotonic()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.nn.functional as F

    from tree_attention_tpu_torch import cli
    from tree_attention_tpu_torch.models import (
        forward_step,
        init_paged_cache,
    )
    from tree_attention_tpu_torch.ops import _build, cuda_attention
    from tree_attention_tpu_torch.ops import cuda_bwd, cuda_decode
    from tree_attention_tpu_torch.ops import flash_attention
    from tree_attention_tpu_torch.ops.block_utils import first_live_q
    from tree_attention_tpu_torch.ops.tuning import DKV_TILES
    from tree_attention_tpu_torch.ops.cuda_decode import gather_paged_kv
    from tree_attention_tpu_torch.serving import SlotServer, synthetic_trace
    from tree_attention_tpu_torch.utils.config import parse_args

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. build ---------------------------------------------------------
    t0 = time.monotonic()
    secs = _build.build()
    print(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
          f"wall {time.monotonic() - t0:.2f}s", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)  # the card's name and power limit, as given
    ptxas = ptxas_summary(_build)
    print(f"ptxas (registers, spill-store bytes): {json.dumps(ptxas)}",
          flush=True)
    hgmma = hgmma_counts(_build)
    print(f"SASS HGMMA instructions of the tensor-core bodies: "
          f"{json.dumps(hgmma)}", flush=True)
    for body in ("flash_fwd_wgmma", "flash_dq_wgmma"):
        if not any(body in n and c > 0 for n, c in hgmma.items()):
            fail(f"no HGMMA instruction in {body}_kernel's SASS")

    # -- 2. kernels against their plain versions ---------------------------
    g = torch.Generator(device=dev).manual_seed(0)
    flush_buf = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    cuda_act = torch.profiler.ProfilerActivity.CUDA
    cuda_dev = torch.autograd.DeviceType.CUDA

    def device_kernels(prof):
        """(name, ms) of every kernel the trace saw on the card."""
        return [(e.name, e.time_range.elapsed_us() / 1e3)
                for e in prof.events() if e.device_type == cuda_dev]

    def time_ms(fn, floor_ms, iters=10, names=None):
        """Device time of one call: the summed duration of the kernels it
        runs on the card (torch.profiler; with ``names``, only the kernels
        whose name holds one of them), mean of ``iters`` calls with the
        L2 flushed before each (a serving step finds the layer's KV cold);
        host launch gaps are excluded. The profiler on the card's machine
        now and then loses kernels, and a lost kernel only lowers a
        reading, so the larger of two traced runs is kept. ``floor_ms`` is
        the least time the card could take for the call's work (its bound):
        a reading below it has still lost kernels, and then — or if the
        profiler traces no device time — the median of CUDA events around
        each call is taken instead (launch gaps included); a reading still
        below the floor fails the run. Returns ``(ms, clock, call_ms)``:
        ``call_ms`` is every kernel of the same calls (or the CUDA-event
        time)."""
        fn()
        torch.cuda.synchronize()
        total = mine = 0.0
        for _ in range(2):
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, cuda_act]) as prof:
                for _ in range(iters):
                    flush_buf.zero_()
                    fn()
                torch.cuda.synchronize()
            kernels = [(n, ms) for n, ms in device_kernels(prof)
                       if "FillFunctor<unsigned char>" not in n]
            run = sum(ms for _, ms in kernels)
            if run > total:
                total = run
                mine = sum(ms for n, ms in kernels
                           if names is None or any(x in n for x in names))
        if mine / iters >= floor_ms:
            return mine / iters, "profiler", total / iters
        if total > 0:
            print(f"time_ms: profiler read {mine / iters:.4f} ms, below "
                  f"the {floor_ms:.4f} ms bound; timing with CUDA events",
                  flush=True)
        times = []
        for _ in range(iters):
            flush_buf.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        ms = sorted(times)[len(times) // 2]
        if ms < floor_ms:
            fail(f"a call timed {ms:.4f} ms, below its {floor_ms:.4f} ms "
                 f"bound")
        return ms, "cuda_events", ms

    def gate(a, b):
        """Hold ``a = (out, lse)`` against the plain ``b``: every query
        row's |dout| within TOL_OUT_REL of that row's largest plain |out|
        (an empty row must be exactly 0 on both sides), the same empty
        rows, |dlse| within TOL_LSE. Returns ``(ok, |dout|, relative
        |dout|, |dlse|)``."""
        (o1, l1), (o2, l2) = a, b
        if not (torch.isfinite(o1).all() and o1.shape == o2.shape):
            return False, math.inf, math.inf, math.inf
        d = (o1.float() - o2.float()).abs()
        row = o2.float().abs().amax(-1, keepdim=True)
        rel = (d / row.clamp_min(1e-30)).max().item()
        fin = torch.isfinite(l2)
        el = (l1[fin] - l2[fin]).abs().max().item() if fin.any() else 0.0
        ok = (torch.equal(torch.isneginf(l1), torch.isneginf(l2))
              and rel <= TOL_OUT_REL and el <= TOL_LSE)
        return ok, d.max().item(), rel, el

    def visible_pairs(qoff, tq, tk):
        """Sum over batch rows and queries of keys visible under the causal
        rule (kv_offset 0): min(tk, qoff + t + 1)."""
        return sum(max(0, min(tk, int(o) + t + 1))
                   for o in qoff.tolist() for t in range(tq))

    def gqa_mask(qoff, tq, tk):
        pos = qoff[:, None].long() + torch.arange(tq, device=dev)
        return (torch.arange(tk, device=dev)[None, None] <= pos[..., None]
                )[:, None]  # (B, 1, Tq, Tk) bool

    cases = []

    def record(kernel, name, fn, plain, library, bytes_, flops, *,
               ops_s=None, yardstick=None, names=None):
        """Gate ``fn`` against ``plain`` and time both beside the bound
        (bytes / HBM rate or the operations' time — ``flops`` at the bf16
        rate, or ``ops_s`` seconds — the larger) and ``library``, one
        PyTorch call of the same function (None where there is none; then
        ``yardstick`` is timed instead, a labelled near-equivalent). With
        ``names`` ``ms`` counts only the kernel's own launches and
        ``call_ms`` the whole call's."""
        a, b = fn(), plain()
        torch.cuda.synchronize()
        ok, eo, er, el = gate(a, b)
        if not ok:
            fail(f"{kernel} {name}: |dout| {eo:.3e}, relative {er:.3e} "
                 f"(tol {TOL_OUT_REL}), |dlse| {el:.3e} (tol {TOL_LSE})")
        t_ops = flops / BF16_FLOPS_PER_S if ops_s is None else ops_s
        bound = max(bytes_ / HBM_BYTES_PER_S, t_ops) * 1e3
        ms, clock, call_ms = time_ms(fn, bound, names=names)
        plain_ms, plain_clock, _ = time_ms(plain, bound, iters=3)
        lib_ms, lib_clock, _ = (time_ms(library, bound)
                                if library is not None else (None,) * 3)
        c = {
            "kernel": kernel, "case": name, "max_abs_err": eo,
            "max_rel_err": er, "max_abs_err_lse": el, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound,
            "bound_by": ("bytes" if bytes_ / HBM_BYTES_PER_S >= t_ops
                         else "operations"),
            "clocks": [clock, plain_clock, lib_clock],
        }
        if names is not None:
            c["call_ms"] = call_ms
        if yardstick is not None:
            c["yardstick_sdpa_dequant_ms"] = time_ms(yardstick, bound)[0]
        cases.append(c)
        lib = (f"sdpa {lib_ms:.4f}" if lib_ms is not None else
               f"library none, sdpa over dequantized bf16 "
               f"{c.get('yardstick_sdpa_dequant_ms', math.nan):.4f}")
        print(f"{kernel} {name}: |dout| {eo:.3e} relative {er:.3e} "
              f"|dlse| {el:.3e} (tol {TOL_OUT_REL}/{TOL_LSE}) ms {ms:.4f} "
              + (f"(whole call {c['call_ms']:.4f}) " if names else "")
              + f"plain {plain_ms:.4f} {lib} bound {bound:.4f} "
              f"({c['bound_by']}) clocks {c['clocks']}", flush=True)

    # B1: the reference workload (the --mode decode shape) ...
    q, k, v = rnd(1, 16, 1, 128), rnd(1, 16, 64000, 128), rnd(1, 16, 64000, 128)
    kv_bytes = 2 * k.numel() * 2
    record("flash_decode", "ref B1 H16 Tk64000 Tq1",
           lambda: cuda_decode.attention_cuda_decode(q, k, v),
           lambda: cuda_decode.decode_plain(q, k, v),
           lambda: F.scaled_dot_product_attention(q, k, v),
           kv_bytes + 2 * q.numel() * 2, 4.0 * 16 * 64000 * 128)
    # The gate has teeth at this shape: it rejects an output off by half,
    # and one split's keys left out of the merge (the wrapper cuts 64000
    # keys into splits of 256 here).
    plain = cuda_decode.decode_plain(q, k, v)
    o, l = cuda_decode.attention_cuda_decode(q, k, v)
    half = gate((o * 0.5, l), plain)
    dropped = gate(cuda_decode.decode_plain(q, k[:, :, 256:], v[:, :, 256:]),
                   plain)
    print(f"gate: output halved -> relative |dout| {half[2]:.3e}; one split "
          f"dropped -> |dlse| {dropped[3]:.3e}; both rejected: "
          f"{not (half[0] or dropped[0])}", flush=True)
    if half[0] or dropped[0]:
        fail("the parity gate accepts a planted fault at the reference shape")
    del plain, o, l
    # ... and a ragged GQA batch.
    for tq in (1, 16):
        q, k, v = rnd(8, 32, tq, 128), rnd(8, 8, 4096, 128), rnd(8, 8, 4096, 128)
        qoff = torch.randint(0, 4096 - tq, (8,), generator=g, device=dev,
                             dtype=torch.int32)
        need = sum(min(4096, int(o) + tq) for o in qoff.tolist())
        mask = gqa_mask(qoff, tq, 4096)
        record("flash_decode", f"GQA B8 Hq32 Hkv8 Tk4096 Tq{tq} ragged",
               lambda: cuda_decode.attention_cuda_decode(
                   q, k, v, causal=True, q_offset=qoff),
               lambda: cuda_decode.decode_plain(q, k, v, causal=True,
                                                q_offset=qoff),
               lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=mask, enable_gqa=True),
               need * 8 * 128 * 2 * 2 + 2 * q.numel() * 2,
               4.0 * 32 * 128 * visible_pairs(qoff, tq, 4096))

    # B2: a fragmented 64-token-block pool at the serve shapes (8 slots,
    # 16 heads x 128, 10-block tables = 640-token slots).
    blk, nb, npool = 64, 10, 96
    kp, vp = rnd(npool, 16, blk, 128), rnd(npool, 16, blk, 128)
    table = torch.stack([torch.randperm(npool, generator=g, device=dev)[:nb]
                         for _ in range(8)]).to(torch.int32)
    for tq in (1, 16, 64):
        q = rnd(8, 16, tq, 128)
        qoff = torch.randint(0, nb * blk - tq, (8,), generator=g, device=dev,
                             dtype=torch.int32)
        need = sum(min(nb * blk, int(o) + tq) for o in qoff.tolist())
        kg, vg = gather_paged_kv(kp, vp, table)
        mask = gqa_mask(qoff, tq, nb * blk)
        record("flash_decode_paged", f"B8 H16 block64 NB10 Tq{tq} ragged",
               lambda: cuda_decode.attention_cuda_decode_paged(
                   q, kp, vp, table, q_offset=qoff),
               lambda: cuda_decode.paged_decode_plain(q, kp, vp, table,
                                                      q_offset=qoff),
               lambda: F.scaled_dot_product_attention(q, kg, vg,
                                                      attn_mask=mask),
               need * 16 * 128 * 2 * 2 + 2 * q.numel() * 2,
               4.0 * 16 * 128 * visible_pairs(qoff, tq, nb * blk))

    # -- 2a. the int8 routes: B4, B5, and B1/B2 over int8 K/V -------------
    # Bound: the visible int8 K+V bytes (to each row's causal frontier),
    # plus Q, the scales and the output; operations: the q.k products at
    # the int8 rate (q8q) or the bf16 rate (cast), the p.v products at the
    # bf16 rate. No PyTorch call computes int8-KV attention (library none);
    # SDPA over the dequantized bf16 K/V is timed as a yardstick: the same
    # result to within quantization, at twice the K/V bytes.
    own = ("decode_split", "merge_splits")

    def q8_ops_s(pairs, q8q):
        qk = INT8_OPS_PER_S if q8q else BF16_FLOPS_PER_S
        return 2.0 * 128 * pairs / qk + 2.0 * 128 * pairs / BF16_FLOPS_PER_S

    def deq(codes, scale):
        return (codes.float() * scale).to(torch.bfloat16)

    q = rnd(1, 16, 1, 128)
    kq, vq, ks, vs = cuda_decode.quantize_kv_channelwise(
        rnd(1, 16, 64000, 128), rnd(1, 16, 64000, 128))
    kd, vd = deq(kq, ks), deq(vq, vs)
    ref_q8_bytes = 2 * kq.numel() + q.numel() * 4 + 4 * ks.numel() * 4
    for kernel, route in (("flash_decode_q8q", "q8q"),
                          ("flash_decode", "q8")):
        record(kernel, "int8 ref B1 H16 Tk64000 Tq1",
               lambda: cuda_decode.resolve_q8_kernel(route)(
                   q, kq, vq, ks, vs),
               lambda: cuda_decode.resolve_q8_kernel(route, plain=True)(
                   q, kq, vq, ks, vs),
               None, ref_q8_bytes, 0.0,
               ops_s=q8_ops_s(16 * 64000, route == "q8q"),
               yardstick=lambda: F.scaled_dot_product_attention(q, kd, vd),
               names=own)
    del kq, vq, kd, vd
    # B4 at GQA with per-batch offsets and a ragged Tk.
    tk = 4037
    q = rnd(8, 32, 16, 128)
    kq, vq, ks, vs = cuda_decode.quantize_kv_channelwise(
        rnd(8, 8, tk, 128), rnd(8, 8, tk, 128))
    qoff = torch.randint(0, tk - 16, (8,), generator=g, device=dev,
                         dtype=torch.int32)
    need = sum(min(tk, int(o) + 16) for o in qoff.tolist())
    kd, vd, mask = deq(kq, ks), deq(vq, vs), gqa_mask(qoff, 16, tk)
    record("flash_decode_q8q", f"int8 GQA B8 Hq32 Hkv8 Tk{tk} Tq16 ragged",
           lambda: cuda_decode.attention_cuda_decode_q8q(
               q, kq, vq, ks, vs, causal=True, q_offset=qoff),
           lambda: cuda_decode.decode_q8q_plain(q, kq, vq, ks, vs,
                                                causal=True, q_offset=qoff),
           None, need * 8 * 128 * 2 + q.numel() * 4 + 4 * ks.numel() * 4,
           0.0, ops_s=q8_ops_s(32 * visible_pairs(qoff, 16, tk), True),
           yardstick=lambda: F.scaled_dot_product_attention(
               q, kd, vd, attn_mask=mask, enable_gqa=True),
           names=own)
    del kq, vq, kd, vd, mask
    # B5 and B2-int8 at the serve decode tick: 8 slots of 640 tokens in
    # 64-token blocks of a fragmented pool, ragged lengths. The pool's
    # blocks carry magnitudes that differ from block to block, so their
    # per-block scales differ as a served cache's do.
    x = (torch.randn((npool, 16, blk, 128), generator=g, device=dev)
         * torch.exp(0.7 * torch.randn((npool, 16, 1, 1), generator=g,
                                       device=dev)))
    kp8, kbs = cuda_decode.quantize_symmetric_int8(
        x.reshape(npool, 16, blk * 128), 2)
    x = (torch.randn((npool, 16, blk, 128), generator=g, device=dev)
         * torch.exp(0.7 * torch.randn((npool, 16, 1, 1), generator=g,
                                       device=dev)))
    vp8, vbs = cuda_decode.quantize_symmetric_int8(
        x.reshape(npool, 16, blk * 128), 2)
    kp8, vp8 = (t.reshape(npool, 16, blk, 128) for t in (kp8, vp8))
    kbs, vbs = kbs[..., 0], vbs[..., 0]
    q = rnd(8, 16, 1, 128)
    qoff = torch.randint(0, nb * blk - 1, (8,), generator=g, device=dev,
                         dtype=torch.int32)
    need = sum(min(nb * blk, int(o) + 1) for o in qoff.tolist())
    mask = gqa_mask(qoff, 1, nb * blk)
    kg, vg = gather_paged_kv(deq(kp8, kbs[..., None, None]),
                             deq(vp8, vbs[..., None, None]), table)
    tick_bytes = need * 16 * 128 * 2 + q.numel() * 4
    serve_q8 = (q, kp8, vp8, table, kbs, vbs, qoff)
    record("flash_decode_paged_q8q", "int8 B8 H16 block64 NB10 Tq1 ragged, "
           "per-block scales",
           lambda: cuda_decode.attention_cuda_decode_paged_q8q(
               q, kp8, vp8, table, kbs, vbs, q_offset=qoff),
           lambda: cuda_decode.paged_decode_q8q_plain(
               q, kp8, vp8, table, kbs, vbs, q_offset=qoff),
           None, tick_bytes + 2 * 8 * nb * 16 * 4, 0.0,
           ops_s=q8_ops_s(16 * visible_pairs(qoff, 1, nb * blk), True),
           yardstick=lambda: F.scaled_dot_product_attention(
               q, kg, vg, attn_mask=mask), names=own)
    record("flash_decode_paged", "int8 B8 H16 block64 NB10 Tq1 ragged, "
           "block_scales",
           lambda: cuda_decode.attention_cuda_decode_paged(
               q, kp8, vp8, table, q_offset=qoff, block_scales=(kbs, vbs)),
           lambda: cuda_decode.paged_decode_plain(
               q, kp8, vp8, table, q_offset=qoff, block_scales=(kbs, vbs)),
           None, tick_bytes + 2 * 8 * nb * 16 * 4, 0.0,
           ops_s=q8_ops_s(16 * visible_pairs(qoff, 1, nb * blk), False),
           yardstick=lambda: F.scaled_dot_product_attention(
               q, kg, vg, attn_mask=mask), names=own)
    cks, cvs = (torch.rand((8, 16, 1, 128), generator=g, device=dev) * 0.03
                + 0.005 for _ in range(2))
    kg, vg = gather_paged_kv(kp8, vp8, table)
    kg, vg = deq(kg, cks), deq(vg, cvs)
    record("flash_decode_paged_q8q", "int8 B8 H16 block64 NB10 Tq1 ragged, "
           "channel scales",
           lambda: cuda_decode.attention_cuda_decode_paged_q8q(
               q, kp8, vp8, table, cks, cvs, q_offset=qoff),
           lambda: cuda_decode.paged_decode_q8q_plain(
               q, kp8, vp8, table, cks, cvs, q_offset=qoff),
           None, tick_bytes + 2 * cks.numel() * 4, 0.0,
           ops_s=q8_ops_s(16 * visible_pairs(qoff, 1, nb * blk), True),
           yardstick=lambda: F.scaled_dot_product_attention(
               q, kg, vg, attn_mask=mask), names=own)
    del kg, vg, mask, x

    # The gate has teeth at B5's serve shape: B5's arithmetic written out
    # here from the gathered view passes it, and with a planted per-block
    # scale fault it is rejected — scales read by logical block j instead
    # of table[b, j], and the V scalar applied before the softmax sum l.
    def q8q_paged_here(fault=None):
        q, kp, vp, tbl, ksc, vsc, qo = serve_q8
        B, NB = tbl.shape
        codes, qs = cuda_decode._fold_quantize_q(q, 16, None, None)
        kg, vg = gather_paged_kv(kp, vp, tbl)
        idx = (torch.arange(NB, device=dev).expand(B, NB)
               if fault == "logical" else tbl.long())
        kk, vk = (sc[idx].transpose(1, 2).repeat_interleave(blk, 2)[
            :, :, None] for sc in (ksc, vsc))
        s = torch.einsum("bhrd,bhkd->bhrk", codes.float(), kg.float()) \
            * qs * kk
        vis = (torch.arange(NB * blk, device=dev)[None, None, None]
               <= qo.long()[:, None, None, None])
        s = s.masked_fill(~vis, -math.inf)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        if fault == "v_early":
            p = p * vk
        den = p.sum(-1)
        if fault != "v_early":
            p = p * vk
        acc = torch.einsum("bhrk,bhkd->bhrd",
                           p.to(torch.bfloat16).float(), vg.float())
        return ((acc / den[..., None]).to(torch.bfloat16).reshape(q.shape),
                (m[..., 0] + torch.log(den)).reshape(q.shape[:3]))

    plain = cuda_decode.paged_decode_q8q_plain(*serve_q8[:6],
                                               q_offset=serve_q8[6])
    teeth = {f: gate(q8q_paged_here(f), plain)
             for f in (None, "logical", "v_early")}
    o, l = cuda_decode.attention_cuda_decode_paged_q8q(
        *serve_q8[:6], q_offset=serve_q8[6])
    teeth["halved"] = gate((o * 0.5, l), plain)
    q8_teeth = {str(f): {"pass": r[0], "rel": r[2], "dlse": r[3]}
                for f, r in teeth.items()}
    print(f"gate at B5's serve shape: written out here {teeth[None][2]:.3e} "
          f"relative (passes: {teeth[None][0]}); scales by logical block -> "
          f"{teeth['logical'][2]:.3e} relative, |dlse| "
          f"{teeth['logical'][3]:.3e}; V scalar before l -> "
          f"{teeth['v_early'][2]:.3e}, |dlse| {teeth['v_early'][3]:.3e}; "
          f"output halved -> {teeth['halved'][2]:.3e}", flush=True)
    if not teeth[None][0] or any(teeth[f][0] for f in
                                 ("logical", "v_early", "halved")):
        fail("the parity gate at B5's serve shape fails its own arithmetic "
             "or accepts a planted fault")
    del plain, o, l, serve_q8, kp8, vp8

    # -- 2b. B2 local_blocks: one rank's slice of a sequence-sharded pool --
    # The serve shapes (8 slots of 640 tokens in 64-token blocks, 16 heads
    # x 128; the tick Tq 1 and a 64-row chunk) over a pool of 80 blocks
    # sharded W = 2 and 4 ways, the table drawn as ShardedBlockAllocator
    # hands blocks out (richest shard first) to slots filled one after the
    # other, so each slot's blocks interleave over the ranks and every row
    # has keys on every rank. Each rank's call is held
    # against its plain version under the row gate, the W partials merged
    # by the in-process monoid against unsharded B2 on the whole pool;
    # exact bf16 and int8 with per-block scales. Timed: rank 0's call,
    # against its bound (the keys it holds up to each row's frontier, K+V,
    # plus Q, the scales it reads and the output / 3.35 TB/s).
    from tree_attention_tpu_torch.ops.reference import merge_partials
    from tree_attention_tpu_torch.serving import ShardedBlockAllocator

    b2 = cuda_decode.attention_cuda_decode_paged
    nb, blk, npool = 10, 64, 80
    pools = {"exact": (rnd(npool, 16, blk, 128), rnd(npool, 16, blk, 128),
                       None)}
    codes = [torch.randint(-127, 128, (npool, 16, blk, 128), generator=g,
                           device=dev, dtype=torch.int8) for _ in range(2)]
    scales = [torch.rand((npool, 16), generator=g, device=dev) * 0.03 + 0.005
              for _ in range(2)]
    pools["int8"] = (codes[0], codes[1], tuple(scales))
    local_merge = {}

    def held_counts(loc, qoff, tq):
        """(keys a rank streams, (query, key) pairs it computes) under a
        signed local table: held keys up to each row's causal frontier."""
        held = (loc >= 0).repeat_interleave(blk, 1)          # (B, K)
        pos = torch.arange(nb * blk, device=dev)
        rows = qoff.long()[:, None] + torch.arange(tq, device=dev)
        vis = (pos[None, None] <= rows[..., None]) & held[:, None]
        keys = (held & (pos[None] <= rows[:, -1:])).sum().item()
        return keys, vis.sum().item()

    for W in (2, 4):
        alloc = ShardedBlockAllocator(npool, W)
        alloc.reserve(npool)
        # Slot by slot, as chunked prefill maps a prompt's blocks: each
        # slot's blocks alternate over the ranks.
        table = torch.tensor([[alloc.alloc() for _ in range(nb)]
                              for _ in range(8)], dtype=torch.int32,
                             device=dev)
        nl = npool // W
        for tq in (1, 64):
            q = rnd(8, 16, tq, 128)
            qoff = torch.randint(0, nb * blk - tq, (8,), generator=g,
                                 device=dev, dtype=torch.int32)
            for kind, (kf, vf, sf) in pools.items():
                int8 = sf is not None
                whole = b2(q, kf, vf, table, q_offset=qoff, block_scales=sf)
                parts = []
                for r in range(W):
                    kr, vr = kf[r * nl:(r + 1) * nl], vf[r * nl:(r + 1) * nl]
                    sr = None if sf is None else tuple(
                        x[r * nl:(r + 1) * nl] for x in sf)
                    loc = table - r * nl
                    loc = torch.where((loc >= 0) & (loc < nl), loc,
                                      -1).to(torch.int32)

                    def fn(kr=kr, vr=vr, loc=loc, sr=sr):
                        return b2(q, kr, vr, loc, q_offset=qoff,
                                  block_scales=sr, local_blocks=True)

                    def plain(kr=kr, vr=vr, loc=loc, sr=sr):
                        return cuda_decode.paged_decode_plain(
                            q, kr, vr, loc, q_offset=qoff, block_scales=sr,
                            local_blocks=True)

                    name = (f"W{W} rank{r} {kind} B8 H16 block64 NB10 Tq{tq} "
                            f"ragged")
                    if r == 0:
                        keys, pairs = held_counts(loc, qoff, tq)
                        elem = 1 if int8 else 2
                        nbytes = (keys * 16 * 128 * elem * 2 + q.numel() * 4
                                  + (int((loc >= 0).sum()) * 16 * 8
                                     if int8 else 0))
                        kg, vg = gather_paged_kv(
                            deq(kr, sr[0][..., None, None]) if int8 else kr,
                            deq(vr, sr[1][..., None, None]) if int8 else vr,
                            loc)
                        held = (loc >= 0).repeat_interleave(blk, 1)
                        mask = gqa_mask(qoff, tq, nb * blk) & \
                            held[:, None, None, :]
                        sdpa = (lambda kg=kg, vg=vg, mask=mask:
                                F.scaled_dot_product_attention(
                                    q, kg, vg, attn_mask=mask))
                        record("flash_decode_paged_local", name, fn, plain,
                               None if int8 else sdpa, nbytes,
                               0.0 if int8 else 4.0 * 128 * pairs * 16,
                               ops_s=(q8_ops_s(16 * pairs, False) if int8
                                      else None),
                               yardstick=sdpa if int8 else None,
                               names=own)
                        del kg, vg, mask
                    else:
                        ok, eo, er, el = gate(fn(), plain())
                        if not ok:
                            fail(f"B2 local_blocks {name}: |dout| {eo:.3e}, "
                                 f"relative {er:.3e}, |dlse| {el:.3e}")
                    parts.append(fn())
                merged = merge_partials(torch.stack([o for o, _ in parts]),
                                        torch.stack([l for _, l in parts]))
                ok, eo, er, el = gate(merged, whole)
                local_merge[f"W{W} {kind} Tq{tq}"] = {
                    "pass": ok, "max_abs_err": eo, "max_rel_err": er,
                    "max_abs_err_lse": el}
                print(f"B2 local_blocks W{W} {kind} Tq{tq}: {W} partials "
                      f"merged vs unsharded B2: |dout| {eo:.3e} relative "
                      f"{er:.3e} |dlse| {el:.3e}", flush=True)
                if not ok:
                    fail(f"B2 local_blocks W{W} {kind} Tq{tq}: merged "
                         f"partials differ from unsharded B2")
    # A row whose every block another rank holds is exactly (0, -inf); and
    # the gate rejects a remote entry read as block 0 (the call without the
    # flag, remote entries clamped to 0: what an unguarded kernel reads).
    kf, vf, _ = pools["exact"]
    kr, vr = kf[:nl], vf[:nl]
    loc = torch.where((table >= 0) & (table < nl), table, -1).to(torch.int32)
    loc[3] = -1
    o, l = b2(q, kr, vr, loc, q_offset=qoff, local_blocks=True)
    identity = bool(torch.all(o[3] == 0) and torch.all(torch.isneginf(l[3])))
    read0 = gate(b2(q, kr, vr, loc.clamp(min=0), q_offset=qoff),
                 cuda_decode.paged_decode_plain(q, kr, vr, loc, q_offset=qoff,
                                                local_blocks=True))
    local_teeth = {"all_remote_row_is_identity": identity,
                   "remote_read_as_block0": {"pass": read0[0],
                                             "rel": read0[2],
                                             "dlse": read0[3]}}
    print(f"B2 local_blocks: all-remote row exactly (0, -inf): {identity}; "
          f"remote entries read as block 0 -> relative |dout| "
          f"{read0[2]:.3e}, |dlse| {read0[3]:.3e}, rejected: "
          f"{not read0[0]}", flush=True)
    if not identity or read0[0]:
        fail("B2 local_blocks: an all-remote row is not (0, -inf), or the "
             "gate accepts remote entries read as block 0")
    del pools, codes, scales, kf, vf, kr, vr, parts, merged, whole, o, l

    # -- 2c. per-shard tree_decode at the reference workload ---------------
    # B1 (H16, Tk 64000, Tq 1, bf16) over W = 2 and 4 KV shards, each with
    # its kv_offset, and B4 over the shards of the channel-quantized K/V
    # (scales of the whole sequence); the merged partials against the
    # unsharded B1 / B4 under the row gate.
    q = rnd(1, 16, 1, 128)
    k, v = rnd(1, 16, 64000, 128), rnd(1, 16, 64000, 128)
    kq, vq, ks, vs = cuda_decode.quantize_kv_channelwise(k, v)
    tree_merge = {}
    for kind, full, shard_fn in (
            ("B1", cuda_decode.attention_cuda_decode(q, k, v),
             lambda lo, hi: cuda_decode.attention_cuda_decode(
                 q, k[:, :, lo:hi], v[:, :, lo:hi], kv_offset=lo)),
            ("B4", cuda_decode.attention_cuda_decode_q8q(q, kq, vq, ks, vs),
             lambda lo, hi: cuda_decode.attention_cuda_decode_q8q(
                 q, kq[:, :, lo:hi], vq[:, :, lo:hi], ks, vs,
                 kv_offset=lo))):
        for W in (2, 4):
            step = 64000 // W
            parts = [shard_fn(r * step, (r + 1) * step) for r in range(W)]
            merged = merge_partials(torch.stack([o for o, _ in parts]),
                                    torch.stack([l for _, l in parts]))
            ok, eo, er, el = gate(merged, full)
            tree_merge[f"{kind} W{W}"] = {"pass": ok, "max_abs_err": eo,
                                          "max_rel_err": er,
                                          "max_abs_err_lse": el}
            print(f"tree_decode shards, reference workload, {kind} W{W}: "
                  f"merged vs unsharded |dout| {eo:.3e} relative {er:.3e} "
                  f"|dlse| {el:.3e}", flush=True)
            if not ok:
                fail(f"tree_decode {kind} W{W}: merged shards differ from "
                     f"the unsharded kernel")
    del q, k, v, kq, vq, ks, vs, parts, merged

    # B3: a Tq=256 prefill chunk against a 2k-token gathered view.
    q, k, v = rnd(8, 16, 256, 128), rnd(8, 16, 2048, 128), rnd(8, 16, 2048, 128)
    qoff = torch.randint(0, 2048 - 256, (8,), generator=g, device=dev,
                         dtype=torch.int32)
    need = sum(min(2048, int(o) + 256) for o in qoff.tolist())
    mask = gqa_mask(qoff, 256, 2048)
    record("flash_fwd", "B8 H16 Tq256 Tk2048 ragged",
           lambda: cuda_attention.attention_cuda_fwd(
               q, k, v, causal=True, q_offset=qoff),
           lambda: cuda_attention.fwd_plain(q, k, v, causal=True,
                                            q_offset=qoff),
           lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
           need * 16 * 128 * 2 * 2 + 2 * q.numel() * 2,
           4.0 * 16 * 128 * visible_pairs(qoff, 256, 2048))
    # The gate has teeth for B3's tiling: it rejects each row's causal
    # frontier shifted by one key (the plain version at q_offset + 1).
    shift = gate(cuda_attention.fwd_plain(q, k, v, causal=True,
                                          q_offset=qoff + 1),
                 cuda_attention.fwd_plain(q, k, v, causal=True,
                                          q_offset=qoff))
    print(f"gate: B3's frontier shifted by one key -> relative |dout| "
          f"{shift[2]:.3e}, |dlse| {shift[3]:.3e}; rejected: "
          f"{not shift[0]}", flush=True)
    if shift[0]:
        fail("the parity gate accepts B3's frontier shifted by one key")
    del q, k, v, kp, vp, mask
    # ... and the training forward: B2 H16 T4096 causal (the train phase's
    # attention shape).
    q, k, v = (rnd(2, 16, 4096, 128) for _ in range(3))
    record("flash_fwd", "train B2 H16 T4096 causal",
           lambda: cuda_attention.attention_cuda_fwd(q, k, v, causal=True),
           lambda: cuda_attention.fwd_plain(q, k, v, causal=True),
           lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
           4 * q.numel() * 2 + 2 * 16 * 4096 * 4,
           4.0 * 128 * causal_pairs(2, 16, 4096, 4096, 0, 0))
    del q, k, v
    torch.cuda.empty_cache()

    # -- 2b. the backward kernels B6 and B7 against their plain versions ---
    def gate_rows(got, want, one_key=None):
        """Every row of each gradient (dq rows per query, dk/dv rows per
        key) within TOL_GRAD_REL of that row's largest plain |value| (a row
        that is 0 in the plain version must be exactly 0); with ``one_key``
        (``cuda_bwd.dq_one_key_bound``) dq's one-key rows within their
        rounding bound. Returns ``(ok, max |d|, max relative |d|)``."""
        return cuda_bwd.grad_rows_close(got, want, TOL_GRAD_REL, one_key)

    def bwd_inputs(B, Hq, Hkv, Tq, Tk, qo, ko):
        q, k, v = rnd(B, Hq, Tq, 128), rnd(B, Hkv, Tk, 128), rnd(B, Hkv, Tk,
                                                                 128)
        dout = rnd(B, Hq, Tq, 128)
        out, lse = cuda_attention.attention_cuda_fwd(  # gated above
            q, k, v, causal=True, q_offset=qo, kv_offset=ko)
        lse_f, delta = cuda_bwd.bwd_residuals(out, lse, dout)
        return q, k, v, dout, lse_f, delta

    def sdpa_bwd(q, k, v, dout, qo, ko):
        """SDPA's backward on the same inputs (flash backend for the plain
        causal square, a boolean mask otherwise): the yardstick only."""
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        Tq, Tk = q.shape[2], k.shape[2]
        if qo == 0 and ko == 0 and Tq == Tk and q.shape[1] == k.shape[1]:
            o = F.scaled_dot_product_attention(*leaves, is_causal=True)
        else:
            pos = torch.arange(Tq, device=dev)[:, None] + qo
            mask = torch.arange(Tk, device=dev)[None] + ko <= pos
            o = F.scaled_dot_product_attention(
                *leaves, attn_mask=mask, enable_gqa=q.shape[1] != k.shape[1])
        return lambda: torch.autograd.grad(o, leaves, dout,
                                           retain_graph=True)

    def bwd_bound(nbytes, flops):
        t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
        return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"

    def record_bwd(name, shape, with_plain=True):
        B, Hq, Hkv, Tq, Tk, qo, ko = shape
        q, k, v, dout, lse_f, delta = bwd_inputs(*shape)
        kw = dict(causal=True, q_offset=qo, kv_offset=ko)
        one_key = (cuda_bwd.dq_one_key_bound(q, k, v, dout, delta, **kw)
                   if with_plain else None)
        pairs = causal_pairs(B, Hq, Tq, Tk, qo, ko)
        io = (q.numel() + dout.numel()) * 2 + 2 * lse_f.numel() * 4
        kv = 2 * k.numel() * 2
        # SDPA's backward does the whole gradient: at least the q.k, dO.v,
        # ds.k, ds^T.q and p^T.dO products, 10 * pairs * D FLOPs.
        lib_ms, lib_clock, _ = time_ms(
            sdpa_bwd(q, k, v, dout, qo, ko),
            bwd_bound(io + 3 * kv + q.numel() * 2, 10.0 * pairs * 128)[0],
            iters=5)
        for kernel, fn, plain, nbytes, flops in (
                ("flash_dq",
                 lambda: (cuda_bwd.attention_cuda_dq(
                     q, k, v, dout, lse_f, delta, **kw),),
                 lambda: (cuda_bwd.dq_plain(q, k, v, dout, lse_f, delta,
                                            **kw),),
                 io + kv + q.numel() * 2, 6.0 * pairs * 128),
                ("flash_dkv",
                 lambda: cuda_bwd.attention_cuda_dkv(
                     q, k, v, dout, lse_f, delta, **kw),
                 lambda: cuda_bwd.dkv_plain(q, k, v, dout, lse_f, delta,
                                            **kw),
                 io + 2 * kv, 8.0 * pairs * 128)):
            bound, bound_by = bwd_bound(nbytes, flops)
            c = {"kernel": kernel, "case": name, "bound_ms": bound,
                 "bound_by": bound_by, "library_ms": lib_ms}
            if with_plain:
                ok, eabs, erel = gate_rows(fn(), plain(), one_key if
                                           kernel == "flash_dq" else None)
                if not ok:
                    fail(f"{kernel} {name}: |d| {eabs:.3e}, relative "
                         f"{erel:.3e} (tol {TOL_GRAD_REL})")
                c["plain_ms"], plain_clock, _ = time_ms(plain, bound,
                                                        iters=3)
                c.update(max_abs_err=eabs, max_rel_err=erel)
            else:
                plain_clock = None
                c.update(plain_ms=None, max_abs_err=None, max_rel_err=None)
            c["ms"], clock, _ = time_ms(fn, bound, iters=5)
            c["clocks"] = [clock, plain_clock, lib_clock]
            cases.append(c)
            print(f"{kernel} {name}: |d| {c['max_abs_err']} relative "
                  f"{c['max_rel_err']} (tol {TOL_GRAD_REL}) ms {c['ms']:.4f} "
                  f"plain {c['plain_ms']} sdpa_bwd {lib_ms:.4f} bound "
                  f"{bound:.4f} ({bound_by}) clocks {c['clocks']}",
                  flush=True)
        return q, k, v, dout, lse_f, delta

    train_shape = (2, 16, 16, 4096, 4096, 0, 0)
    tq_in = record_bwd("train B2 H16 T4096 causal", train_shape)
    for name, shape in (
            ("GQA B2 Hq32 Hkv8 Tq2048 Tk2048 q_offset1000",
             (2, 32, 8, 2048, 2048, 1000, 0)),
            ("ragged B2 H16 Tq100 Tk300 q_offset200",
             (2, 16, 16, 100, 300, 200, 0)),
            ("unaligned B2 H16 T256 kv_offset100",
             (2, 16, 16, 256, 256, 0, 100))):
        record_bwd(name, shape)
    # The gate has teeth at the training shape: it rejects dv halved, and
    # B7 leaving out each KV tile's first live Q tile.
    q, k, v, dout, lse_f, delta = tq_in
    want = cuda_bwd.dkv_plain(q, k, v, dout, lse_f, delta, causal=True)
    dk, dv = cuda_bwd.attention_cuda_dkv(q, k, v, dout, lse_f, delta,
                                         causal=True)
    halved = gate_rows((dk, dv * 0.5), want)
    # ... and B6's causal frontier shifted by one key (the plain dq at
    # q_offset 1, on the same lse and delta).
    dq_shift = gate_rows(
        (cuda_bwd.dq_plain(q, k, v, dout, lse_f, delta, causal=True,
                           q_offset=1),),
        (cuda_bwd.dq_plain(q, k, v, dout, lse_f, delta, causal=True),),
        cuda_bwd.dq_one_key_bound(q, k, v, dout, delta, causal=True))
    # What B7 would give without each KV tile's first live Q tile: the
    # plain dk/dv less that (Q tile, KV tile) pair's share, which is the
    # plain version on the pair's rows and keys at their offsets.
    bq, bk = DKV_TILES["bfloat16"]
    share = ([], [])
    for ki in range(4096 // bk):
        qi = first_live_q(ki, bq, bk, 0, 0, 4096 // bq)
        rows, keys = slice(qi * bq, (qi + 1) * bq), slice(ki * bk,
                                                           (ki + 1) * bk)
        for acc, part in zip(share, cuda_bwd.dkv_plain(
                q[:, :, rows], k[:, :, keys], v[:, :, keys], dout[:, :, rows],
                lse_f[:, :, rows], delta[:, :, rows], causal=True,
                q_offset=qi * bq, kv_offset=ki * bk)):
            acc.append(part.float())
    skipped = gate_rows(tuple(w.float() - torch.cat(acc, 2)
                              for w, acc in zip(want, share)), want)
    print(f"gate: dv halved -> relative |d| {halved[2]:.3e}; B7's first "
          f"live Q tile skipped -> relative |d| {skipped[2]:.3e}; B6's "
          f"frontier shifted by one key -> relative |d| {dq_shift[2]:.3e}; "
          f"all rejected: {not (halved[0] or skipped[0] or dq_shift[0])}",
          flush=True)
    if halved[0] or skipped[0] or dq_shift[0]:
        fail("the gradient gate accepts a planted fault at the training "
             "shape")
    # The one-key dq rows at the training shape (row 0 of every head): the
    # kernel against the plain version there, beside their bound, and the
    # row gate without the one-key rule (reported, not gated).
    rows, bound = cuda_bwd.dq_one_key_bound(q, k, v, dout, delta, causal=True)
    dq_k = cuda_bwd.attention_cuda_dq(q, k, v, dout, lse_f, delta, causal=True)
    dq_p = cuda_bwd.dq_plain(q, k, v, dout, lse_f, delta, causal=True)
    sel = rows.expand_as(bound)
    d1 = (dq_k.float() - dq_p.float()).abs()[sel]
    one_key_rows = {
        "max_abs_diff": d1.max().item(),
        "max_abs_plain": dq_p.float().abs()[sel].max().item(),
        "min_bound": bound[sel].min().item(),
        "max_diff_over_bound": (d1 / bound[sel]).max().item(),
        "strict_row_gate_pass": gate_rows((dq_k,), (dq_p,))[0]}
    print(f"B6's one-key dq rows (train shape): {json.dumps(one_key_rows)}",
          flush=True)
    del rows, bound, dq_k, dq_p, sel, d1
    del q, k, v, dout, lse_f, delta, tq_in, want, dk, dv, share
    torch.cuda.empty_cache()
    # Every body and instantiation that ships, off its tile edges: B3 and
    # B6/B7 in bf16 (the tensor-core bodies of B3 and B6) and f32 (the
    # CUDA-core bodies), D 64 and 128, Tq 5 and 130 against Tk 300, GQA
    # Hq4 Hkv2, per batch row q_offset -3 (rows that see no key, then one
    # key) or 170 with kv_offset 37 (off every tile edge), causal and not,
    # each against its plain version under the gates above; the residuals
    # come from the plain forward.
    edges = []
    qo_e = torch.tensor([-3, 170], dtype=torch.int32, device=dev)
    ko_e = torch.tensor([0, 37], dtype=torch.int32, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        for D in (64, 128):
            for Tq, causal in ((5, True), (130, True), (130, False)):
                q, dout = (torch.randn(2, 4, Tq, D, generator=g, device=dev
                                       ).to(dtype) for _ in range(2))
                k, v = (torch.randn(2, 2, 300, D, generator=g, device=dev
                                    ).to(dtype) for _ in range(2))
                kw = dict(causal=causal, q_offset=qo_e, kv_offset=ko_e)
                want = cuda_attention.fwd_plain(q, k, v, **kw)
                f_ok, _, f_rel, f_lse = gate(
                    cuda_attention.attention_cuda_fwd(q, k, v, **kw), want)
                lse_f, delta = cuda_bwd.bwd_residuals(*want, dout)
                args = (q, k, v, dout, lse_f, delta)
                b_ok, _, b_rel = gate_rows(
                    (cuda_bwd.attention_cuda_dq(*args, **kw),
                     *cuda_bwd.attention_cuda_dkv(*args, **kw)),
                    (cuda_bwd.dq_plain(*args, **kw),
                     *cuda_bwd.dkv_plain(*args, **kw)),
                    cuda_bwd.dq_one_key_bound(q, k, v, dout, delta, **kw))
                edges.append({"dtype": str(dtype).removeprefix("torch."),
                              "D": D, "Tq": Tq, "Tk": 300, "causal": causal,
                              "fwd_rel": f_rel, "fwd_dlse": f_lse,
                              "bwd_rel": b_rel, "ok": f_ok and b_ok})
    torch.cuda.synchronize()
    print(f"tile edges (B3, B6, B7; bf16 and f32, D 64/128, Tq 5/130, Tk "
          f"300): worst out relative "
          f"{max(e['fwd_rel'] for e in edges):.3e}, |dlse| "
          f"{max(e['fwd_dlse'] for e in edges):.3e}, gradient relative "
          f"{max(e['bwd_rel'] for e in edges):.3e}; "
          f"{sum(e['ok'] for e in edges)}/{len(edges)} pass", flush=True)
    bad = [e for e in edges if not e["ok"]]
    if bad:
        fail(f"a kernel differs from its plain version at a tile edge: "
             f"{json.dumps(bad)}")
    del q, k, v, dout, lse_f, delta, want, args
    # BASELINE.json's "causal forward+backward, seq 16384" shape: timing
    # only (the plain versions would materialise 17 GB of scores per array).
    long_shape = (1, 16, 16, 16384, 16384, 0, 0)
    q, k, v = (rnd(1, 16, 16384, 128) for _ in range(3))
    bound, bound_by = bwd_bound(
        4 * q.numel() * 2 + 16 * 16384 * 4,
        4.0 * 128 * causal_pairs(1, 16, 16384, 16384, 0, 0))
    fwd_ms, fwd_clock, _ = time_ms(
        lambda: cuda_attention.attention_cuda_fwd(q, k, v, causal=True),
        bound, iters=3)
    sdpa_ms, sdpa_clock, _ = time_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
        bound, iters=3)
    cases.append({"kernel": "flash_fwd", "case": "long B1 H16 T16384 causal",
                  "ms": fwd_ms, "plain_ms": None, "library_ms": sdpa_ms,
                  "bound_ms": bound, "bound_by": bound_by,
                  "max_abs_err": None, "clocks": [fwd_clock, None,
                                                  sdpa_clock]})
    print(f"flash_fwd long B1 H16 T16384 causal: ms {fwd_ms:.4f} sdpa "
          f"{sdpa_ms:.4f} bound {bound:.4f} ({bound_by})", flush=True)
    del q, k, v
    record_bwd("long B1 H16 T16384 causal", long_shape, with_plain=False)
    del flush_buf
    torch.cuda.empty_cache()
    # The Tq < 128 training route: B1 forward, then the plain blockwise
    # backward (as JAX differentiates its decode kernel), through
    # flash_attention under grad, against the same route's plain forward.
    leaves = [rnd(*s).requires_grad_() for s in
              ((2, 32, 64, 128), (2, 8, 2048, 128), (2, 8, 2048, 128))]
    dout, dlse = rnd(2, 32, 64, 128), rnd(2, 32, 64).float()
    routes = {}
    for impl in ("auto", "plain"):
        o, lse = flash_attention(*leaves, causal=True, q_offset=1984,
                                 impl=impl)
        routes[impl] = torch.autograd.grad(
            (o.float() * dout.float()).sum() + (lse * dlse).sum(), leaves)
    ok, eabs, erel = gate_rows(routes["auto"], routes["plain"])
    print(f"decode-route grads (B1 + blockwise bwd, GQA Hq32 Hkv8 Tq64 "
          f"Tk2048): |d| {eabs:.3e} relative {erel:.3e} (tol "
          f"{TOL_GRAD_REL})", flush=True)
    if not ok:
        fail(f"decode-route grads differ: relative {erel:.3e}")
    del leaves, dout, dlse, routes

    # -- 3. serve through the paged, chunked SlotServer --------------------
    wrappers = {
        "flash_decode": cuda_decode.attention_cuda_decode,
        "flash_decode_paged": cuda_decode.attention_cuda_decode_paged,
        "flash_decode_q8q": cuda_decode.attention_cuda_decode_q8q,
        "flash_decode_paged_q8q": cuda_decode.attention_cuda_decode_paged_q8q,
        "flash_fwd": cuda_attention.attention_cuda_fwd,
        "flash_dq": cuda_bwd.attention_cuda_dq,
        "flash_dkv": cuda_bwd.attention_cuda_dkv,
    }

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    serve_cfg = parse_args(SERVE_ARGS)
    reset_counts()
    t0 = time.monotonic()
    rec, server, serve_rep = cli.run_serve(serve_cfg, dev)
    torch.cuda.synchronize()
    serve_wall = time.monotonic() - t0
    launches = {n: w.launches for n, w in wrappers.items()}
    print(f"serve: {rec['requests']} requests, {rec['tokens_generated']} "
          f"tokens, {rec['tokens_per_sec']} tok/s, ttft_p50 "
          f"{rec['ttft_p50_s']}s, tbt_p50 {rec['tbt_p50_s']}s, tbt_p95 "
          f"{rec['tbt_p95_s']}s, ticks {rec['ticks']}, launches "
          f"{json.dumps(launches)}, wall incl. init {serve_wall:.2f}s",
          flush=True)
    if rec["outcomes"] != {"budget": 16}:
        fail(f"serve outcomes {rec['outcomes']}")
    if rec["tokens_generated"] != 16 * 64:  # every request its 64 tokens
        fail(f"serve generated {rec['tokens_generated']} tokens")
    if any(rec["leaks"][k] for k in rec["leaks"]):
        fail(f"serve leaked: {rec['leaks']}")
    for n in ("flash_decode_paged", "flash_fwd"):
        if launches[n] == 0:
            fail(f"serve never launched {n}")
    single_tokens = {r.uid: r.tokens for r in serve_rep.results}
    single_pool_bytes = server.pool_bytes()

    # Where a serve step's time goes: one more wave (8 requests) on the
    # same weights, served once untraced (its wall) and once traced (its
    # device time; the profiler slows the host, so its own wall is longer).
    tcfg, params = server.cfg, server.params
    trace = synthetic_trace(8, prompt_len=512, prompt_jitter=64,
                            max_new_tokens=64, vocab_size=tcfg.vocab_size,
                            seed=7)

    def wave(**kw):
        engine = SlotServer(params, tcfg, slots=8, cache_len=640,
                            prefill_chunk=256, kv_block=64, **kw)
        rep = engine.serve(trace)
        torch.cuda.synchronize()
        return rep

    matmul = ("nvjet", "gemm", "gemv", "sm90", "cutlass", "cublas")

    def split_by(prof, groups):
        """Device ms of a trace by kernel group (the first group whose
        name fragment a kernel's name holds; "other" else), and by
        kernel."""
        by_kernel = {}
        for name, ms in device_kernels(prof):
            by_kernel[name] = by_kernel.get(name, 0.0) + ms
        split = {g: 0.0 for g in groups}
        split["other"] = 0.0
        for name, ms in by_kernel.items():
            low = name.lower()
            key = next((g for g, keys in groups.items()
                        if any(x.lower() in low for x in keys)), "other")
            split[key] += ms
        return split, by_kernel

    def wave_breakdown(label, groups, **kw):
        """One wave served untraced (its wall) and once traced (its device
        time; the profiler slows the host, so its own wall is longer)."""
        plain_rep = wave(**kw)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            prof_rep = wave(**kw)
        split, by_kernel = split_by(prof, groups)
        busy = sum(split.values())
        wall_ms = plain_rep.wall_s * 1e3
        traced_wall_ms = prof_rep.wall_s * 1e3
        bd = {
            "serve_wall_ms": wall_ms,
            "traced_serve_wall_ms": traced_wall_ms,
            "device_busy_ms": busy,
            "idle_share": (1 - busy / wall_ms) if busy else None,
            "idle_share_of_traced_wall": (1 - busy / traced_wall_ms)
            if busy else None,
            "by_group_ms": split,
            "top_kernels_ms": dict(sorted(by_kernel.items(),
                                          key=lambda kv: -kv[1])[:12]),
            "tokens_per_sec": plain_rep.tokens_per_sec,
            "traced_tokens_per_sec": prof_rep.tokens_per_sec,
        }
        print(f"{label} breakdown (8 requests): "
              + (json.dumps({k: round(v, 3) for k, v in split.items()})
                 + f" busy {busy:.2f} ms (traced) of {wall_ms:.2f} ms "
                 f"untraced wall ({traced_wall_ms:.2f} ms traced), idle "
                 f"share {bd['idle_share']:.4f}"
                 if busy else "device time not measured"), flush=True)
        return plain_rep, bd

    plain_rep, breakdown = wave_breakdown("serve", {
        "flash_decode (B1/B2 + merge)": ("decode_split", "merge_splits"),
        "flash_fwd (B3)": ("flash_fwd",), "matmul": matmul})

    # One mixed step, kernel path vs plain path, on the same cache: slots
    # prefilled to ragged lengths, then decode rows, a 256-row chunk, a
    # short chunk and an inert slot in one step.
    cache = init_paged_cache(tcfg, 8, 640, 80, block=64, device=dev)
    cache.table.copy_(torch.arange(80, device=dev, dtype=torch.int32
                                   ).reshape(8, 10))
    gen = torch.Generator(device=dev).manual_seed(1)
    pre = torch.randint(0, tcfg.vocab_size, (8, 256), generator=gen,
                        device=dev)
    n0 = torch.tensor([256, 17, 0, 200, 64, 1, 256, 128], device=dev,
                      dtype=torch.int32)
    _, cache = forward_step(params, pre, cache, tcfg, n_tokens=n0)
    toks = torch.randint(0, tcfg.vocab_size, (8, 256), generator=gen,
                         device=dev)
    n1 = torch.tensor([1, 1, 256, 40, 0, 1, 100, 1], device=dev,
                      dtype=torch.int32)
    snap = (cache.k.clone(), cache.v.clone())
    lk, ck = forward_step(params, toks, cache, tcfg, n_tokens=n1)
    kv_kernel = (ck.k.clone(), ck.v.clone())
    cache.k.copy_(snap[0])
    cache.v.copy_(snap[1])
    lp, cp = forward_step(params, toks, cache,
                          dataclasses.replace(tcfg, attn_impl="plain"),
                          n_tokens=n1)
    valid = torch.arange(256, device=dev)[None] < n1[:, None]
    logit_err = (lk[valid] - lp[valid]).abs().max().item()
    n_pool = cache.blocks  # block N is the drop target: garbage by design
    kv_err = max((a[:, :n_pool].float() - b[:, :n_pool].float()
                  ).abs().max().item()
                 for a, b in zip(kv_kernel, (cp.k, cp.v)))
    kv_max = max(b[:, :n_pool].float().abs().max().item()
                 for b in (cp.k, cp.v))
    print(f"mixed step: logits |d| {logit_err:.3e} (tol {TOL_LOGITS}), "
          f"written KV |d| {kv_err:.3e} of max |KV| {kv_max:.3e} "
          f"(tol {TOL_KV_REL} x max)", flush=True)
    if not (math.isfinite(logit_err) and logit_err <= TOL_LOGITS):
        fail(f"mixed-step logits differ by {logit_err}")
    if not (math.isfinite(kv_err) and kv_err <= TOL_KV_REL * kv_max):
        fail(f"mixed-step written KV differs by {kv_err} (max |KV| {kv_max})")
    del cache, snap, kv_kernel, lk, lp, ck, cp
    torch.cuda.empty_cache()

    # -- 3b. int8 serve at full width -------------------------------------
    from tree_attention_tpu_torch.models import PagedQuantKVCache

    n_layers = tcfg.n_layers

    def serve_main(argv):
        """``cli.main`` in process, with the metrics registry off as in the
        exact serve: its record, the steps it ran over the int8 cache (each
        decode tick runs one; staged chunks run on the exact staging
        cache), the launches."""
        reset_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        torch.cuda.synchronize()
        rec = json.loads(buf.getvalue().strip().splitlines()[-1])
        return rec, rec["decode_ticks"], {n: w.launches
                                          for n, w in wrappers.items()}

    t0 = time.monotonic()
    q_rec, q_steps, q_launches = serve_main(SERVE_ARGS
                                            + ["--kv-quant", "int8"])
    print(f"int8 serve: {q_rec['requests']} requests, "
          f"{q_rec['tokens_generated']} tokens, {q_rec['tokens_per_sec']} "
          f"tok/s, ttft_p50 {q_rec['ttft_p50_s']}s, ttft_p95 "
          f"{q_rec['ttft_p95_s']}s, tbt_p50 {q_rec['tbt_p50_s']}s, tbt_p95 "
          f"{q_rec['tbt_p95_s']}s, ticks {q_rec['ticks']}, int8 steps "
          f"{q_steps}, launches {json.dumps(q_launches)}, "
          f"wall incl. init {time.monotonic() - t0:.2f}s", flush=True)
    if q_rec["outcomes"] != {"budget": 16} or \
            q_rec["tokens_generated"] != 16 * 64:
        fail(f"int8 serve outcomes {q_rec['outcomes']}, "
             f"{q_rec['tokens_generated']} tokens")
    if any(q_rec["leaks"][k] for k in q_rec["leaks"]):
        fail(f"int8 serve leaked: {q_rec['leaks']}")
    # B5 once per layer and int8 step; staged chunks ran B1 (tails below
    # 128 rows) and B3; the exact paged kernel had nothing to do.
    if not (q_steps > 0 and q_launches["flash_decode_paged_q8q"]
            == n_layers * q_steps):
        fail(f"int8 serve: B5 launched {q_launches['flash_decode_paged_q8q']}"
             f" times over {q_steps} int8 steps")
    if not (q_launches["flash_decode"] and q_launches["flash_fwd"]) or \
            q_launches["flash_decode_paged"]:
        fail(f"int8 serve staged launches {q_launches}")
    c_rec, c_steps, c_launches = serve_main(
        SERVE_ARGS + ["--kv-quant", "int8", "--kv-layout", "contiguous",
                      "--requests", "4", "--max-new-tokens", "16"])
    print(f"int8 serve, contiguous: {c_rec['requests']} requests, "
          f"{c_rec['tokens_generated']} tokens, int8 steps "
          f"{c_steps}, B4 launches "
          f"{c_launches['flash_decode_q8q']}", flush=True)
    if c_rec["outcomes"] != {"budget": 4} or not (
            c_steps > 0 and c_launches["flash_decode_q8q"]
            == n_layers * c_steps):
        fail(f"contiguous int8 serve: {c_rec['outcomes']}, "
             f"{c_launches['flash_decode_q8q']} B4 launches over "
             f"{c_steps} int8 steps")

    x_rec, x_steps, x_launches = serve_main(
        SERVE_ARGS + ["--kv-quant", "int8-cast", "--requests", "4",
                      "--max-new-tokens", "16"])
    print(f"int8-cast serve, paged: {x_rec['requests']} requests, "
          f"{x_rec['tokens_generated']} tokens, int8 steps "
          f"{x_steps}, B2 launches "
          f"{x_launches['flash_decode_paged']}", flush=True)
    if x_rec["outcomes"] != {"budget": 4} or not (
            x_steps > 0 and x_launches["flash_decode_paged"]
            == n_layers * x_steps) or \
            x_launches["flash_decode_paged_q8q"]:
        fail(f"int8-cast serve: {x_rec['outcomes']}, "
             f"{x_launches['flash_decode_paged']} B2 launches over "
             f"{x_steps} int8 steps")

    # The int8 wave: the same 8 requests as the exact wave, on an int8
    # cache; its device time split the same way, B5 apart; and how many of
    # its greedy tokens equal the exact wave's (reported, not gated).
    q8_rep, q8_breakdown = wave_breakdown("int8 serve", {
        "flash_decode_paged_q8q (B5)": ("decode_split_kernel<signed char, "
                                        "signed char",),
        "flash_decode (B1 staged chunks) + merges": ("decode_split",
                                                     "merge_splits"),
        "flash_fwd (B3)": ("flash_fwd",), "matmul": matmul}, quantize=True)
    exact_tok = {r.uid: r.tokens for r in plain_rep.results}
    same = sum(a == b for r in q8_rep.results
               for a, b in zip(r.tokens, exact_tok[r.uid]))
    q8_breakdown["tokens_equal_to_exact"] = same / q8_rep.tokens_generated
    print(f"int8 wave: {same} of {q8_rep.tokens_generated} greedy tokens "
          f"equal the exact wave's ({same / q8_rep.tokens_generated:.4f})",
          flush=True)

    # One int8 decode step, kernel path against plain path, on clones of
    # one paged int8 cache: slots prefilled exactly to ragged lengths
    # (three at a block boundary, so the step enters a block), the pools
    # quantized per block, then one token per slot (slot 2 inert).
    cache = init_paged_cache(tcfg, 8, 640, 80, block=64, device=dev)
    cache.table.copy_(torch.arange(80, device=dev, dtype=torch.int32
                                   ).reshape(8, 10))
    _, cache = forward_step(params, pre, cache, tcfg, n_tokens=n0)

    def per_block(pool):
        codes, sc = cuda_decode.quantize_symmetric_int8(
            pool.reshape(*pool.shape[:3], -1), 3)
        return codes.reshape(pool.shape), sc[..., 0]

    (k8, ks8), (v8, vs8) = per_block(cache.k), per_block(cache.v)
    qcache = PagedQuantKVCache(k=k8, v=v8, table=cache.table,
                               length=cache.length, k_scale=ks8,
                               v_scale=vs8)
    del cache

    def clone(c):
        return dataclasses.replace(c, **{n: getattr(c, n).clone() for n in (
            "k", "v", "k_scale", "v_scale", "length")})

    tok1 = toks[:, :1]
    n_one = torch.tensor([1, 1, 0, 1, 1, 1, 1, 1], device=dev,
                         dtype=torch.int32)
    q8_step = {}
    for route in ("q8q", "q8"):
        lk, ck = forward_step(params, tok1, clone(qcache), tcfg,
                              n_tokens=n_one, quant_kernel=route)
        lp, cp = forward_step(params, tok1, clone(qcache),
                              dataclasses.replace(tcfg, attn_impl="plain"),
                              n_tokens=n_one, quant_kernel=route)
        live = n_one > 0
        n_pool = qcache.blocks
        err = (lk[live] - lp[live]).abs().max().item()
        diff = [(a[:, :n_pool].int() - b[:, :n_pool].int()).abs()
                for a, b in ((ck.k, cp.k), (ck.v, cp.v))]
        codes = max(d.max().item() for d in diff)
        n_off = sum(int((d != 0).sum()) for d in diff)
        layer0_equal = all(int(d[0].max()) == 0 for d in diff)
        scales_equal = all(torch.equal(a[:, :n_pool], b[:, :n_pool])
                           for a, b in ((ck.k_scale, cp.k_scale),
                                        (ck.v_scale, cp.v_scale)))
        # The code gate's teeth: the plain path's new K rows quantized
        # under the next head's scalar of their block (a head-stride fault).
        slots = live.nonzero()[:, 0]
        pos = qcache.length[slots].long()
        pb = qcache.table[slots, pos // qcache.block].long().tolist()
        off = (pos % qcache.block).tolist()
        rows = torch.stack([cp.k[:, b, :, o] for b, o in zip(pb, off)]
                           ).float()
        sc = torch.stack([cp.k_scale[:, b] for b in pb])[..., None]
        planted = torch.clamp(torch.round(rows * sc / sc.roll(1, 2)), -127,
                              127)
        planted_codes = (planted - rows).abs().max().item()
        q8_step[route] = {"logits_err": err, "max_code_diff": codes,
                          "codes_off": n_off, "layer0_codes_equal":
                          layer0_equal, "scales_equal": scales_equal,
                          "planted_next_head_scale_codes": planted_codes}
        print(f"int8 step ({route}), kernel vs plain: logits |d| {err:.3e} "
              f"(tol {TOL_LOGITS}); written codes equal in layer 0: "
              f"{layer0_equal}, within {codes} step(s) in all layers (tol "
              f"{TOL_CODES}; {n_off} codes differ; new rows under the next "
              f"head's block scale read {planted_codes:.0f}); block scales "
              f"equal: {scales_equal}", flush=True)
        if not (math.isfinite(err) and err <= TOL_LOGITS and layer0_equal
                and codes <= TOL_CODES and scales_equal):
            fail(f"int8 step ({route}) kernel and plain paths differ: "
                 f"{q8_step[route]}")
        if planted_codes <= TOL_CODES:
            fail(f"int8 step ({route}): the code gate passes rows quantized "
                 f"under the wrong head's scale ({planted_codes} codes)")
    del server, params, qcache, lk, lp, ck, cp, k8, v8
    torch.cuda.empty_cache()

    # -- 3c. two ranks sharing the card: the sequence-sharded pool ---------
    sharded = run_sharded_ranks()
    sh = {label: [r[label] for r in sharded] for label in ("exact", "int8")}
    for label, ranks in sh.items():
        for rank, r in enumerate(ranks):
            rrec, n_steps = r["rec"], r["rec"]["steps"]
            n_att = n_layers * n_steps
            want_colls = {"paged_tree_decode/pmax": n_att,
                          "paged_tree_decode/psum_num": n_att,
                          "paged_tree_decode/psum_den": n_att}
            if label == "int8":
                want_colls["paged_anchor_scales/psum"] = n_steps
            print(f"sharded serve ({label}), rank {rank} of 2 on one card "
                  f"over gloo: {rrec['requests']} requests, "
                  f"{rrec['tokens_generated']} tokens, {rrec['tokens_per_sec']}"
                  f" tok/s (two ranks sharing one card, not a scaling "
                  f"figure), steps {n_steps}, launches "
                  f"{json.dumps(r['launches'])}, collectives "
                  f"{json.dumps(r['colls'])}, pool bytes {r['pool_bytes']} "
                  f"of {r['whole_pool_bytes']}, wall {r['wall_s']:.2f}s",
                  flush=True)
            if rrec["outcomes"] != {"budget": 16} or \
                    rrec["tokens_generated"] != 16 * 64:
                fail(f"sharded serve ({label}) rank {rank}: outcomes "
                     f"{rrec['outcomes']}, {rrec['tokens_generated']} tokens")
            if any(rrec["leaks"][k] for k in rrec["leaks"]):
                fail(f"sharded serve ({label}) rank {rank} leaked: "
                     f"{rrec['leaks']}")
            if 2 * r["pool_bytes"] != r["whole_pool_bytes"]:
                fail(f"sharded serve ({label}) rank {rank}: pool bytes "
                     f"{r['pool_bytes']}, not half of {r['whole_pool_bytes']}")
            # B2 local_blocks once per layer and step; nothing else attends
            # over the sharded pool (int8: B1/B3 run the staged chunks on
            # the whole staging cache).
            lc = r["launches"]
            if not (n_steps > 0 and lc["flash_decode_paged_local"] == n_att
                    and lc["flash_decode_paged"] == 0
                    and lc["flash_decode_paged_q8q"] == 0):
                fail(f"sharded serve ({label}) rank {rank}: launches {lc} "
                     f"over {n_steps} steps")
            if label == "exact" and lc["flash_fwd"]:
                fail(f"sharded serve (exact) rank {rank} ran B3: {lc}")
            if r["colls"] != want_colls:
                fail(f"sharded serve ({label}) rank {rank}: collectives "
                     f"{r['colls']}, expected {want_colls}")
        if ranks[0]["tokens"] != ranks[1]["tokens"]:
            fail(f"sharded serve ({label}): the ranks' tokens differ")
    if sh["exact"][0]["whole_pool_bytes"] != single_pool_bytes:
        fail(f"sharded serve: whole pool {sh['exact'][0]['whole_pool_bytes']}"
             f" B vs the single-rank serve's {single_pool_bytes} B")
    for rank, r in enumerate(sharded):
        m = r["mixed"]
        print(f"sharded mixed step, rank {rank}: merged logits vs the "
              f"single-rank path on the same logical cache |d| "
              f"{m['logits_err']:.3e} (tol {TOL_LOGITS})", flush=True)
        if not (math.isfinite(m["logits_err"])
                and m["logits_err"] <= TOL_LOGITS):
            fail(f"sharded mixed step, rank {rank}: logits differ by "
                 f"{m['logits_err']}")
    same = sum(a == b for uid, toks in sh["exact"][0]["tokens"].items()
               for a, b in zip(toks, single_tokens[uid]))
    sharded_agree = same / (16 * 64)
    print(f"sharded serve: {same} of {16 * 64} greedy tokens equal the "
          f"single-rank exact serve's ({sharded_agree:.4f}; reported, not "
          f"gated)", flush=True)
    mdec = sharded[0]["decode"]
    floor_ms = mdec["kv_bytes"] / HBM_BYTES_PER_S * 1e3
    print(f"decode on two ranks sharing one card (gloo; two ranks sharing "
          f"one card, not a scaling figure): {mdec['name']} "
          f"{mdec['median_s'] * 1e3:.4f} ms per step ({mdec['clock']}; this "
          f"rank's KV floor {floor_ms:.4f} ms), B1 launches "
          f"{[r['decode_launches'] for r in sharded]}", flush=True)
    if mdec["name"] != "tree_decode" or not all(
            r["decode_launches"] for r in sharded) \
            or mdec["median_s"] * 1e3 < floor_ms:
        fail(f"decode on the mesh: {mdec['name']}, launches "
             f"{[r['decode_launches'] for r in sharded]}, median "
             f"{mdec['median_s']} s")

    # -- 4. decode: the reference workload through B1, then int8 through
    # B4 and through B1 over int8 K/V ---------------------------------------
    decode_recs = {}
    for quant, kernel in (("none", "flash_decode"),
                          ("int8", "flash_decode_q8q"),
                          ("int8-cast", "flash_decode")):
        reset_counts()
        drec = cli.run_decode(parse_args(
            ["--mode", "decode", "--iters", "20", "--kv-quant", quant]), dev)
        n = wrappers[kernel].launches
        floor_ms = drec["kv_bytes"] / HBM_BYTES_PER_S * 1e3
        drec["launches"] = n
        decode_recs[quant] = drec
        print(f"decode ({drec['name']}, kv_quant {quant}): "
              f"{drec['median_s'] * 1e3:.4f} ms per step ({drec['clock']}; "
              f"KV floor {floor_ms:.4f} ms), {drec['tokens_per_sec']} KV "
              f"tokens/s, {kernel} launches {n}", flush=True)
        if n == 0:
            fail(f"decode --kv-quant {quant} never launched {kernel}")
        if drec["median_s"] * 1e3 < floor_ms:
            fail(f"decode --kv-quant {quant}: {drec['median_s']} s is below "
                 f"the KV bytes' floor {floor_ms} ms")
    drec = decode_recs["none"]
    launches["flash_decode"] = decode_recs["none"]["launches"]

    # -- 5. train through the CLI's --mode train ---------------------------
    targs = parse_args(TRAIN_ARGS)
    n_layers = targs.n_layers
    # Steps the run takes: --steps, then the timing's warmup and --iters.
    steps_run = targs.steps + 1 + targs.iters
    reset_counts()
    buf = io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(buf):
        cli.main(TRAIN_ARGS)
    torch.cuda.synchronize()
    train_wall = time.monotonic() - t0
    trec = json.loads(buf.getvalue().strip().splitlines()[-1])
    train_launches = {n: wrappers[n].launches
                      for n in ("flash_fwd", "flash_dq", "flash_dkv")}
    print(f"train: losses {trec['losses']}, {trec['tokens_per_sec']} tok/s, "
          f"step median {trec['median_s'] * 1e3:.2f} ms ({trec['clock']}), "
          f"launches {json.dumps(train_launches)} over {steps_run} steps, "
          f"wall incl. init {train_wall:.2f}s", flush=True)
    if not (len(trec["losses"]) == targs.steps
            and all(math.isfinite(x) for x in trec["losses"])):
        fail(f"train losses {trec['losses']}")
    # B6 and B7 once per layer per backward; B3 twice per layer per step
    # (the forward, and its recomputation under remat in the backward).
    expect = {"flash_fwd": 2 * n_layers * steps_run,
              "flash_dq": n_layers * steps_run,
              "flash_dkv": n_layers * steps_run}
    if train_launches != expect:
        fail(f"train launches {train_launches}, expected {expect}")

    # -- 6. one training step, kernel path against plain path --------------
    from tree_attention_tpu_torch.data import make_lm_batch
    from tree_attention_tpu_torch.models import (
        default_optimizer,
        init_params,
        init_train_state,
        loss_and_grads,
        make_train_step,
        named_params,
    )

    tcfg = cli.transformer_config(targs)
    batch = make_lm_batch(torch.Generator().manual_seed(5), targs.batch,
                          targs.seq_len, tcfg.vocab_size, dev)
    one = {}
    for impl in ("auto", "plain"):
        c = dataclasses.replace(tcfg, n_layers=2, attn_impl=impl)
        p = init_params(c, 0, dev)
        for _, t in named_params(p):
            t.requires_grad_(True)
        loss, grads = loss_and_grads(p, batch, c)
        one[impl] = (float(loss), grads)
        del p
    (loss_k, g_k), (loss_p, g_p) = one["auto"], one["plain"]
    grad_rel = {n: ((g_k[n].float() - g_p[n].float()).norm()
                    / g_p[n].float().norm().clamp_min(1e-30)).item()
                for n in g_p}
    worst = max(grad_rel, key=grad_rel.get)
    print(f"train step, kernels vs plain (2 layers): loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (tol {TOL_STEP_LOSS}); worst gradient "
          f"{worst} |dg|/|g| {grad_rel[worst]:.3e} (tol {TOL_STEP_GRAD})",
          flush=True)
    if not abs(loss_k - loss_p) <= TOL_STEP_LOSS:
        fail(f"kernel-path loss {loss_k} vs plain {loss_p}")
    if not all(r <= TOL_STEP_GRAD for r in grad_rel.values()):
        fail(f"kernel-path gradients differ: {grad_rel}")
    del one, g_k, g_p
    torch.cuda.empty_cache()

    # -- 7. where a training step's time goes ------------------------------
    # Three untraced steps (the median wall) and one traced step (its device
    # time) at the train phase's config, after a warm-up step.
    opt = default_optimizer()
    state = init_train_state(tcfg, opt, seed=0, device=dev)
    step = make_train_step(tcfg, opt)
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(3):  # one wall is at the host's mercy: take the median
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    step_wall_ms = sorted(walls)[1]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        traced_wall_ms = (time.perf_counter() - t0) * 1e3
    tsplit, tby_kernel = split_by(prof, {
        "flash_fwd (B3)": ("flash_fwd",), "flash_dq (B6)": ("flash_dq",),
        "flash_dkv (B7)": ("flash_dkv",), "matmul": matmul})
    tbusy = sum(tsplit.values())
    train_breakdown = {
        "step_wall_ms": step_wall_ms,
        "step_walls_ms": walls,
        "peak_memory_gb": peak_gb,
        "traced_step_wall_ms": traced_wall_ms,
        "device_busy_ms": tbusy,
        "idle_share": (1 - tbusy / step_wall_ms) if tbusy else None,
        "by_group_ms": tsplit,
        "top_kernels_ms": dict(sorted(tby_kernel.items(),
                                      key=lambda kv: -kv[1])[:12]),
    }
    print("train step breakdown: "
          + (json.dumps({k: round(v, 3) for k, v in tsplit.items()})
             + f" busy {tbusy:.2f} ms (traced) of {step_wall_ms:.2f} ms "
             f"median untraced step wall (of {[round(w, 2) for w in walls]}; "
             f"{traced_wall_ms:.2f} ms traced), idle "
             f"share {train_breakdown['idle_share']:.4f}, peak device "
             f"memory {peak_gb:.2f} GB"
             if tbusy else "device time not measured"), flush=True)
    del state, step, batch
    torch.cuda.empty_cache()

    # -- 8. report -------------------------------------------------------
    csrc = "tree_attention_tpu_torch/csrc/"
    meta = {
        "flash_decode": ("cuda", csrc + "flash_decode.cu",
                         "tree_attention_tpu/ops/pallas_decode.py:179"),
        "flash_decode_paged": ("cuda", csrc + "flash_decode.cu",
                               "tree_attention_tpu/ops/pallas_decode.py:344"),
        "flash_decode_q8q": ("cuda", csrc + "flash_decode.cu",
                             "tree_attention_tpu/ops/pallas_decode.py:266"),
        "flash_decode_paged_q8q": (
            "cuda", csrc + "flash_decode.cu",
            "tree_attention_tpu/ops/pallas_decode.py:461"),
        "flash_decode_paged_local": (
            "cuda", csrc + "flash_decode.cu",
            "tree_attention_tpu/ops/pallas_decode.py:344"),
        "flash_fwd": ("cuda", csrc + "flash_fwd.cu",
                      "tree_attention_tpu/ops/pallas_attention.py:65"),
        "flash_dq": ("cuda", csrc + "flash_bwd.cu",
                     "tree_attention_tpu/ops/pallas_bwd.py:84"),
        "flash_dkv": ("cuda", csrc + "flash_bwd.cu",
                      "tree_attention_tpu/ops/pallas_bwd.py:118"),
    }
    # Main-path launches: B1 in the decode phase, B2 in the serve phase, B3
    # in the serve and the train phases, B6/B7 in the train phase, B5 in
    # the int8 serve, B4 in the int8 decode and the contiguous int8 serve.
    main_launches = dict(launches)
    for n, count in train_launches.items():
        main_launches[n] = main_launches.get(n, 0) + count
    main_launches["flash_decode_paged_q8q"] = q_launches[
        "flash_decode_paged_q8q"]
    main_launches["flash_decode_q8q"] = (decode_recs["int8"]["launches"]
                                         + c_launches["flash_decode_q8q"])
    # B2 local_blocks: rank 0's launches in the two-rank exact sharded serve.
    main_launches["flash_decode_paged_local"] = sh["exact"][0]["launches"][
        "flash_decode_paged_local"]
    kernels = []
    for name, (route, src, replaces) in meta.items():
        mine = [c for c in cases if c["kernel"] == name]
        gated = [c for c in mine if c["max_abs_err"] is not None]
        head = mine[0]  # the main-path shape: listed first per kernel
        entry = {
            "name": name, "route": route, "source": src,
            "replaces": replaces, "launches": main_launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in gated),
            "max_rel_err": max(c["max_rel_err"] for c in gated),
            "tolerance_rel": (TOL_GRAD_REL if name in ("flash_dq",
                                                       "flash_dkv")
                              else TOL_OUT_REL),
            "parity": "pass",
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
        }
        if name not in ("flash_dq", "flash_dkv"):
            entry["tolerance_lse"] = TOL_LSE
        if head["library_ms"] is None:
            # No PyTorch call computes int8-KV attention.
            entry["library"] = "none"
            entry["yardstick_sdpa_dequant_ms"] = head[
                "yardstick_sdpa_dequant_ms"]
        if head.get("call_ms") is not None:
            entry["call_ms"] = head["call_ms"]
        if name in ("flash_decode", "flash_decode_paged"):
            # The int8-cast route through this kernel.
            cast = next(c for c in mine if c["case"].startswith("int8"))
            entry["int8_cast"] = {k: cast[k] for k in (
                "case", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                "yardstick_sdpa_dequant_ms", "max_rel_err")}
            entry["launches_int8"] = (
                decode_recs["int8-cast"]["launches"] if name == "flash_decode"
                else x_launches[name])
            entry["launches_int8_serve_staged"] = q_launches[name]
        if name == "flash_decode_paged_local":
            entry["launches_per_rank"] = {
                label: [r["launches"][name] for r in ranks]
                for label, ranks in sh.items()}
            entry["int8_block_scales"] = next(
                {k: c[k] for k in ("case", "ms", "call_ms", "plain_ms",
                                   "bound_ms", "bound_by",
                                   "yardstick_sdpa_dequant_ms",
                                   "max_rel_err")}
                for c in mine if " int8 " in c["case"])
        if name in ("flash_fwd", "flash_dq"):
            # bf16 runs the tensor-core body: its HGMMA count in the SASS.
            entry["hgmma_sass"] = sum(c for n, c in hgmma.items()
                                      if f"{name}_wgmma" in n)
        if name == "flash_fwd":
            # Serve chunks, then 2 per layer and training step (forward and
            # its recomputation under remat).
            entry["launches_serve"] = launches[name]
            entry["launches_train"] = train_launches[name]
        if name in train_launches:
            entry["train_shape"] = next(
                {k: c[k] for k in ("ms", "plain_ms", "bound_ms",
                                   "library_ms")}
                for c in mine if c["case"].startswith("train"))
        kernels.append(entry)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "build_s": secs, "cases": cases,
                   "serve": rec, "decode": drec, "decode_q8": {
                       k: decode_recs[k] for k in ("int8", "int8-cast")},
                   "int8_serve": q_rec, "int8_serve_steps": q_steps,
                   "int8_serve_launches": q_launches,
                   "int8_serve_contiguous": c_rec,
                   "int8_cast_serve": x_rec, "int8_cast_serve_launches":
                   x_launches,
                   "int8_serve_breakdown": q8_breakdown,
                   "int8_step_vs_plain": q8_step, "q8_gate_teeth": q8_teeth,
                   "mixed_step": {"logits_err": logit_err, "kv_err": kv_err,
                                  "kv_max": kv_max},
                   "serve_breakdown": breakdown, "train": trec,
                   "train_launches": train_launches,
                   "train_step_vs_plain": {"loss": [loss_k, loss_p],
                                           "grad_rel": grad_rel},
                   "train_breakdown": train_breakdown,
                   "local_blocks_merge": local_merge,
                   "local_blocks_teeth": local_teeth,
                   "tree_decode_shards": tree_merge,
                   "sharded": [{k: r[k] for k in ("exact", "int8", "mixed",
                                                  "decode", "decode_launches")}
                               for r in sharded],
                   "sharded_tokens_equal_to_single": sharded_agree,
                   "ptxas": ptxas, "hgmma_sass": hgmma, "tile_edges": edges,
                   "one_key_rows": one_key_rows,
                   "kernels": kernels}, f, indent=1)
    print(f"chip_smoke: total wall {time.monotonic() - t_start:.1f}s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
