"""On-card smoke test of the PyTorch + CUDA port (one NVIDIA H100).

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, any
failure exits non-zero:

1. Build the CUDA kernels from ``tree_attention_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together), print the card, each
   kernel's registers and spills (the decode split body's tree variants
   beside their causal twins, every instantiation of the multi-row body of
   B1, B2, B4, B5 and the cast route, by library, and of the tick body),
   and the HGMMA instructions in the SASS of the tensor-core bodies of B3,
   B6 and B7 (``cuobjdump -sass``; none is a failure, and so is a spill in
   B7's tensor-core body, the multi-row decode body or the tick body).
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
   3.35 TB/s or FLOPs / 989 TFLOP/s, the larger); B1 and B4 at the
   reference workload also split body and merge apart. B3 also at the training
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
   beside SDPA's backward (B7 in bf16 is its tensor-core body); then every
   body that ships off its tile edges (B3, B6, B7 in bf16 and f32, D 64
   and 128, Tq 5 and 130 against Tk 300, GQA, a negative and an unaligned
   offset, causal and not) under the same gates; and
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
   sum, and an output halved; the same at B2's cast tick.
   The tick body (B2, its cast route and B5 at one packed row through a
   table; ``cuda_decode.decode_body`` "tick"): every such call counted on
   the wrapper's ``.tick_launches``; under the row gate and timed beside
   its bound at D 64 and 128 over 64- and 16-token blocks (8 slots x 16
   heads of at most 640 tokens, ragged, one slot with no visible key), and
   at one long paged slot (B1 H16, 1000 blocks of 64: the reference
   workload through a table; bf16 and B5); bit for bit: NaN keys past each
   slot's frontier inside its last block, NaN blocks past each slot and
   in blocks no table names, and (int8) codes changed and NaN scalars past
   each slot, all unread; the gate shown rejecting the last cluster rank's
   partial left out of the merge.
   B2 with ``local_blocks`` (one rank's slice of a sequence-sharded pool
   under a signed table) at the serve tick (B8 H16 Tq1, 640-token slots)
   and a 64-row chunk, exact bf16 and int8 with per-block scales, over 80
   blocks sharded W = 2 and 4 ways with tables drawn as
   ``ShardedBlockAllocator`` hands blocks out: every rank's call under the
   row gate, rank 0's timed against its bound (the keys it holds / 3.35
   TB/s), the W partials merged by the in-process monoid against unsharded
   B2, an all-remote row exactly ``(0, -inf)`` (tick and chunk), each
   tick's rank pool past every frontier poisoned and unread bit for bit,
   and the gate shown rejecting remote entries read as block 0.
   Per-shard ``tree_decode`` at the reference workload: B1 over W = 2 and 4
   KV shards with their offsets, and B4 over the shards of the
   channel-quantized K/V, merged against the unsharded B1 / B4 under the
   same gate. The tree variants (speculative tree verification: the
   ancestor-window rule in place of the causal one) under the same row
   gate, masks random draft trees packed as ``pack_proposal`` packs them
   (one slot a chain):
   B2 and B5 at a verify tick (B8 H16, Tq 8 and 32 — bit 31 — 640-token
   slots, one window across a block boundary; bf16, int8 per-block
   scales), B1 and B4 at the contiguous verify tick and at the reference
   workload with Tq 8, the int8-cast routes of B1 and B2; each timed beside
   its bound (the keys some row sees, K+V / 3.35 TB/s) and SDPA with a
   boolean ``attn_mask`` over the gathered view. A lower-triangular mask
   gives the causal launch's out and lse bit for bit (B1, B2, B4, B5);
   table entries past each window named a NaN block change nothing; the
   gate is shown rejecting each row reading the previous row's bits and
   the window shifted by one key.
   B2's multi-row body (bf16, more than one packed row: prompt tails,
   verify ticks, the sharded pool's chunks; ``cuda_decode.decode_body``)
   under the row gate at Tq 2, 8, 28, 32, 64, 127 for G 1 and 4, ragged
   640-token slots, every table entry past each window naming a NaN block,
   and under ``local_blocks`` with every block the rank's table does not
   name NaN-poisoned; each such launch counted on ``.tiled_launches``; the
   prompt-tail buckets Tq 8, 16, 32, 64 timed beside SDPA.
   B1 and B5 on the same multi-row body (exact bf16 contiguous, and paged
   int8 x int8, with more than one packed row or a tree), each launch
   counted on the wrapper's ``.tiled_launches``: B1 under the row gate at
   GQA Tq 16 over Tk 4096 and 4037, Tq 2, 5, 64, 127, G 1 and 4, D 64 and
   128, causal with per-slot kv_offset (a shard wholly past its frontier
   exactly ``(0, -inf)``) and not causal, K/V past each frontier NaN
   unread bit for bit, the gate shown rejecting an output halved and the
   first split's keys left out; B5 at chain and tree verify ticks (Tq 8,
   32) over 64- and 16-token blocks with per-block scales that differ by
   block and with channel scales, every Q and K code at +-127, tril ==
   causal and NaN blocks and scales past each window unread bit for bit,
   the gate shown rejecting scales read by logical block, the V scalar
   before the softmax sum and an output halved; B5's chain verify ticks
   timed.
   B4 and the int8 cast route over B1/B2 on the same multi-row body (phase
   2g), each launch counted on ``.tiled_launches`` (B4) or
   ``.cast_tiled_launches`` (B1, B2): B4 under the row gate at GQA Tq 16
   over Tk 4096 and 4037, Tq 2, 5, 64, 127, G 1 and 4, D 64 and 128,
   causal with per-slot kv_offset (a shard past its frontier exactly
   ``(0, -inf)``) and not, trees at Tq 8 and 32 and at the reference
   workload; the cast route on both layouts with channel scales and with
   per-block scales over 64- and 16-token blocks, trees at Tq 8 and 32,
   the ``local_blocks`` 64-row chunk at W 2 and 4 merged against
   unsharded B2, codes at +-127; bit for bit: tril == causal, codes past
   each frontier changed, and NaN scalars past each window and in every
   block a rank's table does not name, all unread; the gate shown
   rejecting an output halved, one split dropped, scalars read by logical
   block and the V scalar before the softmax sum; the timed cases beside
   their bound and the dequantized-SDPA yardstick.
3. Serve 16 requests through the paged, chunked SlotServer (the CLI's
   ``--mode serve`` entry point) at the reference attention width (d_model
   2048, 16 heads x 128, d_ff 5504, vocab 32768, bf16, depth cut to 4
   layers, random weights from a seed); check every request retires with
   its budget, the pool drains, the paged decode (B2: every one-row tick
   on its tick body, its multi-row body on the prompt-tail ticks, counted
   by Tq bucket) and Q-tiled (B3) kernels ran, and one mixed step's
   logits and written KV match the plain path on the same cache (logits
   within 0.1: bf16 activations, relative precision ~4e-3, through 4 layers
   at a logit scale ~1; KV within 2e-2 of the pool's largest |value|). The
   serve step's device time is split by kernel group from a traced wave,
   against the same wave's untraced wall.
   Then int8: 16 requests through ``cli.main --mode serve --kv-quant
   int8`` (staged admission, the paged int8 cache): every request retires
   with its budget, the pool drains, B5 launched once per layer and int8
   step, each on its tick body, B1/B3 for the staged chunks (the tails
   below 128 rows on B1's multi-row body); 4 requests on the contiguous int8
   cache (B4 once per layer and int8 step) and 4 through ``--kv-quant
   int8-cast`` (B2 with per-block scales once per layer and int8 step,
   on its tick body);
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
   Then speculative serving (``--speculate``, draft_k 4): the 16-request
   serve through ``cli.run_serve`` with ``--drafter ngram`` and
   ``ngram-tree``, exact and ``--kv-quant int8``, and the 8-request wave
   with an oracle drafter (the non-speculative wave's tokens, a wrong token
   every 3rd call, a decoy branch packed before the true chain: every
   proposal a tree, every commit a compaction) on the paged and contiguous
   layouts, exact and int8: every request retires with its budget, the
   pool drains, each tree verify tick launches the layout's tree kernel
   once per layer and no other tree kernel runs (through the multi-row
   body of B2, B1, B5 and B4, which every verify tick takes), and the
   same oracle wave through the int8 cast route (``quant_kernel="q8"``)
   on the paged and contiguous layouts, whose verify ticks take the cast
   route's multi-row body (B2 with per-block scales, B1); the
   oracle's acceptance
   is above 0 on the paged layouts, and every emitted greedy token is
   within 0.1 of its position's largest logit when the stream is re-scored
   by the non-speculative kernel path through the serve's own q8 route
   (teacher-forced replay). One tree
   verify step's logits against the plain path (exact and int8) and
   against each root path decoded one token at a time, within 0.1. Token
   agreement with the non-speculative serve, acceptance, tokens per verify
   tick and spec tok/s beside non-spec tok/s are reported, with the oracle
   wave's device split, exact and on the paged and contiguous int8 pools.
   Every serve's launches of the multi-row body are reported by kernel and
   Tq. Then two ranks on the one card (spawned processes on ``cuda:0`` over
   gloo; NCCL refuses two ranks on one device): ``--mesh seq=2 --kv-shard
   seq`` at the same width, exact and ``--kv-quant int8`` (16 requests
   each): every request retires with its budget, each rank's pool drains
   and holds half the whole pool's bytes, B2 ``local_blocks`` launches
   once per layer and step on each rank (nothing else reads the sharded
   pool; the exact chunks take its multi-row body, every tick its tick
   body; the int8 slice runs one-row decode ticks only, staged admission's
   chunks going to the staging cache), exactly 1 MAX + 2 SUM all-reduces
   per layer and step (int8: plus one SUM per step for the anchor scales),
   both ranks' tokens equal; one mixed step's merged logits within 0.1 of
   the single-rank path on the same logical cache; greedy agreement with
   the single-rank serve reported; and ``--mode decode --mesh seq=2`` at
   the reference workload
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


def _fwd_bwd_name(m) -> str:
    dtype = "f32" if m.group(2) == "f" else "bf16"
    return f"{m.group(1)}<{dtype},{m.group(3)}>"


def ptxas_summary(build, libs=("flash_fwd", "flash_bwd"),
                  pattern=r"(flash_(?:fwd|dq|dkv)(?:_wgmma)?_kernel)I"
                          r"(13__nv_bfloat16|f|)Li(\d+)E",
                  name=_fwd_bwd_name) -> dict:
    """``{kernel: [registers, spill-store bytes]}`` from the ``-Xptxas -v``
    log the build keeps beside each library of ``libs``: every entry
    function whose mangled name matches ``pattern``, named by ``name(match)``.
    The default reads the forward and backward kernels (B3, B6, B7) as
    ``kernel<dtype,D>``; the tensor-core bodies are bf16 only
    (``*_wgmma_kernel<D>``)."""
    import re

    out = {}
    for lib in libs:
        log = build._target(lib).with_suffix(".log").read_text()
        for block in log.split("Compiling entry function")[1:]:
            m = re.search(pattern, block)
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            if m and regs:
                out[name(m)] = [int(regs.group(1)),
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
        "flash_decode_paged_tiled": (b2, "tiled_launches"),
        "flash_decode_paged_tick": (b2, "tick_launches"),
        "flash_decode_tiled": (cuda_decode.attention_cuda_decode,
                               "tiled_launches"),
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


SPEC_ARGS = ["--speculate", "--draft-k", "4"]
# A verify tick's tree masks: 8 rows (draft_k 4 plus decoys fit), and the
# 32-row cap of the int32 bitmasks.
TREE_TQS = (8, 32)


def random_trees(B: int, tq: int, chain_slot: int, seed: int):
    """``(B, tq, tq)`` bool ancestor masks of random draft trees packed as
    the engine packs a proposal (``pack_proposal``: topological parents,
    the tip at row 0); slot ``chain_slot`` is a plain chain. Row ``tq - 1``
    sees itself, so at tq 32 every slot has a row that sets bit 31."""
    import numpy as np
    import torch

    from tree_attention_tpu_torch.serving.speculation import (
        DraftProposal,
        pack_proposal,
    )

    rng = np.random.default_rng(seed)
    out = np.zeros((B, tq, tq), bool)
    for b in range(B):
        parents = [i - 1 if b == chain_slot else int(rng.integers(-1, i))
                   for i in range(tq - 1)]
        out[b] = pack_proposal(0, DraftProposal(
            np.zeros(tq - 1, np.int32), np.asarray(parents, np.int32))).anc
    return torch.from_numpy(out)


def oracle_drafter(requests, refs, vocab: int, wrong_every: int = 3):
    """The adversarial drafter of the JAX package's spec tests: each
    request's non-speculative continuation ``refs[uid]`` with a wrong
    second token every ``wrong_every``-th call, behind a decoy branch packed
    BEFORE the true chain — every proposal is a tree, an accepted path is
    never contiguous rows, so every commit compacts, and a random-weight
    model accepts where n-gram lookup may not."""
    import numpy as np

    from tree_attention_tpu_torch.serving.speculation import (
        DraftProposal,
        Drafter,
    )

    full = [(np.asarray(r.prompt, np.int32),
             np.concatenate([np.asarray(r.prompt, np.int32),
                             np.asarray(refs[r.uid], np.int32)]))
            for r in requests]

    class Oracle(Drafter):
        calls = 0

        def propose(self, history, k):
            self.calls += 1
            seq = next(f for p, f in full if len(history) >= len(p)
                       and np.array_equal(history[:len(p)], p))
            cont = seq[len(history):len(history) + k].copy()
            if len(cont) == 0:
                cont = np.full((max(k, 1),), 3, np.int32)
            if self.calls % wrong_every == 0 and len(cont) > 1:
                cont[1] = (cont[1] + 1) % vocab
            tokens, parents, prev = [int((cont[0] + 1) % vocab)], [-1], -1
            for t in cont[:max(len(cont) - 1, 1)]:
                parents.append(prev)
                prev = len(tokens)
                tokens.append(int(t))
            return DraftProposal(np.asarray(tokens, np.int32),
                                 np.asarray(parents, np.int32))

    return Oracle()


def replay_margin(params, cfg, results, requests, quant: bool, layout: str,
                  dev, block: int = 64, quant_kernel: str = "q8q") -> float:
    """Teacher-forced re-scoring of a greedy serve's emitted tokens through
    the non-speculative kernel path: each request's prompt prefilled
    exactly (an int8 cache then takes it quantized as staged admission
    does: per block on the paged layout, per channel on the contiguous
    one), then every emitted token but the last in one step (an int8
    cache's through the serve's ``quant_kernel`` route). Returns the
    largest (row's max logit - emitted token's logit) over every emitted
    token; a greedy token the model would not pick shows there."""
    import numpy as np
    import torch

    from tree_attention_tpu_torch.models import (
        forward_step,
        init_cache,
        init_paged_cache,
        paged_insert_slot,
        quantize_cache,
        quantize_paged_blocks,
    )

    prompts = {r.uid: r.prompt for r in requests}
    worst = 0.0
    for res in results:
        prompt = torch.as_tensor(np.asarray(prompts[res.uid]),
                                 dtype=torch.int64, device=dev)[None]
        toks = torch.as_tensor(res.tokens, dtype=torch.int64, device=dev)
        plen, total = prompt.shape[1], prompt.shape[1] + len(res.tokens)
        nb = -(-total // block)

        def paged(q):
            c = init_paged_cache(cfg, 1, total, nb, block=block, device=dev,
                                 quantize=q)
            c.table.copy_(torch.arange(nb, dtype=torch.int32,
                                       device=dev)[None])
            return c

        if not quant:
            cache = (paged(False) if layout == "paged"
                     else init_cache(cfg, 1, total, device=dev))
            lg, _ = forward_step(params, torch.cat([prompt, toks[None, :-1]],
                                                   1), cache, cfg)
            rows = lg[0, plen - 1:]
        else:
            stage = init_cache(cfg, 1, total, device=dev)
            lg, stage = forward_step(params, prompt, stage, cfg)
            rows = lg[0, -1:]
            if layout == "paged":
                cache = paged(True)
                kq, vq, ks, vs = quantize_paged_blocks(stage.k, stage.v,
                                                       block)
                paged_insert_slot(cache, 0, kq, vq, plen, ks, vs)
            else:
                cache = quantize_cache(stage)
            if len(res.tokens) > 1:
                lg, _ = forward_step(params, toks[None, :-1], cache, cfg,
                                     quant_kernel=quant_kernel)
                rows = torch.cat([rows, lg[0]], 0)
        rows = rows.float()
        margin = rows.amax(-1) - rows.gather(1, toks[:, None])[:, 0]
        worst = max(worst, margin.max().item())
    return worst


def tree_step_check(params, cfg, dev, slots: int = 8, cache_len: int = 640,
                    block: int = 64, prefix: int = 256, tq: int = 8) -> dict:
    """One tree verify step (random trees, one slot a chain; positions =
    length + depth) on a prefilled paged cache at ragged lengths, one of
    them a window across a block boundary: the kernel path against the
    plain path on copies of the same cache, exact and int8 (the cache
    quantized per block); and each exact tree row against its root path
    decoded one token at a time by the kernel path. Returns the largest
    |dlogit| of each comparison."""
    import dataclasses

    import torch

    from tree_attention_tpu_torch.models import (
        PagedQuantKVCache,
        forward_step,
        init_paged_cache,
    )
    from tree_attention_tpu_torch.ops.cuda_decode import (
        quantize_symmetric_int8,
    )

    nb = cache_len // block
    cache = init_paged_cache(cfg, slots, cache_len, slots * nb, block=block,
                             device=dev)
    cache.table.copy_(torch.arange(slots * nb, dtype=torch.int32,
                                   device=dev).reshape(slots, nb))
    gen = torch.Generator(device=dev).manual_seed(1)
    pre = torch.randint(0, cfg.vocab_size, (slots, prefix), generator=gen,
                        device=dev)
    n0 = torch.randint(1, prefix + 1, (slots,), generator=gen, device=dev,
                       dtype=torch.int32)
    n0[0] = min(2 * block - 3, prefix)  # the window crosses a block edge
    _, cache = forward_step(params, pre, cache, cfg, n_tokens=n0)
    trees = random_trees(slots, tq, 1, 2).to(dev)
    depth = trees.sum(-1) - 1  # a row's ancestors, itself included
    toks = torch.randint(0, cfg.vocab_size, (slots, tq), generator=gen,
                         device=dev)
    plain_cfg = dataclasses.replace(cfg, attn_impl="plain")

    def clone(c):
        return dataclasses.replace(c, **{
            f.name: getattr(c, f.name).clone()
            for f in dataclasses.fields(c)})

    def tree_step(c, conf):
        lg, _ = forward_step(params, toks, clone(c), conf,
                             positions=c.length.long()[:, None] + depth,
                             tree_mask=trees)
        return lg.float()

    lk = tree_step(cache, cfg)
    out = {"logits_err_plain": (lk - tree_step(cache, plain_cfg)
                                ).abs().max().item()}
    # Each row against its root path, one token per step (slots whose path
    # is shorter ride the later steps inert).
    worst = 0.0
    for i in range(tq):
        paths = []
        for b in range(slots):
            anc = trees[b, i].nonzero()[:, 0].tolist()  # ascending = path
            paths.append(anc)
        c = clone(cache)
        last = torch.empty_like(lk[:, 0])
        for s in range(max(len(p) for p in paths)):
            step = torch.tensor([[int(toks[b, p[s]]) if s < len(p) else 0]
                                 for b, p in enumerate(paths)], device=dev)
            n = torch.tensor([int(s < len(p)) for p in paths], device=dev,
                             dtype=torch.int32)
            lg, c = forward_step(params, step, c, cfg, n_tokens=n)
            for b, p in enumerate(paths):
                if s == len(p) - 1:
                    last[b] = lg[b, 0].float()
        worst = max(worst, (last - lk[:, i]).abs().max().item())
    out["logits_err_paths"] = worst

    def per_block(pool):
        codes, sc = quantize_symmetric_int8(
            pool.reshape(*pool.shape[:3], -1), 3)
        return codes.reshape(pool.shape), sc[..., 0]

    (k8, ks8), (v8, vs8) = per_block(cache.k), per_block(cache.v)
    qcache = PagedQuantKVCache(k=k8, v=v8, table=cache.table,
                               length=cache.length, k_scale=ks8,
                               v_scale=vs8)
    out["int8_logits_err_plain"] = (
        tree_step(qcache, cfg) - tree_step(qcache, plain_cfg)
    ).abs().max().item()
    return out


def spec_phase(dev, params, cfg, serve_args, trace, refs, engine_kw,
               wrappers, reset_counts, tol_logits) -> dict:
    """Phase 3d: speculative serving at the serve width.

    (a) ``cli.run_serve`` (what ``cli.main --mode serve --speculate``
    runs) with the ``ngram`` and ``ngram-tree`` drafters, exact and
    ``--kv-quant int8``, on the serve phase's trace; (b) the oracle drafter
    in process on the wave's trace (``refs``: its non-speculative greedy
    tokens, exact and int8) on the paged and contiguous layouts, exact and
    int8 through both q8 routes (q8q: B5 / B4; q8, the cast route: B2 with
    per-block scales / B1). Every serve retires every request with its
    budget and drains its pool; each tree verify tick launches the layout's
    tree kernel once per layer (and no other tree kernel runs), and the
    kernel's multi-row body (its cast route's, for q8) at least once per
    tree launch; the oracle's acceptance is above 0 on the paged layouts;
    every emitted token passes the teacher-forced replay
    (:func:`replay_margin` within ``tol_logits``); (c) a sampled
    wave served plain and then speculatively (the oracle drafting the plain
    serve's sampled tokens) under one seed. Token agreement with the
    non-speculative serves is reported, not gated. On a CPU the launch
    counts are not read (the wrappers run their plain versions)."""
    import torch

    from tree_attention_tpu_torch import cli
    from tree_attention_tpu_torch.serving import SlotServer, synthetic_trace
    from tree_attention_tpu_torch.utils.config import parse_args

    on_card = dev.type == "cuda"
    # The tree kernel of each (layout, q8 route; None: exact).
    tree_kernel = {("paged", None): "flash_decode_paged",
                   ("paged", "q8q"): "flash_decode_paged_q8q",
                   ("paged", "q8"): "flash_decode_paged",
                   ("contiguous", None): "flash_decode",
                   ("contiguous", "q8q"): "flash_decode_q8q",
                   ("contiguous", "q8"): "flash_decode"}
    n_layers = cfg.n_layers

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def check(label, rep, server, n_req, n_new, layout, route):
        """The gates every speculative serve passes; returns its facts.
        ``route``: the q8 route of an int8 cache, None for an exact one."""
        tree = {n: w.tree_launches for n, w in wrappers.items()
                if hasattr(w, "tree_launches")}
        ticks = rep.spec["tree_verify_ticks"]
        if rep.outcomes != {"budget": n_req} or \
                rep.tokens_generated != n_req * n_new:
            fail(f"spec serve {label}: outcomes {rep.outcomes}, "
                 f"{rep.tokens_generated} tokens")
        if any(server.leak_report().values()):
            fail(f"spec serve {label} leaked: {server.leak_report()}")
        mine = tree_kernel[(layout, route)]
        if on_card and (tree[mine] != n_layers * ticks or any(
                c for n, c in tree.items() if n != mine)):
            fail(f"spec serve {label}: tree launches {tree} over {ticks} "
                 f"tree verify ticks x {n_layers} layers")
        # Every verify tick (tree or chain, Tq >= 8) runs the layout's
        # kernel on the multi-row body (B2, B1, B5, B4; the cast route's
        # for q8, counted apart from the exact staged prompt tails).
        tiled = getattr(wrappers[mine], "cast_tiled_launches"
                        if route == "q8" else "tiled_launches")
        if on_card and not (tiled >= tree[mine] and tiled > 0):
            fail(f"spec serve {label}: {mine}'s multi-row body launched "
                 f"{tiled} times beside {tree[mine]} tree launches")
        by_tq = {n: dict(sorted(wrappers[k].tiled_tq.items()))
                 for n, k in (("B1", "flash_decode"),
                              ("B2", "flash_decode_paged"),
                              ("B4", "flash_decode_q8q"),
                              ("B5", "flash_decode_paged_q8q"))
                 if wrappers[k].tiled_tq}
        return {"spec": rep.spec, "tokens_per_sec": rep.tokens_per_sec,
                "wall_s": rep.wall_s, "ticks": rep.ticks,
                "decode_ticks": rep.decode_ticks, "route": route,
                "layout": layout, "tree_launches": tree[mine],
                "tree_kernel": mine, "tiled_launches": tiled,
                "tiled_by_tq": by_tq}

    out = {"cli": {}, "oracle": {}}
    for quant in ("none", "int8"):
        for drafter in ("ngram", "ngram-tree"):
            label = f"cli {drafter} kv_quant {quant}"
            c = parse_args(serve_args + SPEC_ARGS + ["--drafter", drafter,
                                                     "--kv-quant", quant])
            reset_counts()
            rec, server, rep = cli.run_serve(c, dev)
            sync()
            r = check(label, rep, server, c.requests, c.max_new_tokens,
                      "paged", None if quant == "none" else "q8q")
            reqs = synthetic_trace(
                c.requests, prompt_len=c.prompt_len,
                prompt_jitter=c.prompt_jitter,
                max_new_tokens=c.max_new_tokens,
                arrival_every=c.arrival_every,
                vocab_size=server.cfg.vocab_size, seed=c.seed + 1)
            r["replay_margin"] = replay_margin(
                server.params, server.cfg, rep.results, reqs,
                quant != "none", "paged", dev, server.kv_block)
            r["tokens"] = {x.uid: x.tokens for x in rep.results}
            r["record"] = rec
            out["cli"][label] = r
            print(f"spec serve ({label}): {rec['tokens_per_sec']} tok/s, "
                  f"spec {json.dumps(rep.spec)}, tree launches "
                  f"{r['tree_launches']}, multi-row launches by Tq "
                  f"{json.dumps(r['tiled_by_tq'])}, replay margin "
                  f"{r['replay_margin']:.3e} (tol {tol_logits})", flush=True)
            if not r["replay_margin"] <= tol_logits:
                fail(f"spec serve ({label}): an emitted token is "
                     f"{r['replay_margin']} below its position's largest "
                     f"logit on the non-speculative path")
            del server
    n_new = max(r.max_new_tokens for r in trace)
    for layout in ("paged", "contiguous"):
        for route in (None, "q8q", "q8"):
            quant = route is not None
            label = (f"oracle {layout}{' int8' if quant else ''}"
                     f"{' q8' if route == 'q8' else ''}")
            ref = refs[quant]
            server = SlotServer(
                params, cfg, **engine_kw, kv_layout=layout, quantize=quant,
                quant_kernel=route or "q8q", speculate=True, draft_k=4,
                drafter=oracle_drafter(trace, ref, cfg.vocab_size))
            reset_counts()
            rep = server.serve(trace)
            sync()
            r = check(label, rep, server, len(trace), n_new, layout, route)
            if on_card and not r["tree_launches"]:
                fail(f"spec serve ({label}): no tree verify tick")
            same = sum(a == b for x in rep.results
                       for a, b in zip(x.tokens, ref[x.uid]))
            r["tokens_equal_to_nonspec"] = same / rep.tokens_generated
            r["replay_margin"] = replay_margin(
                params, cfg, rep.results, trace, quant, layout, dev,
                engine_kw.get("kv_block", 64), route or "q8q")
            out["oracle"][label] = r
            print(f"spec serve ({label}): {rep.tokens_per_sec:.1f} tok/s, "
                  f"spec {json.dumps(rep.spec)}, tree launches "
                  f"{r['tree_launches']} ({r['tree_kernel']}), multi-row "
                  f"launches by Tq {json.dumps(r['tiled_by_tq'])}, tokens "
                  f"equal "
                  f"to the non-spec wave's {same}/{rep.tokens_generated}, "
                  f"replay margin {r['replay_margin']:.3e} (tol "
                  f"{tol_logits})", flush=True)
            if layout == "paged" and not rep.spec["acceptance_rate"] > 0:
                fail(f"spec serve ({label}): acceptance rate "
                     f"{rep.spec['acceptance_rate']}")
            if not r["replay_margin"] <= tol_logits:
                fail(f"spec serve ({label}): an emitted token is "
                     f"{r['replay_margin']} below its position's largest "
                     f"logit on the non-speculative path")
            del server
    # (c) Sampled: the wave at temperature 0.8, top-k 50 under one seed,
    # served plain, then speculatively with the oracle drafting the plain
    # serve's own sampled tokens (keyed draws: on exact arithmetic the two
    # streams are one). Both retire and drain; agreement is reported.
    samp = dict(temperature=0.8, top_k=50, seed=11)
    server = SlotServer(params, cfg, **engine_kw, **samp)
    plain = server.serve(trace)
    sync()
    if plain.outcomes != {"budget": len(trace)} or any(
            server.leak_report().values()):
        fail(f"sampled plain serve: outcomes {plain.outcomes}, leaks "
             f"{server.leak_report()}")
    sref = {x.uid: x.tokens for x in plain.results}
    label = "oracle paged sampled"
    server = SlotServer(params, cfg, **engine_kw, **samp, speculate=True,
                        draft_k=4,
                        drafter=oracle_drafter(trace, sref, cfg.vocab_size))
    reset_counts()
    rep = server.serve(trace)
    sync()
    r = check(label, rep, server, len(trace), n_new, "paged", None)
    same = sum(a == b for x in rep.results
               for a, b in zip(x.tokens, sref[x.uid]))
    r["tokens_equal_to_nonspec"] = same / rep.tokens_generated
    r["nonspec_tokens_per_sec"] = plain.tokens_per_sec
    out["oracle"][label] = r
    print(f"spec serve ({label}): {rep.tokens_per_sec:.1f} tok/s beside "
          f"the sampled plain serve's {plain.tokens_per_sec:.1f}, spec "
          f"{json.dumps(rep.spec)}, tree launches {r['tree_launches']}, "
          f"tokens equal to the sampled plain serve's "
          f"{same}/{rep.tokens_generated} (reported, not gated)", flush=True)
    del server
    return out


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
    # Every instantiation of the decode body (B1/B2/B4/B5), by mangled
    # name; the tree variants' template arguments end in ``ELb1EE``.
    dptx = ptxas_summary(_build, ("flash_decode",),
                         r"(_Z\w*decode_split_kernel\w*)",
                         lambda m: m.group(1))
    tree_bodies = {n: r for n, r in dptx.items() if "ELb1EEEv" in n}
    print(f"ptxas of the decode body: {len(dptx)} instantiations, "
          f"{len(tree_bodies)} tree variants; tree vs causal twin "
          f"(registers, spill-store bytes): " + json.dumps({
              n[n.index("kernelI") + 7:n.index("EEEv")]: [
                  r, dptx.get(n.replace("ELb1EEEv", "ELb0EEEv"))]
              for n, r in tree_bodies.items()}), flush=True)
    # The multi-row body (mma.sync) in its three libraries (bf16: B1, B2;
    # the cast route; q8q: B4, B5): registers and spills of each
    # instantiation (operands, layout, D, warps, tree, local), by mangled
    # name.
    by_lib = {lib: ptxas_summary(_build, (lib,),
                                 r"_Z\w*(decode_tiled_kernelI\w+?EE)v",
                                 lambda m: m.group(1))
              for lib in ("flash_decode_tiled", "flash_decode_tiled_cast",
                          "flash_decode_tiled_q8q")}
    tptx = {n: r for lib in by_lib.values() for n, r in lib.items()}
    per_lib = {lib: len(x) for lib, x in by_lib.items()}
    print(f"ptxas of the multi-row body (B1, B2, B4, B5, the cast route): "
          f"{len(tptx)} instantiations ({json.dumps(per_lib)}; registers, "
          f"spill-store bytes): {json.dumps(tptx)}", flush=True)
    # The tick body (B2 and B5's one-row paged launches): registers and
    # spills of each instantiation (operands, D, per-block scalars).
    kptx = ptxas_summary(_build, ("decode_tick",),
                         r"_Z\w*(decode_tick_kernelI\w+?EE)v",
                         lambda m: m.group(1))
    print(f"ptxas of the tick body (B2, B5, the cast route at one row): "
          f"{len(kptx)} instantiations (registers, spill-store bytes): "
          f"{json.dumps(kptx)}", flush=True)
    hgmma = hgmma_counts(_build)
    print(f"SASS HGMMA instructions of the tensor-core bodies: "
          f"{json.dumps(hgmma)}", flush=True)
    for body in ("flash_fwd_wgmma", "flash_dq_wgmma", "flash_dkv_wgmma"):
        if not any(body in n and c > 0 for n, c in hgmma.items()):
            fail(f"no HGMMA instruction in {body}_kernel's SASS")
    # The redesigned bodies keep every register: a spill would put the
    # accumulators (B7's dK and dV, the multi-row body's O) through local
    # memory.
    spills = {n: r for n, r in {**ptxas, **tptx, **kptx}.items()
              if ("dkv_wgmma" in n or "decode_t" in n) and r[1]}
    if spills or not tptx or len(kptx) != 10 or not any(
            "dkv_wgmma" in n for n in ptxas):
        fail(f"the new bodies spill or are missing from the build: "
             f"{json.dumps(spills)}")

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
               ops_s=None, yardstick=None, names=None, parts=None):
        """Gate ``fn`` against ``plain`` and time both beside the bound
        (bytes / HBM rate or the operations' time — ``flops`` at the bf16
        rate, or ``ops_s`` seconds — the larger) and ``library``, one
        PyTorch call of the same function (None where there is none; then
        ``yardstick`` is timed instead, a labelled near-equivalent). With
        ``names`` ``ms`` counts only the kernel's own launches and
        ``call_ms`` the whole call's; ``parts`` (kernel name fragments) are
        also timed apart, as ``by_kernel_ms``."""
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
        if parts is not None:
            c["by_kernel_ms"] = {x: time_ms(fn, 0.0, names=(x,))[0]
                                 for x in parts}
        cases.append(c)
        lib = (f"sdpa {lib_ms:.4f}" if lib_ms is not None else
               f"library none, sdpa over dequantized bf16 "
               f"{c.get('yardstick_sdpa_dequant_ms', math.nan):.4f}")
        print(f"{kernel} {name}: |dout| {eo:.3e} relative {er:.3e} "
              f"|dlse| {el:.3e} (tol {TOL_OUT_REL}/{TOL_LSE}) ms {ms:.4f} "
              + (f"(whole call {c['call_ms']:.4f}) " if names else "")
              + (f"by kernel {json.dumps(c['by_kernel_ms'])} " if parts
                 else "")
              + f"plain {plain_ms:.4f} {lib} bound {bound:.4f} "
              f"({c['bound_by']}) clocks {c['clocks']}", flush=True)

    # The decode kernels' own launches: a body and the merge (the tick body
    # merges inside its launch).
    own = ("decode_split", "decode_tiled", "decode_tick", "merge_splits")

    # B1: the reference workload (the --mode decode shape) ...
    q, k, v = rnd(1, 16, 1, 128), rnd(1, 16, 64000, 128), rnd(1, 16, 64000, 128)
    kv_bytes = 2 * k.numel() * 2
    record("flash_decode", "ref B1 H16 Tk64000 Tq1",
           lambda: cuda_decode.attention_cuda_decode(q, k, v),
           lambda: cuda_decode.decode_plain(q, k, v),
           lambda: F.scaled_dot_product_attention(q, k, v),
           kv_bytes + 2 * q.numel() * 2, 4.0 * 16 * 64000 * 128,
           parts=("decode_split", "merge_splits"))
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
    # ... and a ragged GQA batch: Tq 1 on the split body, Tq 16 (64 packed
    # rows a KV head, a staged int8 prompt tail's shape) on the multi-row
    # body.
    for tq in (1, 16):
        q, k, v = rnd(8, 32, tq, 128), rnd(8, 8, 4096, 128), rnd(8, 8, 4096, 128)
        qoff = torch.randint(0, 4096 - tq, (8,), generator=g, device=dev,
                             dtype=torch.int32)
        need = sum(min(4096, int(o) + tq) for o in qoff.tolist())
        mask = gqa_mask(qoff, tq, 4096)
        record("flash_decode" if tq == 1 else "flash_decode_tiled",
               f"GQA B8 Hq32 Hkv8 Tk4096 Tq{tq} ragged",
               lambda: cuda_decode.attention_cuda_decode(
                   q, k, v, causal=True, q_offset=qoff),
               lambda: cuda_decode.decode_plain(q, k, v, causal=True,
                                                q_offset=qoff),
               lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=mask, enable_gqa=True),
               need * 8 * 128 * 2 * 2 + 2 * q.numel() * 2,
               4.0 * 32 * 128 * visible_pairs(qoff, tq, 4096), names=own,
               parts=(("decode_tiled", "merge_splits") if tq > 1 else None))

    # B2: a fragmented 64-token-block pool at the serve shapes (8 slots,
    # 16 heads x 128, 10-block tables = 640-token slots), the decode tick
    # (the tick body; more rows take the multi-row body, phase 2e).
    def ticked(wrapper, fn):
        """``fn()``, failing unless it launched ``wrapper``'s tick body
        exactly once."""
        before = wrapper.tick_launches
        out = fn()
        if wrapper.tick_launches != before + 1:
            fail(f"a one-row paged call did not run the tick body once "
                 f"({wrapper.tick_launches - before} tick launches)")
        return out

    b2t = cuda_decode.attention_cuda_decode_paged
    b5t = cuda_decode.attention_cuda_decode_paged_q8q
    blk, nb, npool = 64, 10, 96
    kp, vp = rnd(npool, 16, blk, 128), rnd(npool, 16, blk, 128)
    table = torch.stack([torch.randperm(npool, generator=g, device=dev)[:nb]
                         for _ in range(8)]).to(torch.int32)
    for tq in (1,):
        q = rnd(8, 16, tq, 128)
        qoff = torch.randint(0, nb * blk - tq, (8,), generator=g, device=dev,
                             dtype=torch.int32)
        need = sum(min(nb * blk, int(o) + tq) for o in qoff.tolist())
        kg, vg = gather_paged_kv(kp, vp, table)
        mask = gqa_mask(qoff, tq, nb * blk)
        record("flash_decode_paged_tick", f"B8 H16 block64 NB10 Tq{tq} ragged",
               lambda: ticked(b2t, lambda: b2t(q, kp, vp, table,
                                               q_offset=qoff)),
               lambda: cuda_decode.paged_decode_plain(q, kp, vp, table,
                                                      q_offset=qoff),
               lambda: F.scaled_dot_product_attention(q, kg, vg,
                                                      attn_mask=mask),
               need * 16 * 128 * 2 * 2 + 2 * q.numel() * 2,
               4.0 * 16 * 128 * visible_pairs(qoff, tq, nb * blk),
               names=own)

    # -- 2a. the int8 routes: B4, B5, and B1/B2 over int8 K/V -------------
    # Bound: the visible int8 K+V bytes (to each row's causal frontier),
    # plus Q, the scales and the output; operations: the q.k products at
    # the int8 rate (q8q) or the bf16 rate (cast), the p.v products at the
    # bf16 rate. No PyTorch call computes int8-KV attention (library none);
    # SDPA over the dequantized bf16 K/V is timed as a yardstick: the same
    # result to within quantization, at twice the K/V bytes.

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
               names=own, parts=("decode_split", "merge_splits"))
    del kq, vq, kd, vd
    # (B4 with more than one packed row runs the multi-row body: phase 2g.)
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
    record("flash_decode_paged_q8q_tick", "int8 B8 H16 block64 NB10 Tq1 "
           "ragged, per-block scales",
           lambda: ticked(b5t, lambda: b5t(q, kp8, vp8, table, kbs, vbs,
                                           q_offset=qoff)),
           lambda: cuda_decode.paged_decode_q8q_plain(
               q, kp8, vp8, table, kbs, vbs, q_offset=qoff),
           None, tick_bytes + 2 * 8 * nb * 16 * 4, 0.0,
           ops_s=q8_ops_s(16 * visible_pairs(qoff, 1, nb * blk), True),
           yardstick=lambda: F.scaled_dot_product_attention(
               q, kg, vg, attn_mask=mask), names=own)
    record("flash_decode_paged_tick", "int8 B8 H16 block64 NB10 Tq1 ragged, "
           "block_scales",
           lambda: ticked(b2t, lambda: b2t(q, kp8, vp8, table, q_offset=qoff,
                                           block_scales=(kbs, vbs))),
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
    record("flash_decode_paged_q8q_tick", "int8 B8 H16 block64 NB10 Tq1 "
           "ragged, channel scales",
           lambda: ticked(b5t, lambda: b5t(q, kp8, vp8, table, cks, cvs,
                                           q_offset=qoff)),
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
    def q8q_paged_here(case, fault=None, route="q8q"):
        """B5 (``route`` "q8q"; "q8": B2's cast route) with per-block
        scales on ``case`` = (q, K and V pools, table, K and V scales,
        q_offset), written out from the gathered view; a packed row r sits
        at q_offset + r % Tq."""
        q, kp, vp, tbl, ksc, vsc, qo = case
        B, NB = tbl.shape
        blk, hkv, tq = kp.shape[2], kp.shape[1], q.shape[2]
        if route == "q8q":
            codes, qs = cuda_decode._fold_quantize_q(q, hkv, None, None)
        else:  # a bf16 Q and the softmax scale
            codes = q.to(torch.bfloat16).reshape(B, hkv, -1, q.shape[3])
            qs = q.shape[3] ** -0.5
        kg, vg = gather_paged_kv(kp, vp, tbl)
        idx = (torch.arange(NB, device=dev).expand(B, NB)
               if fault == "logical" else tbl.long())
        kk, vk = (sc[idx].transpose(1, 2).repeat_interleave(blk, 2)[
            :, :, None] for sc in (ksc, vsc))
        s = torch.einsum("bhrd,bhkd->bhrk", codes.float(), kg.float()) \
            * qs * kk
        pos = qo.long()[:, None] + torch.arange(codes.shape[2],
                                                device=dev) % tq
        vis = (torch.arange(NB * blk, device=dev)[None, None, None]
               <= pos[:, None, :, None])
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

    def q8q_teeth(case, kernel, route="q8q"):
        """The gate against B5's plain version (``route`` "q8": B2's with
        ``block_scales``) on ``case``: the arithmetic written out here, its
        two planted scale faults, and ``kernel``'s output halved."""
        if route == "q8q":
            def call(f):
                return f(*case[:6], q_offset=case[6])

            plain = call(cuda_decode.paged_decode_q8q_plain)
        else:
            def call(f):
                return f(*case[:4], q_offset=case[6],
                         block_scales=case[4:6])

            plain = call(cuda_decode.paged_decode_plain)
        teeth = {f: gate(q8q_paged_here(case, f, route), plain)
                 for f in (None, "logical", "v_early")}
        o, l = call(kernel)
        teeth["halved"] = gate((o * 0.5, l), plain)
        return teeth

    teeth = q8q_teeth(serve_q8, cuda_decode.attention_cuda_decode_paged_q8q)
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
    cast_teeth = q8q_teeth(serve_q8, b2t, route="q8")
    q8_teeth["cast tick"] = {str(f): {"pass": r[0], "rel": r[2], "dlse": r[3]}
                             for f, r in cast_teeth.items()}
    print(f"gate at B2's cast tick: written out here {cast_teeth[None][2]:.3e}"
          f" relative (passes: {cast_teeth[None][0]}); scales by logical "
          f"block -> {cast_teeth['logical'][2]:.3e}; V scalar before l -> "
          f"{cast_teeth['v_early'][2]:.3e}; output halved -> "
          f"{cast_teeth['halved'][2]:.3e}", flush=True)
    if not cast_teeth[None][0] or any(cast_teeth[f][0] for f in
                                      ("logical", "v_early", "halved")):
        fail("the parity gate at B2's cast tick fails its own arithmetic "
             "or accepts a planted fault")
    del serve_q8, kp8, vp8

    # The tick body (cuda_decode.decode_body "tick": B2, its cast route
    # and B5 at one packed row through a table) over D 64 and 128 and 64-
    # and 16-token blocks: 8 slots x 16 heads of at most 640 tokens on
    # disjoint tables, ragged, one slot with no visible key, one full, one
    # ending on a block edge. Every call counted on .tick_launches, gated
    # and timed beside its bound (bf16: and SDPA over the gathered view;
    # int8: SDPA over the dequantized view as the yardstick); the serve
    # shape's cases (D 128, block 64) are the head cases above. Bit for
    # bit: NaN in the keys past each slot's frontier inside its last block,
    # NaN blocks past each slot and in blocks no table names (bf16); codes
    # past each frontier changed and NaN scalars on blocks past each slot
    # and unnamed (int8) — all unread.
    tick_bits = {}
    for D in (128, 64):
        for tblk in (64, 16):
            tnb = 640 // tblk
            tn = 8 * tnb + 4  # the slots' blocks, and 4 no table names
            tk, tv = rnd(tn, 16, tblk, D), rnd(tn, 16, tblk, D)
            tkq, tvq = (torch.randint(-127, 128, (tn, 16, tblk, D),
                                      generator=g, device=dev,
                                      dtype=torch.int8) for _ in range(2))
            tbs = tuple(torch.rand((tn, 16), generator=g, device=dev) * 0.03
                        + 0.005 for _ in range(2))
            tcs = tuple(torch.rand((8, 16, 1, D), generator=g, device=dev)
                        * 0.03 + 0.005 for _ in range(2))
            ttab = torch.randperm(tn, generator=g, device=dev)[:8 * tnb] \
                .reshape(8, tnb).to(torch.int32)
            tq = rnd(8, 16, 1, D)
            tqo = torch.randint(0, 639, (8,), generator=g, device=dev,
                                dtype=torch.int32)
            tqo[0], tqo[1], tqo[2] = -1, 639, 3 * tblk - 1
            pairs = 16 * visible_pairs(tqo, 1, 640)
            tag = f"D{D} block{tblk} B8 H16 Tq1 ragged"
            cases_here = {
                "bf16": (b2t, lambda k_, v_, s_: b2t(tq, k_, v_, ttab,
                                                     q_offset=tqo)),
                "cast, per-block scales": (
                    b2t, lambda k_, v_, s_: b2t(tq, k_, v_, ttab,
                                                q_offset=tqo,
                                                block_scales=s_)),
                "q8q, per-block scales": (
                    b5t, lambda k_, v_, s_: b5t(tq, k_, v_, ttab, *s_,
                                                q_offset=tqo)),
                "q8q, channel scales": (
                    b5t, lambda k_, v_, s_: b5t(tq, k_, v_, ttab, *tcs,
                                                q_offset=tqo)),
            }
            plains = {
                "bf16": lambda: cuda_decode.paged_decode_plain(
                    tq, tk, tv, ttab, q_offset=tqo),
                "cast, per-block scales": lambda: cuda_decode
                .paged_decode_plain(tq, tkq, tvq, ttab, q_offset=tqo,
                                    block_scales=tbs),
                "q8q, per-block scales": lambda: cuda_decode
                .paged_decode_q8q_plain(tq, tkq, tvq, ttab, *tbs,
                                        q_offset=tqo),
                "q8q, channel scales": lambda: cuda_decode
                .paged_decode_q8q_plain(tq, tkq, tvq, ttab, *tcs,
                                        q_offset=tqo),
            }
            mask = gqa_mask(tqo, 1, 640)
            kg, vg = gather_paged_kv(tk, tv, ttab)
            kgd, vgd = gather_paged_kv(deq(tkq, tbs[0][..., None, None]),
                                       deq(tvq, tbs[1][..., None, None]),
                                       ttab)
            # Past each slot: the rest of its last block, and its later
            # blocks; and the blocks no table names.
            past = torch.zeros((tn,), dtype=torch.bool, device=dev)
            unnamed = sorted(set(range(tn)) - set(ttab.flatten().tolist()))
            past[torch.tensor(unnamed, device=dev, dtype=torch.long)] = True
            tails = []
            for b_, o in enumerate(tqo.tolist()):
                j1 = max(o + 1, 0)
                for nb_ in range(-(-j1 // tblk), tnb):
                    past[ttab[b_, nb_].long()] = True
                if j1 % tblk:
                    tails.append((int(ttab[b_, j1 // tblk]), j1 % tblk))
            for name, (wr, call) in cases_here.items():
                int8 = name != "bf16"
                kk, vv = (tkq, tvq) if int8 else (tk, tv)
                fn = (lambda wr=wr, call=call, kk=kk, vv=vv:
                      ticked(wr, lambda: call(kk, vv, tbs)))
                if D == 128 and tblk == 64:
                    # the serve shape: timed above; here the gate only
                    ok, eo, er, el = gate(fn(), plains[name]())
                    if not ok:
                        fail(f"tick {name} {tag}: |dout| {eo:.3e}, relative "
                             f"{er:.3e}, |dlse| {el:.3e}")
                else:
                    kernel = ("flash_decode_paged_q8q_tick"
                              if name.startswith("q8q")
                              else "flash_decode_paged_tick")
                    elem = 1 if int8 else 2
                    nbytes = (pairs * D * elem * 2 + tq.numel() * 4
                              + (2 * 8 * tnb * 16 * 4 if "per-block" in name
                                 else 2 * tcs[0].numel() * 4 if int8 else 0))
                    record(kernel, f"{'int8 ' if int8 else ''}{tag}, {name}",
                           fn, plains[name],
                           None if int8 else (
                               lambda: F.scaled_dot_product_attention(
                                   tq, kg, vg, attn_mask=mask)),
                           nbytes, 0.0 if int8 else 4.0 * D * pairs,
                           ops_s=(q8_ops_s(pairs, name.startswith("q8q"))
                                  * D / 128 if int8 else None),
                           yardstick=(lambda: F.scaled_dot_product_attention(
                               tq, kgd, vgd, attn_mask=mask))
                           if int8 else None, names=own)
                # Bit for bit: what lies past each slot is never read.
                want = fn()
                kk2, vv2 = kk.clone(), vv.clone()
                if int8:
                    for pb_, r_ in tails:
                        kk2[pb_, :, r_:] = 127
                        vv2[pb_, :, r_:] = -127
                    kk2[past], vv2[past] = -127, 127
                    sc2 = tuple(x.clone() for x in tbs)
                    for x in sc2:
                        x[past] = math.nan
                else:
                    for pb_, r_ in tails:
                        kk2[pb_, :, r_:] = math.nan
                        vv2[pb_, :, r_:] = math.nan
                    kk2[past], vv2[past] = math.nan, math.nan
                    sc2 = tbs
                got = ticked(wr, lambda: call(kk2, vv2, sc2))
                same = (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1]))
                tick_bits[f"{tag}, {name}"] = same
                if not same:
                    fail(f"tick {name} {tag}: what lies past each slot "
                         f"changed the result")
            del tk, tv, tkq, tvq, kg, vg, kgd, vgd
    print(f"tick body: {len(tick_bits)} sweep cases under the row gate, "
          f"past-the-frontier bytes unread bit for bit in every one: "
          f"{all(tick_bits.values())}", flush=True)

    # One long paged slot: the reference workload through a table (B1 H16,
    # 1000 blocks of 64 tokens), bf16 and B5 over its per-block-quantized
    # pool — the tick body's largest cluster.
    lk, lv = rnd(1000, 16, 64, 128), rnd(1000, 16, 64, 128)
    ltab = torch.randperm(1000, generator=g, device=dev)[None].to(torch.int32)
    lq = rnd(1, 16, 1, 128)
    lqo = torch.full((1,), 63999, dtype=torch.int32, device=dev)
    kg, vg = gather_paged_kv(lk, lv, ltab)
    record("flash_decode_paged_tick", "long slot B1 H16 block64 NB1000 Tq1",
           lambda: ticked(b2t, lambda: b2t(lq, lk, lv, ltab, q_offset=lqo)),
           lambda: cuda_decode.paged_decode_plain(lq, lk, lv, ltab,
                                                  q_offset=lqo),
           lambda: F.scaled_dot_product_attention(lq, kg, vg),
           2 * lk.numel() * 2 + 2 * lq.numel() * 2, 4.0 * 16 * 64000 * 128,
           names=own)
    del kg, vg
    lkq, lks = cuda_decode.quantize_symmetric_int8(lk.reshape(1000, 16, -1), 2)
    lvq, lvs = cuda_decode.quantize_symmetric_int8(lv.reshape(1000, 16, -1), 2)
    lkq, lvq = lkq.reshape(lk.shape), lvq.reshape(lv.shape)
    lks, lvs = lks[..., 0], lvs[..., 0]
    del lk, lv
    kgd, vgd = gather_paged_kv(deq(lkq, lks[..., None, None]),
                               deq(lvq, lvs[..., None, None]), ltab)
    record("flash_decode_paged_q8q_tick", "int8 long slot B1 H16 block64 "
           "NB1000 Tq1, per-block scales",
           lambda: ticked(b5t, lambda: b5t(lq, lkq, lvq, ltab, lks, lvs,
                                           q_offset=lqo)),
           lambda: cuda_decode.paged_decode_q8q_plain(lq, lkq, lvq, ltab, lks,
                                                      lvs, q_offset=lqo),
           None, 2 * lkq.numel() + lq.numel() * 4 + 2 * 1000 * 16 * 4, 0.0,
           ops_s=q8_ops_s(16 * 64000, True),
           yardstick=lambda: F.scaled_dot_product_attention(lq, kgd, vgd),
           names=own)
    del lkq, lvq, kgd, vgd

    # The gate has teeth for the in-cluster merge: at the serve shape it
    # rejects the result with the last cluster rank's partial left out —
    # the plain version with that rank's units (cuda_decode.tick_units at
    # this launch's geometry) hidden.
    tgeo = cuda_decode.decode_geometry("tick", 1, 8, 16, nb * blk)
    cut = table.clone()
    for b_, o in enumerate(qoff.tolist()):
        for nb_, _, _ in cuda_decode.tick_units(tgeo, tgeo.ctas - 1, o, 1,
                                                nb * blk, blk):
            cut[b_, nb_] = -1
    rank_out = gate(cuda_decode.paged_decode_plain(q, kp, vp, cut,
                                                   q_offset=qoff,
                                                   local_blocks=True),
                    cuda_decode.paged_decode_plain(q, kp, vp, table,
                                                   q_offset=qoff))
    tick_teeth = {"cluster": tgeo.ctas, "last_rank_left_out": {
        "pass": rank_out[0], "rel": rank_out[2], "dlse": rank_out[3]}}
    print(f"gate at the tick's serve shape (cluster of {tgeo.ctas}): the "
          f"last rank's partial left out -> relative |dout| "
          f"{rank_out[2]:.3e}, |dlse| {rank_out[3]:.3e}, rejected: "
          f"{not rank_out[0]}", flush=True)
    if rank_out[0] or tgeo.ctas < 2:
        fail("the parity gate accepts a cluster rank's partial left out")

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
    local_unnamed = {}  # tick: the pool past each frontier unread

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
                                  block_scales=sr, local_blocks=True,
                                  local_shards=W)

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
                        record("flash_decode_paged_local_tick" if tq == 1
                               else "flash_decode_paged_local_tiled", name,
                               fn, plain,
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
                    if tq == 1:
                        # A tick reads nothing of the rank's pool past each
                        # slot's frontier: the rest of the frontier block
                        # (NaN, bf16; other codes, int8) and every block no
                        # slot needs (NaN, or NaN scalars) change nothing,
                        # bit for bit.
                        need = torch.zeros(nl, dtype=torch.bool, device=dev)
                        tails = []
                        lrow = loc.tolist()
                        for b_, o in enumerate(qoff.tolist()):
                            for nb_, pb_ in enumerate(lrow[b_]):
                                if pb_ >= 0 and nb_ * blk <= o:
                                    need[pb_] = True
                                    if o + 1 < (nb_ + 1) * blk:
                                        tails.append((pb_, o + 1 - nb_ * blk))
                        k2, v2 = kr.clone(), vr.clone()
                        s2 = sr
                        if int8:
                            s2 = tuple(x.clone() for x in sr)
                            for x in s2:
                                x[~need] = math.nan
                            for pb_, r_ in tails:
                                k2[pb_, :, r_:], v2[pb_, :, r_:] = 127, -127
                        else:
                            k2[~need], v2[~need] = math.nan, math.nan
                            for pb_, r_ in tails:
                                k2[pb_, :, r_:] = math.nan
                                v2[pb_, :, r_:] = math.nan
                        a_, b_ = fn(), b2(q, k2, v2, loc, q_offset=qoff,
                                          block_scales=s2, local_blocks=True,
                                          local_shards=W)
                        if not (torch.equal(a_[0], b_[0])
                                and torch.equal(a_[1], b_[1])):
                            fail(f"B2 local_blocks tick {name}: bytes past "
                                 f"a slot's frontier were read")
                        local_unnamed[name] = True
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
    # ... on the tick body too (one packed row).
    q1 = rnd(8, 16, 1, 128)
    o, l = ticked(b2, lambda: b2(q1, kr, vr, loc, q_offset=qoff,
                                 local_blocks=True))
    identity = identity and bool(torch.all(o[3] == 0)
                                 and torch.all(torch.isneginf(l[3])))
    read0 = gate(b2(q, kr, vr, loc.clamp(min=0), q_offset=qoff),
                 cuda_decode.paged_decode_plain(q, kr, vr, loc, q_offset=qoff,
                                                local_blocks=True))
    local_teeth = {"all_remote_row_is_identity": identity,
                   "tick_past_frontier_unread": local_unnamed,
                   "remote_read_as_block0": {"pass": read0[0],
                                             "rel": read0[2],
                                             "dlse": read0[3]}}
    print(f"B2 local_blocks: all-remote row exactly (0, -inf) (the tick "
          f"and the 64-row chunk): {identity}; the rank's pool past each "
          f"frontier poisoned, unread bit for bit at the tick: "
          f"{len(local_unnamed)} calls; "
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

    # -- 2d. the tree variants of B1, B2, B4 and B5 -------------------------
    # Speculative tree verification: the tree mask replaces the causal rule
    # with the ancestor-window rule. Masks are random draft trees packed as
    # pack_proposal packs them (slot 1 a plain chain; at Tq 32 every slot's
    # last row sets bit 31). Shapes: B2/B5 at a verify tick (B8 H16, Tq 8
    # and 32, 640-token slots of 64-token blocks; bf16, int8 with per-block
    # scales), B1/B4 at the contiguous verify tick (B8 H16 Tk640) and at the
    # reference workload with Tq 8, and the int8-cast routes of B1 and B2.
    # Bound: the keys some row sees (history plus the window), K+V, plus Q
    # and the output / 3.35 TB/s, or the visible (row, key) pairs' products.
    # Library: SDPA with a boolean attn_mask over the gathered view (the
    # labelled yardstick for the int8 routes: over the dequantized view).
    from tree_attention_tpu_torch.ops.block_utils import tree_window_mask

    def tree_counts(trees, qoff, tk):
        """(keys some row sees, visible (row, key) pairs) over the slots:
        each row sees the history below the window and its ancestors."""
        tq = trees.shape[1]
        keys = sum(min(tk, int(o) + tq) for o in qoff.tolist())
        pairs = int(trees.sum()) + tq * int(qoff.clamp(max=tk).sum())
        return keys, pairs

    def tree_sdpa_mask(trees, qoff, tk):
        return tree_window_mask(trees, qoff, torch.zeros_like(qoff),
                                tk)[:, None]  # (B, 1, Tq, Tk)

    tree_cases = {}
    causal_ms = {}  # the causal launch on the same inputs: the mask's cost
    blk, nb, npool = 64, 10, 96
    kp, vp = rnd(npool, 16, blk, 128), rnd(npool, 16, blk, 128)
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
    del x
    table = torch.stack([torch.randperm(npool, generator=g, device=dev)[:nb]
                         for _ in range(8)]).to(torch.int32)
    kgd, vgd = gather_paged_kv(deq(kp8, kbs[..., None, None]),
                               deq(vp8, vbs[..., None, None]), table)
    kg, vg = gather_paged_kv(kp, vp, table)
    b2, b5 = (cuda_decode.attention_cuda_decode_paged,
              cuda_decode.attention_cuda_decode_paged_q8q)
    for tq in TREE_TQS:
        q = rnd(8, 16, tq, 128)
        qoff = torch.randint(0, nb * blk - tq, (8,), generator=g, device=dev,
                             dtype=torch.int32)
        qoff[0] = 3 * blk - 3  # the window straddles a block boundary
        trees = random_trees(8, tq, 1, tq).to(dev)
        keys, pairs = tree_counts(trees, qoff, nb * blk)
        mask = tree_sdpa_mask(trees, qoff, nb * blk)
        tree_cases[tq] = (q, qoff, trees)
        record("flash_decode_paged_tree", f"B8 H16 block64 NB10 Tq{tq} tree",
               lambda: b2(q, kp, vp, table, q_offset=qoff, tree_mask=trees),
               lambda: cuda_decode.paged_decode_plain(
                   q, kp, vp, table, q_offset=qoff, tree_mask=trees),
               lambda: F.scaled_dot_product_attention(q, kg, vg,
                                                      attn_mask=mask),
               keys * 16 * 128 * 2 * 2 + 2 * q.numel() * 2,
               4.0 * 16 * 128 * pairs, names=own)
        record("flash_decode_paged_q8q_tree",
               f"int8 B8 H16 block64 NB10 Tq{tq} tree, per-block scales",
               lambda: b5(q, kp8, vp8, table, kbs, vbs, q_offset=qoff,
                          tree_mask=trees),
               lambda: cuda_decode.paged_decode_q8q_plain(
                   q, kp8, vp8, table, kbs, vbs, q_offset=qoff,
                   tree_mask=trees),
               None, keys * 16 * 128 * 2 + q.numel() * 4
               + 2 * 8 * nb * 16 * 4, 0.0,
               ops_s=q8_ops_s(16 * pairs, True),
               yardstick=lambda: F.scaled_dot_product_attention(
                   q, kgd, vgd, attn_mask=mask), names=own)
        for name, fn in (
                ("B2", lambda: b2(q, kp, vp, table, q_offset=qoff)),
                ("B5", lambda: b5(q, kp8, vp8, table, kbs, vbs,
                                  q_offset=qoff))):
            causal_ms[f"{name} Tq{tq}"] = time_ms(
                fn, keys * 16 * 128 * 2 / HBM_BYTES_PER_S * 1e3,
                names=own)[0]
    print(f"the same inputs without the mask (causal launch) ms: "
          f"{json.dumps(causal_ms)}", flush=True)
    q, qoff, trees = tree_cases[8]
    keys, pairs = tree_counts(trees, qoff, nb * blk)
    mask = tree_sdpa_mask(trees, qoff, nb * blk)
    record("flash_decode_paged_tree",
           "int8 B8 H16 block64 NB10 Tq8 tree, block_scales",
           lambda: b2(q, kp8, vp8, table, q_offset=qoff,
                      block_scales=(kbs, vbs), tree_mask=trees),
           lambda: cuda_decode.paged_decode_plain(
               q, kp8, vp8, table, q_offset=qoff, block_scales=(kbs, vbs),
               tree_mask=trees),
           None, keys * 16 * 128 * 2 + q.numel() * 4 + 2 * 8 * nb * 16 * 4,
           0.0, ops_s=q8_ops_s(16 * pairs, False),
           yardstick=lambda: F.scaled_dot_product_attention(
               q, kgd, vgd, attn_mask=mask), names=own)
    # Lower-triangular masks give the causal launches' out and lse bit for
    # bit (B2 and B5 here, B1 and B4 below); rows past a slot's window never
    # read a table entry past it: every entry past each slot's window names
    # a block of NaN (int8: NaN block scales), and the result is unchanged.
    tree_teeth = {}
    tril8 = torch.tril(torch.ones(8, 8, dtype=torch.bool, device=dev)
                       ).expand(8, 8, 8)
    for name, fn in (
            ("B2", lambda **kw: b2(q, kp, vp, table, q_offset=qoff, **kw)),
            ("B5", lambda **kw: b5(q, kp8, vp8, table, kbs, vbs,
                                   q_offset=qoff, **kw))):
        a, t = fn(), fn(tree_mask=tril8)
        tree_teeth[f"{name} tril == causal"] = (torch.equal(a[0], t[0])
                                                and torch.equal(a[1], t[1]))
    q32, qoff32, trees32 = tree_cases[32]
    past = (torch.arange(nb, device=dev)[None] * blk
            >= (qoff32 + 32)[:, None])
    used = torch.zeros(npool, dtype=torch.bool, device=dev)
    used[table.long().flatten()] = True
    spare = int((~used).nonzero()[0])  # a block no slot maps
    nan_table = torch.where(past, spare, table).to(torch.int32)
    kn, vn = kp.clone(), vp.clone()
    kn[spare], vn[spare] = math.nan, math.nan
    ksn, vsn = kbs.clone(), vbs.clone()
    ksn[spare], vsn[spare] = math.nan, math.nan
    if not bool(past.any()):
        fail("tree: no table entry lies past a window")
    for name, a, t in (
            ("B2", b2(q32, kp, vp, table, q_offset=qoff32, tree_mask=trees32),
             b2(q32, kn, vn, nan_table, q_offset=qoff32, tree_mask=trees32)),
            ("B5", b5(q32, kp8, vp8, table, kbs, vbs, q_offset=qoff32,
                      tree_mask=trees32),
             b5(q32, kp8, vp8, nan_table, ksn, vsn, q_offset=qoff32,
                tree_mask=trees32))):
        tree_teeth[f"{name} entries past the window unread"] = (
            torch.equal(a[0], t[0]) and torch.equal(a[1], t[1]))
    del kn, vn
    # The gate has teeth for the window rule: it rejects each row reading
    # the previous row's bits, and the window shifted by one key.
    got = b2(q32, kp, vp, table, q_offset=qoff32, tree_mask=trees32)
    for fault, plain in (
            ("previous row's bits", cuda_decode.paged_decode_plain(
                q32, kp, vp, table, q_offset=qoff32,
                tree_mask=trees32.roll(1, 1))),
            ("window shifted by one key", cuda_decode.paged_decode_plain(
                q32, kp, vp, table, q_offset=qoff32 + 1,
                tree_mask=trees32))):
        r = gate(got, plain)
        tree_teeth[fault] = {"pass": r[0], "rel": r[2], "dlse": r[3]}
    print(f"tree variants: {json.dumps(tree_teeth)}", flush=True)
    if not all(tree_teeth[k] for k in tree_teeth if "==" in k or "unread"
               in k) or any(tree_teeth[f]["pass"] for f in (
                   "previous row's bits", "window shifted by one key")):
        fail(f"tree variants: {tree_teeth}")
    del kp, vp, kp8, vp8, kg, vg, kgd, vgd, got
    # B1 and B4 at the contiguous verify tick (8 slots of 640 tokens) and at
    # the reference workload with Tq 8; the int8-cast route of B1.
    b1, b4 = (cuda_decode.attention_cuda_decode,
              cuda_decode.attention_cuda_decode_q8q)
    for shape, B, tk in (("B8 H16 Tk640", 8, 640),
                         ("ref B1 H16 Tk64000", 1, 64000)):
        q, k, v = rnd(B, 16, 8, 128), rnd(B, 16, tk, 128), rnd(B, 16, tk, 128)
        qoff = (torch.randint(0, tk - 8, (B,), generator=g, device=dev,
                              dtype=torch.int32) if B > 1 else
                torch.full((1,), tk - 8, dtype=torch.int32, device=dev))
        trees = random_trees(B, 8, 1 if B > 1 else -1, 3).to(dev)
        keys, pairs = tree_counts(trees, qoff, tk)
        mask = tree_sdpa_mask(trees, qoff, tk)
        kq, vq, ks, vs = cuda_decode.quantize_kv_channelwise(k, v)
        kd, vd = deq(kq, ks), deq(vq, vs)
        kw = dict(causal=True, q_offset=qoff)
        record("flash_decode_tree", f"{shape} Tq8 tree",
               lambda: b1(q, k, v, tree_mask=trees, **kw),
               lambda: cuda_decode.decode_plain(q, k, v, tree_mask=trees,
                                                **kw),
               lambda: F.scaled_dot_product_attention(q, k, v,
                                                      attn_mask=mask),
               keys * 16 * 128 * 2 * 2 + 2 * q.numel() * 2,
               4.0 * 16 * 128 * pairs, names=own)
        q8_bytes = keys * 16 * 128 * 2 + q.numel() * 4 + 4 * ks.numel() * 4
        record("flash_decode_q8q_tree", f"int8 {shape} Tq8 tree",
               lambda: b4(q, kq, vq, ks, vs, tree_mask=trees, **kw),
               lambda: cuda_decode.decode_q8q_plain(
                   q, kq, vq, ks, vs, tree_mask=trees, **kw),
               None, q8_bytes, 0.0, ops_s=q8_ops_s(16 * pairs, True),
               yardstick=lambda: F.scaled_dot_product_attention(
                   q, kd, vd, attn_mask=mask), names=own)
        if B == 1:
            record("flash_decode_tree", f"int8 {shape} Tq8 tree, cast",
                   lambda: cuda_decode.attention_cuda_decode_q8(
                       q, kq, vq, ks, vs, tree_mask=trees, **kw),
                   lambda: cuda_decode.decode_q8_plain(
                       q, kq, vq, ks, vs, tree_mask=trees, **kw),
                   None, q8_bytes, 0.0, ops_s=q8_ops_s(16 * pairs, False),
                   yardstick=lambda: F.scaled_dot_product_attention(
                       q, kd, vd, attn_mask=mask), names=own)
        tril = torch.tril(torch.ones(8, 8, dtype=torch.bool, device=dev)
                          ).expand(B, 8, 8)
        for name, fn in (("B1", lambda **a: b1(q, k, v, **kw, **a)),
                         ("B4", lambda **a: b4(q, kq, vq, ks, vs, **kw,
                                               **a))):
            a, t = fn(), fn(tree_mask=tril)
            same = torch.equal(a[0], t[0]) and torch.equal(a[1], t[1])
            tree_teeth[f"{name} {shape} tril == causal"] = same
            if not same:
                fail(f"tree: {name} {shape} with a lower-triangular mask "
                     f"differs from the causal launch")
        del q, k, v, kq, vq, kd, vd, mask
    torch.cuda.empty_cache()

    # -- 2e. B2's multi-row body: bf16, more than one packed row ----------
    # The body the plain serve's prompt tails (chunk buckets Tq 8-64, below
    # the Q-tile width), the verify ticks (2d) and the sharded pool's chunks
    # (2b) run, by cuda_decode.decode_body's rule. Row gate against the
    # plain version at Tq 2, 8, 28, 32, 64, 127 for G 1 (H16) and 4 (Hq64
    # Hkv16) over 640-token slots of 64-token blocks, ragged: one slot's
    # window ends on a block's last key, one starts on a block's first;
    # every table entry past each slot's window names a block of NaN (never
    # read). Then local_blocks (W 2, rank 0) with the rank's slice holding
    # NaN in block 0 and in every block its table does not name: a remote
    # entry read as block 0 would poison its row. Each launch must count on
    # .tiled_launches. Timed: the prompt-tail buckets, the 64-row chunk
    # first, beside SDPA with the causal mask over the gathered view.
    tiled_gate = {}
    b2 = cuda_decode.attention_cuda_decode_paged
    blk, nb, npool = 64, 10, 96
    kp, vp = rnd(npool, 16, blk, 128), rnd(npool, 16, blk, 128)
    table = torch.stack([torch.randperm(npool, generator=g, device=dev)[:nb]
                         for _ in range(8)]).to(torch.int32)
    used = torch.zeros(npool, dtype=torch.bool, device=dev)
    used[table.long().flatten()] = True
    spare = int((~used).nonzero()[0])
    kn, vn = kp.clone(), vp.clone()
    kn[spare], vn[spare] = math.nan, math.nan

    def tiled_call(fn):
        before = b2.tiled_launches
        out = fn()
        if b2.tiled_launches != before + 1:
            fail("B2's multi-row body did not take a bf16 multi-row launch")
        return out

    def ragged_qoff(tq):
        qoff = torch.randint(0, nb * blk - tq, (8,), generator=g, device=dev,
                             dtype=torch.int32)
        qoff[0] = 3 * blk - tq  # the window ends on a block's last key
        qoff[1] = 5 * blk       # ... starts on a block's first key
        return qoff

    for G in (1, 4):
        for tq in (2, 8, 28, 32, 64, 127):
            q = rnd(8, 16 * G, tq, 128)
            qoff = ragged_qoff(tq)
            past = (torch.arange(nb, device=dev)[None] * blk
                    >= (qoff + tq)[:, None])
            nan_table = torch.where(past, spare, table).to(torch.int32)
            got = tiled_call(lambda: b2(q, kn, vn, nan_table, q_offset=qoff))
            ok, eo, er, el = gate(got, cuda_decode.paged_decode_plain(
                q, kp, vp, table, q_offset=qoff))
            tiled_gate[f"G{G} Tq{tq}"] = {"pass": ok, "max_abs_err": eo,
                                          "max_rel_err": er,
                                          "max_abs_err_lse": el}
            if not ok:
                fail(f"B2 multi-row G{G} Tq{tq} (entries past each window "
                     f"NaN): |dout| {eo:.3e}, relative {er:.3e}, |dlse| "
                     f"{el:.3e}")
    from tree_attention_tpu_torch.serving import ShardedBlockAllocator

    alloc = ShardedBlockAllocator(80, 2)
    alloc.reserve(80)
    gtable = torch.tensor([[alloc.alloc() for _ in range(nb)]
                           for _ in range(8)], dtype=torch.int32, device=dev)
    kr, vr = kp[:40], vp[:40]  # rank 0's slice: global ids [0, 40)
    loc = torch.where(gtable < 40, gtable, -1).to(torch.int32)
    nan_blocks = torch.full((9, 16, blk, 128), math.nan, device=dev,
                            dtype=torch.bfloat16)
    kpois = torch.cat([nan_blocks[:1], kr, nan_blocks[1:]])
    vpois = torch.cat([nan_blocks[:1], vr, nan_blocks[1:]])
    for tq in (8, 64):
        q = rnd(8, 16, tq, 128)
        qoff = ragged_qoff(tq)
        past = (torch.arange(nb, device=dev)[None] * blk
                >= (qoff + tq)[:, None])
        # Held entries shift by the NaN block 0; past each window they name
        # it (held, never read); remote entries stay -1.
        lpois = torch.where(loc >= 0, torch.where(past, 0, loc + 1),
                            -1).to(torch.int32)
        got = tiled_call(lambda: b2(q, kpois, vpois, lpois, q_offset=qoff,
                                    local_blocks=True, local_shards=2))
        ok, eo, er, el = gate(got, cuda_decode.paged_decode_plain(
            q, kr, vr, loc, q_offset=qoff, local_blocks=True))
        tiled_gate[f"local W2 rank0 Tq{tq}"] = {
            "pass": ok, "max_abs_err": eo, "max_rel_err": er,
            "max_abs_err_lse": el}
        if not ok:
            fail(f"B2 multi-row local_blocks Tq{tq} (unnamed blocks NaN): "
                 f"|dout| {eo:.3e}, relative {er:.3e}, |dlse| {el:.3e}")
    print(f"B2 multi-row body, row gate (entries past each window and "
          f"unnamed local blocks NaN): worst relative "
          f"{max(c['max_rel_err'] for c in tiled_gate.values()):.3e}, |dlse| "
          f"{max(c['max_abs_err_lse'] for c in tiled_gate.values()):.3e}, "
          f"{len(tiled_gate)} cases pass", flush=True)
    del kn, vn, kpois, vpois, nan_blocks, kr, vr
    kg, vg = gather_paged_kv(kp, vp, table)
    for tq in (64, 8, 16, 32):
        q = rnd(8, 16, tq, 128)
        qoff = ragged_qoff(tq)
        need = sum(min(nb * blk, int(o) + tq) for o in qoff.tolist())
        mask = gqa_mask(qoff, tq, nb * blk)
        record("flash_decode_paged_tiled",
               f"{'chunk' if tq == 64 else 'prompt tail'} B8 H16 block64 "
               f"NB10 Tq{tq} ragged",
               lambda: b2(q, kp, vp, table, q_offset=qoff),
               lambda: cuda_decode.paged_decode_plain(q, kp, vp, table,
                                                      q_offset=qoff),
               lambda: F.scaled_dot_product_attention(q, kg, vg,
                                                      attn_mask=mask),
               need * 16 * 128 * 2 * 2 + 2 * q.numel() * 2,
               4.0 * 16 * 128 * visible_pairs(qoff, tq, nb * blk),
               names=own)
    del kp, vp, kg, vg, mask

    # -- 2f. B1 and B5 on the multi-row body --------------------------------
    # B1 (contiguous bf16) and B5 (paged int8 x int8) with more than one
    # packed row take the multi-row body (cuda_decode.decode_body), as B2
    # does: every such launch must count on the wrapper's .tiled_launches.
    # B1 under the row gate at GQA Tq 16 over Tk 4096 and 4037, Tq 2, 5, 64,
    # 127 at G 1 and 4, D 64 and 128, causal with per-slot kv_offset (a
    # tree_decode shard; slot 2's shard lies wholly past its frontier and
    # must come back exactly (0, -inf)) and not causal; K/V rows past each
    # slot's frontier set to NaN change nothing, bit for bit; the gate
    # rejects an output halved and one split's keys left out. (The tree
    # ticks, tril == causal included, are phase 2d's.) B5 at the verify
    # ticks (B8 H16 640-token slots, Tq 8 and 32, chain and tree) over
    # 64- and 16-token blocks whose magnitudes, and so per-block scales,
    # differ by block, and with channel scales; codes at +-127 at D 128;
    # tril == causal and NaN blocks and NaN scales past each window change
    # nothing, bit for bit; the gate rejects scales read by logical block,
    # the V scalar applied before the softmax sum and an output halved.
    # Timed: B5's chain verify ticks (its tree ticks are phase 2d's).
    b1 = cuda_decode.attention_cuda_decode
    b5 = cuda_decode.attention_cuda_decode_paged_q8q
    multi_gate = {}

    def multi_call(w, fn, cast=False):
        """``fn()``, which must launch ``w``'s multi-row body once (with
        ``cast``, its int8 cast route: counted on .cast_tiled_launches
        too, and only then)."""
        def counts():
            return (w.tiled_launches, getattr(w, "cast_tiled_launches", 0))

        before = counts()
        out = fn()
        if counts() != (before[0] + 1, before[1] + int(cast)):
            fail(f"{w.__name__}: a multi-row launch did not take the "
                 f"multi-row body")
        return out

    def multi_check(name, got, want, store=multi_gate):
        ok, eo, er, el = gate(got, want)
        store[name] = {"pass": ok, "max_abs_err": eo, "max_rel_err": er,
                       "max_abs_err_lse": el}
        if not ok:
            fail(f"multi-row {name}: |dout| {eo:.3e}, relative {er:.3e}, "
                 f"|dlse| {el:.3e}")

    def same(a, b):
        return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    multi_bits = {}
    for D in (64, 128):
        for G, tq, tk in ((4, 16, 4096), (4, 16, 4037), (1, 2, 640),
                          (4, 5, 640), (1, 64, 700), (4, 127, 700)):
            q = rnd(4, 8 * G, tq, D)
            k, v = rnd(4, 8, tk, D), rnd(4, 8, tk, D)
            qo = torch.tensor([tk - tq, 500, tk - 1, 60], dtype=torch.int32,
                              device=dev)
            ko = torch.tensor([0, 37, tk + 200, 5], dtype=torch.int32,
                              device=dev)
            kw = dict(causal=True, q_offset=qo, kv_offset=ko)
            name = f"B1 D{D} G{G} Tq{tq} Tk{tk}"
            got = multi_call(b1, lambda: b1(q, k, v, **kw))
            multi_check(name + " causal", got,
                        cuda_decode.decode_plain(q, k, v, **kw))
            if not (torch.all(got[0][2] == 0)
                    and torch.all(torch.isneginf(got[1][2]))):
                fail(f"{name}: the shard past its frontier is not (0, -inf)")
            multi_check(name + " not causal",
                        multi_call(b1, lambda: b1(q, k, v)),
                        cuda_decode.decode_plain(q, k, v))
            kn, vn = k.clone(), v.clone()
            for b in range(4):
                lo = max(0, int(qo[b] - ko[b]) + tq)
                kn[b, :, lo:], vn[b, :, lo:] = math.nan, math.nan
            multi_bits[f"{name} NaN past each frontier unread"] = same(
                got, b1(q, kn, vn, **kw))
            del kn, vn
    # The gate has teeth at B1's multi-row shape (the last one above, GQA
    # Tq 16 is the first: redo it): an output halved, the first split's
    # keys left out.
    q, k, v = rnd(8, 32, 16, 128), rnd(8, 8, 4096, 128), rnd(8, 8, 4096, 128)
    qo = torch.randint(1024, 4096 - 16, (8,), generator=g, device=dev,
                       dtype=torch.int32)
    plain = cuda_decode.decode_plain(q, k, v, causal=True, q_offset=qo)
    o, l = b1(q, k, v, causal=True, q_offset=qo)
    cut = cuda_decode.decode_geometry("tiled", 64, 8, 8, 4096).split_len
    half = gate((o * 0.5, l), plain)
    dropped = gate(cuda_decode.decode_plain(
        q, k[:, :, cut:], v[:, :, cut:], causal=True, q_offset=qo,
        kv_offset=cut), plain)
    multi_teeth = {"B1 output halved": {"pass": half[0], "rel": half[2]},
                   f"B1 first split ({cut} keys) left out": {
                       "pass": dropped[0], "dlse": dropped[3]}}
    del q, k, v, plain, o, l
    for blk in (64, 16):
        nb = 640 // blk
        npool = 12 * nb  # the 8 slots' tables leave blocks no slot maps
        codes_scales = []
        for _ in range(2):  # K, V: magnitudes that differ by block
            x = (torch.randn((npool, 16, blk, 128), generator=g, device=dev)
                 * torch.exp(0.7 * torch.randn((npool, 16, 1, 1),
                                               generator=g, device=dev)))
            c8, sc = cuda_decode.quantize_symmetric_int8(
                x.reshape(npool, 16, blk * 128), 2)
            codes_scales.append((c8.reshape(npool, 16, blk, 128), sc[..., 0]))
        (kp8, kbs), (vp8, vbs) = codes_scales
        cks, cvs = (torch.rand((8, 16, 1, 128), generator=g, device=dev)
                    * 0.03 + 0.005 for _ in range(2))
        table = torch.stack([torch.randperm(npool, generator=g,
                                            device=dev)[:nb]
                             for _ in range(8)]).to(torch.int32)
        used = torch.zeros(npool, dtype=torch.bool, device=dev)
        used[table.long().flatten()] = True
        spare = int((~used).nonzero()[0])
        ksn, vsn = kbs.clone(), vbs.clone()
        ksn[spare], vsn[spare] = math.nan, math.nan
        for tq in (8, 32):
            q = rnd(8, 16, tq, 128)
            qo = torch.randint(0, 640 - tq, (8,), generator=g, device=dev,
                               dtype=torch.int32)
            qo[0] = 3 * blk - 3  # the window straddles a block boundary
            trees = random_trees(8, tq, 1, tq + blk).to(dev)
            tril = torch.tril(torch.ones(tq, tq, dtype=torch.bool,
                                         device=dev)).expand(8, tq, tq)
            past = (torch.arange(nb, device=dev)[None] * blk
                    >= (qo + tq)[:, None])
            nan_table = torch.where(past, spare, table).to(torch.int32)
            for tm, kind in ((None, "chain"), (trees, "tree")):
                for sk, (ks_, vs_) in (("per-block", (kbs, vbs)),
                                       ("channel", (cks, cvs))):
                    name = f"B5 block{blk} Tq{tq} {kind} {sk}"
                    got = multi_call(b5, lambda: b5(
                        q, kp8, vp8, table, ks_, vs_, q_offset=qo,
                        tree_mask=tm))
                    multi_check(name, got, cuda_decode.paged_decode_q8q_plain(
                        q, kp8, vp8, table, ks_, vs_, q_offset=qo,
                        tree_mask=tm))
                    if sk == "per-block":
                        multi_bits[f"{name}: NaN blocks and scales past the "
                                   f"window unread"] = same(got, b5(
                                       q, kp8, vp8, nan_table, ksn, vsn,
                                       q_offset=qo, tree_mask=tm))
            multi_bits[f"B5 block{blk} Tq{tq} tril == causal"] = same(
                b5(q, kp8, vp8, table, kbs, vbs, q_offset=qo),
                b5(q, kp8, vp8, table, kbs, vbs, q_offset=qo,
                   tree_mask=tril))
            if blk == 16 and tq == 8:
                # The gate's teeth at B5's multi-row shape, several blocks
                # (and so scalars) in each 64-key tile.
                teeth = q8q_teeth((q, kp8, vp8, table, kbs, vbs, qo), b5)
                multi_teeth.update({f"B5 {f}": {"pass": r[0], "rel": r[2],
                                                "dlse": r[3]}
                                    for f, r in teeth.items()})
            if blk == 64:
                keys = sum(min(nb * blk, int(o) + tq) for o in qo.tolist())
                pairs = visible_pairs(qo, tq, nb * blk)
                mask = gqa_mask(qo, tq, nb * blk)
                kgd, vgd = gather_paged_kv(deq(kp8, kbs[..., None, None]),
                                           deq(vp8, vbs[..., None, None]),
                                           table)
                record("flash_decode_paged_q8q_tiled",
                       f"int8 B8 H16 block64 NB10 Tq{tq} chain, per-block "
                       f"scales",
                       lambda: b5(q, kp8, vp8, table, kbs, vbs, q_offset=qo),
                       lambda: cuda_decode.paged_decode_q8q_plain(
                           q, kp8, vp8, table, kbs, vbs, q_offset=qo),
                       None, keys * 16 * 128 * 2 + q.numel() * 4
                       + 2 * 8 * nb * 16 * 4, 0.0,
                       ops_s=q8_ops_s(16 * pairs, True),
                       yardstick=lambda: F.scaled_dot_product_attention(
                           q, kgd, vgd, attn_mask=mask), names=own,
                       parts=("decode_tiled", "merge_splits"))
                del kgd, vgd, mask
    # Saturated codes: every Q code (each row +-1 before the fold, so
    # absmax/127 puts every code at +-127) and every K code at +-127.
    kp8 = (torch.randint(0, 2, (40, 16, 64, 128), generator=g, device=dev,
                         dtype=torch.int8) * 2 - 1) * 127
    vp8 = torch.randint(-127, 128, (40, 16, 64, 128), generator=g,
                        device=dev, dtype=torch.int8)
    kbs, vbs = (torch.rand((40, 16), generator=g, device=dev) * 0.03 + 0.005
                for _ in range(2))
    table = torch.stack([torch.randperm(40, generator=g, device=dev)[:10]
                         for _ in range(8)]).to(torch.int32)
    q = (torch.randint(0, 2, (8, 16, 8, 128), generator=g, device=dev) * 2
         - 1).to(torch.bfloat16)
    qo = torch.randint(0, 632, (8,), generator=g, device=dev,
                       dtype=torch.int32)
    codes, _ = cuda_decode._fold_quantize_q(q, 16, None, None)
    if not bool((codes.abs() == 127).all()):
        fail("saturated case: Q codes are not all +-127")
    multi_check("B5 saturated codes D128 Tq8",
                multi_call(b5, lambda: b5(q, kp8, vp8, table, kbs, vbs,
                                          q_offset=qo)),
                cuda_decode.paged_decode_q8q_plain(q, kp8, vp8, table, kbs,
                                                   vbs, q_offset=qo))
    print(f"multi-row B1 and B5, row gate: {len(multi_gate)} cases pass, "
          f"worst relative "
          f"{max(c['max_rel_err'] for c in multi_gate.values()):.3e}, "
          f"|dlse| "
          f"{max(c['max_abs_err_lse'] for c in multi_gate.values()):.3e}; "
          f"bit for bit {json.dumps(multi_bits)}; the gate's teeth "
          f"{json.dumps(multi_teeth)}", flush=True)
    if not all(multi_bits.values()):
        fail(f"multi-row B1/B5 bit-for-bit checks: {multi_bits}")
    if not multi_teeth["B5 None"]["pass"] or any(
            r["pass"] for f, r in multi_teeth.items() if f != "B5 None"):
        fail(f"multi-row B1/B5: the gate fails its own arithmetic or "
             f"accepts a planted fault: {multi_teeth}")
    del kp8, vp8, q, codes
    torch.cuda.empty_cache()

    # -- 2g. B4 and the int8 cast route on the multi-row body ---------------
    # B4 (contiguous q8q) and the cast route over B1/B2 (bf16 Q against
    # int8 K/V) with more than one packed row or a tree take the multi-row
    # body (cuda_decode.decode_body): every such launch must count on B4's
    # .tiled_launches, or on B1's / B2's .cast_tiled_launches. Under the
    # row gate: B4 and the contiguous cast route at B1's phase-2f shapes
    # (GQA Tq 16 over Tk 4096 and 4037, Tq 2, 5, 64, 127, G 1 and 4, D 64
    # and 128, causal with per-slot kv_offset — slot 2's shard lies wholly
    # past its frontier and must come back exactly (0, -inf) — and not),
    # trees at Tq 8 and 32 over 640-token slots, B4 at the reference
    # workload with a Tq-8 tree; the paged cast route at Tq 8, 32, 64 over
    # 64- and 16-token blocks with per-block scales that differ by block
    # and with channel scales, trees at Tq 8 and 32, and the local_blocks
    # 64-row chunk at W 2 and 4, its ranks' partials merged against
    # unsharded B2; codes at +-127. Bit for bit: tril == causal; int8
    # codes past each frontier changed (int8 has no NaN: codes not read
    # cannot matter); table entries past each window naming a block whose
    # per-block scalars are NaN, and under local_blocks NaN scalars in
    # block 0 and every block the rank's table does not name (a scalar
    # read there poisons its row through p * vs). The gate rejects an
    # output halved, one split's keys left out, scalars read by logical
    # block and the V scalar applied before the softmax sum (the cast
    # route's arithmetic written out here passes it). Timed, beside the
    # bound and the dequantized-SDPA yardstick: B4 at the contiguous chain
    # verify tick and GQA Tq 16, the cast route at the contiguous tree tick
    # and GQA Tq 16 and at the paged chain tick and 64-row chunk (their
    # other trees are phase 2d's, the local chunk phase 2b's).
    b1 = cuda_decode.attention_cuda_decode
    b2 = cuda_decode.attention_cuda_decode_paged
    b4 = cuda_decode.attention_cuda_decode_q8q
    q8_route = cuda_decode.resolve_q8_kernel
    int8_gate, int8_bits, int8_teeth = {}, {}, {}

    def int8_call(w, fn):
        return multi_call(w, fn, cast=w is not b4)

    def int8_check(name, got, want):
        multi_check(name, got, want, store=int8_gate)

    routes = (("B4", "q8q", b4), ("B1 cast", "q8", b1))
    for D in (64, 128):
        for G, tq, tk in ((4, 16, 4096), (4, 16, 4037), (1, 2, 640),
                          (4, 5, 640), (1, 64, 700), (4, 127, 700)):
            q = rnd(4, 8 * G, tq, D)
            kq, vq, ks, vs = cuda_decode.quantize_kv_channelwise(
                rnd(4, 8, tk, D), rnd(4, 8, tk, D))
            qo = torch.tensor([tk - tq, 500, tk - 1, 60], dtype=torch.int32,
                              device=dev)
            ko = torch.tensor([0, 37, tk + 200, 5], dtype=torch.int32,
                              device=dev)
            kw = dict(causal=True, q_offset=qo, kv_offset=ko)
            kn, vn = kq.clone(), vq.clone()
            for b in range(4):  # other codes past each slot's frontier
                lo = max(0, int(qo[b] - ko[b]) + tq)
                kn[b, :, lo:], vn[b, :, lo:] = 127, -127
            for kind, route, w in routes:
                fn, plain = q8_route(route), q8_route(route, plain=True)
                name = f"{kind} D{D} G{G} Tq{tq} Tk{tk}"
                got = int8_call(w, lambda: fn(q, kq, vq, ks, vs, **kw))
                int8_check(name + " causal", got,
                           plain(q, kq, vq, ks, vs, **kw))
                if not (torch.all(got[0][2] == 0)
                        and torch.all(torch.isneginf(got[1][2]))):
                    fail(f"{name}: the shard past its frontier is not "
                         f"(0, -inf)")
                int8_check(name + " not causal",
                           int8_call(w, lambda: fn(q, kq, vq, ks, vs)),
                           plain(q, kq, vq, ks, vs))
                int8_bits[f"{name}: codes past each frontier unread"] = \
                    same(got, fn(q, kn, vn, ks, vs, **kw))
            del kn, vn
    # Trees (and chains) at the contiguous verify tick: 8 slots of 640.
    for tq in TREE_TQS:
        q = rnd(8, 16, tq, 128)
        kq, vq, ks, vs = cuda_decode.quantize_kv_channelwise(
            rnd(8, 16, 640, 128), rnd(8, 16, 640, 128))
        qo = torch.randint(0, 640 - tq, (8,), generator=g, device=dev,
                           dtype=torch.int32)
        trees = random_trees(8, tq, 1, tq + 5).to(dev)
        tril = torch.tril(torch.ones(tq, tq, dtype=torch.bool,
                                     device=dev)).expand(8, tq, tq)
        kw = dict(causal=True, q_offset=qo)
        for kind, route, w in routes:
            fn, plain = q8_route(route), q8_route(route, plain=True)
            name = f"{kind} B8 H16 Tk640 Tq{tq}"
            got = int8_call(w, lambda: fn(q, kq, vq, ks, vs, tree_mask=trees,
                                          **kw))
            int8_check(name + " tree", got,
                       plain(q, kq, vq, ks, vs, tree_mask=trees, **kw))
            int8_bits[f"{name} tril == causal"] = same(
                int8_call(w, lambda: fn(q, kq, vq, ks, vs, **kw)),
                fn(q, kq, vq, ks, vs, tree_mask=tril, **kw))
    # B4 at the reference workload with a Tq-8 tree (timed in phase 2d).
    q = rnd(1, 16, 8, 128)
    kq, vq, ks, vs = cuda_decode.quantize_kv_channelwise(
        rnd(1, 16, 64000, 128), rnd(1, 16, 64000, 128))
    kw = dict(causal=True, tree_mask=random_trees(1, 8, -1, 4).to(dev),
              q_offset=torch.full((1,), 64000 - 8, dtype=torch.int32,
                                  device=dev))
    int8_check("B4 ref B1 H16 Tk64000 Tq8 tree",
               int8_call(b4, lambda: b4(q, kq, vq, ks, vs, **kw)),
               cuda_decode.decode_q8q_plain(q, kq, vq, ks, vs, **kw))
    del kq, vq
    # The gate's teeth at GQA Tq 16 (B4 and the contiguous cast route): an
    # output halved, the first split's keys left out.
    q = rnd(8, 32, 16, 128)
    kq, vq, ks, vs = cuda_decode.quantize_kv_channelwise(
        rnd(8, 8, 4096, 128), rnd(8, 8, 4096, 128))
    qo = torch.randint(1024, 4096 - 16, (8,), generator=g, device=dev,
                       dtype=torch.int32)
    cut = cuda_decode.decode_geometry("tiled", 64, 8, 8, 4096).split_len
    for kind, route, w in routes:
        kw = dict(causal=True, q_offset=qo)
        plain = q8_route(route, plain=True)(q, kq, vq, ks, vs, **kw)
        o, l = q8_route(route)(q, kq, vq, ks, vs, **kw)
        half = gate((o * 0.5, l), plain)
        dropped = gate(q8_route(route, plain=True)(
            q, kq[:, :, cut:], vq[:, :, cut:], ks, vs, kv_offset=cut, **kw),
            plain)
        int8_teeth[f"{kind} output halved"] = {"pass": half[0],
                                               "rel": half[2]}
        int8_teeth[f"{kind} first split ({cut} keys) left out"] = {
            "pass": dropped[0], "dlse": dropped[3]}
    del q, kq, vq, o, l, plain
    # The paged cast route: per-block scales (magnitudes that differ by
    # block) and channel scales, over 64- and 16-token blocks.
    for blk in (64, 16):
        nb = 640 // blk
        npool = 12 * nb  # the 8 slots' tables leave blocks no slot maps
        codes_scales = []
        for _ in range(2):
            x = (torch.randn((npool, 16, blk, 128), generator=g, device=dev)
                 * torch.exp(0.7 * torch.randn((npool, 16, 1, 1),
                                               generator=g, device=dev)))
            c8, sc = cuda_decode.quantize_symmetric_int8(
                x.reshape(npool, 16, blk * 128), 2)
            codes_scales.append((c8.reshape(npool, 16, blk, 128), sc[..., 0]))
        (kp8, kbs), (vp8, vbs) = codes_scales
        del x
        cks, cvs = (torch.rand((8, 16, 1, 128), generator=g, device=dev)
                    * 0.03 + 0.005 for _ in range(2))
        table = torch.stack([torch.randperm(npool, generator=g,
                                            device=dev)[:nb]
                             for _ in range(8)]).to(torch.int32)
        used = torch.zeros(npool, dtype=torch.bool, device=dev)
        used[table.long().flatten()] = True
        spare = int((~used).nonzero()[0])
        ksn, vsn = kbs.clone(), vbs.clone()
        ksn[spare], vsn[spare] = math.nan, math.nan
        for tq in (8, 32, 64):
            q = rnd(8, 16, tq, 128)
            qo = torch.randint(0, 640 - tq, (8,), generator=g, device=dev,
                               dtype=torch.int32)
            qo[0] = 3 * blk - 3  # the window straddles a block boundary
            past = (torch.arange(nb, device=dev)[None] * blk
                    >= (qo + tq)[:, None])
            nan_table = torch.where(past, spare, table).to(torch.int32)
            kinds = ((None, "chain"),) if tq == 64 else (
                (None, "chain"), (random_trees(8, tq, 1, tq + blk).to(dev),
                                  "tree"))
            for tm, kind in kinds:
                for sk, sc in (("per-block", (kbs, vbs)),
                               ("channel", (cks, cvs))):
                    name = f"B2 cast block{blk} Tq{tq} {kind} {sk}"
                    kw = dict(causal=True, q_offset=qo, block_table=table,
                              tree_mask=tm)
                    got = int8_call(b2, lambda: q8_route("q8")(
                        q, kp8, vp8, *sc, **kw))
                    int8_check(name, got, q8_route("q8", plain=True)(
                        q, kp8, vp8, *sc, **kw))
                    if sk == "per-block":
                        int8_bits[f"{name}: NaN scalars past the window "
                                  f"unread"] = same(got, q8_route("q8")(
                                      q, kp8, vp8, ksn, vsn, **dict(
                                          kw, block_table=nan_table)))
            if tq < 64:
                tril = torch.tril(torch.ones(tq, tq, dtype=torch.bool,
                                             device=dev)).expand(8, tq, tq)
                kw = dict(causal=True, q_offset=qo, block_table=table)
                int8_bits[f"B2 cast block{blk} Tq{tq} tril == causal"] = same(
                    q8_route("q8")(q, kp8, vp8, kbs, vbs, **kw),
                    q8_route("q8")(q, kp8, vp8, kbs, vbs, tree_mask=tril,
                                   **kw))
            if blk == 16 and tq == 8:
                # The gate's teeth at the cast route's multi-row shape,
                # several blocks (and so scalars) in each 64-key tile.
                teeth = q8q_teeth((q, kp8, vp8, table, kbs, vbs, qo), b2,
                                  route="q8")
                int8_teeth.update({f"B2 cast {f}": {"pass": r[0],
                                                    "rel": r[2],
                                                    "dlse": r[3]}
                                   for f, r in teeth.items()})
            if tq == 64:
                # local_blocks: the 64-row chunk over W ranks' slices; each
                # rank's slice gets a block 0 and its unnamed blocks with
                # NaN scalars (held entries shift by one; past each window
                # they name block 0, held but never read).
                for W in (2, 4):
                    nl = npool // W
                    parts = []
                    for r in range(W):
                        loc = table - r * nl
                        held = (loc >= 0) & (loc < nl)
                        lpois = torch.where(held, torch.where(past, 0,
                                                              loc + 1),
                                            -1).to(torch.int32)
                        sl = slice(r * nl, (r + 1) * nl)
                        kr = torch.cat([kp8[:1] * 0, kp8[sl]])
                        vr = torch.cat([vp8[:1] * 0, vp8[sl]])
                        named = torch.zeros(nl + 1, dtype=torch.bool,
                                            device=dev)
                        named[lpois[lpois > 0].long()] = True
                        scp = tuple(torch.where(
                            named[:, None], torch.cat([x[:1], x[sl]]),
                            math.nan) for x in (kbs, vbs))
                        got = int8_call(b2, lambda: b2(
                            q, kr, vr, lpois, q_offset=qo, block_scales=scp,
                            local_blocks=True, local_shards=W))
                        int8_check(
                            f"B2 cast local W{W} rank{r} block{blk} Tq64 "
                            f"(unnamed blocks' scalars NaN)", got,
                            cuda_decode.paged_decode_plain(
                                q, kp8[sl], vp8[sl],
                                torch.where(held, loc, -1).to(torch.int32),
                                q_offset=qo,
                                block_scales=tuple(x[sl] for x in (kbs,
                                                                   vbs)),
                                local_blocks=True))
                        parts.append(got)
                    merged = merge_partials(
                        torch.stack([o.float() for o, _ in parts]),
                        torch.stack([l for _, l in parts]))
                    int8_check(f"B2 cast local W{W} block{blk} Tq64: "
                               f"{W} partials merged vs unsharded B2",
                               merged, b2(q, kp8, vp8, table, q_offset=qo,
                                          block_scales=(kbs, vbs)))
    del kp8, vp8, ksn, vsn
    # Saturated codes: every K code at +-127 (B4 with every Q code at
    # +-127 too: each row +-1 before the fold).
    q = (torch.randint(0, 2, (8, 16, 8, 128), generator=g, device=dev) * 2
         - 1).to(torch.bfloat16)
    kq = (torch.randint(0, 2, (8, 16, 640, 128), generator=g, device=dev,
                        dtype=torch.int8) * 2 - 1) * 127
    vq = torch.randint(-127, 128, (8, 16, 640, 128), generator=g,
                       device=dev, dtype=torch.int8)
    ks, vs = (torch.rand((8, 16, 1, 128), generator=g, device=dev) * 0.03
              + 0.005 for _ in range(2))
    qo = torch.randint(0, 632, (8,), generator=g, device=dev,
                       dtype=torch.int32)
    codes, _ = cuda_decode._fold_quantize_q(q, 16, torch.ones_like(ks),
                                            None)
    if not bool((codes.abs() == 127).all()):
        fail("saturated case: Q codes are not all +-127")
    for kind, route, w in routes:
        kw = dict(causal=True, q_offset=qo)
        int8_check(f"{kind} saturated codes D128 Tq8",
                   int8_call(w, lambda: q8_route(route)(
                       q, kq, vq, torch.ones_like(ks), vs, **kw)),
                   q8_route(route, plain=True)(q, kq, vq,
                                               torch.ones_like(ks), vs,
                                               **kw))
    del q, kq, vq, codes
    print(f"multi-row B4 and cast route, row gate: {len(int8_gate)} cases "
          f"pass, worst relative "
          f"{max(c['max_rel_err'] for c in int8_gate.values()):.3e}, |dlse| "
          f"{max(c['max_abs_err_lse'] for c in int8_gate.values()):.3e}; "
          f"bit for bit {json.dumps(int8_bits)}; the gate's teeth "
          f"{json.dumps(int8_teeth)}", flush=True)
    if not all(int8_bits.values()):
        fail(f"multi-row B4/cast bit-for-bit checks: {int8_bits}")
    if not int8_teeth["B2 cast None"]["pass"] or any(
            r["pass"] for f, r in int8_teeth.items() if f != "B2 cast None"):
        fail(f"multi-row B4/cast: the gate fails its own arithmetic or "
             f"accepts a planted fault: {int8_teeth}")
    # Timed: B4 at the contiguous chain verify tick and GQA Tq 16; the cast
    # route at the contiguous tree tick and GQA Tq 16, and on the paged
    # layout at the chain tick and the 64-row chunk (per-block scales).
    for tq, B, hq, hkv, tk in ((8, 8, 16, 16, 640), (16, 8, 32, 8, 4037)):
        q = rnd(B, hq, tq, 128)
        kq, vq, ks, vs = cuda_decode.quantize_kv_channelwise(
            rnd(B, hkv, tk, 128), rnd(B, hkv, tk, 128))
        qoff = torch.randint(0, tk - tq, (B,), generator=g, device=dev,
                             dtype=torch.int32)
        need = sum(min(tk, int(o) + tq) for o in qoff.tolist())
        pairs = hq * visible_pairs(qoff, tq, tk)
        kd, vd, mask = deq(kq, ks), deq(vq, vs), gqa_mask(qoff, tq, tk)
        nbytes = (need * hkv * 128 * 2 + q.numel() * 4 + 4 * ks.numel() * 4)
        shape = (f"B8 H16 Tk640 Tq8 chain" if tq == 8 else
                 f"GQA B8 Hq32 Hkv8 Tk{tk} Tq16 ragged")
        record("flash_decode_q8q_tiled", f"int8 {shape}",
               lambda: b4(q, kq, vq, ks, vs, causal=True, q_offset=qoff),
               lambda: cuda_decode.decode_q8q_plain(
                   q, kq, vq, ks, vs, causal=True, q_offset=qoff),
               None, nbytes, 0.0, ops_s=q8_ops_s(pairs, True),
               yardstick=lambda: F.scaled_dot_product_attention(
                   q, kd, vd, attn_mask=mask, enable_gqa=True),
               names=own, parts=("decode_tiled", "merge_splits"))
        if tq == 8:  # the cast route's contiguous verify tick: a tree
            trees = random_trees(B, 8, 1, 9).to(dev)
            keys, tpairs = tree_counts(trees, qoff, tk)
            tmask = tree_sdpa_mask(trees, qoff, tk)
            record("flash_decode_cast_tiled", "int8 B8 H16 Tk640 Tq8 tree, "
                   "cast",
                   lambda: cuda_decode.attention_cuda_decode_q8(
                       q, kq, vq, ks, vs, causal=True, q_offset=qoff,
                       tree_mask=trees),
                   lambda: cuda_decode.decode_q8_plain(
                       q, kq, vq, ks, vs, causal=True, q_offset=qoff,
                       tree_mask=trees),
                   None, keys * 16 * 128 * 2 + q.numel() * 4
                   + 4 * ks.numel() * 4, 0.0,
                   ops_s=q8_ops_s(16 * tpairs, False),
                   yardstick=lambda: F.scaled_dot_product_attention(
                       q, kd, vd, attn_mask=tmask), names=own)
        else:
            record("flash_decode_cast_tiled", f"int8 {shape}, cast",
                   lambda: cuda_decode.attention_cuda_decode_q8(
                       q, kq, vq, ks, vs, causal=True, q_offset=qoff),
                   lambda: cuda_decode.decode_q8_plain(
                       q, kq, vq, ks, vs, causal=True, q_offset=qoff),
                   None, nbytes, 0.0, ops_s=q8_ops_s(pairs, False),
                   yardstick=lambda: F.scaled_dot_product_attention(
                       q, kd, vd, attn_mask=mask, enable_gqa=True),
                   names=own)
        del kq, vq, kd, vd, mask
    blk, nb, npool = 64, 10, 96
    (kp8, kbs), (vp8, vbs) = (
        (c.reshape(npool, 16, blk, 128), sc[..., 0]) for c, sc in (
            cuda_decode.quantize_symmetric_int8(
                (torch.randn((npool, 16, blk, 128), generator=g, device=dev)
                 * torch.exp(0.7 * torch.randn((npool, 16, 1, 1),
                                               generator=g, device=dev))
                 ).reshape(npool, 16, blk * 128), 2) for _ in range(2)))
    table = torch.stack([torch.randperm(npool, generator=g, device=dev)[:nb]
                         for _ in range(8)]).to(torch.int32)
    kgd, vgd = gather_paged_kv(deq(kp8, kbs[..., None, None]),
                               deq(vp8, vbs[..., None, None]), table)
    for tq in (8, 64):
        q = rnd(8, 16, tq, 128)
        qoff = torch.randint(0, nb * blk - tq, (8,), generator=g, device=dev,
                             dtype=torch.int32)
        need = sum(min(nb * blk, int(o) + tq) for o in qoff.tolist())
        mask = gqa_mask(qoff, tq, nb * blk)
        record("flash_decode_paged_cast_tiled",
               f"int8 B8 H16 block64 NB10 Tq{tq} "
               f"{'chain' if tq == 8 else 'chunk'}, per-block scales",
               lambda: b2(q, kp8, vp8, table, q_offset=qoff,
                          block_scales=(kbs, vbs)),
               lambda: cuda_decode.paged_decode_plain(
                   q, kp8, vp8, table, q_offset=qoff,
                   block_scales=(kbs, vbs)),
               None, need * 16 * 128 * 2 + q.numel() * 4
               + 2 * 8 * nb * 16 * 4, 0.0,
               ops_s=q8_ops_s(16 * visible_pairs(qoff, tq, nb * blk), False),
               yardstick=lambda: F.scaled_dot_product_attention(
                   q, kgd, vgd, attn_mask=mask), names=own,
               parts=("decode_tiled", "merge_splits"))
    del kp8, vp8, kgd, vgd, mask, q
    torch.cuda.empty_cache()

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
    del q, k, v, mask
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
            for extra in ("tree_launches", "local_launches",
                          "tiled_launches", "cast_tiled_launches",
                          "tick_launches"):
                if hasattr(w, extra):
                    setattr(w, extra, 0)
            if hasattr(w, "tiled_tq"):
                w.tiled_tq.clear()

    # The multi-row body's launches of a serve, by kernel and Tq.
    multi_row = {"B1": cuda_decode.attention_cuda_decode,
                 "B2": cuda_decode.attention_cuda_decode_paged,
                 "B4": cuda_decode.attention_cuda_decode_q8q,
                 "B5": cuda_decode.attention_cuda_decode_paged_q8q}

    def tiled_by_tq():
        return {n: dict(sorted(w.tiled_tq.items()))
                for n, w in multi_row.items() if w.tiled_tq}

    serve_tiled = {}  # serve label -> tiled_by_tq()

    serve_cfg = parse_args(SERVE_ARGS)
    reset_counts()
    t0 = time.monotonic()
    rec, server, serve_rep = cli.run_serve(serve_cfg, dev)
    torch.cuda.synchronize()
    serve_wall = time.monotonic() - t0
    launches = {n: w.launches for n, w in wrappers.items()}
    # B2's multi-row body: the prompt-tail ticks (chunk buckets below 128
    # rows run every slot's rows through B2 at that Tq), by Tq bucket.
    b2w = cuda_decode.attention_cuda_decode_paged
    launches["flash_decode_paged_tiled"] = b2w.tiled_launches
    launches["flash_decode_paged_tick"] = b2w.tick_launches
    serve_tiled_tq = dict(sorted(b2w.tiled_tq.items()))
    serve_tiled["serve"] = tiled_by_tq()
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
    for n in ("flash_decode_paged", "flash_decode_paged_tiled",
              "flash_decode_paged_tick", "flash_fwd"):
        if launches[n] == 0:
            fail(f"serve never launched {n}")
    # Every one-row tick ran on the tick body: B2's launches are its
    # multi-row ones and its ticks, nothing on the split body.
    off_tick = (launches["flash_decode_paged"] - b2w.tiled_launches
                - b2w.tick_launches)
    print(f"serve: B2's multi-row body launched {b2w.tiled_launches} times "
          f"(by Tq bucket {json.dumps(serve_tiled_tq)}), its tick body "
          f"{b2w.tick_launches}, its split body {off_tick}", flush=True)
    if off_tick:
        fail("serve: a one-row paged tick ran off the tick body")
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
        "B2 multi-row body": ("decode_tiled",),
        "B2 tick body (decode ticks)": ("decode_tick",),
        "flash_decode (B1/B2 split body + merge)": ("decode_split",
                                                     "merge_splits"),
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

    def serve_main(label, argv):
        """``cli.main`` in process, with the metrics registry off as in the
        exact serve: its record, the steps it ran over the int8 cache (each
        decode tick runs one; staged chunks run on the exact staging
        cache), the launches (``<kernel>_tiled``: of the multi-row body;
        by Tq in ``serve_tiled[label]``)."""
        reset_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        torch.cuda.synchronize()
        rec = json.loads(buf.getvalue().strip().splitlines()[-1])
        counts = {n: w.launches for n, w in wrappers.items()}
        for n in ("flash_decode", "flash_decode_paged",
                  "flash_decode_paged_q8q"):
            counts[n + "_tiled"] = wrappers[n].tiled_launches
        for n in ("flash_decode_paged", "flash_decode_paged_q8q"):
            counts[n + "_tick"] = wrappers[n].tick_launches
        serve_tiled[label] = tiled_by_tq()
        return rec, rec["decode_ticks"], counts

    t0 = time.monotonic()
    q_rec, q_steps, q_launches = serve_main(
        "int8 serve", SERVE_ARGS + ["--kv-quant", "int8"])
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
    # ... each an int8 decode tick, on the tick body.
    if q_launches["flash_decode_paged_q8q_tick"] != \
            q_launches["flash_decode_paged_q8q"]:
        fail(f"int8 serve: {q_launches['flash_decode_paged_q8q_tick']} of "
             f"B5's {q_launches['flash_decode_paged_q8q']} launches on the "
             f"tick body")
    if not (q_launches["flash_decode"] and q_launches["flash_fwd"]) or \
            q_launches["flash_decode_paged"]:
        fail(f"int8 serve staged launches {q_launches}")
    # The staged prompt tails (below 128 rows) run B1's multi-row body.
    if not q_launches["flash_decode_tiled"]:
        fail(f"int8 serve: no staged tail took B1's multi-row body: "
             f"{q_launches}")
    print(f"int8 serve: the multi-row body's launches by Tq "
          f"{json.dumps(serve_tiled['int8 serve'])}", flush=True)
    c_rec, c_steps, c_launches = serve_main(
        "int8 serve, contiguous",
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
        "int8-cast serve",
        SERVE_ARGS + ["--kv-quant", "int8-cast", "--requests", "4",
                      "--max-new-tokens", "16"])
    print(f"int8-cast serve, paged: {x_rec['requests']} requests, "
          f"{x_rec['tokens_generated']} tokens, int8 steps "
          f"{x_steps}, B2 launches "
          f"{x_launches['flash_decode_paged']} (on the tick body "
          f"{x_launches['flash_decode_paged_tick']})", flush=True)
    if x_rec["outcomes"] != {"budget": 4} or not (
            x_steps > 0 and x_launches["flash_decode_paged"]
            == n_layers * x_steps == x_launches["flash_decode_paged_tick"]) \
            or x_launches["flash_decode_paged_q8q"]:
        fail(f"int8-cast serve: {x_rec['outcomes']}, "
             f"{x_launches['flash_decode_paged']} B2 launches over "
             f"{x_steps} int8 steps")

    # The int8 wave: the same 8 requests as the exact wave, on an int8
    # cache; its device time split the same way, B5 apart; and how many of
    # its greedy tokens equal the exact wave's (reported, not gated).
    q8_rep, q8_breakdown = wave_breakdown("int8 serve", {
        "flash_decode_paged_q8q (B5)": ("decode_tick_kernel<signed char, "
                                        "signed char",
                                        "decode_tiled_kernel<1,",
                                        "decode_tiled_kernel<2,"),
        "flash_decode (B1 staged chunks) + merges": ("decode_split",
                                                     "decode_tiled",
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
    del qcache, lk, lp, ck, cp, k8, v8
    torch.cuda.empty_cache()

    # -- 3d. speculative serving ------------------------------------------
    # The CLI's --speculate serves (ngram, ngram-tree; exact, int8) on the
    # serve phase's trace, the oracle drafter on the wave's trace on the
    # four layouts (spec_phase), one tree verify step against the plain
    # path and against each root path decoded token by token
    # (tree_step_check), and the verify ticks' device split from a traced
    # oracle wave beside the plain wave's.
    spec_refs = {False: {r.uid: r.tokens for r in plain_rep.results},
                 True: {r.uid: r.tokens for r in q8_rep.results}}
    spec_kw = dict(slots=8, cache_len=640, prefill_chunk=256, kv_block=64)
    t0 = time.monotonic()
    spec = spec_phase(dev, params, tcfg, SERVE_ARGS, trace, spec_refs,
                      spec_kw, wrappers, reset_counts, TOL_LOGITS)
    for label, r in spec["cli"].items():
        if "kv_quant none" in label:
            same = sum(a == b for uid, toks in r["tokens"].items()
                       for a, b in zip(toks, single_tokens[uid]))
            r["tokens_equal_to_nonspec"] = same / (16 * 64)
            print(f"spec serve ({label}): {same} of {16 * 64} greedy tokens "
                  f"equal the non-speculative serve's (reported, not gated); "
                  f"{r['tokens_per_sec']:.1f} spec tok/s beside "
                  f"{rec['tokens_per_sec']} non-spec tok/s", flush=True)
        del r["tokens"]
    tree_step = tree_step_check(params, tcfg, dev)
    print(f"tree verify step: kernel vs plain logits |d| "
          f"{tree_step['logits_err_plain']:.3e} (int8 "
          f"{tree_step['int8_logits_err_plain']:.3e}), tree rows vs their "
          f"root paths decoded token by token |d| "
          f"{tree_step['logits_err_paths']:.3e} (tol {TOL_LOGITS})",
          flush=True)
    if not all(math.isfinite(e) and e <= TOL_LOGITS
               for e in tree_step.values()):
        fail(f"tree verify step: {tree_step}")
    # The multi-row body's kernels by name (their template arguments lead
    # with the operands): B1 <0, false, ...>, B2 <0, true, ...>, B4 <1,
    # false, ...>, B5 <1, true, ...> or <2, ...>, the cast route <3 or 4,
    # ...>.
    spec_wave, spec_breakdown = wave_breakdown("spec serve (oracle)", {
        "B2 multi-row body (tree and chain verify ticks, tails)": (
            "decode_tiled",),
        "B2 tick body (decode ticks)": ("decode_tick",),
        "flash_decode (B2/B1 split body) + merges": ("decode_split",
                                                     "merge_splits"),
        "flash_fwd (B3)": ("flash_fwd",), "matmul": matmul},
        speculate=True, draft_k=4,
        drafter=oracle_drafter(trace, spec_refs[False], tcfg.vocab_size))
    spec_breakdown["spec"] = spec_wave.spec
    spec_breakdown["nonspec_tokens_per_sec"] = plain_rep.tokens_per_sec
    spec_breakdown["verify_ticks"] = spec_wave.decode_ticks
    print(f"spec wave (oracle, 8 requests): {spec_wave.tokens_per_sec:.1f} "
          f"tok/s beside the plain wave's {plain_rep.tokens_per_sec:.1f}; "
          f"{spec_wave.decode_ticks} verify ticks vs "
          f"{plain_rep.decode_ticks} decode ticks; spec "
          f"{json.dumps(spec_wave.spec)}; phase wall "
          f"{time.monotonic() - t0:.2f}s", flush=True)
    # The same oracle wave on the paged int8 pool: B5's verify ticks on the
    # multi-row body, B1's staged prompt tails, B5's tick body on the
    # decode ticks between.
    spec8_wave, spec8_breakdown = wave_breakdown(
        "spec serve (oracle, paged int8)", {
            "B5 multi-row body (verify ticks)": ("decode_tiled_kernel<1,",
                                                 "decode_tiled_kernel<2,"),
            "B1 multi-row body (staged prompt tails)": (
                "decode_tiled_kernel<0, false",),
            "B5 tick body (decode ticks)": ("decode_tick",),
            "decode split body (B1) + merges": ("decode_split",
                                                "merge_splits"),
            "flash_fwd (B3)": ("flash_fwd",), "matmul": matmul},
        speculate=True, draft_k=4, quantize=True,
        drafter=oracle_drafter(trace, spec_refs[True], tcfg.vocab_size))
    spec8_breakdown["spec"] = spec8_wave.spec
    spec8_breakdown["verify_ticks"] = spec8_wave.decode_ticks
    # ... and on the contiguous int8 cache: B4's verify ticks on the
    # multi-row body.
    specc8_wave, specc8_breakdown = wave_breakdown(
        "spec serve (oracle, contiguous int8)", {
            "B4 multi-row body (verify ticks)": (
                "decode_tiled_kernel<1, false",),
            "B1 multi-row body (staged prompt tails)": (
                "decode_tiled_kernel<0, false",),
            "decode split body (B4 ticks, B1) + merges": ("decode_split",
                                                          "merge_splits"),
            "flash_fwd (B3)": ("flash_fwd",), "matmul": matmul},
        speculate=True, draft_k=4, quantize=True, kv_layout="contiguous",
        drafter=oracle_drafter(trace, spec_refs[True], tcfg.vocab_size))
    specc8_breakdown["spec"] = specc8_wave.spec
    specc8_breakdown["verify_ticks"] = specc8_wave.decode_ticks
    del server, params
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
            # bf16 chunks (more than one packed row) take B2's multi-row
            # body; the int8 slice sees one-row decode ticks only (staged
            # admission runs the chunks on the staging cache).
            if (lc["flash_decode_paged_tiled"] > 0) != (label == "exact"):
                fail(f"sharded serve ({label}) rank {rank}: multi-row B2 "
                     f"launches {lc['flash_decode_paged_tiled']}")
            # ... and its one-row ticks all on the tick body.
            if not (lc["flash_decode_paged_tick"] > 0
                    and lc["flash_decode_paged_local"]
                    == lc["flash_decode_paged_tick"]
                    + lc["flash_decode_paged_tiled"]):
                fail(f"sharded serve ({label}) rank {rank}: ticks off the "
                     f"tick body: {lc}")
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
        "flash_decode_paged_tick": (
            "cuda", csrc + "decode_tick.cu",
            "tree_attention_tpu/ops/pallas_decode.py:344"),
        "flash_decode_q8q": ("cuda", csrc + "flash_decode.cu",
                             "tree_attention_tpu/ops/pallas_decode.py:266"),
        "flash_decode_paged_q8q_tick": (
            "cuda", csrc + "decode_tick.cu",
            "tree_attention_tpu/ops/pallas_decode.py:461"),
        "flash_decode_paged_local_tick": (
            "cuda", csrc + "decode_tick.cu",
            "tree_attention_tpu/ops/pallas_decode.py:344"),
        "flash_decode_paged_local_tiled": (
            "cuda", csrc + "flash_decode_tiled.cu",
            "tree_attention_tpu/ops/pallas_decode.py:344"),
        "flash_decode_paged_tiled": (
            "cuda", csrc + "flash_decode_tiled.cu",
            "tree_attention_tpu/ops/pallas_decode.py:344"),
        "flash_decode_tiled": (
            "cuda", csrc + "flash_decode_tiled.cu",
            "tree_attention_tpu/ops/pallas_decode.py:179"),
        "flash_decode_paged_q8q_tiled": (
            "cuda", csrc + "flash_decode_tiled_q8q.cu",
            "tree_attention_tpu/ops/pallas_decode.py:461"),
        "flash_decode_q8q_tiled": (
            "cuda", csrc + "flash_decode_tiled_q8q.cu",
            "tree_attention_tpu/ops/pallas_decode.py:266"),
        "flash_decode_cast_tiled": (
            "cuda", csrc + "flash_decode_tiled_cast.cu",
            "tree_attention_tpu/ops/pallas_decode.py:179"),
        "flash_decode_paged_cast_tiled": (
            "cuda", csrc + "flash_decode_tiled_cast.cu",
            "tree_attention_tpu/ops/pallas_decode.py:344"),
        "flash_decode_tree": ("cuda", csrc + "flash_decode_tiled.cu",
                              "tree_attention_tpu/ops/pallas_decode.py:179"),
        "flash_decode_paged_tree": (
            "cuda", csrc + "flash_decode_tiled.cu",
            "tree_attention_tpu/ops/pallas_decode.py:344"),
        "flash_decode_q8q_tree": (
            "cuda", csrc + "flash_decode_tiled_q8q.cu",
            "tree_attention_tpu/ops/pallas_decode.py:266"),
        "flash_decode_paged_q8q_tree": (
            "cuda", csrc + "flash_decode_tiled_q8q.cu",
            "tree_attention_tpu/ops/pallas_decode.py:461"),
        "flash_fwd": ("cuda", csrc + "flash_fwd.cu",
                      "tree_attention_tpu/ops/pallas_attention.py:65"),
        "flash_dq": ("cuda", csrc + "flash_bwd.cu",
                     "tree_attention_tpu/ops/pallas_bwd.py:84"),
        "flash_dkv": ("cuda", csrc + "flash_bwd.cu",
                      "tree_attention_tpu/ops/pallas_bwd.py:118"),
    }
    # Main-path launches: B1 in the decode phase, B2's ticks in the serve
    # phase, B3 in the serve and the train phases, B6/B7 in the train
    # phase, B5's ticks in the int8 serve, B4 in the int8 decode and the
    # contiguous int8 serve.
    main_launches = dict(launches)
    for n, count in train_launches.items():
        main_launches[n] = main_launches.get(n, 0) + count
    main_launches["flash_decode_paged_q8q_tick"] = q_launches[
        "flash_decode_paged_q8q_tick"]
    main_launches["flash_decode_q8q"] = (decode_recs["int8"]["launches"]
                                         + c_launches["flash_decode_q8q"])
    # B2 local_blocks: rank 0's launches in the two-rank exact sharded
    # serve, ticks and chunks.
    for name in ("tick", "tiled"):
        main_launches[f"flash_decode_paged_local_{name}"] = sh["exact"][0][
            "launches"][f"flash_decode_paged_{name}"]
    # B2's multi-row body: its launches in the plain serve (prompt tails).
    main_launches["flash_decode_paged_tiled"] = launches[
        "flash_decode_paged_tiled"]
    # B1's multi-row body: the int8 serve's staged prompt tails; B5's and
    # B4's: the verify ticks of the speculative serves over the paged and
    # the contiguous int8 pool; the cast route's (B1, B2): the verify
    # ticks of the q8 oracle serves.
    spec_runs = {**spec["cli"], **spec["oracle"]}
    main_launches["flash_decode_tiled"] = q_launches["flash_decode_tiled"]
    for name, tree_kernel, route in (
            ("flash_decode_paged_q8q_tiled", "flash_decode_paged_q8q",
             "q8q"),
            ("flash_decode_q8q_tiled", "flash_decode_q8q", "q8q"),
            ("flash_decode_cast_tiled", "flash_decode", "q8"),
            ("flash_decode_paged_cast_tiled", "flash_decode_paged", "q8")):
        main_launches[name] = sum(
            r["tiled_launches"] for r in spec_runs.values()
            if r["tree_kernel"] == tree_kernel and r["route"] == route)
        if not main_launches[name]:
            fail(f"the speculative serves never launched {name}")
    # Every serve's multi-row launches by kernel and Tq.
    for label, r in spec_runs.items():
        serve_tiled[f"spec {label}"] = r["tiled_by_tq"]
    # The tree variants: their launches in the speculative serves (3d; the
    # cast route's count under its multi-row entries above).
    for name in ("flash_decode", "flash_decode_paged", "flash_decode_q8q",
                 "flash_decode_paged_q8q"):
        main_launches[name + "_tree"] = sum(
            r["tree_launches"] for r in spec_runs.values()
            if r["tree_kernel"] == name and r["route"] != "q8")
        if not main_launches[name + "_tree"]:
            fail(f"the speculative serves never launched {name}'s tree "
                 f"variant")
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
        if name in ("flash_decode", "flash_decode_paged_tick"):
            # The int8-cast route through this kernel.
            cast = next(c for c in mine if c["case"].startswith("int8"))
            entry["int8_cast"] = {k: cast[k] for k in (
                "case", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                "yardstick_sdpa_dequant_ms", "max_rel_err")}
            entry["launches_int8"] = (
                decode_recs["int8-cast"]["launches"] if name == "flash_decode"
                else x_launches[name])
            entry["launches_int8_serve_staged"] = q_launches[
                name.replace("_tick", "")]
        if name in ("flash_decode_tree", "flash_decode_paged_tree"):
            # The int8-cast route through the tree variant.
            cast = next(c for c in mine if c["case"].startswith("int8"))
            entry["int8_cast"] = {k: cast[k] for k in (
                "case", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                "yardstick_sdpa_dequant_ms", "max_rel_err")}
        if name.endswith("_tree"):
            entry["launches_per_run"] = {
                label: r["tree_launches"] for label, r in spec_runs.items()
                if r["tree_kernel"] + "_tree" == name and r["route"] != "q8"}
        if name.startswith("flash_decode_paged_local"):
            # Each rank's ticks (chunks) in the two-rank serves.
            counter = name.replace("_local", "")
            entry["launches_per_rank"] = {
                label: [r["launches"][counter] for r in ranks]
                for label, ranks in sh.items()}
            entry["int8_block_scales"] = next(
                {k: c[k] for k in ("case", "ms", "call_ms", "plain_ms",
                                   "bound_ms", "bound_by",
                                   "yardstick_sdpa_dequant_ms",
                                   "max_rel_err")}
                for c in mine if " int8 " in c["case"])
        if name.startswith("flash_decode"):
            # Which body ran the head case (cuda_decode.decode_body: every
            # variant but f32 with more than one packed row or a tree takes
            # the multi-row one).
            entry["body"] = ("tick" if name.endswith("_tick") else
                             "tiled" if name.endswith(("_tiled", "_tree"))
                             else "split")
        if name in ("flash_decode_tiled", "flash_decode_paged_tiled",
                    "flash_decode_paged_q8q_tiled",
                    "flash_decode_q8q_tiled"):
            # The multi-row body's launches of this kernel on every serve,
            # by Tq.
            key = {"flash_decode_tiled": "B1", "flash_decode_paged_tiled":
                   "B2", "flash_decode_paged_q8q_tiled": "B5",
                   "flash_decode_q8q_tiled": "B4"}[name]
            entry["launches_per_serve_by_tq"] = {
                label: by[key] for label, by in serve_tiled.items()
                if key in by}
            if key in ("B1", "B2"):  # the two-rank serves (B1: staged tails)
                entry["launches_sharded_rank0"] = {
                    label: ranks[0]["launches"][name]
                    for label, ranks in sh.items()}
        if name in ("flash_decode_cast_tiled",
                    "flash_decode_paged_cast_tiled"):
            # The cast route's multi-row launches in each q8 oracle serve.
            entry["launches_per_run"] = {
                label: r["tiled_launches"] for label, r in spec_runs.items()
                if r["route"] == "q8"
                and r["tree_kernel"] == name.replace("_cast_tiled", "")}
        if name.endswith("_tick"):
            # The tick body (decode_tick_kernel): one launch a tick, its
            # cluster size at the head case, and its launches per serve.
            entry["kernel"] = "decode_tick_kernel"
            entry["cluster_at_head"] = cuda_decode.decode_geometry(
                "tick", 1, 8, 16, 640).ctas
            if name == "flash_decode_paged_tick":
                entry["launches_per_serve"] = {
                    "serve (exact)": launches[name],
                    "int8-cast serve": x_launches[name],
                    "int8 serve": q_launches[name]}
            if name == "flash_decode_paged_q8q_tick":
                entry["launches_per_serve"] = {"int8 serve": q_launches[name]}
        if name == "flash_decode_paged_tiled":
            entry["launches_per_serve"] = {
                "serve (prompt-tail ticks)": launches[name],
                "serve by Tq bucket": serve_tiled_tq,
                "speculative serves (paged exact)": {
                    label: r["tiled_launches"]
                    for label, r in spec_runs.items()
                    if r["tree_kernel"] == "flash_decode_paged"
                    and r["route"] is None},
                "sharded serve, rank 0 (exact)": sh["exact"][0]["launches"][
                    name]}
        if name in ("flash_fwd", "flash_dq", "flash_dkv"):
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
                   "tick_ptxas": kptx, "tick_bits": tick_bits,
                   "tick_teeth": tick_teeth,
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
                   "tree_variants": tree_teeth, "decode_ptxas": dptx,
                   "tiled_ptxas": tptx, "tiled_gate": tiled_gate,
                   "serve_tiled_tq": serve_tiled_tq,
                   "tree_causal_ms": causal_ms,
                   "spec": spec, "spec_tree_step": tree_step,
                   "spec_breakdown": spec_breakdown,
                   "spec_int8_breakdown": spec8_breakdown,
                   "multi_row_gate": multi_gate,
                   "multi_row_bits": multi_bits,
                   "multi_row_teeth": multi_teeth,
                   "int8_multi_row_gate": int8_gate,
                   "int8_multi_row_bits": int8_bits,
                   "int8_multi_row_teeth": int8_teeth,
                   "spec_contiguous_int8_breakdown": specc8_breakdown,
                   "serve_multi_row_by_tq": serve_tiled,
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
