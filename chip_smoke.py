"""On-card smoke test of the PyTorch + CUDA port (one NVIDIA H100).

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, any
failure exits non-zero:

1. Build the CUDA kernels from ``tree_attention_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together) and print the card.
2. Hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (bf16; each query row's out within 2e-2 of that row's
   largest |out|, i.e. about two bf16 ulps, and lse within 1e-3 — P is
   rounded to bf16 on both sides; at the reference shape the gate is shown
   to reject an output halved and one split's keys dropped) and time kernel,
   plain
   version, and ``scaled_dot_product_attention`` on the same function as a
   yardstick (the port never calls it) — device time of each call's kernels
   from ``torch.profiler`` (CUDA events if it traces nothing), L2 flushed
   before each call — beside the least time the card could take (bytes /
   3.35 TB/s or FLOPs / 989 TFLOP/s, the larger). B3 also at the training
   shape (B2 H16 T4096 causal).
   Then the backward kernels B6 (dq) and B7 (dk, dv) against their plain
   versions at the training shape, a GQA shape with a query offset, a
   ragged Tq/Tk shape and a KV offset that is not tile-aligned (each row of
   each gradient within 2e-2 of that row's largest |plain value|; at the
   training shape the gate is shown to reject dv halved and B7 skipping
   each KV tile's first live Q tile), timed beside SDPA's backward; and
   B3, B6, B7 timed at B1 H16 T16384 causal (no plain version there); and
   the gradients of the Tq < 128 training route (B1 forward, blockwise
   backward) against its plain forward, under the same row gate.
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
4. Time ``--mode decode`` at the reference workload (B=1, 16 heads x 128,
   64000 KV tokens, one query) through the contiguous decode kernel (B1).
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
TOL_OUT_REL, TOL_LSE = 2e-2, 1e-3  # out: relative to each row's max |out|
TOL_LOGITS = 0.1
TOL_KV_REL = 2e-2  # written KV: relative to the pool's max |value|
# dq/dk/dv: each row within 2e-2 of that row's largest |plain value| (about
# two bf16 ulps: both sides round ds and p to bf16 before the products).
TOL_GRAD_REL = 2e-2
# One training step, kernel path vs plain path: per-parameter gradient norm
# ratio, and the loss.
TOL_STEP_GRAD, TOL_STEP_LOSS = 2e-2, 1e-2
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
    """``{kernel<dtype,D>: [registers, spill-store bytes]}`` of the
    backward kernels, from the ``-Xptxas -v`` log the build keeps beside
    each library."""
    import re

    out = {}
    log = build._target("flash_bwd").with_suffix(".log").read_text()
    for block in log.split("Compiling entry function")[1:]:
        name = re.search(r"(flash_(?:dq|dkv)_kernel)I(13__nv_bfloat16|f)"
                         r"Li(\d+)E", block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        if name and regs:
            dtype = "bf16" if name.group(2) != "f" else "f32"
            key = f"{name.group(1)}<{dtype},{name.group(3)}>"
            out[key] = [int(regs.group(1)),
                        int(spill.group(1)) if spill else 0]
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
    from tree_attention_tpu_torch.ops.tuning import BWD_BLOCK_K, BWD_BLOCK_Q
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

    def time_ms(fn, floor_ms, iters=10):
        """Device time of one call: the summed duration of the kernels it
        runs on the card (torch.profiler), mean of ``iters`` calls with the
        L2 flushed before each (a serving step finds the layer's KV cold);
        host launch gaps are excluded. ``floor_ms`` is the least time the
        card could take for the call's work (its bound): a profiler reading
        below it has lost kernels, and then — or if the profiler traces no
        device time — the median of CUDA events around each call is taken
        instead (launch gaps included); a reading still below the floor
        fails the run. Returns ``(ms, clock)``."""
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, cuda_act]) as prof:
            for _ in range(iters):
                flush_buf.zero_()
                fn()
            torch.cuda.synchronize()
        total = sum(ms for name, ms in device_kernels(prof)
                    if "FillFunctor<unsigned char>" not in name)
        if total / iters >= floor_ms:
            return total / iters, "profiler"
        if total > 0:
            print(f"time_ms: profiler read {total / iters:.4f} ms, below "
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
        return ms, "cuda_events"

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

    def record(kernel, name, fn, plain, library, bytes_, flops):
        a, b = fn(), plain()
        torch.cuda.synchronize()
        ok, eo, er, el = gate(a, b)
        if not ok:
            fail(f"{kernel} {name}: |dout| {eo:.3e}, relative {er:.3e} "
                 f"(tol {TOL_OUT_REL}), |dlse| {el:.3e} (tol {TOL_LSE})")
        bound = max(bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
        (ms, clock), (plain_ms, plain_clock), (lib_ms, lib_clock) = (
            time_ms(fn, bound), time_ms(plain, bound, iters=3),
            time_ms(library, bound))
        c = {
            "kernel": kernel, "case": name, "max_abs_err": eo,
            "max_rel_err": er, "max_abs_err_lse": el, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound,
            "bound_by": ("bytes" if bytes_ / HBM_BYTES_PER_S
                         >= flops / BF16_FLOPS_PER_S else "operations"),
            "clocks": [clock, plain_clock, lib_clock],
        }
        cases.append(c)
        print(f"{kernel} {name}: |dout| {eo:.3e} relative {er:.3e} "
              f"|dlse| {el:.3e} (tol {TOL_OUT_REL}/{TOL_LSE}) ms {ms:.4f} plain {plain_ms:.4f} "
              f"sdpa {lib_ms:.4f} bound {bound:.4f} ({c['bound_by']}) "
              f"clocks {c['clocks']}", flush=True)

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
    del q, k, v, kp, vp, kg, vg, mask
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
    def gate_rows(got, want):
        """Every row of each gradient (dq rows per query, dk/dv rows per
        key) within TOL_GRAD_REL of that row's largest plain |value| — a
        row that is 0 in the plain version must be exactly 0. Returns
        ``(ok, max |d|, max relative |d|)``."""
        ok, eabs, erel = True, 0.0, 0.0
        for a, b in zip(got, want):
            if not (a.shape == b.shape and torch.isfinite(a).all()):
                return False, math.inf, math.inf
            d = (a.float() - b.float()).abs()
            row = b.float().abs().amax(-1, keepdim=True)
            ok = ok and bool((d <= TOL_GRAD_REL * row).all())
            eabs = max(eabs, d.max().item())
            erel = max(erel, (d / row.clamp_min(1e-30)).max().item())
        return ok, eabs, erel

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
        pairs = causal_pairs(B, Hq, Tq, Tk, qo, ko)
        io = (q.numel() + dout.numel()) * 2 + 2 * lse_f.numel() * 4
        kv = 2 * k.numel() * 2
        # SDPA's backward does the whole gradient: at least the q.k, dO.v,
        # ds.k, ds^T.q and p^T.dO products, 10 * pairs * D FLOPs.
        lib_ms, lib_clock = time_ms(
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
                ok, eabs, erel = gate_rows(fn(), plain())
                if not ok:
                    fail(f"{kernel} {name}: |d| {eabs:.3e}, relative "
                         f"{erel:.3e} (tol {TOL_GRAD_REL})")
                (c["plain_ms"], plain_clock) = time_ms(plain, bound, iters=3)
                c.update(max_abs_err=eabs, max_rel_err=erel)
            else:
                plain_clock = None
                c.update(plain_ms=None, max_abs_err=None, max_rel_err=None)
            c["ms"], clock = time_ms(fn, bound, iters=5)
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
    # What B7 would give without each KV tile's first live Q tile: the
    # plain dk/dv less that (Q tile, KV tile) pair's share, which is the
    # plain version on the pair's rows and keys at their offsets.
    bq, bk = BWD_BLOCK_Q, BWD_BLOCK_K
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
    print(f"gate: dv halved -> relative |d| {halved[2]:.3e}; first live Q "
          f"tile skipped -> relative |d| {skipped[2]:.3e}; both rejected: "
          f"{not (halved[0] or skipped[0])}", flush=True)
    if halved[0] or skipped[0]:
        fail("the gradient gate accepts a planted fault at the training "
             "shape")
    del q, k, v, dout, lse_f, delta, tq_in, want, dk, dv, share
    torch.cuda.empty_cache()
    # BASELINE.json's "causal forward+backward, seq 16384" shape: timing
    # only (the plain versions would materialise 17 GB of scores per array).
    long_shape = (1, 16, 16, 16384, 16384, 0, 0)
    q, k, v = (rnd(1, 16, 16384, 128) for _ in range(3))
    bound, bound_by = bwd_bound(
        4 * q.numel() * 2 + 16 * 16384 * 4,
        4.0 * 128 * causal_pairs(1, 16, 16384, 16384, 0, 0))
    fwd_ms, fwd_clock = time_ms(
        lambda: cuda_attention.attention_cuda_fwd(q, k, v, causal=True),
        bound, iters=3)
    sdpa_ms, sdpa_clock = time_ms(
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
        "flash_fwd": cuda_attention.attention_cuda_fwd,
        "flash_dq": cuda_bwd.attention_cuda_dq,
        "flash_dkv": cuda_bwd.attention_cuda_dkv,
    }

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0

    serve_cfg = parse_args([
        "--mode", "serve", "--model-dim", "2048", "--heads", "16",
        "--n-layers", "4", "--vocab-size", "32768", "--dtype", "bfloat16",
        "--slots", "8", "--requests", "16", "--prompt-len", "512",
        "--prompt-jitter", "64", "--max-new-tokens", "64",
        "--prefill-chunk", "256", "--kv-layout", "paged", "--kv-block", "64",
        "--temperature", "0",
    ])
    reset_counts()
    t0 = time.monotonic()
    rec, server = cli.run_serve(serve_cfg, dev)
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

    # Where a serve step's time goes: one more wave (8 requests) on the
    # same weights, served once untraced (its wall) and once traced (its
    # device time; the profiler slows the host, so its own wall is longer).
    tcfg, params = server.cfg, server.params
    trace = synthetic_trace(8, prompt_len=512, prompt_jitter=64,
                            max_new_tokens=64, vocab_size=tcfg.vocab_size,
                            seed=7)

    def wave():
        engine = SlotServer(params, tcfg, slots=8, cache_len=640,
                            prefill_chunk=256, kv_block=64)
        rep = engine.serve(trace)
        torch.cuda.synchronize()
        return rep

    plain_rep = wave()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        prof_rep = wave()
    by_kernel = {}
    for name, ms in device_kernels(prof):
        by_kernel[name] = by_kernel.get(name, 0.0) + ms
    groups = {"flash_decode (B1/B2 + merge)": ("decode_split", "merge_splits"),
              "flash_fwd (B3)": ("flash_fwd",),
              "matmul": ("nvjet", "gemm", "gemv", "sm90", "cutlass",
                         "cublas")}
    split = {g: 0.0 for g in groups}
    split["other"] = 0.0
    for name, ms in by_kernel.items():
        low = name.lower()
        key = next((g for g, keys in groups.items()
                    if any(x in low for x in keys)), "other")
        split[key] += ms
    busy = sum(split.values())
    wall_ms, traced_wall_ms = plain_rep.wall_s * 1e3, prof_rep.wall_s * 1e3
    breakdown = {
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
    print(f"serve breakdown (8 requests): "
          + (json.dumps({k: round(v, 3) for k, v in split.items()})
             + f" busy {busy:.2f} ms (traced) of {wall_ms:.2f} ms untraced "
             f"wall ({traced_wall_ms:.2f} ms traced), idle share "
             f"{breakdown['idle_share']:.4f}"
             if busy else "device time not measured"), flush=True)

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
    del server, params, cache, snap, kv_kernel, lk, lp, ck, cp
    torch.cuda.empty_cache()

    # -- 4. decode: the reference workload through B1 ----------------------
    reset_counts()
    drec = cli.run_decode(parse_args(["--mode", "decode", "--iters", "20"]),
                          dev)
    launches["flash_decode"] = wrappers["flash_decode"].launches
    print(f"decode: {drec['median_s'] * 1e3:.4f} ms per step "
          f"({drec['clock']}), {drec['tokens_per_sec']} KV tokens/s, "
          f"launches {launches['flash_decode']}", flush=True)
    if launches["flash_decode"] == 0:
        fail("decode never launched flash_decode")

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
    tgroups = {"flash_fwd (B3)": ("flash_fwd_kernel",),
               "flash_dq (B6)": ("flash_dq_kernel",),
               "flash_dkv (B7)": ("flash_dkv_kernel",),
               "matmul": groups["matmul"]}
    tsplit = {g: 0.0 for g in tgroups}
    tsplit["other"] = 0.0
    tby_kernel = {}
    for name, ms in device_kernels(prof):
        tby_kernel[name] = tby_kernel.get(name, 0.0) + ms
        low = name.lower()
        key = next((g for g, keys in tgroups.items()
                    if any(x in low for x in keys)), "other")
        tsplit[key] += ms
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
        "flash_fwd": ("cuda", csrc + "flash_fwd.cu",
                      "tree_attention_tpu/ops/pallas_attention.py:65"),
        "flash_dq": ("cuda", csrc + "flash_bwd.cu",
                     "tree_attention_tpu/ops/pallas_bwd.py:84"),
        "flash_dkv": ("cuda", csrc + "flash_bwd.cu",
                      "tree_attention_tpu/ops/pallas_bwd.py:118"),
    }
    # Main-path launches: B1 in the decode phase, B2 in the serve phase, B3
    # in the serve and the train phases, B6/B7 in the train phase.
    main_launches = dict(launches)
    for n, count in train_launches.items():
        main_launches[n] = main_launches.get(n, 0) + count
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
                   "serve": rec, "decode": drec,
                   "mixed_step": {"logits_err": logit_err, "kv_err": kv_err,
                                  "kv_max": kv_max},
                   "serve_breakdown": breakdown, "train": trec,
                   "train_launches": train_launches,
                   "train_step_vs_plain": {"loss": [loss_k, loss_p],
                                           "grad_rel": grad_rel},
                   "train_breakdown": train_breakdown,
                   "ptxas": ptxas, "kernels": kernels}, f, indent=1)
    print(f"chip_smoke: total wall {time.monotonic() - t_start:.1f}s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
