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
   3.35 TB/s or FLOPs / 989 TFLOP/s, the larger).
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
5. Print the kernels line, then ``{"ok": true, "device": {...}}`` last.

Extra per-case numbers go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
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


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.nn.functional as F

    from tree_attention_tpu_torch import cli
    from tree_attention_tpu_torch.models import (
        forward_step,
        init_paged_cache,
    )
    from tree_attention_tpu_torch.ops import _build, cuda_attention
    from tree_attention_tpu_torch.ops import cuda_decode
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

    def time_ms(fn, iters=10):
        """Device time of one call: the summed duration of the kernels it
        runs on the card (torch.profiler), mean of ``iters`` calls with the
        L2 flushed before each (a serving step finds the layer's KV cold);
        host launch gaps are excluded. If the profiler traces no device
        time, the median of CUDA events around each call instead (launch
        gaps included). Returns ``(ms, clock)``."""
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
        if total > 0:
            return total / iters, "profiler"
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
        return sorted(times)[len(times) // 2], "cuda_events"

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
            time_ms(fn), time_ms(plain, iters=3), time_ms(library))
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
    del q, k, v, kp, vp, kg, vg, mask, flush_buf
    torch.cuda.empty_cache()

    # -- 3. serve through the paged, chunked SlotServer --------------------
    wrappers = {
        "flash_decode": cuda_decode.attention_cuda_decode,
        "flash_decode_paged": cuda_decode.attention_cuda_decode_paged,
        "flash_fwd": cuda_attention.attention_cuda_fwd,
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

    # -- 5. report -------------------------------------------------------
    csrc = "tree_attention_tpu_torch/csrc/"
    meta = {
        "flash_decode": ("cuda", csrc + "flash_decode.cu",
                         "tree_attention_tpu/ops/pallas_decode.py:179"),
        "flash_decode_paged": ("cuda", csrc + "flash_decode.cu",
                               "tree_attention_tpu/ops/pallas_decode.py:344"),
        "flash_fwd": ("cuda", csrc + "flash_fwd.cu",
                      "tree_attention_tpu/ops/pallas_attention.py:65"),
    }
    kernels = []
    for name, (route, src, replaces) in meta.items():
        mine = [c for c in cases if c["kernel"] == name]
        head = mine[0]  # the main-path shape: listed first per kernel
        kernels.append({
            "name": name, "route": route, "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "max_rel_err": max(c["max_rel_err"] for c in mine),
            "tolerance_rel": TOL_OUT_REL, "tolerance_lse": TOL_LSE,
            "parity": "pass",
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
        })
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "build_s": secs, "cases": cases,
                   "serve": rec, "decode": drec,
                   "mixed_step": {"logits_err": logit_err, "kv_err": kv_err,
                                  "kv_max": kv_max},
                   "serve_breakdown": breakdown,
                   "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
