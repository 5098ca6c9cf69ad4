"""Time the decode kernels of one checkout of the port on the card.

``python3 kernel_times.py --root DIR --label NAME`` imports
``tree_attention_tpu_torch`` from the checkout at ``DIR`` (its kernels
built there at first use) and times, on one GPU, the shapes where B1, B2,
B4 and B5 run on the main path:

- B1 at the reference workload (B1 H16 Tk64000 Tq1, ``--mode decode``),
  its split body and its merge apart; a ragged GQA batch (B8 Hq32 Hkv8
  Tk4096 Tq16: a prompt tail of the int8 staging cache's shape); the
  contiguous verify tick (B8 H16 Tk640 Tq8 tree) and the reference workload
  with a Tq-8 tree;
- B4 at the reference workload (channel scales), split and merge apart,
  and with a Tq-8 tree; at the contiguous verify tick (Tq 8 tree) and the
  ragged GQA batch with a ragged Tk (Tk 4037);
- the int8 cast route over B1 (bf16 Q against channel-quantized K/V) at
  the reference workload, Tq 1 and with a Tq-8 tree;
- B5 over a paged int8 pool with per-block scales at the serve shapes (8
  slots of 640 tokens in 64-token blocks, 16 heads x 128): the decode tick
  (Tq 1), chain verify ticks (Tq 8, 32) and tree verify ticks (Tq 8, 32);
- B2 at the same serve shapes: the tick, tree verify ticks at Tq 8 and 32,
  the prompt-tail buckets Tq 8, 16, 32 and 64, one rank's tick and 64-row
  chunk of a pool sharded two ways; and its cast route over the int8 pool
  with per-block scales: the tick, the Tq-8 tree verify tick and the
  rank's 64-row chunk;
- one long paged slot (B1 H16, 1000 blocks of 64 tokens: the reference
  workload through a table), B2 and B5 with per-block scales, at one row;
- B7 (dK/dV) at the training shape (B2 H16 T4096 causal).

The checkout's kernels are built first, one ``nvcc`` per source in
parallel. Inputs come from fixed seeds, so two checkouts see the same ones.
Run it
for two checkouts in turns in one call (parent, change, change, parent) to
compare them on one card.

Each time is device time from ``torch.profiler``, mean of 10 calls with
the L2 flushed before each, the larger of two traced runs: ``kernel_ms``
counts the kernel's own launches (for the decode kernels the split or
multi-row or tick body and the merge), ``by_kernel_ms`` splits them by
body (``decode_split``, ``decode_tiled``, ``decode_tick``,
``merge_splits``), ``call_ms`` counts
every kernel of the call. Prints one JSON line and writes it to
``chiprun_out/kernel_times_<label>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

DECODE_BODIES = ("decode_split", "decode_tiled", "decode_tick",
                 "merge_splits")


def tree_masks(B: int, tq: int, seed: int):
    """(B, tq, tq) bool draft trees: row i's parent is a random earlier
    row, and a row sees itself and its ancestors."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    m = np.zeros((B, tq, tq), bool)
    for b in range(B):
        for i in range(tq):
            m[b, i, i] = True
            if i:
                m[b, i] |= m[b, int(rng.integers(0, i))]
    return torch.from_numpy(m)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_times: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from tree_attention_tpu_torch.ops import _build, cuda_attention, cuda_bwd
    from tree_attention_tpu_torch.ops import cuda_decode as cd

    _build.build()

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    cuda_dev = torch.autograd.DeviceType.CUDA

    def device_ms(fn, names=DECODE_BODIES, iters=10):
        fn()
        torch.cuda.synchronize()
        best = None
        for _ in range(2):
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    flush.zero_()
                    fn()
                torch.cuda.synchronize()
            ks = [(e.name, e.time_range.elapsed_us() / 1e3)
                  for e in prof.events() if e.device_type == cuda_dev
                  and "FillFunctor<unsigned char>" not in e.name]
            by = {n: sum(ms for k, ms in ks if n in k) / iters
                  for n in names}
            run = {"kernel_ms": sum(by.values()),
                   "call_ms": sum(ms for _, ms in ks) / iters,
                   "by_kernel_ms": {n: ms for n, ms in by.items() if ms}}
            if best is None or run["kernel_ms"] > best["kernel_ms"]:
                best = run
        return best

    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def offsets(B, tk, tq):
        return torch.randint(0, tk - tq, (B,), generator=g, device=dev,
                             dtype=torch.int32)

    cases = {}
    b1, b2 = cd.attention_cuda_decode, cd.attention_cuda_decode_paged
    b4, b5 = cd.attention_cuda_decode_q8q, cd.attention_cuda_decode_paged_q8q

    # The reference workload: B1, then B4 over its channel-quantized K/V.
    q, k, v = rnd(1, 16, 1, 128), rnd(1, 16, 64000, 128), rnd(1, 16, 64000,
                                                              128)
    cases["B1 ref B1 H16 Tk64000 Tq1"] = device_ms(lambda: b1(q, k, v))
    kq, vq, ks, vs = cd.quantize_kv_channelwise(k, v)
    cases["B4 ref B1 H16 Tk64000 Tq1, channel scales"] = device_ms(
        lambda: b4(q, kq, vq, ks, vs))
    q8 = cd.attention_cuda_decode_q8
    cases["B1 cast ref B1 H16 Tk64000 Tq1, channel scales"] = device_ms(
        lambda: q8(q, kq, vq, ks, vs))
    q = rnd(1, 16, 8, 128)
    qoff = torch.full((1,), 64000 - 8, dtype=torch.int32, device=dev)
    trees = tree_masks(1, 8, 3).to(dev)
    cases["B1 ref B1 H16 Tk64000 Tq8 tree"] = device_ms(
        lambda: b1(q, k, v, causal=True, q_offset=qoff, tree_mask=trees))
    cases["B4 ref B1 H16 Tk64000 Tq8 tree, channel scales"] = device_ms(
        lambda: b4(q, kq, vq, ks, vs, causal=True, q_offset=qoff,
                   tree_mask=trees))
    cases["B1 cast ref B1 H16 Tk64000 Tq8 tree, channel scales"] = \
        device_ms(lambda: q8(q, kq, vq, ks, vs, causal=True, q_offset=qoff,
                             tree_mask=trees))
    del k, v, kq, vq
    q, k, v = rnd(8, 32, 16, 128), rnd(8, 8, 4096, 128), rnd(8, 8, 4096, 128)
    qoff = offsets(8, 4096, 16)
    cases["B1 GQA B8 Hq32 Hkv8 Tk4096 Tq16 ragged"] = device_ms(
        lambda: b1(q, k, v, causal=True, q_offset=qoff))
    q, k, v = rnd(8, 16, 8, 128), rnd(8, 16, 640, 128), rnd(8, 16, 640, 128)
    qoff = offsets(8, 640, 8)
    trees = tree_masks(8, 8, 8).to(dev)
    cases["B1 contiguous verify tick B8 H16 Tk640 Tq8 tree"] = device_ms(
        lambda: b1(q, k, v, causal=True, q_offset=qoff, tree_mask=trees))
    kq, vq, ks, vs = cd.quantize_kv_channelwise(k, v)
    cases["B4 contiguous verify tick B8 H16 Tk640 Tq8 tree"] = device_ms(
        lambda: b4(q, kq, vq, ks, vs, causal=True, q_offset=qoff,
                   tree_mask=trees))
    q = rnd(8, 32, 16, 128)
    kq, vq, ks, vs = cd.quantize_kv_channelwise(rnd(8, 8, 4037, 128),
                                                rnd(8, 8, 4037, 128))
    qoff = offsets(8, 4037, 16)
    cases["B4 GQA B8 Hq32 Hkv8 Tk4037 Tq16 ragged"] = device_ms(
        lambda: b4(q, kq, vq, ks, vs, causal=True, q_offset=qoff))
    del k, v, kq, vq

    # The serve shapes: 8 slots of 640 tokens in 64-token blocks of a
    # fragmented 96-block pool; int8 blocks with magnitudes (and so scales)
    # that differ from block to block.
    blk, nb, npool = 64, 10, 96
    kp, vp = rnd(npool, 16, blk, 128), rnd(npool, 16, blk, 128)
    table = torch.stack([torch.randperm(npool, generator=g, device=dev)[:nb]
                         for _ in range(8)]).to(torch.int32)

    def int8_pool():
        x = (torch.randn((npool, 16, blk, 128), generator=g, device=dev)
             * torch.exp(0.7 * torch.randn((npool, 16, 1, 1), generator=g,
                                           device=dev)))
        codes, sc = cd.quantize_symmetric_int8(
            x.reshape(npool, 16, blk * 128), 2)
        return codes.reshape(npool, 16, blk, 128), sc[..., 0]

    (kp8, kbs), (vp8, vbs) = int8_pool(), int8_pool()
    for tq in (1, 8, 32):
        q = rnd(8, 16, tq, 128)
        qoff = offsets(8, nb * blk, tq)
        kind = "tick" if tq == 1 else "chain verify tick"
        cases[f"B5 {kind} Tq{tq}, per-block scales"] = device_ms(
            lambda: b5(q, kp8, vp8, table, kbs, vbs, q_offset=qoff))
        if tq > 1:
            trees = tree_masks(8, tq, tq).to(dev)
            cases[f"B5 tree verify tick Tq{tq}, per-block scales"] = \
                device_ms(lambda: b5(q, kp8, vp8, table, kbs, vbs,
                                     q_offset=qoff, tree_mask=trees))
            cases[f"B2 tree verify tick Tq{tq}"] = device_ms(
                lambda: b2(q, kp, vp, table, q_offset=qoff, tree_mask=trees))
    for tq in (1, 8, 16, 32, 64):
        q = rnd(8, 16, tq, 128)
        qoff = offsets(8, nb * blk, tq)
        kind = {1: "tick", 64: "chunk"}.get(tq, "prompt tail")
        cases[f"B2 {kind} Tq{tq}"] = device_ms(
            lambda: b2(q, kp, vp, table, q_offset=qoff))
        if tq in (1, 8):  # the cast route over the int8 pool
            kind = "tick" if tq == 1 else "tree verify tick"
            trees = tree_masks(8, tq, 5).to(dev) if tq > 1 else None
            cases[f"B2 cast {kind} Tq{tq}, per-block scales"] = device_ms(
                lambda: b2(q, kp8, vp8, table, q_offset=qoff,
                           block_scales=(kbs, vbs), tree_mask=trees))
    # One rank of two: global ids [0, 40) of an 80-block pool, slot tables
    # interleaved over the ranks as the sharded allocator hands blocks out.
    order = [r * 40 + i for i in range(40) for r in range(2)]
    gtable = torch.tensor(order, dtype=torch.int32, device=dev).reshape(8, 10)
    loc = torch.where(gtable < 40, gtable, -1).to(torch.int32)
    q = rnd(8, 16, 1, 128)
    qoff = offsets(8, nb * blk, 1)
    cases["B2 local_blocks tick Tq1, rank 0 of W=2"] = device_ms(
        lambda: b2(q, kp[:40], vp[:40], loc, q_offset=qoff,
                   local_blocks=True, local_shards=2))
    q = rnd(8, 16, 64, 128)
    qoff = offsets(8, nb * blk, 64)
    cases["B2 local_blocks chunk Tq64, rank 0 of W=2"] = device_ms(
        lambda: b2(q, kp[:40], vp[:40], loc, q_offset=qoff,
                   local_blocks=True, local_shards=2))
    cases["B2 cast local_blocks chunk Tq64, rank 0 of W=2, per-block "
          "scales"] = device_ms(
        lambda: b2(q, kp8[:40], vp8[:40], loc, q_offset=qoff,
                   block_scales=(kbs[:40], vbs[:40]), local_blocks=True,
                   local_shards=2))
    del kp, vp, kp8, vp8

    # One long paged slot: the reference workload through a table.
    kp, vp = rnd(1000, 16, 64, 128), rnd(1000, 16, 64, 128)
    table = torch.randperm(1000, generator=g, device=dev)[None].to(
        torch.int32)
    q = rnd(1, 16, 1, 128)
    qoff = torch.full((1,), 63999, dtype=torch.int32, device=dev)
    cases["B2 long paged slot B1 H16 NB1000 Tq1"] = device_ms(
        lambda: b2(q, kp, vp, table, q_offset=qoff))
    (kp8, kbs), (vp8, vbs) = (
        (c.reshape(kp.shape), sc[..., 0]) for c, sc in (
            cd.quantize_symmetric_int8(x.reshape(1000, 16, -1), 2)
            for x in (kp, vp)))
    del kp, vp
    cases["B5 long paged slot B1 H16 NB1000 Tq1, per-block scales"] = \
        device_ms(lambda: b5(q, kp8, vp8, table, kbs, vbs, q_offset=qoff))
    del kp8, vp8

    q, k, v, dout = (rnd(2, 16, 4096, 128) for _ in range(4))
    out, lse = cuda_attention.attention_cuda_fwd(q, k, v, causal=True)
    lse_f, delta = cuda_bwd.bwd_residuals(out, lse, dout)
    cases["B7 train B2 H16 T4096 causal"] = device_ms(
        lambda: cuda_bwd.attention_cuda_dkv(q, k, v, dout, lse_f, delta,
                                            causal=True), ("flash_dkv",))

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    rec = {"label": args.label, "root": args.root, "card": card,
           "cases": cases}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out",
                           f"kernel_times_{args.label}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
