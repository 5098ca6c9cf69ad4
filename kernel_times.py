"""Time the redesigned kernels of one checkout of the port on the card.

``python3 kernel_times.py --root DIR --label NAME`` imports
``tree_attention_tpu_torch`` from the checkout at ``DIR`` (its kernels
built there at first use) and times, on one GPU, the shapes where B7 and
B2's multi-row shapes run on the main path: B7 (dK/dV) at the training
shape (B2 H16 T4096 causal) and at B1 H16 T16384, and B2 at the serve
shapes (8 slots of 640 tokens in 64-token blocks, 16 heads x 128): verify
ticks with a tree mask at Tq 8 and 32, the prompt-tail buckets Tq 8, 16,
32 and 64, and one rank's 64-row chunk of a pool sharded two ways — and,
where the checkout's B2 takes ``local_shards``, one rank's tick and chunk
at W = 2 and 4 with the splits sized on the logical length and on the
rank's share. Inputs come from fixed seeds, so two checkouts see the same
ones. Run it for two checkouts in turns in one call (parent, change,
change, parent) to compare them on one card.

Each time is device time from ``torch.profiler``, mean of 10 calls with
the L2 flushed before each, the larger of two traced runs: ``kernel_ms``
counts the kernel's own launches (for B2 the split/multi-row body and the
merge), ``call_ms`` every kernel of the call. Prints one JSON line and
writes it to ``chiprun_out/kernel_times_<label>.json``.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys


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
    from tree_attention_tpu_torch.ops import cuda_attention, cuda_bwd
    from tree_attention_tpu_torch.ops import cuda_decode

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    cuda_dev = torch.autograd.DeviceType.CUDA

    def device_ms(fn, names, iters=10):
        fn()
        torch.cuda.synchronize()
        best = (0.0, 0.0)
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
            call = sum(ms for _, ms in ks) / iters
            own = sum(ms for n, ms in ks if any(x in n for x in names)) / iters
            best = max(best, (own, call))
        return {"kernel_ms": best[0], "call_ms": best[1]}

    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    cases = {}
    for name, (B, T) in (("B7 train B2 H16 T4096 causal", (2, 4096)),
                         ("B7 long B1 H16 T16384 causal", (1, 16384))):
        q, k, v, dout = (rnd(B, 16, T, 128) for _ in range(4))
        out, lse = cuda_attention.attention_cuda_fwd(q, k, v, causal=True)
        lse_f, delta = cuda_bwd.bwd_residuals(out, lse, dout)
        cases[name] = device_ms(lambda: cuda_bwd.attention_cuda_dkv(
            q, k, v, dout, lse_f, delta, causal=True), ("flash_dkv",))
        del q, k, v, dout, out, lse, lse_f, delta

    b2 = cuda_decode.attention_cuda_decode_paged
    own = ("decode_split", "decode_tiled", "merge_splits")
    blk, nb, npool = 64, 10, 96
    kp, vp = rnd(npool, 16, blk, 128), rnd(npool, 16, blk, 128)
    table = torch.stack([torch.randperm(npool, generator=g, device=dev)[:nb]
                         for _ in range(8)]).to(torch.int32)
    for tq in (8, 32):
        q = rnd(8, 16, tq, 128)
        qoff = torch.randint(0, nb * blk - tq, (8,), generator=g, device=dev,
                             dtype=torch.int32)
        trees = tree_masks(8, tq, tq).to(dev)
        cases[f"B2 verify tick tree Tq{tq}"] = device_ms(
            lambda: b2(q, kp, vp, table, q_offset=qoff, tree_mask=trees), own)
    for tq in (64, 8, 16, 32):
        q = rnd(8, 16, tq, 128)
        qoff = torch.randint(0, nb * blk - tq, (8,), generator=g, device=dev,
                             dtype=torch.int32)
        cases[f"B2 {'chunk' if tq == 64 else 'prompt tail'} Tq{tq}"] = \
            device_ms(lambda: b2(q, kp, vp, table, q_offset=qoff), own)
    # One rank of two: global ids [0, 40) of an 80-block pool, slot tables
    # interleaved over the ranks as the sharded allocator hands blocks out.
    order = [r * 40 + i for i in range(40) for r in range(2)]
    gtable = torch.tensor(order, dtype=torch.int32, device=dev).reshape(8, 10)
    loc = torch.where(gtable < 40, gtable, -1).to(torch.int32)
    q = rnd(8, 16, 64, 128)
    qoff = torch.randint(0, nb * blk - 64, (8,), generator=g, device=dev,
                         dtype=torch.int32)
    kw = dict(q_offset=qoff, local_blocks=True)
    if "local_shards" in inspect.signature(b2).parameters:
        kw["local_shards"] = 2  # what the sharded serve passes
    cases["B2 local_blocks chunk Tq64, rank 0 of W=2"] = device_ms(
        lambda: b2(q, kp[:40], vp[:40], loc, **kw), own)
    if "local_shards" in kw:
        # Split sizing under local_blocks: one rank's launches (the tick and
        # the 64-row chunk, W = 2 and 4) with the splits sized on the
        # logical length (local_shards=1) and on the rank's share (W).
        for W in (2, 4):
            nl = 80 // W
            order = [r * nl + i for i in range(nl) for r in range(W)]
            gt = torch.tensor(order, dtype=torch.int32,
                              device=dev).reshape(8, 10)
            lw = torch.where(gt < nl, gt, -1).to(torch.int32)
            for tq in (1, 64):
                q = rnd(8, 16, tq, 128)
                qoff = torch.randint(0, nb * blk - tq, (8,), generator=g,
                                     device=dev, dtype=torch.int32)
                for shards in (1, W):
                    cases[f"B2 local_blocks Tq{tq}, rank 0 of W={W}, splits "
                          f"sized for {shards} shard(s)"] = device_ms(
                        lambda: b2(q, kp[:nl], vp[:nl], lw, q_offset=qoff,
                                   local_blocks=True, local_shards=shards),
                        own)

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
