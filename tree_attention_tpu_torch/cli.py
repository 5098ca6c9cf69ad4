"""Command line: ``python -m tree_attention_tpu_torch``.

Counterpart of ``tree_attention_tpu/cli.py`` for four modes, each printing
one JSON record on stdout:

    python -m tree_attention_tpu_torch                  # reference workload
    python -m tree_attention_tpu_torch --mode generate --q-len 16
    python -m tree_attention_tpu_torch --mode serve --model-dim 2048 ...
    python -m tree_attention_tpu_torch --mode train --seq-len 4096 ...

``decode`` times one attention step over a ``--seq-len`` KV cache (64000
tokens, 16 heads x 128, one query by default) with CUDA events (over an int8
cache with ``--kv-quant``); ``generate``
prefills a random prompt and decodes; ``serve`` drains a synthetic request
trace through the continuous-batching :class:`SlotServer`; ``train`` takes
``--steps`` optimizer steps on random next-token batches (with
``--ckpt-dir``/``--resume`` checkpointing) and times one more. Everything
runs on the GPU unless ``--device cpu`` is given; with no usable GPU the CLI
exits with an error instead of falling back.

Under ``--mesh seq=W`` the CLI runs once per rank, e.g.::

    torchrun --standalone --nproc-per-node 2 -m tree_attention_tpu_torch \
        --mesh seq=2 --mode serve --kv-shard seq ...

``decode`` then shards the KV sequence over the ranks and merges their
partials with the tree all-reduce (record ``tree_decode``); ``serve`` with
``--kv-shard seq`` serves from a sequence-sharded paged pool. The process
group forms before any device work and is destroyed on exit; only rank 0
prints the record.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import sys
import zlib
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from tree_attention_tpu_torch.obs.metrics import TRAIN_STEPS, TRAIN_TOKENS
from tree_attention_tpu_torch.parallel.mesh import (
    AXIS_SEQ,
    Mesh,
    dist_info,
    initialize_distributed,
    make_mesh,
)
from tree_attention_tpu_torch.utils import resolve_device
from tree_attention_tpu_torch.utils.config import RunConfig, parse_args
from tree_attention_tpu_torch.utils.logging import get_logger, setup_logging
from tree_attention_tpu_torch.utils.profiling import time_fn

log = get_logger("cli")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def check_kv_quant(cfg: RunConfig) -> Optional[str]:
    """The q8 route of ``--kv-quant`` (None without it). An int8 buffer is
    served by the q8 kernels or their plain versions only, so ``--impl
    naive|blockwise`` is refused."""
    kernel = cfg.resolved_quant_kernel()
    if kernel is not None and cfg.impl not in ("auto", "plain"):
        raise SystemExit(
            f"--kv-quant {cfg.kv_quant} runs a q8 decode kernel; --impl "
            f"{cfg.impl} cannot serve a quantized buffer"
        )
    return kernel


def _seq_sharded(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.axis_size(AXIS_SEQ) > 1


def _quantize_across(k: torch.Tensor, v: torch.Tensor, mesh: Mesh):
    """Per-channel int8 quantization of this rank's K/V shard under the
    scales of the WHOLE sequence: each channel's absmax is taken over every
    rank's shard (one MAX all-reduce; setup, outside any timed call), then
    the q8 contract (:func:`quantize_symmetric_int8`'s scale and rounding)
    runs against it."""
    from tree_attention_tpu_torch.ops.cuda_decode import (
        quantize_symmetric_int8,
    )

    out = []
    for x in (k, v):
        amax = x.float().abs().amax(2, keepdim=True)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX,
                        group=mesh.group(AXIS_SEQ))
        out.append(quantize_symmetric_int8(x, 2, amax=amax))
    (k_q, k_s), (v_q, v_s) = out
    return k_q, v_q, k_s, v_s


def run_decode(cfg: RunConfig, dev: torch.device,
               mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """The reference workload: one attention step over a KV cache, timed;
    with ``--kv-quant`` over its per-channel int8 quantization through the
    q8 route it names. On a mesh whose ``seq`` axis is larger than 1 the
    KV sequence is sharded over the ranks (each makes only its own shard)
    and each timed call is this rank's partial plus the tree merge."""
    from tree_attention_tpu_torch.data import make_qkv, make_qkv_sharded
    from tree_attention_tpu_torch.ops import flash_attention
    from tree_attention_tpu_torch.ops.cuda_decode import (
        quantize_kv_channelwise,
        resolve_q8_kernel,
    )
    from tree_attention_tpu_torch.parallel.tree import (
        tree_decode,
        tree_decode_q8,
    )

    kernel = check_kv_quant(cfg)
    hkv = cfg.resolved_kv_heads()
    shape = dict(batch=cfg.batch, heads=cfg.heads, kv_heads=hkv,
                 q_len=cfg.q_len, seq_len=cfg.seq_len,
                 head_dim=cfg.head_dim, dtype=_DTYPES[cfg.dtype], device=dev)
    sharded = _seq_sharded(mesh)
    if sharded:
        if cfg.impl not in ("auto", "plain"):
            raise SystemExit(f"--mesh runs the decode kernels or their "
                             f"plain versions; --impl {cfg.impl} cannot")
        q, k, v = make_qkv_sharded(cfg.seed, mesh, **shape)
    else:
        q, k, v = make_qkv(torch.Generator(device=dev).manual_seed(cfg.seed),
                           **shape)
    name, impl, extra = "decode", cfg.impl, {}
    if kernel is None and sharded:
        name = "tree_decode"
        stats = time_fn(tree_decode, q, k, v, mesh=mesh, causal=cfg.causal,
                        impl=cfg.impl, iters=cfg.iters, warmup=cfg.warmup,
                        device=dev)
    elif kernel is None:
        stats = time_fn(flash_attention, q, k, v, causal=cfg.causal,
                        impl=cfg.impl, iters=cfg.iters, warmup=cfg.warmup,
                        device=dev)
    else:
        if sharded:
            k, v, k_s, v_s = _quantize_across(k, v, mesh)
            name = "tree_decode_" + kernel
            stats = time_fn(tree_decode_q8, q, k, v, k_s, v_s, mesh=mesh,
                            causal=cfg.causal, kernel=kernel, impl=cfg.impl,
                            iters=cfg.iters, warmup=cfg.warmup, device=dev)
        else:
            k, v, k_s, v_s = quantize_kv_channelwise(k, v)
            fn = resolve_q8_kernel(kernel, plain=cfg.impl == "plain")
            stats = time_fn(fn, q, k, v, k_s, v_s, causal=cfg.causal,
                            iters=cfg.iters, warmup=cfg.warmup, device=dev)
            name = "decode_" + kernel
        extra = {"kv_quant": cfg.kv_quant}
        # What actually ran: B4, or B1 over int8 K/V, or a plain version.
        impl = ("plain" if cfg.impl == "plain" or dev.type == "cpu"
                else {"q8q": "flash_decode_q8q", "q8": "flash_decode"}[
                    kernel])
    if sharded:
        extra.update(_mesh_record(cfg, mesh, dev))
    flops = 4.0 * cfg.batch * cfg.heads * cfg.q_len * cfg.seq_len \
        * cfg.head_dim
    log.info("%s: %d KV tokens, %d heads x %d, %s on %s: median %.6fs",
             name, cfg.seq_len, cfg.heads, cfg.head_dim, cfg.dtype,
             device_name(dev), stats.median)
    return {
        "name": name,
        "workload": {
            "batch": cfg.batch, "heads": cfg.heads, "kv_heads": hkv,
            "head_dim": cfg.head_dim, "seq_len": cfg.seq_len,
            "q_len": cfg.q_len, "dtype": cfg.dtype, "causal": cfg.causal,
            "impl": impl, **extra,
        },
        # The K and V bytes one step must stream (this rank's shard).
        "kv_bytes": k.numel() * k.element_size() * 2,
        "device": device_name(dev),
        "tokens_per_sec": round(cfg.batch * cfg.seq_len / stats.median, 1),
        "flops_per_sec": flops / stats.median,
        "clock": stats.clock,
        **stats.as_dict(),
    }


def _mesh_record(cfg: RunConfig, mesh: Mesh, dev: torch.device
                 ) -> Dict[str, Any]:
    """What a record states about its mesh: the axes, the backend, and
    how many of this host's ranks share each card (more than 1 only under
    an explicit gloo backend)."""
    rec: Dict[str, Any] = {"mesh": dict(mesh.shape),
                           "dist_backend": cfg.resolved_dist_backend()}
    if dev.type == "cuda":
        rec["ranks_per_card"] = -(-dist_info().local_world_size
                                  // torch.cuda.device_count())
    return rec


def transformer_config(cfg: RunConfig):
    """The model the CLI builds: d_head = model_dim / heads, SwiGLU width
    ~8/3 d_model rounded to 128 (the JAX CLI's rule)."""
    from tree_attention_tpu_torch.models import TransformerConfig

    return TransformerConfig(
        vocab_size=cfg.vocab_size,
        d_model=cfg.model_dim,
        n_layers=cfg.n_layers,
        n_heads=cfg.heads,
        n_kv_heads=cfg.resolved_kv_heads(),
        d_head=cfg.model_dim // cfg.heads,
        d_ff=int(8 * cfg.model_dim / 3 + 127) // 128 * 128,
        max_seq_len=max(cfg.seq_len, 128),
        dtype=_DTYPES[cfg.dtype],
        attn_impl="plain" if cfg.impl == "plain" else "auto",
    )


def run_train(cfg: RunConfig, dev: torch.device) -> Dict[str, Any]:
    """LM training steps (the JAX CLI's ``_run_train`` on one device: no
    mesh, corpus or elastic restarts), then one more step timed."""
    from tree_attention_tpu_torch.checkpoint import (
        Checkpointer,
        load_model_config,
    )
    from tree_attention_tpu_torch.data import make_lm_batch
    from tree_attention_tpu_torch.models import (
        count_params,
        default_optimizer,
        init_train_state,
        make_train_step,
    )

    if cfg.steps < 1:
        # The timing below reuses the last training batch; with no steps
        # there is neither a batch nor anything meaningful to time.
        raise SystemExit("train mode requires --steps >= 1")
    if cfg.resume and not cfg.ckpt_dir:
        raise SystemExit("--resume requires --ckpt-dir")
    tcfg = transformer_config(cfg)
    opt = default_optimizer()
    state = init_train_state(tcfg, opt, seed=cfg.seed, device=dev)
    step = make_train_step(tcfg, opt)
    log.info("transformer: %d params, %d layers, d_model %d, seq %d",
             count_params(state[0]), tcfg.n_layers, tcfg.d_model,
             cfg.seq_len)
    ckpt = start_step = None
    if cfg.ckpt_dir:
        ckpt = Checkpointer(cfg.ckpt_dir, save_interval_steps=cfg.ckpt_every)
        if cfg.resume and ckpt.latest_step() is not None:
            with contextlib.suppress(FileNotFoundError):
                saved_cfg = load_model_config(cfg.ckpt_dir)
                if saved_cfg != tcfg:
                    raise SystemExit(
                        f"checkpoint config in {cfg.ckpt_dir} disagrees with "
                        f"the CLI flags:\n  saved: {saved_cfg}\n  flags: "
                        f"{tcfg}"
                    )
            state, start_step = ckpt.restore(state)
            log.info("resumed from step %d", start_step)
    # --resume runs --steps MORE steps from the restored point.
    start = 0 if start_step is None else start_step + 1
    end = start + cfg.steps

    def next_batch(i: int) -> Dict[str, torch.Tensor]:
        # Batch i is a pure function of (seed, i): a resume replays nothing.
        g = torch.Generator().manual_seed((cfg.seed + 1) * 1_000_003 + i)
        return make_lm_batch(g, cfg.batch, cfg.seq_len, tcfg.vocab_size, dev)

    losses = []
    saved_last = True
    for i in range(start, end):
        batch = next_batch(i)
        state, loss = step(state, batch)
        losses.append(float(loss))
        TRAIN_STEPS.inc()
        TRAIN_TOKENS.inc(cfg.batch * cfg.seq_len)
        log.info("step %d: loss %.4f", i, losses[-1])
        if ckpt is not None:
            saved_last = ckpt.save(i, state, cfg=tcfg)
    if ckpt is not None:
        if not saved_last:
            # The save interval skipped the final step; the resumable
            # state must include all completed work.
            ckpt.save(end - 1, state, cfg=tcfg, force=True)
        ckpt.close()
    # Throughput of the step on the last batch. The timed steps update the
    # state in place too; they come after the last checkpoint and their
    # losses are not recorded.
    stats = time_fn(step, state, batch, iters=max(cfg.iters, 1), warmup=1,
                    device=dev)
    toks = cfg.batch * cfg.seq_len
    log.info("train step: median %.4fs (%.0f tokens/s)", stats.median,
             toks / stats.median)
    return {
        "mode": "train",
        "device": device_name(dev),
        "losses": losses,
        "tokens_per_sec": round(toks / stats.median, 1),
        "clock": stats.clock,
        **stats.as_dict(),
    }


def run_generate(cfg: RunConfig, dev: torch.device) -> Dict[str, Any]:
    from tree_attention_tpu_torch.models import generate, init_params

    if cfg.temperature < 0:
        raise SystemExit("--temperature must be >= 0 (0 = greedy)")
    if cfg.max_new_tokens < 1:
        raise SystemExit("--max-new-tokens must be >= 1")
    kernel = check_kv_quant(cfg)
    tcfg = transformer_config(cfg)
    params = init_params(tcfg, cfg.seed, dev)
    g = torch.Generator().manual_seed(cfg.seed + 1)
    prompt = torch.randint(0, tcfg.vocab_size, (cfg.batch, max(cfg.q_len, 1)),
                           generator=g).to(dev)
    toks = generate(params, prompt, cfg.max_new_tokens, tcfg,
                    temperature=cfg.temperature,
                    generator=torch.Generator(device=dev).manual_seed(
                        cfg.seed + 2),
                    quantize_after_prefill=kernel is not None,
                    quant_kernel=kernel or "q8q")
    log.info("generated %s tokens from a %s prompt%s", tuple(toks.shape),
             tuple(prompt.shape),
             f" ({cfg.kv_quant} KV cache)" if kernel else "")
    return {"mode": "generate", "device": device_name(dev),
            "tokens": toks.tolist(),
            **({"kv_quant": cfg.kv_quant} if kernel else {})}


def run_serve(cfg: RunConfig, dev: torch.device,
              mesh: Optional[Mesh] = None
              ) -> Tuple[Dict[str, Any], Any, Any]:
    """Drain a synthetic trace through the SlotServer; returns the JSON
    record, the drained server and its ``ServeReport``. Under a mesh every
    rank serves the same trace; with ``--kv-shard seq`` from its slice of
    the sharded pool. The ranks' token streams are checked equal at the end
    (one all-reduce)."""
    from tree_attention_tpu_torch.models import init_params, round_cache_len
    from tree_attention_tpu_torch.serving import SlotServer, synthetic_trace

    if cfg.max_new_tokens < 1:
        raise SystemExit("--max-new-tokens must be >= 1")
    if cfg.slots < 1:
        raise SystemExit("--slots must be >= 1")
    if cfg.prompt_len - cfg.prompt_jitter < 1:
        raise SystemExit("--prompt-jitter must leave prompts >= 1 token")
    if cfg.prefill_chunk < 1:
        raise SystemExit("--prefill-chunk must be >= 1")
    if cfg.prefill_budget is not None and cfg.prefill_budget < 1:
        raise SystemExit("--prefill-budget must be >= 1")
    if cfg.temperature < 0:
        raise SystemExit("--temperature must be >= 0 (0 = greedy)")
    if cfg.top_k < 0:
        raise SystemExit("--top-k must be >= 0 (0 = off)")
    if cfg.slo_ttft <= 0 or cfg.slo_tbt <= 0:
        raise SystemExit("--slo-ttft and --slo-tbt must be > 0")
    if cfg.kv_block is not None and (cfg.kv_block < 1
                                     or cfg.kv_block & (cfg.kv_block - 1)):
        raise SystemExit("--kv-block must be a power of two >= 1")
    if cfg.kv_blocks is not None and cfg.kv_blocks < 1:
        raise SystemExit("--kv-blocks must be >= 1")
    if cfg.kv_shard == "seq" and cfg.kv_layout != "paged":
        raise SystemExit("--kv-shard seq requires --kv-layout paged (it "
                         "shards the block pool)")
    if _seq_sharded(mesh) and cfg.kv_layout != "paged":
        raise SystemExit("--mesh serves from the paged layout: a contiguous "
                         "cache sharded over seq is a later slice of the "
                         "port (ROADMAP)")
    kernel = check_kv_quant(cfg)
    cache_len = round_cache_len(
        cfg.prompt_len + cfg.prompt_jitter + cfg.max_new_tokens, mesh)
    tcfg = transformer_config(dataclasses.replace(cfg, seq_len=cache_len))
    params = init_params(tcfg, cfg.seed, dev)
    server = SlotServer(
        params, tcfg, slots=cfg.slots, cache_len=cache_len,
        temperature=cfg.temperature, top_k=cfg.top_k, seed=cfg.seed + 2,
        prefill_chunk=cfg.prefill_chunk, prefill_budget=cfg.prefill_budget,
        slo_ttft=cfg.slo_ttft, slo_tbt=cfg.slo_tbt,
        kv_layout=cfg.kv_layout, kv_block=cfg.kv_block,
        kv_blocks=cfg.kv_blocks, quantize=kernel is not None,
        quant_kernel=kernel or "q8q", mesh=mesh, kv_shard=cfg.kv_shard,
    )
    trace = synthetic_trace(
        cfg.requests, prompt_len=cfg.prompt_len,
        prompt_jitter=cfg.prompt_jitter, max_new_tokens=cfg.max_new_tokens,
        arrival_every=cfg.arrival_every, vocab_size=tcfg.vocab_size,
        seed=cfg.seed + 1,
    )
    report = server.serve(trace)
    log.info("served %d requests on %d slot(s): %.1f tokens/s aggregate",
             len(report.results), cfg.slots, report.tokens_per_sec)
    mesh_rec = {}
    if _seq_sharded(mesh):
        _check_ranks_agree(report, mesh)
        mesh_rec = {**_mesh_record(cfg, mesh, dev),
                    "kv_shard": cfg.kv_shard}
    record = {
        "mode": "serve",
        "device": device_name(dev),
        "slots": cfg.slots,
        "cache_len": cache_len,
        "prefill_chunk": cfg.prefill_chunk,
        "kv_layout": cfg.kv_layout,
        **({"kv_quant": cfg.kv_quant} if kernel else {}),
        **mesh_rec,
        **report.as_dict(),
        "leaks": server.leak_report(),
    }
    return record, server, report


def _check_ranks_agree(report, mesh: Mesh) -> None:
    """Every rank must have served the same tokens: the merged attention
    comes out of an all-reduce, so logits and greedy tokens agree by
    construction — checked here, not assumed, with one MAX all-reduce of
    each rank's digest and its negation."""
    flat = [t for r in report.results for t in [r.uid, *r.tokens, -1]]
    digest = zlib.crc32(",".join(map(str, flat)).encode())
    on = (torch.device("cuda", torch.cuda.current_device())
          if dist.get_backend() == "nccl" else torch.device("cpu"))
    both = torch.tensor([digest, -digest], dtype=torch.int64, device=on)
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=mesh.group(AXIS_SEQ))
    if int(both[0]) != digest or int(-both[1]) != digest:
        raise RuntimeError(
            f"rank {mesh.rank}: the ranks served different tokens (digest "
            f"{digest}, max {int(both[0])}, min {int(-both[1])})")


def main(argv: Optional[list] = None) -> int:
    cfg = parse_args(argv)
    axes = cfg.mesh_axes()
    mesh = None
    created = False
    try:
        if axes is not None:
            # The process group forms before any device work; the rank's
            # device is checked against the backend first.
            try:
                dev, created = initialize_distributed(
                    cfg.resolved_dist_backend(), cfg.device)
                mesh = make_mesh(axes)
            except (RuntimeError, ValueError, NotImplementedError) as e:
                raise SystemExit(f"error: {e}") from None
        rank = mesh.rank if mesh is not None else 0
        setup_logging(getattr(logging, cfg.log_level.upper())
                      if rank == 0 else logging.WARNING,
                      log_file=cfg.log_file)
        if mesh is None:
            try:
                dev = resolve_device(cfg.device)
            except RuntimeError as e:
                raise SystemExit(f"error: {e}") from None
        log.info("device=%s mode=%s%s", device_name(dev), cfg.mode,
                 f" mesh={dict(mesh.shape)}" if mesh is not None else "")
        if mesh is not None and cfg.mode in ("generate", "train") \
                and mesh.size > 1:
            raise SystemExit(
                f"--mode {cfg.mode} on a mesh is a later slice of the port "
                "(ROADMAP): decode and serve run on one")
        if cfg.mode == "decode":
            record = run_decode(cfg, dev, mesh)
        elif cfg.mode == "generate":
            record = run_generate(cfg, dev)
        elif cfg.mode == "train":
            record = run_train(cfg, dev)
        else:
            record, _, _ = run_serve(cfg, dev, mesh)
        if rank == 0:
            print(json.dumps(record))
        return 0
    finally:
        if created:
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
