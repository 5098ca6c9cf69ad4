"""Command line: ``python -m tree_attention_tpu_torch``.

Counterpart of ``tree_attention_tpu/cli.py`` for three modes, each printing
one JSON record on stdout:

    python -m tree_attention_tpu_torch                  # reference workload
    python -m tree_attention_tpu_torch --mode generate --q-len 16
    python -m tree_attention_tpu_torch --mode serve --model-dim 2048 ...

``decode`` times one attention step over a ``--seq-len`` KV cache (64000
tokens, 16 heads x 128, one query by default) with CUDA events; ``generate``
prefills a random prompt and decodes; ``serve`` drains a synthetic request
trace through the continuous-batching :class:`SlotServer`. Everything runs
on the GPU unless ``--device cpu`` is given; with no usable GPU the CLI
exits with an error instead of falling back.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import statistics
import sys
import time
from typing import Any, Dict, Optional, Tuple

import torch

from tree_attention_tpu_torch.utils import resolve_device
from tree_attention_tpu_torch.utils.config import RunConfig, parse_args
from tree_attention_tpu_torch.utils.logging import get_logger, setup_logging

log = get_logger("cli")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def time_calls(fn, *, iters: int, warmup: int,
               dev: torch.device) -> Dict[str, Any]:
    """Per-call seconds of ``fn()``: CUDA events around each call on the
    GPU (device time), the host clock on the CPU."""
    for _ in range(max(warmup, 0)):
        fn()
    times = []
    for _ in range(max(iters, 1)):
        if dev.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return {
        "clock": "cuda_events" if dev.type == "cuda" else "host",
        "median_s": statistics.median(times),
        "min_s": min(times),
        "iters": len(times),
    }


def run_decode(cfg: RunConfig, dev: torch.device) -> Dict[str, Any]:
    """The reference workload: one attention step over a KV cache, timed."""
    from tree_attention_tpu_torch.ops import flash_attention

    dtype = _DTYPES[cfg.dtype]
    g = torch.Generator(device=dev).manual_seed(cfg.seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    hkv = cfg.resolved_kv_heads()
    q = rnd(cfg.batch, cfg.heads, cfg.q_len, cfg.head_dim)
    k = rnd(cfg.batch, hkv, cfg.seq_len, cfg.head_dim)
    v = rnd(cfg.batch, hkv, cfg.seq_len, cfg.head_dim)
    stats = time_calls(
        lambda: flash_attention(q, k, v, causal=cfg.causal, impl=cfg.impl),
        iters=cfg.iters, warmup=cfg.warmup, dev=dev,
    )
    flops = 4.0 * cfg.batch * cfg.heads * cfg.q_len * cfg.seq_len \
        * cfg.head_dim
    log.info("decode: %d KV tokens, %d heads x %d, %s on %s: median %.6fs",
             cfg.seq_len, cfg.heads, cfg.head_dim, cfg.dtype,
             device_name(dev), stats["median_s"])
    return {
        "name": "decode",
        "workload": {
            "batch": cfg.batch, "heads": cfg.heads, "kv_heads": hkv,
            "head_dim": cfg.head_dim, "seq_len": cfg.seq_len,
            "q_len": cfg.q_len, "dtype": cfg.dtype, "causal": cfg.causal,
            "impl": cfg.impl,
        },
        "device": device_name(dev),
        "tokens_per_sec": round(cfg.batch * cfg.seq_len / stats["median_s"], 1),
        "flops_per_sec": flops / stats["median_s"],
        **stats,
    }


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


def run_generate(cfg: RunConfig, dev: torch.device) -> Dict[str, Any]:
    from tree_attention_tpu_torch.models import generate, init_params

    if cfg.temperature < 0:
        raise SystemExit("--temperature must be >= 0 (0 = greedy)")
    if cfg.max_new_tokens < 1:
        raise SystemExit("--max-new-tokens must be >= 1")
    tcfg = transformer_config(cfg)
    params = init_params(tcfg, cfg.seed, dev)
    g = torch.Generator().manual_seed(cfg.seed + 1)
    prompt = torch.randint(0, tcfg.vocab_size, (cfg.batch, max(cfg.q_len, 1)),
                           generator=g).to(dev)
    toks = generate(params, prompt, cfg.max_new_tokens, tcfg,
                    temperature=cfg.temperature,
                    generator=torch.Generator(device=dev).manual_seed(
                        cfg.seed + 2))
    log.info("generated %s tokens from a %s prompt", tuple(toks.shape),
             tuple(prompt.shape))
    return {"mode": "generate", "device": device_name(dev),
            "tokens": toks.tolist()}


def run_serve(cfg: RunConfig, dev: torch.device
              ) -> Tuple[Dict[str, Any], Any]:
    """Drain a synthetic trace through the SlotServer; returns the JSON
    record and the drained server."""
    from tree_attention_tpu_torch.models import init_params
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
    cache_len = cfg.prompt_len + cfg.prompt_jitter + cfg.max_new_tokens
    tcfg = transformer_config(dataclasses.replace(cfg, seq_len=cache_len))
    params = init_params(tcfg, cfg.seed, dev)
    server = SlotServer(
        params, tcfg, slots=cfg.slots, cache_len=cache_len,
        temperature=cfg.temperature, top_k=cfg.top_k, seed=cfg.seed + 2,
        prefill_chunk=cfg.prefill_chunk, prefill_budget=cfg.prefill_budget,
        slo_ttft=cfg.slo_ttft, slo_tbt=cfg.slo_tbt,
        kv_layout=cfg.kv_layout, kv_block=cfg.kv_block,
        kv_blocks=cfg.kv_blocks,
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
    record = {
        "mode": "serve",
        "device": device_name(dev),
        "slots": cfg.slots,
        "cache_len": cache_len,
        "prefill_chunk": cfg.prefill_chunk,
        "kv_layout": cfg.kv_layout,
        **report.as_dict(),
        "leaks": server.leak_report(),
    }
    return record, server


def main(argv: Optional[list] = None) -> int:
    cfg = parse_args(argv)
    setup_logging(getattr(logging, cfg.log_level.upper()),
                  log_file=cfg.log_file)
    try:
        dev = resolve_device(cfg.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}") from None
    log.info("device=%s mode=%s", device_name(dev), cfg.mode)
    if cfg.mode == "decode":
        record = run_decode(cfg, dev)
    elif cfg.mode == "generate":
        record = run_generate(cfg, dev)
    else:
        record, _ = run_serve(cfg, dev)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
