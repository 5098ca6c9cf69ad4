"""Run configuration: one dataclass, one argparse bridge.

Counterpart of ``tree_attention_tpu/utils/config.py`` for the modes this
port runs (``decode``, ``generate``, ``serve``, ``train``), with the same
flag names and defaults. The defaults reproduce the reference workload: decode over a
64000-token context, 16 heads x 128, B=1, one query. ``--device`` is
``cuda`` (the default) or ``cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass
class RunConfig:
    """Everything a run needs; field defaults == the reference workload."""

    # Problem size.
    batch: int = 1
    seq_len: int = 64000
    q_len: int = 1
    heads: int = 16
    kv_heads: Optional[int] = None  # None -> MHA (kv_heads == heads)
    head_dim: int = 128
    causal: bool = False
    dtype: str = "bfloat16"

    # Execution.
    mode: str = "decode"  # decode | generate | serve | train
    device: str = "cuda"  # cuda | cpu
    impl: str = "auto"    # auto | naive | blockwise | plain
    seed: int = 0
    iters: int = 10
    warmup: int = 2

    # Model (generate / serve).
    model_dim: int = 256
    n_layers: int = 2
    vocab_size: int = 4096
    temperature: float = 0.8
    max_new_tokens: int = 32
    top_k: int = 0

    # Train mode.
    steps: int = 3
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 1
    resume: bool = False

    # Serve mode (continuous batching over a synthetic request trace).
    slots: int = 8
    requests: int = 16
    prompt_len: int = 32
    prompt_jitter: int = 8
    arrival_every: int = 0
    prefill_chunk: int = 256
    prefill_budget: Optional[int] = None
    slo_ttft: float = 1.0
    slo_tbt: float = 0.2
    kv_layout: str = "paged"  # paged | contiguous
    kv_block: Optional[int] = None  # tokens per pool block (pow2; None -> 64)
    kv_blocks: Optional[int] = None  # pool blocks (None -> slots * table)

    # Observability.
    log_level: str = "info"
    log_file: Optional[str] = None

    def resolved_kv_heads(self) -> int:
        return self.heads if self.kv_heads is None else self.kv_heads


def build_arg_parser() -> argparse.ArgumentParser:
    d = RunConfig()
    p = argparse.ArgumentParser(
        prog="tree_attention_tpu_torch",
        allow_abbrev=False,
        description=(
            "PyTorch + CUDA tree attention for NVIDIA Hopper. With no "
            "flags, reproduces the reference workload (decode over a "
            f"{d.seq_len}-token context, {d.heads} heads x {d.head_dim}) on "
            "the GPU."
        ),
    )
    p.add_argument("--mode", choices=["decode", "generate", "serve", "train"],
                   default=d.mode)
    p.add_argument("--device", choices=["cuda", "cpu"], default=d.device,
                   help="cuda (default; fails when no GPU is present) or "
                        "cpu (the kernels' plain versions)")
    p.add_argument("--batch", type=int, default=d.batch)
    p.add_argument("--seq-len", type=int, default=d.seq_len)
    p.add_argument("--q-len", type=int, default=d.q_len)
    p.add_argument("--heads", type=int, default=d.heads)
    p.add_argument("--kv-heads", type=int, default=d.kv_heads,
                   help="GQA KV head count (default: same as --heads)")
    p.add_argument("--head-dim", type=int, default=d.head_dim)
    p.add_argument("--causal", action="store_true", default=d.causal)
    p.add_argument("--dtype", choices=["bfloat16", "float32"],
                   default=d.dtype)
    p.add_argument("--impl", choices=["auto", "naive", "blockwise", "plain"],
                   default=d.impl,
                   help="attention implementation: auto = the CUDA kernels "
                        "on the GPU")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--iters", type=int, default=d.iters)
    p.add_argument("--warmup", type=int, default=d.warmup)
    p.add_argument("--model-dim", type=int, default=d.model_dim)
    p.add_argument("--n-layers", type=int, default=d.n_layers)
    p.add_argument("--vocab-size", type=int, default=d.vocab_size)
    p.add_argument("--temperature", type=float, default=d.temperature,
                   help="generate/serve: sampling temperature (0 = greedy)")
    p.add_argument("--top-k", type=int, default=d.top_k,
                   help="serve: sample from the k highest logits (0 = off)")
    p.add_argument("--max-new-tokens", type=int, default=d.max_new_tokens)
    p.add_argument("--steps", type=int, default=d.steps,
                   help="train-mode steps")
    p.add_argument("--ckpt-dir", default=d.ckpt_dir,
                   help="train: checkpoint directory (enables saving)")
    p.add_argument("--ckpt-every", type=int, default=d.ckpt_every,
                   help="save every N steps")
    p.add_argument("--resume", action="store_true", default=d.resume,
                   help="resume from the latest checkpoint in --ckpt-dir")
    p.add_argument("--slots", type=int, default=d.slots,
                   help="serve: concurrent cache slots")
    p.add_argument("--requests", type=int, default=d.requests,
                   help="serve: synthetic request-trace length")
    p.add_argument("--prompt-len", type=int, default=d.prompt_len)
    p.add_argument("--prompt-jitter", type=int, default=d.prompt_jitter)
    p.add_argument("--arrival-every", type=int, default=d.arrival_every,
                   help="serve: ticks between arrivals (0 = all at start)")
    p.add_argument("--prefill-chunk", type=int, default=d.prefill_chunk,
                   help="serve: max prompt tokens one tick writes per slot")
    p.add_argument("--prefill-budget", type=int, default=d.prefill_budget,
                   help="serve: max prompt tokens per tick over all slots")
    p.add_argument("--slo-ttft", type=float, default=d.slo_ttft,
                   metavar="SEC")
    p.add_argument("--slo-tbt", type=float, default=d.slo_tbt,
                   metavar="SEC")
    p.add_argument("--kv-layout", choices=["paged", "contiguous"],
                   default=d.kv_layout)
    p.add_argument("--kv-block", type=int, default=d.kv_block,
                   help="serve: tokens per KV pool block (power of two; "
                        "default 64)")
    p.add_argument("--kv-blocks", type=int, default=d.kv_blocks,
                   help="serve: total paged pool capacity in blocks")
    p.add_argument("--log-level",
                   choices=["debug", "info", "warning", "error"],
                   default=d.log_level)
    p.add_argument("--log-file", default=d.log_file)
    return p


def parse_args(argv: Optional[Sequence[str]] = None) -> RunConfig:
    ns = build_arg_parser().parse_args(argv)
    return RunConfig(**vars(ns))
