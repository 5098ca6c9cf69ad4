"""Run configuration: one dataclass, one argparse bridge.

Counterpart of ``tree_attention_tpu/utils/config.py`` for the modes this
port runs (``decode``, ``generate``, ``serve``, ``train``), with the same
flag names and defaults. The defaults reproduce the reference workload: decode over a
64000-token context, 16 heads x 128, B=1, one query. ``--device`` is
``cuda`` (the default) or ``cpu``. ``--mesh seq=W`` runs one process per
rank (``torchrun --nproc-per-node W``) over a ``--dist-backend`` process
group: NCCL by default on the card, gloo on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Optional, Sequence


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """Parse ``"seq=8"`` / ``"data=1,seq=2"`` into an ordered axis map (a
    size of -1 absorbs the ranks left over; see ``parallel.make_mesh``)."""
    axes: Dict[str, int] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        if "=" not in part:
            raise ValueError(f"bad mesh axis {part!r}; want name=size")
        name, _, size = part.partition("=")
        name = name.strip()
        if name in axes:
            raise ValueError(f"duplicate mesh axis {name!r}")
        axes[name] = int(size)
    if not axes:
        raise ValueError(f"empty mesh spec {spec!r}")
    return axes


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
    mesh: Optional[str] = None  # e.g. "seq=2": one process per rank
    dist_backend: Optional[str] = None  # nccl | gloo (None: by --device)
    impl: str = "auto"    # auto | naive | blockwise | plain
    kv_quant: str = "none"  # none | int8 (int8 x int8 q8q) | int8-cast (q8)
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
    kv_shard: str = "replicated"  # replicated | seq (shard the block pool)

    # Observability.
    log_level: str = "info"
    log_file: Optional[str] = None

    def mesh_axes(self) -> Optional[Dict[str, int]]:
        return parse_mesh_spec(self.mesh) if self.mesh else None

    def resolved_dist_backend(self) -> str:
        """``--dist-backend``, else NCCL for ``--device cuda`` and gloo for
        ``--device cpu``."""
        if self.dist_backend is not None:
            return self.dist_backend
        return "nccl" if self.device == "cuda" else "gloo"

    def resolved_kv_heads(self) -> int:
        return self.heads if self.kv_heads is None else self.kv_heads

    def resolved_quant_kernel(self) -> Optional[str]:
        """kv_quant -> q8 route (the one home of that mapping): 'int8' ->
        'q8q' (B4/B5), 'int8-cast' -> 'q8' (the cast route over B1/B2),
        'none' -> None. Programmatic configs bypass argparse's choices, so
        an unknown value raises here."""
        kernels = {"none": None, "int8": "q8q", "int8-cast": "q8"}
        if self.kv_quant not in kernels:
            raise ValueError(
                f"kv_quant must be one of {sorted(kernels)}, "
                f"got {self.kv_quant!r}"
            )
        return kernels[self.kv_quant]


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
    p.add_argument("--mesh", default=d.mesh, metavar="SPEC",
                   help="named mesh axes, e.g. seq=2: one process per rank "
                        "(torchrun --nproc-per-node 2); only seq may exceed "
                        "1. decode: the KV sequence sharded over the ranks "
                        "and merged by the tree all-reduce; serve: with "
                        "--kv-shard seq")
    p.add_argument("--dist-backend", choices=["nccl", "gloo"],
                   default=d.dist_backend,
                   help="process-group backend under --mesh (default: nccl "
                        "for --device cuda, one card per rank; gloo for "
                        "--device cpu). gloo on cuda lets ranks share a "
                        "card")
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
    p.add_argument("--kv-quant", choices=["none", "int8", "int8-cast"],
                   default=d.kv_quant,
                   help="decode: int8-quantize the KV buffer; generate: "
                        "quantize the cache after prefill; serve: serve "
                        "from an int8 cache (per-channel scales; halves the "
                        "KV stream). 'int8' runs the int8 x int8 q8q kernels "
                        "(B4/B5); 'int8-cast' the cast route over B1/B2 "
                        "(minimum int8 error)")
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
    p.add_argument("--kv-shard", choices=["replicated", "seq"],
                   default=d.kv_shard,
                   help="serve: 'seq' shards the paged KV pool over the "
                        "mesh's seq axis — each rank holds blocks/W pool "
                        "rows and decode merges the ranks' partials with "
                        "the tree monoid (one MAX and two SUM all-reduces "
                        "per layer and step); needs --kv-layout paged")
    p.add_argument("--log-level",
                   choices=["debug", "info", "warning", "error"],
                   default=d.log_level)
    p.add_argument("--log-file", default=d.log_file)
    return p


def parse_args(argv: Optional[Sequence[str]] = None) -> RunConfig:
    ns = build_arg_parser().parse_args(argv)
    return RunConfig(**vars(ns))
