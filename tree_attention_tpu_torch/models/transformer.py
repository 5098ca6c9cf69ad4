"""Decoder-only transformer LM over the port's attention ops.

Counterpart of ``tree_attention_tpu/models/transformer.py``: a Llama-style
LM (RMSNorm, rotary embeddings, SwiGLU, grouped-query attention) written as
plain functions over a parameter dictionary with the JAX package's layout —
per-layer weights stacked on a leading ``n_layers`` axis — so
:func:`params_from_jax` is a dtype-preserving copy and both packages compute
the same thing. Norms, RoPE and the softmax run in float32; weights and
activations in ``cfg.dtype``. :func:`forward` is differentiable (training
goes through :func:`loss_fn`); serving callers wrap it in ``no_grad``.

Under a mesh whose ``seq`` axis is larger than 1 (one process per rank),
:func:`forward` and :func:`loss_fn` take the GLOBAL batch on every rank and
compute this rank's ``T / W`` rows (``cfg.seq_layout``: contiguous, or the
causally balanced zigzag), each layer's attention through
:func:`~tree_attention_tpu_torch.parallel.tree.tree_attention`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tree_attention_tpu_torch.ops import flash_attention
from tree_attention_tpu_torch.parallel.mesh import Mesh, seq_sharded
from tree_attention_tpu_torch.parallel.tree import (
    SEQ_LAYOUTS,
    local_positions,
    tree_attention,
)
from tree_attention_tpu_torch.utils import resolve_device

Params = Dict[str, Any]
LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w3", "w2")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Static architecture hyperparameters (the JAX config's fields that
    this slice's paths read)."""

    vocab_size: int = 32768
    d_model: int = 512
    n_layers: int = 6
    n_heads: int = 8
    n_kv_heads: int = 8          # < n_heads for GQA/MQA
    d_head: int = 64
    d_ff: int = 1408
    max_seq_len: int = 65536
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "auto"      # "auto" (kernels) | "plain" (their plain
    #                              versions on any device)
    remat: bool = True           # recompute each layer body in the backward
    seq_layout: str = "contiguous"  # contiguous | zigzag (mesh seq > 1)

    def __post_init__(self):
        if self.attn_impl not in ("auto", "plain"):
            raise ValueError(
                f"attn_impl must be 'auto' or 'plain', got {self.attn_impl!r}"
            )
        if self.seq_layout not in SEQ_LAYOUTS:
            raise ValueError(f"seq_layout must be one of {SEQ_LAYOUTS}, got "
                             f"{self.seq_layout!r}")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_heads ({self.n_heads}) must be a multiple of "
                f"n_kv_heads ({self.n_kv_heads})"
            )

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head


def _to_torch(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a)  # a writable copy (JAX exports read-only buffers)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree: Mapping[str, Any],
                    device: Union[str, torch.device] = "cuda") -> Params:
    """The port's parameters from the JAX ``init_params`` pytree given as
    numpy arrays (same keys, stacked ``(L, ...)`` layer weights, same
    dtypes)."""
    dev = resolve_device(device)
    return {
        "embed": _to_torch(tree["embed"], dev),
        "layers": {k: _to_torch(tree["layers"][k], dev) for k in LAYER_KEYS},
        "ln_f": _to_torch(tree["ln_f"], dev),
        "wout": _to_torch(tree["wout"], dev),
    }


def init_params(cfg: TransformerConfig, seed: int = 0,
                device: Union[str, torch.device] = "cuda") -> Params:
    """Random parameters from a numpy seed, with the JAX initialiser's
    scales (std 0.02; residual projections ``wo``/``w2`` scaled by
    ``(2 L)^-1/2``). Not the JAX values — ``jax.random`` is not reproduced;
    use :func:`params_from_jax` for parity."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    L, D = cfg.n_layers, cfg.d_model
    std = 0.02
    res_std = std / (2 * L) ** 0.5

    def normal(shape, stddev):
        a = rng.standard_normal(shape, dtype=np.float32) * np.float32(stddev)
        return torch.from_numpy(a).to(dev, cfg.dtype)

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    layers = {
        "ln1": ones((L, D)),
        "wq": normal((L, D, cfg.q_dim), std),
        "wk": normal((L, D, cfg.kv_dim), std),
        "wv": normal((L, D, cfg.kv_dim), std),
        "wo": normal((L, cfg.q_dim, D), res_std),
        "ln2": ones((L, D)),
        "w1": normal((L, D, cfg.d_ff), std),
        "w3": normal((L, D, cfg.d_ff), std),
        "w2": normal((L, cfg.d_ff, D), res_std),
    }
    return {
        "embed": normal((cfg.vocab_size, D), std),
        "layers": layers,
        "ln_f": ones((D,)),
        "wout": normal((D, cfg.vocab_size), std),
    }


def named_params(params: Params) -> List[Tuple[str, torch.Tensor]]:
    """Every parameter tensor with a dotted name, in a fixed order (the
    optimizer's and the checkpoint's)."""
    return ([("embed", params["embed"])]
            + [(f"layers.{k}", params["layers"][k]) for k in LAYER_KEYS]
            + [("ln_f", params["ln_f"]), ("wout", params["wout"])])


def count_params(params: Params) -> int:
    return sum(t.numel() for _, t in named_params(params))


def layer(params: Params, i: int) -> Params:
    """Layer ``i``'s weights (views into the stacked tensors)."""
    return {k: v[i] for k, v in params["layers"].items()}


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * rms * w).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding on ``(B, H, T, D)``; ``positions`` is ``(T,)``
    shared across the batch or ``(B, T)`` per row (the ragged decode
    shape). Math in float32."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions.float()[..., None] * freqs  # (..., T, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    if angles.ndim == 3:  # (B, T, half): broadcast over heads
        cos, sin = cos[:, None], sin[:, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def heads(x: torch.Tensor, n_heads: int, d_head: int) -> torch.Tensor:
    """(B, T, H*D) -> (B, H, T, D)."""
    B, T, _ = x.shape
    return x.reshape(B, T, n_heads, d_head).transpose(1, 2)


def unheads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, D) -> (B, T, H*D)."""
    B, H, T, D = x.shape
    return x.transpose(1, 2).reshape(B, T, H * D)


def local_rows(t: int, mesh: Mesh, cfg: TransformerConfig,
               device: torch.device) -> torch.Tensor:
    """The natural positions of this rank's rows of a length-``t``
    sequence under ``cfg.seq_layout`` (int64, on ``device``)."""
    return torch.from_numpy(local_positions(t, mesh, cfg.seq_layout)).to(
        device)


def _attention_block(p: Params, x: torch.Tensor, positions: torch.Tensor,
                     cfg: TransformerConfig,
                     mesh: Optional[Mesh] = None) -> torch.Tensor:
    q = rope(heads(x @ p["wq"], cfg.n_heads, cfg.d_head), positions,
             cfg.rope_theta)
    k = rope(heads(x @ p["wk"], cfg.n_kv_heads, cfg.d_head), positions,
             cfg.rope_theta)
    v = heads(x @ p["wv"], cfg.n_kv_heads, cfg.d_head)
    if seq_sharded(mesh):
        out, _ = tree_attention(q, k, v, mesh=mesh, causal=True,
                                impl=cfg.attn_impl, layout=cfg.seq_layout)
    else:
        out, _ = flash_attention(q, k, v, causal=True, impl=cfg.attn_impl)
    return unheads(out) @ p["wo"]


def _mlp_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]


def _layer_body(x: torch.Tensor, p: Params, positions: torch.Tensor,
                cfg: TransformerConfig,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    x = x + _attention_block(p, rms_norm(x, p["ln1"], cfg.norm_eps),
                             positions, cfg, mesh)
    return x + _mlp_block(p, rms_norm(x, p["ln2"], cfg.norm_eps))


def forward(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
            *, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Token ids ``(B, T)`` -> logits ``(B, T, vocab)`` float32. Under grad
    mode with ``cfg.remat``, each layer body is checkpointed: its
    activations are recomputed in the backward (attention's forward kernel
    runs twice per layer and step), as JAX's ``jax.checkpoint``.

    With a ``mesh`` that shards ``seq``: ``tokens`` is the global batch
    (the same on every rank) and the result this rank's ``(B, T/W,
    vocab)`` logits, its rows in :func:`local_rows` order, each at its
    natural position (RoPE reads it). Under remat the backward recomputes
    each layer's tree-attention collectives too, in the same order on
    every rank."""
    T = tokens.shape[1]
    if T > cfg.max_seq_len:
        raise ValueError(
            f"sequence length {T} exceeds max_seq_len={cfg.max_seq_len}"
        )
    if seq_sharded(mesh):
        positions = local_rows(T, mesh, cfg, tokens.device)
        tokens = tokens[:, positions]
    else:
        mesh = None
        positions = torch.arange(T, device=tokens.device)
    x = params["embed"][tokens.long()]
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        p = layer(params, i)
        if remat:
            x = checkpoint(_layer_body, x, p, positions, cfg, mesh,
                           use_reentrant=False)
        else:
            x = _layer_body(x, p, positions, cfg, mesh)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return (x @ params["wout"]).float()


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token next-token negative log-likelihood in float32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    return logz - logits.gather(-1, targets.long()[..., None])[..., 0]


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy in float32. ``targets``/``mask``:
    ``(B, T)``."""
    nll = token_nll(logits, targets)
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def loss_fn(params: Params, batch: Mapping[str, torch.Tensor],
            cfg: TransformerConfig, *,
            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Batch = ``{"inputs": (B, T) ids, "targets": (B, T) ids, optional
    "mask"}``, targets pre-shifted at the data layer (contiguous layout).

    With a ``mesh`` that shards ``seq`` (the global batch on every rank):
    this rank's NLL sum over its rows divided by the GLOBAL token (or
    mask) count, so that the ranks' losses SUM to the global mean."""
    logits = forward(params, batch["inputs"], cfg, mesh=mesh)
    targets, mask = batch["targets"], batch.get("mask")
    if not seq_sharded(mesh):
        return cross_entropy_loss(logits, targets, mask)
    rows = local_rows(targets.shape[1], mesh, cfg, targets.device)
    nll = token_nll(logits, targets[:, rows])
    if mask is None:
        return nll.sum() / targets.numel()
    mask = mask.float()
    return (nll * mask[:, rows]).sum() / mask.sum().clamp_min(1.0)
