"""Synthetic data: random LM batches and attention operands.

Counterpart of ``tree_attention_tpu/data.py``. Batches are drawn from an
explicit ``torch.Generator``, so a batch is a pure function of the
generator's seed; the numbers are not ``jax.random``'s (parity tests hand
both packages the same numpy batch).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from tree_attention_tpu_torch.utils import resolve_device


def make_lm_batch(generator: torch.Generator, batch: int, seq_len: int,
                  vocab_size: int,
                  device: Union[str, torch.device] = "cuda", *,
                  mesh=None) -> Dict[str, torch.Tensor]:
    """Random next-token batch: ``targets`` is ``inputs`` shifted left by
    one, both ``(batch, seq_len)`` int64, drawn on the generator's device
    and placed on ``device``. With a ``mesh`` the sizes must divide over
    its ``data`` and ``seq`` axes; the batch is the GLOBAL one, the same on
    every rank for the same generator seed (the sharded train step takes
    it whole and each rank picks its rows)."""
    if mesh is not None:
        for dim, name, size in (("batch", "data", batch),
                                ("seq_len", "seq", seq_len)):
            if name in mesh.shape and size % mesh.shape[name]:
                raise ValueError(
                    f"{dim}={size} not divisible by mesh axis "
                    f"'{name}'={mesh.shape[name]}")
    tokens = torch.randint(0, vocab_size, (batch, seq_len + 1),
                           generator=generator, device=generator.device)
    tokens = tokens.to(resolve_device(device))
    return {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}


def make_qkv(generator: torch.Generator, *, batch: int = 1, heads: int = 16,
             kv_heads: Optional[int] = None, q_len: int = 1,
             seq_len: int = 64000, head_dim: int = 128,
             dtype: torch.dtype = torch.bfloat16,
             device: Union[str, torch.device] = "cuda"
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Standard-normal ``q (B, H, q_len, D)`` and ``k``, ``v`` ``(B, Hkv,
    seq_len, D)`` for the single-device decode bench; the defaults are the
    reference workload (B=1, 16 heads x 128, 64000 keys, one query)."""
    dev = resolve_device(device)
    kv_heads = heads if kv_heads is None else kv_heads

    def rnd(*shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device).to(dev, dtype)

    return (rnd(batch, heads, q_len, head_dim),
            rnd(batch, kv_heads, seq_len, head_dim),
            rnd(batch, kv_heads, seq_len, head_dim))


def make_qkv_sharded(seed: int, mesh, *, batch: int = 1, heads: int = 16,
                     kv_heads: Optional[int] = None, q_len: int = 1,
                     seq_len: int = 64000, head_dim: int = 128,
                     dtype: torch.dtype = torch.bfloat16,
                     device: Union[str, torch.device] = "cuda"
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """This rank's operands of the sequence-sharded decode bench: ``q``
    ``(B, H, q_len, D)``, the same on every rank (drawn from ``seed``),
    and this rank's KV shard ``(B, Hkv, seq_len / W, D)`` only, drawn from
    a generator seeded from ``(seed, rank)`` — no rank ever makes the whole
    sequence. Unlike the JAX package's ``make_qkv_sharded``, the shards do
    not concatenate to :func:`make_qkv`'s tensors (``torch.Generator`` is
    not threefry, and the JAX package's per-shard fold_in blocks have no
    counterpart here); each shard is standard normal all the same."""
    n = mesh.axis_size("seq")
    if seq_len % n:
        raise ValueError(f"seq_len {seq_len} not divisible by {n} 'seq' "
                         f"shards")
    dev = resolve_device(device)
    kv_heads = heads if kv_heads is None else kv_heads
    rank = mesh.axis_index("seq")
    gq = torch.Generator(device=dev).manual_seed(seed)
    gkv = torch.Generator(device=dev).manual_seed(seed * 1_000_003 + rank + 1)

    def rnd(g, *shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    t_local = seq_len // n
    return (rnd(gq, batch, heads, q_len, head_dim),
            rnd(gkv, batch, kv_heads, t_local, head_dim),
            rnd(gkv, batch, kv_heads, t_local, head_dim))
