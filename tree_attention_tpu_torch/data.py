"""Synthetic data: random LM batches and attention operands.

Counterpart of ``tree_attention_tpu/data.py`` on one device (no mesh).
Batches are drawn from an explicit ``torch.Generator``, so a batch is a pure
function of the generator's seed; the numbers are not ``jax.random``'s
(parity tests hand both packages the same numpy batch).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from tree_attention_tpu_torch.utils import resolve_device


def make_lm_batch(generator: torch.Generator, batch: int, seq_len: int,
                  vocab_size: int,
                  device: Union[str, torch.device] = "cuda"
                  ) -> Dict[str, torch.Tensor]:
    """Random next-token batch: ``targets`` is ``inputs`` shifted left by
    one, both ``(batch, seq_len)`` int64, drawn on the generator's device
    and placed on ``device``."""
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
