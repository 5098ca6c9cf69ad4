"""Shared blocking and masking rules of the attention ops.

Counterpart of ``tree_attention_tpu/ops/block_utils.py``: the ONE
causal-with-offsets rule (a query at global position ``q_offset + i`` sees a
key at ``kv_offset + j`` iff ``q_offset + i >= kv_offset + j``), the
ragged-tail rule (keys past ``tk`` are invisible), and the per-batch offset
operand the kernels read.
"""

from __future__ import annotations

from typing import Union

import torch

NEG_INF = float("-inf")

Offset = Union[int, torch.Tensor]


def pad_to_block(x: torch.Tensor, dim: int, block: int) -> torch.Tensor:
    """Zero-pad ``dim`` up to a multiple of ``block``."""
    pad = (-x.shape[dim]) % block
    if not pad:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def tile_live(qi: int, ki: int, block_q: int, block_k: int, q_offset: Offset,
              kv_offset: Offset, causal: bool):
    """Whether a (Q-tile, KV-tile) pair has any visible entry under
    causality: live iff the most-visible corner (last row, first column) is
    unmasked."""
    if not causal:
        return True
    return (q_offset + qi * block_q + block_q - 1) >= (kv_offset + ki * block_k)


def tile_mask(tq: int, blk: int, blk_idx: int, tk: int, q_offset: Offset,
              kv_offset: Offset, causal: bool,
              device: torch.device) -> torch.Tensor:
    """``(tq, blk)`` visibility of one KV tile: the ragged-tail check plus
    cross-shard causality (scalar offsets)."""
    col = blk_idx * blk + torch.arange(blk, device=device)[None, :]
    valid = (col < tk).expand(tq, blk)
    if causal:
        row = q_offset + torch.arange(tq, device=device)[:, None]
        valid = valid & (row >= kv_offset + col)
    return valid


def offsets(q_offset: Offset, kv_offset: Offset, batch: int,
            device: torch.device) -> torch.Tensor:
    """``(2, B)`` int32 per-batch ``[q_offset | kv_offset]`` rows: scalars
    broadcast to every batch row, a ``(B,)`` tensor gives each row (cache
    slot) its own position — the ragged-batch operand every kernel reads."""

    def row(x: Offset) -> torch.Tensor:
        t = torch.as_tensor(x, dtype=torch.int32, device=device)
        return t.expand(batch)

    return torch.stack([row(q_offset), row(kv_offset)])
