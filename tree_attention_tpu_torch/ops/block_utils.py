"""Shared blocking and masking rules of the attention ops.

Counterpart of ``tree_attention_tpu/ops/block_utils.py``: the ONE
causal-with-offsets rule (a query at global position ``q_offset + i`` sees a
key at ``kv_offset + j`` iff ``q_offset + i >= kv_offset + j``), the
ragged-tail rule (keys past ``tk`` are invisible), the per-batch offset
operand the kernels read, and the tree-window rule of speculative tree
verification (:func:`tree_window_mask`).
"""

from __future__ import annotations

from typing import Optional, Union

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


def last_live_k(qi: int, block_q: int, block_k: int, q_offset: int,
                kv_offset: int, n_k: int) -> int:
    """Last KV tile a dQ tile (kernel B6) needs under causality: the tile of
    the key at its last row's frontier, ``(q_offset - kv_offset + qi*bq +
    bq - 1) // bk``, clamped to ``[0, n_k - 1]`` (a Q tile that sees no key
    clamps to 0; its tiles are dead either way). Integer counterpart of the
    JAX package's ``causal_last_live_k``. B6 computes the same frontier
    inline (``csrc/flash_bwd.cu``); this form states the rule and is held
    against JAX's in ``tests/test_torch_vjp.py``."""
    hi = (q_offset - kv_offset + qi * block_q + block_q - 1) // block_k
    return min(max(hi, 0), n_k - 1)


def first_live_q(ki: int, block_q: int, block_k: int, q_offset: int,
                 kv_offset: int, n_q: int) -> int:
    """First Q tile a dK/dV tile (kernel B7) needs under causality: the tile
    holding row ``kv_offset + ki*bk - q_offset``, the first that sees the KV
    tile's first key, clamped to ``[0, n_q - 1]``. Integer counterpart of
    the JAX package's ``causal_first_live_q``."""
    lo = -((q_offset + block_q - 1 - kv_offset - ki * block_k) // block_q)
    return min(max(lo, 0), n_q - 1)


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


# Ancestor sets pack into one int32 word per query row (bit j = window row
# j), so a tree mask covers at most 32 query rows.
TREE_MAX_ROWS = 32


def check_tree_mask(tree_mask: torch.Tensor, batch: int, tq: int,
                    causal: bool, max_rows: Optional[int] = None) -> None:
    """Validate a ``(B, Tq, Tq)`` tree mask, with the JAX package's
    messages: it needs ``causal`` and, where ``max_rows`` is given (the
    kernels' int32 bitmasks), ``Tq <= max_rows``."""
    if not causal:
        raise ValueError("tree_mask requires causal=True")
    if max_rows is not None and tq > max_rows:
        raise ValueError(
            f"tree_mask packs into int32 bitmasks: Tq={tq} exceeds "
            f"{max_rows}")
    if tuple(tree_mask.shape) != (batch, tq, tq):
        raise ValueError(
            f"tree_mask must be (B, Tq, Tq) = {(batch, tq, tq)}, got "
            f"{tuple(tree_mask.shape)}")


def tree_window_mask(tree_mask: torch.Tensor, q_offset: torch.Tensor,
                     kv_offset: torch.Tensor, tk: int) -> torch.Tensor:
    """``(B, Tq, Tk)`` visibility under the tree-window rule (SpecInfer,
    arXiv:2305.09781): slot ``b``'s Tq query rows occupy KV positions
    ``[q_offset[b], q_offset[b] + Tq)``, and row ``i`` sees the key at
    ``p = kv_offset[b] + j`` iff ``p < q_offset[b]`` (committed history) or
    ``0 <= p - q_offset[b] < Tq`` and ``tree_mask[b, i, p - q_offset[b]]``
    (an ancestor of ``i``, or ``i`` itself); nothing past the window. A
    lower-triangular mask is the causal rule. Offsets are ``(B,)``."""
    B, tq, _ = tree_mask.shape
    rel = (kv_offset.long()[:, None] - q_offset.long()[:, None]
           + torch.arange(tk, device=tree_mask.device))          # (B, Tk)
    taken = tree_mask.bool().gather(
        2, rel.clamp(0, tq - 1)[:, None, :].expand(B, tq, tk))
    rel = rel[:, None, :]
    return (rel < 0) | ((rel < tq) & taken)
