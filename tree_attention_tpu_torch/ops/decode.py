"""Causal decode attention of a few new queries against a long KV buffer.

Counterpart of ``tree_attention_tpu/ops/decode.py``. Masking is uniformly
causal-with-offsets: query ``i`` of batch row ``b`` sits at global position
``q_position[b] + i`` and sees keys at positions ``<= q_position[b] + i``, so
a partially filled buffer (or a slot's unwritten table entries) needs no
separate length mask.

Dispatch (``impl="auto"``): query counts below the Q-tile width take the
packed-row decode kernels — B1 on a contiguous buffer, B2 straight through
the block table on a paged pool — and prefill-sized chunks take the Q-tiled
kernel B3, after one gather of a paged pool's logical view. Each kernel
wrapper runs its plain version for CPU tensors. ``impl="plain"`` runs the
plain versions on any device (the comparison path of the on-card checks).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tree_attention_tpu_torch import obs
from tree_attention_tpu_torch.ops.cuda_attention import (
    attention_cuda_fwd,
    fwd_plain,
)
from tree_attention_tpu_torch.ops.cuda_decode import (  # noqa: F401
    attention_cuda_decode,
    attention_cuda_decode_paged,
    decode_plain,
    gather_paged_kv,
    paged_decode_plain,
)
from tree_attention_tpu_torch.ops.tuning import kernel_for

_DECODE_DISPATCH = obs.counter(
    "decode_dispatch_total",
    "flash_decode dispatches by kernel path",
    labels=("path",),
)
_DECODE_KV_TOKENS = obs.counter(
    "decode_dispatch_kv_tokens_total",
    "logical KV tokens each dispatched decode call covers",
    labels=("path",),
)


def _account_dispatch(path: str, kv_tokens: int) -> None:
    if not obs.REGISTRY.enabled:
        return
    _DECODE_DISPATCH.labels(path=path).inc()
    _DECODE_KV_TOKENS.labels(path=path).inc(int(kv_tokens))


def default_num_splits(kv_len: int, block_size: int) -> int:
    """Enough chunks to expose parallelism, never smaller than one block;
    the cap grows by one chunk per 16k tokens beyond 256k."""
    cap = max(16, kv_len // 16384)
    return max(1, min(cap, kv_len // max(block_size, 1)))


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 q_position=None, scale: Optional[float] = None,
                 block_table: Optional[torch.Tensor] = None,
                 impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal decode attention, ``(out, lse)``.

    Args:
      q: ``(B, Hq, Tq, D)``.
      k, v: ``(B, Hkv, Tk, D)`` buffers, or with ``block_table`` ``(N, Hkv,
        block, D)`` pools read through the ``(B, NB)`` int32 table.
      q_position: global position of each row's first query — an int or a
        ``(B,)`` tensor (the ragged batch: slot ``b``'s queries sit at its
        own length). Defaults to ``Tk - Tq``; paged callers must pass it.
      impl: ``"auto"`` (kernels for CUDA tensors, their plain versions for
        CPU tensors) or ``"plain"`` (plain versions on any device).

    Returns ``(B, Hq, Tq, D)`` in q's dtype and ``(B, Hq, Tq)`` float32.
    """
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    Tq = q.shape[2]
    paged = block_table is not None
    Tk = block_table.shape[1] * k.shape[2] if paged else k.shape[2]
    if q_position is None:
        if paged:
            # Tk - Tq would expose every table entry, unwritten ones too.
            raise ValueError("paged decode needs an explicit q_position")
        q_position = Tk - Tq
    kernel = kernel_for(Tq)
    plain = impl == "plain"
    if paged and kernel == "decode":
        _account_dispatch("paged_decode", Tk)
        fn = paged_decode_plain if plain else attention_cuda_decode_paged
        return fn(q, k, v, block_table, q_offset=q_position, scale=scale)
    if paged:
        # B3 has no table path: one gather, amortised over Tq rows.
        k, v = gather_paged_kv(k, v, block_table)
    _account_dispatch(kernel, Tk)
    if kernel == "decode":
        fn = decode_plain if plain else attention_cuda_decode
    else:
        fn = fwd_plain if plain else attention_cuda_fwd
    return fn(q, k, v, causal=True, scale=scale, q_offset=q_position,
              kv_offset=0)
