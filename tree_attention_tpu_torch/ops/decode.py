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
A ``tree_mask`` (speculative tree verification, ``Tq <= 32``) always takes
the decode kernels, whatever Tq is: B3 has no mask path.

:func:`paged_local_partial` is one rank's half of the sequence-sharded
pool's decode (``parallel/tree.py:paged_tree_decode`` merges the ranks'
partials): B2 with ``local_blocks`` for every Tq.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tree_attention_tpu_torch import obs
from tree_attention_tpu_torch.ops.block_utils import (
    TREE_MAX_ROWS,
    check_tree_mask,
)
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
                 impl: str = "auto",
                 tree_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
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
      tree_mask: optional ``(B, Tq, Tq)`` bool ancestor mask (``Tq <= 32``,
        a per-slot ``(B,)`` ``q_position``): the query rows are packed
        draft-tree nodes at KV positions ``[q_position[b], q_position[b] +
        Tq)``, and row ``i`` sees window position ``j`` iff
        ``tree_mask[b, i, j]``; everything below the window stays visible,
        nothing past it is (:func:`~.block_utils.tree_window_mask`).

    Returns ``(B, Hq, Tq, D)`` in q's dtype and ``(B, Hq, Tq)`` float32.
    """
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    Tq = q.shape[2]
    if tree_mask is not None:
        check_tree_mask(tree_mask, q.shape[0], Tq, True, TREE_MAX_ROWS)
        if getattr(q_position, "ndim", 0) != 1:
            raise ValueError(
                "tree_mask needs a per-slot (B,) q_position (the window "
                "start is each slot's committed length)")
    paged = block_table is not None
    Tk = block_table.shape[1] * k.shape[2] if paged else k.shape[2]
    if q_position is None:
        if paged:
            # Tk - Tq would expose every table entry, unwritten ones too.
            raise ValueError("paged decode needs an explicit q_position")
        q_position = Tk - Tq
    # Spec-tree chunks are <= 32 rows, the decode kernels' regime; the
    # Q-tiled kernel has no mask path.
    kernel = "decode" if tree_mask is not None else kernel_for(Tq)
    plain = impl == "plain"
    tree_kw = {} if tree_mask is None else {"tree_mask": tree_mask}
    if paged and kernel == "decode":
        _account_dispatch("paged_decode", Tk)
        fn = paged_decode_plain if plain else attention_cuda_decode_paged
        return fn(q, k, v, block_table, q_offset=q_position, scale=scale,
                  **tree_kw)
    if paged:
        # B3 has no table path: one gather, amortised over Tq rows.
        k, v = gather_paged_kv(k, v, block_table)
    _account_dispatch(kernel, Tk)
    if kernel == "decode":
        fn = decode_plain if plain else attention_cuda_decode
    else:
        fn = fwd_plain if plain else attention_cuda_fwd
    return fn(q, k, v, causal=True, scale=scale, q_offset=q_position,
              kv_offset=0, **tree_kw)


def paged_local_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        local_table: torch.Tensor, *, q_position,
                        scale: Optional[float] = None,
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None,
                        impl: str = "auto"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's flash partial over its slice of a sequence-sharded paged
    pool: the per-rank half of the tree-attention decode monoid.

    Args:
      q: ``(B, Hq, Tq, D)``, the same on every rank.
      k, v: ``(Nl, Hkv, block, D)``, this rank's pool slice (``Nl = N/W``).
      local_table: ``(B, NB)`` int32, the slot tables rebased to LOCAL
        block ids: entries in ``[0, Nl)`` name a local block, a negative
        entry a block another rank holds (its keys do not contribute here).
      q_position: per-slot ``(B,)`` global position of each slot's first
        query row; the causal rule is in LOGICAL positions, so the ranks'
        partials merge into exactly the unsharded result.
      k_scale, v_scale: optional ``(Nl, Hkv)`` per-block scales of an int8
        slice (sharded with it).
      impl: ``"auto"`` (the kernel for CUDA tensors) or ``"plain"``.

    On the card this is B2 with ``local_blocks`` for every Tq (prompt
    chunks too: the JAX package also runs its decode kernel for them); an
    int8 slice goes through B2's cast route with ``block_scales``. On the
    CPU, as the JAX package off the TPU: the plain version, and for an
    int8 slice the exact plain version over the slice dequantized under
    its per-block scales (int8 x scale in f32, cast to q's dtype).

    Returns ``(out, lse)``, normalized within the rank; rows with no local
    visible key are ``(0, -inf)``.
    """
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    if getattr(q_position, "ndim", 0) != 1:
        raise ValueError("paged_local_partial needs a per-slot (B,) "
                         "q_position")
    _account_dispatch("paged_local_partial",
                      local_table.shape[1] * k.shape[2])
    fn = paged_decode_plain if impl == "plain" else attention_cuda_decode_paged
    if k_scale is None:
        return fn(q, k, v, local_table, q_offset=q_position, scale=scale,
                  local_blocks=True)
    if q.device.type == "cpu":
        def deq(pool: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
            return (pool.float() * s[:, :, None, None]).to(q.dtype)

        return paged_decode_plain(q, deq(k, k_scale), deq(v, v_scale),
                                  local_table, q_offset=q_position,
                                  scale=scale, local_blocks=True)
    out, lse = fn(q.to(torch.bfloat16), k, v, local_table,
                  q_offset=q_position, scale=scale,
                  block_scales=(k_scale, v_scale), local_blocks=True)
    return out.to(q.dtype), lse
