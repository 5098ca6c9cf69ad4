"""Autoregressive decoding: KV caches, the mixed-Tq step, sampling, generate.

Counterpart of ``tree_attention_tpu/models/decode.py`` (single device):

- :class:`KVCache` — per-layer buffers ``(L, B, Hkv, Tmax, D)`` plus a
  per-slot length vector ``(B,)``.
- :class:`PagedKVCache` — one block pool under every slot plus per-slot
  block tables (PagedAttention, arXiv:2309.06180).
- :func:`forward_step` — ``Tq`` new tokens per slot against the cache: slot
  ``i``'s rows land at ``[length[i], length[i] + n_tokens[i])`` and its
  queries attend causally from ``length[i]``. Mixed-Tq ``n_tokens`` lets
  decode slots (one token) and prefill chunks share one step.

Unlike the JAX package (immutable arrays), the cache buffers are updated IN
PLACE: a step writes its new rows into the cache tensors it was given and
returns a cache object with the advanced lengths over the same buffers.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from tree_attention_tpu_torch import obs
from tree_attention_tpu_torch.models.transformer import (
    Params,
    TransformerConfig,
    _mlp_block,
    heads,
    layer,
    rms_norm,
    rope,
    unheads,
)
from tree_attention_tpu_torch.ops.decode import flash_decode
from tree_attention_tpu_torch.utils import resolve_device

_CACHE_CAPACITY = obs.gauge(
    "kv_cache_capacity_tokens",
    "capacity of the most recently allocated KV cache (tokens)",
)
_STEP_DISPATCH = obs.counter(
    "forward_step_dispatch_total",
    "forward_step calls by cache kind",
    labels=("cache",),
)


@dataclasses.dataclass
class KVCache:
    """Per-layer KV buffers ``(L, B, Hkv, Tmax, D)`` and per-slot lengths."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor  # (B,) int32 — tokens written so far, per slot

    @property
    def capacity(self) -> int:
        return self.k.shape[3]


@dataclasses.dataclass
class PagedKVCache:
    """Paged KV: one block pool, per-slot block tables.

    ``k``/``v`` are ``(L, N + 1, Hkv, block, D)``: pool blocks ``[0, N)``
    plus one DROP block at index ``N`` that absorbs the writes of invalid
    rows (pad rows past a slot's ``n_tokens``, rows past its logical
    capacity) — the JAX scatter drops them with ``mode="drop"``; here they
    land where no table entry ever points. ``table[i, j]`` names the pool
    block holding slot ``i``'s tokens ``[j*block, (j+1)*block)``; unwritten
    entries stay at a valid index (0) and sit past the slot's length, where
    the causal mask hides them and the kernel never reads them.
    """

    k: torch.Tensor      # (L, N + 1, Hkv, block, D)
    v: torch.Tensor
    table: torch.Tensor  # (B, NB) int32
    length: torch.Tensor  # (B,) int32

    @property
    def blocks(self) -> int:
        return self.k.shape[1] - 1

    @property
    def block(self) -> int:
        return self.k.shape[3]

    @property
    def capacity(self) -> int:
        return self.table.shape[1] * self.block

    def pool(self, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layer ``i``'s ``(N, Hkv, block, D)`` K and V pools."""
        n = self.blocks
        return self.k[i, :n], self.v[i, :n]


AnyCache = Union[KVCache, PagedKVCache]


def init_cache(cfg: TransformerConfig, batch_size: int, max_len: int, *,
               device: Union[str, torch.device] = "cuda") -> KVCache:
    """An empty contiguous cache."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch_size, cfg.n_kv_heads, max_len, cfg.d_head)
    if obs.REGISTRY.enabled:
        _CACHE_CAPACITY.set(max_len)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        length=torch.zeros((batch_size,), dtype=torch.int32, device=dev),
    )


def init_paged_cache(cfg: TransformerConfig, batch_size: int, max_len: int,
                     blocks: int, *, block: int = 64,
                     device: Union[str, torch.device] = "cuda"
                     ) -> PagedKVCache:
    """An empty paged cache: a ``blocks``-block pool (plus the drop block)
    and all-zero tables of ``ceil(max_len / block)`` entries per slot."""
    if block < 1 or block & (block - 1):
        raise ValueError(f"kv block must be a power of two, got {block}")
    if blocks < 1:
        raise ValueError(f"paged pool needs >= 1 block, got {blocks}")
    dev = resolve_device(device)
    nb = -(-max_len // block)
    shape = (cfg.n_layers, blocks + 1, cfg.n_kv_heads, block, cfg.d_head)
    if obs.REGISTRY.enabled:
        _CACHE_CAPACITY.set(nb * block)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
        table=torch.zeros((batch_size, nb), dtype=torch.int32, device=dev),
        length=torch.zeros((batch_size,), dtype=torch.int32, device=dev),
    )


def _paged_pool_write(pool: torch.Tensor, rows: torch.Tensor,
                      table: torch.Tensor, start: torch.Tensor,
                      n: torch.Tensor) -> None:
    """Scatter each slot's new rows through its block table, in place.

    ``pool`` is one layer's ``(N + 1, Hkv, block, D)`` buffer, ``rows``
    ``(B, Hkv, Tq, D)``, ``start``/``n`` ``(B,)``. Token ``j`` of slot ``i``
    (valid iff ``j < n[i]`` and inside the slot's logical capacity) lands at
    block ``table[i, (start[i] + j) // block]``, row ``(start[i] + j) %
    block``; invalid rows go to the drop block ``N``. Distinct slots never
    share a writable block, so valid writes never collide."""
    N = pool.shape[0] - 1
    blk = pool.shape[2]
    B, Hkv, Tq, D = rows.shape
    NB = table.shape[1]
    j = torch.arange(Tq, device=rows.device)
    pos = start.long()[:, None] + j[None, :]
    pb = table.long().gather(1, (pos // blk).clamp(0, NB - 1))
    valid = (j[None, :] < n.long()[:, None]) & (pos < NB * blk)
    pb = torch.where(valid, pb, N)
    pool[pb.reshape(-1), :, (pos % blk).reshape(-1)] = (
        rows.transpose(1, 2).reshape(B * Tq, Hkv, D).to(pool.dtype)
    )


def _masked_window_write(buf: torch.Tensor, rows: torch.Tensor,
                         start: torch.Tensor, n: torch.Tensor) -> None:
    """Write ``rows[b, :, :n[b]]`` into ``buf[b]`` at token positions
    ``[start[b], start[b] + n[b])``, in place, leaving every other byte.

    ``buf`` is one layer's ``(B, Hkv, Tmax, D)``, ``rows`` ``(B, Hkv, Tq,
    D)``. The Tq-row window is read at an offset clamped to ``Tmax - Tq``
    (a decode slot near capacity riding a chunk-sized Tq), the valid rows
    are placed at their true positions inside it, and it is written back."""
    B, _, cap, _ = buf.shape
    Tq = rows.shape[2]
    dev = rows.device
    start = start.long()
    ws = start.clamp(0, cap - Tq)
    j = torch.arange(Tq, device=dev)
    src = j[None, :] - (start - ws)[:, None]          # (B, Tq) row index
    keep = (src >= 0) & (src < n.long()[:, None])
    pos = ws[:, None] + j[None, :]
    b = torch.arange(B, device=dev)[:, None]
    window = buf[b, :, pos]                            # (B, Tq, Hkv, D)
    new = rows.transpose(1, 2)[b, src.clamp(0, Tq - 1)]
    buf[b, :, pos] = torch.where(keep[..., None, None], new.to(buf.dtype),
                                 window)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     q_position, block_table: Optional[torch.Tensor] = None,
                     impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Op-level decode entry (single device): split-KV flash decode over a
    contiguous buffer or, with ``block_table``, a paged pool."""
    return flash_decode(q, k, v, q_position=q_position,
                        block_table=block_table, impl=impl)


@torch.no_grad()
def forward_step(params: Params, tokens: torch.Tensor, cache: AnyCache,
                 cfg: TransformerConfig, *,
                 n_tokens: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, AnyCache]:
    """Run ``Tq`` new tokens per slot through the model against the cache.

    ``tokens`` ``(B, Tq)``: row ``i`` occupies positions ``[length[i],
    length[i] + Tq)`` of its own slot. ``n_tokens`` (``(B,)``, optional) is
    the mixed-Tq step: slot ``i`` consumes only its first ``n_tokens[i]``
    rows (0 = inert: nothing written, length frozen); logits rows at
    ``>= n_tokens[i]`` are pad the caller ignores. Callers keep
    ``length + n_tokens <= capacity`` (and ``Tq <= capacity`` for the
    contiguous layout).

    Returns ``logits`` ``(B, Tq, vocab)`` float32 and the cache with
    ``length`` advanced (same buffers, written in place).
    """
    B, Tq = tokens.shape
    start = cache.length
    paged = isinstance(cache, PagedKVCache)
    if not paged and Tq > cache.capacity:
        raise ValueError(
            f"step of Tq={Tq} exceeds cache capacity {cache.capacity}"
        )
    if obs.REGISTRY.enabled:
        _STEP_DISPATCH.labels(cache="paged" if paged else "exact").inc()
    n_valid = (torch.full((B,), Tq, dtype=torch.int32, device=tokens.device)
               if n_tokens is None else n_tokens)
    positions = start.long()[:, None] + torch.arange(Tq, device=tokens.device)
    x = params["embed"][tokens.long()]
    for i in range(cfg.n_layers):
        p = layer(params, i)
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q = rope(heads(h @ p["wq"], cfg.n_heads, cfg.d_head), positions,
                 cfg.rope_theta)
        k_new = rope(heads(h @ p["wk"], cfg.n_kv_heads, cfg.d_head),
                     positions, cfg.rope_theta)
        v_new = heads(h @ p["wv"], cfg.n_kv_heads, cfg.d_head)
        if paged:
            _paged_pool_write(cache.k[i], k_new, cache.table, start, n_valid)
            _paged_pool_write(cache.v[i], v_new, cache.table, start, n_valid)
            k_pool, v_pool = cache.pool(i)
            out, _ = decode_attention(q, k_pool, v_pool, q_position=start,
                                      block_table=cache.table,
                                      impl=cfg.attn_impl)
        else:
            _masked_window_write(cache.k[i], k_new, start, n_valid)
            _masked_window_write(cache.v[i], v_new, start, n_valid)
            out, _ = decode_attention(q, cache.k[i], cache.v[i],
                                      q_position=start, impl=cfg.attn_impl)
        x = x + unheads(out) @ p["wo"]
        x = x + _mlp_block(p, rms_norm(x, p["ln2"], cfg.norm_eps))
    logits = (rms_norm(x, params["ln_f"], cfg.norm_eps) @ params["wout"]).float()
    return logits, dataclasses.replace(cache, length=start + n_valid)


def round_cache_len(total: int) -> int:
    """Cache capacity for ``total`` tokens (one device: no rounding; the JAX
    rule rounds up to the mesh's sequence-shard multiple)."""
    return total


def sample_slots(logits: torch.Tensor, temperature: np.ndarray,
                 top_k: np.ndarray,
                 generators: Sequence[Optional[torch.Generator]],
                 active: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot sampling for the serving tick: exact argmax where a slot's
    temperature is 0 (token-identical to the greedy path), temperature /
    top-k categorical from the slot's own ``torch.Generator`` where it is
    positive. Only ``active`` sampled slots draw, so a request's random
    stream depends on its own emitted tokens only, never on which other
    slots share the tick. ``jax.random`` streams are not reproduced: sampled
    parity with the JAX engine is distributional.

    Args:
      logits: ``(S, V)`` last-row logits.
      temperature, top_k: ``(S,)`` host arrays (0 = greedy / top-k off).
      generators: one generator per slot (used where it samples).
      active: ``(S,)`` host bool — slots whose sample is kept this tick.

    Returns ``(tok, logprob)``: ``(S,)`` int32 ids and the float32 model
    log-probabilities of the chosen tokens (unadjusted by temperature).
    """
    lf = logits.float()
    tok = lf.argmax(-1)
    V = lf.shape[-1]
    for i in np.flatnonzero(np.asarray(active) & (temperature > 0)):
        lg = lf[i]
        k = int(top_k[i])
        if k > 0:
            thresh = torch.topk(lg, min(k, V)).values[-1]
            lg = lg.masked_fill(lg < thresh, float("-inf"))
        probs = torch.softmax(lg / float(temperature[i]), -1)
        tok[i] = torch.multinomial(probs, 1, generator=generators[i])[0]
    lp = F.log_softmax(lf, -1).gather(1, tok[:, None])[:, 0]
    return tok.int(), lp


def _sample(logits: torch.Tensor, temperature: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    if temperature == 0.0:
        return logits.argmax(-1)
    probs = torch.softmax(logits.float() / temperature, -1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(params: Params, prompt: torch.Tensor, max_new_tokens: int,
             cfg: TransformerConfig, *, cache_len: Optional[int] = None,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Prefill ``prompt`` ``(B, Tp)`` then decode ``max_new_tokens``
    (greedy at temperature 0). Returns ``(B, max_new_tokens)`` ids."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    B, Tp = prompt.shape
    total = Tp + max_new_tokens
    cache_len = round_cache_len(total) if cache_len is None else cache_len
    if cache_len < total:
        raise ValueError(f"cache_len={cache_len} < prompt+new={total}")
    cache = init_cache(cfg, B, cache_len, device=prompt.device)
    logits, cache = forward_step(params, prompt, cache, cfg)
    toks: List[torch.Tensor] = [_sample(logits[:, -1], temperature,
                                        generator)]
    for _ in range(max_new_tokens - 1):
        logits, cache = forward_step(params, toks[-1][:, None], cache, cfg)
        toks.append(_sample(logits[:, -1], temperature, generator))
    return torch.stack(toks, 1).int()
