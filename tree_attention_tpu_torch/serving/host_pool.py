"""Host-RAM block tier under the device KV pool (KV tiering).

Counterpart of ``tree_attention_tpu/serving/host_pool.py``. The device pool
caps how much prefix the radix tree can retain: its LRU eviction frees
refcount-0 blocks, so every evicted prefix is a future cold prefill. This
module turns that eviction into **demotion** (the hierarchical cache of
SGLang, extending RadixAttention, arXiv:2312.07104): an evicted block parks
in a preallocated pool of host rows, its radix node survives with its
``tier`` set to host, and a later prefix hit **restores** the path with one
batched H2D copy and scatter into freshly allocated device blocks.

A block's journey:

- **Demote (staged)**: the tree picks its LRU victim and calls
  :meth:`HostBlockPool.enqueue` — the device block enters the allocator's
  ``demoted`` state (not reusable yet) and a (host row <- device block)
  pair joins the pending queue. No device work happens here.
- **Flush**: the engine drains the queue at the end of a tick — one gather
  of the batch on the device, then :meth:`commit` copies it into the
  pinned rows with ``non_blocking=True`` on the current stream — and the
  device blocks free (:meth:`BlockAllocator.free_demoted`). Every later
  write to a freed block is a kernel on the same stream, so it runs after
  the copy has read the block. A dry allocator can force a flush mid-tick.
- **Restore**: a hit on a demoted node either *cancels* a still-pending
  demotion (the device bytes never left: zero copies) or takes a fresh
  device block from the admission's reservation and rides one batched H2D
  copy for the whole path. Restore copies bytes; it recomputes nothing.
- **Drop**: a full host pool evicts its own LRU refcount-0 leaf, and the
  node leaves the tree as in a classic eviction.

The rows live in page-locked host memory when the engine serves on a GPU
(``pin_memory=True``; a failed pin raises), so both copies are DMA
transfers that do not stage through a bounce buffer. :meth:`read`, the one
place the host reads the rows, first waits for the last flush's copy to
land. int8 pools carry their per-block scales ``(L, Hkv)`` beside the
bytes, so a restored block dequantizes as it did before demotion.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from tree_attention_tpu_torch import obs
from tree_attention_tpu_torch.utils.logging import get_logger

log = get_logger("serving.host_pool")

_HOST_USED = obs.gauge(
    "serving_kv_host_blocks_used",
    "host-tier KV blocks currently holding a demoted span",
)
_DEMOTIONS = obs.counter(
    "serving_kv_demotions_total",
    "device KV blocks demoted toward the host tier (counted at enqueue)",
)
_RESTORES = obs.counter(
    "serving_kv_restores_total",
    "demoted KV blocks restored to the device tier (H2D copies and "
    "cancelled-pending restores both count — each was a device-capacity "
    "miss the host tier absorbed)",
)


def _runs(rows: List[int]) -> List[Tuple[int, int, int]]:
    """Split ascending ``rows`` into maximal runs of consecutive rows:
    ``(first_index, first_row, length)`` triples."""
    out: List[Tuple[int, int, int]] = []
    for i, r in enumerate(rows):
        if out and r == out[-1][1] + out[-1][2]:
            j, r0, m = out[-1]
            out[-1] = (j, r0, m + 1)
        else:
            out.append((i, r, 1))
    return out


class HostBlockPool:
    """A fixed pool of ``blocks`` host-RAM KV blocks and the staging queue.

    Args:
      blocks: host-tier capacity in blocks (``--host-blocks``).
      n_layers / n_kv_heads / block / d_head: the block geometry, the
        device pool's.
      dtype: the device pool's dtype (``torch.int8`` under quantized
        serving, the model dtype otherwise).
      quantized: also carry per-block scales ``(L, Hkv)`` for K and V.
      pin_memory: page-lock the rows (the engine's choice on a GPU).

    Single-threaded: every method runs on the engine loop's thread. The
    device gather and scatter are the caller's; this class owns the host
    bytes, the two copies and the pending bookkeeping.
    """

    def __init__(
        self,
        blocks: int,
        *,
        n_layers: int,
        n_kv_heads: int,
        block: int,
        d_head: int,
        dtype: torch.dtype,
        quantized: bool = False,
        pin_memory: bool = False,
    ):
        if blocks < 1:
            raise ValueError(f"host pool needs >= 1 block, got {blocks}")
        self.blocks = blocks
        self.block = block
        self.pinned = bool(pin_memory)
        shape = (blocks, n_layers, n_kv_heads, block, d_head)
        self.k = torch.zeros(shape, dtype=dtype, pin_memory=self.pinned)
        self.v = torch.zeros(shape, dtype=dtype, pin_memory=self.pinned)
        self.quantized = quantized
        if quantized:
            sshape = (blocks, n_layers, n_kv_heads)
            self.k_scale = torch.ones(sshape, dtype=torch.float32,
                                      pin_memory=self.pinned)
            self.v_scale = torch.ones(sshape, dtype=torch.float32,
                                      pin_memory=self.pinned)
        if self.pinned and not all(t.is_pinned() for t in self._parts()):
            raise RuntimeError("host KV tier: pinned allocation failed")
        self._free: List[int] = list(range(blocks - 1, -1, -1))
        # host row -> device block id, for demotions whose D2H copy has
        # not been issued yet (their canonical bytes are on the device).
        self.pending: Dict[int, int] = {}
        # The event recorded after the last flush's copies: the host reads
        # no row before it has completed (None: nothing in flight).
        self._landed: Optional[torch.cuda.Event] = None
        # Lifetime accounting (the engine snapshots and diffs per run).
        self.demotions = 0
        self.restores = 0
        self.drops = 0

    def _parts(self) -> List[torch.Tensor]:
        return [self.k, self.v] + ([self.k_scale, self.v_scale]
                                   if self.quantized else [])

    @property
    def nbytes(self) -> int:
        """Host bytes of the tier (rows and scales)."""
        return sum(t.numel() * t.element_size() for t in self._parts())

    # -- introspection ----------------------------------------------------

    @property
    def used(self) -> int:
        return self.blocks - len(self._free)

    @property
    def free_count(self) -> int:
        return len(self._free)

    def publish_gauge(self) -> None:
        if obs.REGISTRY.enabled:
            _HOST_USED.set(self.used)

    # -- demote side ------------------------------------------------------

    def alloc(self) -> Optional[int]:
        """One free host row, or None when the tier is full (the radix
        index then drops its host-LRU leaf and retries)."""
        if not self._free:
            return None
        return self._free.pop()

    def enqueue(self, row: int, device_bid: int) -> None:
        """Stage one demotion: host ``row`` receives device block
        ``device_bid`` at the next flush. The device block must already be
        in the allocator's ``demoted`` state."""
        assert row not in self.pending, f"host row {row} double-staged"
        self.pending[row] = device_bid
        self.demotions += 1
        if obs.REGISTRY.enabled:
            _DEMOTIONS.inc()
            _HOST_USED.set(self.used)

    def take_pending(self) -> List[Tuple[int, int]]:
        """Drain the staging queue for one flush: ``(host_row,
        device_bid)`` pairs in ascending row order. The caller owns the
        gather and the ``free_demoted`` calls; the rows stay allocated."""
        items = sorted(self.pending.items())
        self.pending.clear()
        return items

    def commit(
        self,
        rows: List[int],
        k_rows: torch.Tensor,
        v_rows: torch.Tensor,
        k_scale: Optional[torch.Tensor] = None,
        v_scale: Optional[torch.Tensor] = None,
    ) -> None:
        """Land one flushed batch: ``k_rows``/``v_rows`` are the gathered
        ``(nb, L, Hkv, block, D)`` device tensors (``nb >= len(rows)``,
        the first ``len(rows)`` in ``rows`` order), plus ``(nb, L, Hkv)``
        scales under quantized serving. ``rows`` ascend (as
        :meth:`take_pending` hands them out), so each run of consecutive
        rows is one ``non_blocking`` copy — one per part when the rows are
        contiguous, as a fresh tier allocates them. No host sync: an event
        on the current stream marks the copies' completion for
        :meth:`read`."""
        srcs = [k_rows, v_rows] + ([k_scale, v_scale]
                                   if self.quantized else [])
        for j, r0, m in _runs(list(rows)):
            for dst, src in zip(self._parts(), srcs):
                dst[r0:r0 + m].copy_(src[j:j + m], non_blocking=True)
        if k_rows.is_cuda:
            self._landed = torch.cuda.Event()
            self._landed.record()

    # -- restore side -----------------------------------------------------

    def cancel_pending(self, row: int) -> Optional[int]:
        """If ``row``'s demotion has not flushed yet, cancel it: the device
        block (returned) is still canonical, the host row frees. None when
        the copy already ran (a real restore is needed)."""
        bid = self.pending.pop(row, None)
        if bid is None:
            return None
        self._free.append(row)
        self.restores += 1
        if obs.REGISTRY.enabled:
            _RESTORES.inc()
            _HOST_USED.set(self.used)
        return bid

    def read(self, rows: List[int], pad_to: Optional[int] = None
             ) -> Tuple[torch.Tensor, ...]:
        """The H2D source of a restore batch: ``(n, L, Hkv, block, D)`` K
        and V rows (and ``(n, L, Hkv)`` scales when quantized) in ``rows``
        order, gathered on the host into fresh tensors — page-locked on a
        GPU host, so one ``non_blocking`` copy takes each as it is, and the
        pool's rows are free to reuse the moment this returns. ``pad_to``
        pads the leading axis with zero rows. Waits first for the last
        flush's D2H copies, the only ones that write rows."""
        if self._landed is not None:
            self._landed.synchronize()
            self._landed = None
        idx = torch.tensor(list(rows), dtype=torch.long)
        n = len(rows)
        nb = n if pad_to is None else max(pad_to, n)
        out = []
        for part in self._parts():
            buf = torch.zeros((nb,) + tuple(part.shape[1:]),
                              dtype=part.dtype, pin_memory=self.pinned)
            torch.index_select(part, 0, idx, out=buf[:n])
            out.append(buf)
        return tuple(out)

    def release(self, row: int, *, restored: bool) -> None:
        """Return one host row after a restore's read (``restored``) or a
        drop of a flushed node. Pending rows go through
        :meth:`cancel_pending` / :meth:`drop` instead."""
        assert row not in self.pending, (
            f"host row {row} released while still staged"
        )
        self._free.append(row)
        if restored:
            self.restores += 1
            if obs.REGISTRY.enabled:
                _RESTORES.inc()
        else:
            self.drops += 1
        if obs.REGISTRY.enabled:
            _HOST_USED.set(self.used)

    def drop(self, row: int) -> Optional[int]:
        """The host tier's own LRU eviction: the node leaves the tree.
        Returns the device block id when the demotion was still pending
        (the caller must ``free_demoted`` it — the copy never ran and never
        will), else None (only the host row frees)."""
        bid = self.pending.pop(row, None)
        self._free.append(row)
        self.drops += 1
        if obs.REGISTRY.enabled:
            _HOST_USED.set(self.used)
        return bid

    def stats(self) -> Dict[str, int]:
        return {
            "host_blocks": self.blocks,
            "host_blocks_used": self.used,
            "demotions": self.demotions,
            "restores": self.restores,
            "host_drops": self.drops,
        }
