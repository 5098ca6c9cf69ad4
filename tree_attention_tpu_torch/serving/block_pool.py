"""Host-side allocator for the unified paged-KV block pool.

Counterpart of ``tree_attention_tpu/serving/block_pool.py`` (the port's own
copy of the jax-free ledger). One pool of ``N`` blocks sits under every
slot; ownership is single-writer:

- a **free** block belongs to the allocator's free list;
- a **private** block belongs to exactly one slot;
- a **cached** block belongs to one radix-tree node (the prefix cache, a
  later slice of the port; the hooks below are its seam).

**Reservation-based admission** turns an over-subscribed pool into a clean
scheduling decision: an admission reserves its worst-case block count up
front against ``available() = free + evictable - reserved``; if that does
not fit, the request waits in the queue. Every later :meth:`alloc` is
backed by a reservation, so it cannot fail.

Pure host integers — no device state.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from tree_attention_tpu_torch import obs

_BLOCKS_USED = obs.gauge(
    "serving_kv_blocks_used",
    "unified KV pool blocks currently owned by a slot or the prefix tree",
)
_BLOCKS_FREE = obs.gauge(
    "serving_kv_blocks_free",
    "unified KV pool blocks on the free list",
)
# Per-shard views of the same ledger (the sequence-sharded pool): the
# aggregate gauges above keep their contract; these show the split.
_BLOCKS_USED_SHARD = obs.gauge(
    "serving_kv_blocks_used_shard",
    "KV pool blocks owned per mesh shard (sequence-sharded pool)",
    labels=("shard",),
)
_BLOCKS_FREE_SHARD = obs.gauge(
    "serving_kv_blocks_free_shard",
    "KV pool blocks free per mesh shard (sequence-sharded pool)",
    labels=("shard",),
)

# Block ownership states (the debug ledger's vocabulary).
_FREE, _PRIVATE, _CACHED = 0, 1, 2


class BlockAllocator:
    """Free list + reservation accounting over ``blocks`` pool blocks.

    The radix tree registers itself via :meth:`set_evictor`; without one
    (prefix cache off) *evictable* is always 0 and the allocator is a
    plain reserve-then-take free list.
    """

    def __init__(self, blocks: int):
        if blocks < 1:
            raise ValueError(f"block pool needs >= 1 block, got {blocks}")
        self.blocks = blocks
        # Pop from the end -> ascending ids early on (cosmetic, and it
        # makes allocator traces readable).
        self._free: List[int] = list(range(blocks - 1, -1, -1))
        self._state = [_FREE] * blocks  # the double-free/leak ledger
        self.reserved = 0
        # Availability generation: bumped whenever availability can have
        # GROWN (frees, unreserves; the engine also bumps on retire,
        # whose pin releases grow evictability without touching the free
        # list). A deferred admission latches the generation it failed
        # at and skips the O(prompt) re-match + O(tree) evictability
        # recount until the counter moves — pool state can't have
        # improved in between.
        self.gen = 0
        self._evict_one: Optional[Callable[[], bool]] = None
        self._evictable: Optional[Callable[[], int]] = None

    # -- the free list (subclass seam) ------------------------------------
    #
    # Every free-list touch goes through these two hooks so a subclass can
    # swap the backing structure (the sequence-sharded allocator keeps one
    # list per mesh shard) without re-deriving any of the ownership
    # transitions or the reservation-soundness argument.

    def _push_free(self, bid: int) -> None:
        self._free.append(bid)

    def _pop_free(self) -> int:
        return self._free.pop()

    # -- introspection ----------------------------------------------------

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        return self.blocks - self.free_count

    def evictable(self) -> int:
        return self._evictable() if self._evictable is not None else 0

    def available(self) -> int:
        """Blocks an admission may still reserve: free + evictable-now,
        minus what earlier admissions already promised themselves."""
        return self.free_count + self.evictable() - self.reserved

    def publish_gauges(self) -> None:
        if obs.REGISTRY.enabled:
            _BLOCKS_USED.set(self.used)
            _BLOCKS_FREE.set(self.free_count)

    # -- the evictor hook (the radix tree) --------------------------------

    def set_evictor(
        self, evict_one: Callable[[], bool], evictable: Callable[[], int]
    ) -> None:
        """``evict_one()`` must free one refcount-0 cached leaf into this
        allocator (returning False only when none exists); ``evictable()``
        counts blocks reachable that way."""
        self._evict_one = evict_one
        self._evictable = evictable

    # -- reservations -----------------------------------------------------

    def reserve(self, n: int) -> bool:
        """Promise ``n`` future :meth:`alloc` calls; False if the pool
        cannot honor them (the engine defers the admission)."""
        if n < 0:
            raise ValueError(f"cannot reserve {n} blocks")
        if n > self.available():
            return False
        self.reserved += n
        return True

    def unreserve(self, n: int) -> None:
        """Return unused reservations (early EOS, retire)."""
        self.reserved -= n
        self.gen += 1
        assert self.reserved >= 0, "block reservation underflow"

    # -- allocation / ownership transitions -------------------------------

    def alloc(self) -> int:
        """One private block, consuming one reservation. Never fails:
        reservations are only granted against free + evictable blocks,
        and pins (which shrink evictability) are themselves reserved."""
        assert self.reserved > 0, "alloc without a backing reservation"
        self.reserved -= 1
        while not self.free_count:
            # Load-bearing call — NOT inside an assert (python -O strips
            # assert statements, and the eviction must still run).
            if self._evict_one is None or not self._evict_one():
                raise AssertionError(
                    "allocator invariant broken: a backed reservation "
                    "found neither a free block nor an evictable leaf"
                )
        bid = self._pop_free()
        assert self._state[bid] == _FREE, f"block {bid} double-allocated"
        self._state[bid] = _PRIVATE
        return bid

    def publish(self, bid: int) -> None:
        """Ownership transfer private slot -> radix node (zero bytes
        moved — the whole point of the paged layout)."""
        assert self._state[bid] == _PRIVATE, (
            f"block {bid} published while not privately owned"
        )
        self._state[bid] = _CACHED

    def free_private(self, bid: int) -> None:
        """A retiring slot returns a block it still owns."""
        assert self._state[bid] == _PRIVATE, (
            f"block {bid} freed while not privately owned"
        )
        self._state[bid] = _FREE
        self._push_free(bid)
        self.gen += 1

    def unmap_private(self, bid: int) -> None:
        """A slot unmaps a block whose tokens were ROLLED BACK (rejected
        speculation) but keeps its worst-case claim: the block returns to
        the free list AND the reservation it consumed is restored, so the
        slot's later re-allocation cannot fail. Net availability is
        unchanged (+1 free, +1 reserved), hence no generation bump — a
        deferred admission could not be admitted by this."""
        assert self._state[bid] == _PRIVATE, (
            f"block {bid} unmapped while not privately owned"
        )
        self._state[bid] = _FREE
        self._push_free(bid)
        self.reserved += 1

    def free_cached(self, bid: int) -> None:
        """The radix tree evicts a refcount-0 leaf's block."""
        assert self._state[bid] == _CACHED, (
            f"block {bid} evicted while not tree-owned"
        )
        self._state[bid] = _FREE
        self._push_free(bid)
        self.gen += 1


class ShardedBlockAllocator(BlockAllocator):
    """The sequence-sharded pool's ledger: ``blocks`` global block ids
    range-partitioned over ``shards`` ranks — shard ``s`` owns ids ``[s*Nl,
    (s+1)*Nl)`` with ``Nl = blocks // shards``, the rule the device pool
    uses to map a global table entry to a local slice row, so ledger and
    placement cannot disagree. Every rank keeps the same ledger.

    One free list per shard; :meth:`alloc` pops from the RICHEST shard (the
    lowest index on a tie), so a growing slot's blocks interleave across
    shards and each shard holds about ``1/W`` of every slot's keys.
    Reservations stay GLOBAL: any block can serve any slot through the
    table, so ``available()`` over the pooled free count is exactly what
    :meth:`alloc` needs.
    """

    def __init__(self, blocks: int, shards: int):
        if shards < 1:
            raise ValueError(f"need >= 1 shard, got {shards}")
        if blocks % shards:
            raise ValueError(
                f"pool of {blocks} blocks does not split over {shards} "
                f"shards — round the pool up first")
        self.shards = shards
        self.shard_blocks = blocks // shards
        super().__init__(blocks)
        nl = self.shard_blocks
        self._free_by_shard: List[List[int]] = [
            list(range((s + 1) * nl - 1, s * nl - 1, -1))
            for s in range(shards)
        ]
        self._free = []  # unused: the per-shard lists are the free list

    def shard_of(self, bid: int) -> int:
        return bid // self.shard_blocks

    def _push_free(self, bid: int) -> None:
        self._free_by_shard[bid // self.shard_blocks].append(bid)

    def _pop_free(self) -> int:
        rich = max(range(self.shards),
                   key=lambda s: len(self._free_by_shard[s]))
        return self._free_by_shard[rich].pop()

    @property
    def free_count(self) -> int:
        return sum(len(f) for f in self._free_by_shard)

    def free_per_shard(self) -> List[int]:
        return [len(f) for f in self._free_by_shard]

    def used_per_shard(self) -> List[int]:
        return [self.shard_blocks - len(f) for f in self._free_by_shard]

    def publish_gauges(self) -> None:
        super().publish_gauges()
        if obs.REGISTRY.enabled:
            for s, nfree in enumerate(self.free_per_shard()):
                _BLOCKS_FREE_SHARD.labels(shard=s).set(nfree)
                _BLOCKS_USED_SHARD.labels(shard=s).set(
                    self.shard_blocks - nfree)
