"""Radix prefix KV cache: shared-prompt reuse across serving requests.

Counterpart of ``tree_attention_tpu/serving/prefix_cache.py`` (the port's
own copy). Request streams share prompt prefixes (system prompts, few-shot
templates), and a plain slot server prefills them again for every
admission. A radix tree over prompt token sequences, mapping prefixes to
cached KV blocks, turns that duplicate prefill into reuse (RadixAttention,
arXiv:2312.07104):

- **Host-side radix tree** at ``block``-token granularity (a power of
  two): each node owns ONE block — the KV rows of one ``block``-token span
  — keyed by that span's token tuple under its parent. A path from the
  root spells a prompt prefix; matching is a walk.
- **Ref-counted LRU eviction**: a node is pinned (``refs > 0``) from the
  admission that matched or published it until that request retires;
  eviction only takes a refcount-0 *leaf* (evicting an interior node would
  orphan its children's prefix), least recently used first.

Two indexes share that machinery (:class:`_RadixBase`):

- :class:`PagedPrefixIndex` over the engine's paged block pool: a hit
  writes the matched block ids into the slot's table row and a publish
  ADOPTS the slot's private prompt blocks, so neither moves a device byte
  (int8 pools included: a block carries its own scales);
- :class:`PrefixCache` for the contiguous layout: its own device pool of
  exact rows, a hit one gather into the slot
  (:func:`~tree_attention_tpu_torch.models.decode.insert_prefix_blocks`),
  a publish one scatter out of it (:func:`~tree_attention_tpu_torch.models
  .decode.extract_prefix_blocks`).

Matches are capped at ``len(prompt) - 1`` tokens (rounded down to the
block size): the suffix keeps at least one token, because sampling the
first output token needs a forward row.

KV tiering puts a host tier under the paged index
(:class:`~tree_attention_tpu_torch.serving.host_pool.HostBlockPool`): its
eviction then DEMOTES the victim's block into a host row (the node stays,
its ``tier`` ``TIER_HOST``), and a hit on a demoted path restores it
(:meth:`PagedPrefixIndex.restore_nodes`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from tree_attention_tpu_torch import obs
from tree_attention_tpu_torch.models.decode import (
    KVCache,
    extract_prefix_blocks,
    insert_prefix_blocks,
)
from tree_attention_tpu_torch.models.transformer import TransformerConfig
from tree_attention_tpu_torch.serving.block_pool import BlockAllocator
from tree_attention_tpu_torch.utils import resolve_device
from tree_attention_tpu_torch.utils.logging import get_logger

log = get_logger("serving.prefix")

# Host-loop truths recorded at admission, and the tree's block count; all
# free while the registry is off.
_HITS = obs.counter(
    "serving_prefix_hits_total",
    "admissions that matched a cached prompt prefix",
)
_MISSES = obs.counter(
    "serving_prefix_misses_total",
    "admissions that found no cached prefix (cold prefill)",
)
_TOKENS_REUSED = obs.counter(
    "serving_prefix_tokens_reused_total",
    "prompt tokens whose prefill a cached prefix replaced",
)
_POOL_USED = obs.gauge(
    "serving_prefix_pool_blocks_used",
    "blocks the prefix tree currently holds",
)


def _block_key(toks: List[int], j: int, block: int) -> Tuple[int, ...]:
    """The radix key of block ``j``: that span's token tuple (callers
    convert the prompt with one ``tolist()`` and slice here)."""
    return tuple(toks[j * block:(j + 1) * block])


# Node tiers: a DEVICE node's ``block_id`` names a device pool block; a
# HOST node's names a row of the host tier (a demoted block).
TIER_DEVICE, TIER_HOST = 0, 1


class _Node:
    """One radix node: a ``block``-token span owning one block."""

    __slots__ = ("key", "parent", "children", "block_id", "refs",
                 "last_use", "tier")

    def __init__(self, key: Tuple[int, ...], parent: Optional["_Node"],
                 block_id: int):
        self.key = key
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.block_id = block_id
        self.refs = 0
        self.last_use = 0
        self.tier = TIER_DEVICE


class _RadixBase:
    """The walk, pin and LRU machinery both prefix indexes share: one
    definition of pin-as-you-visit, the LRU touch, the one-suffix-token
    match cap, the refcount-0-leaf victim and the stats vocabulary."""

    def _init_tree(self, block: int) -> None:
        if block < 1 or block & (block - 1):
            raise ValueError(f"prefix block must be a power of two, "
                             f"got {block}")
        self.block = block
        self._root = _Node((), None, -1)
        self._clock = 0
        # Lifetime stats; the engine diffs them over each serve() run.
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0
        self.evictions = 0

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.last_use = self._clock

    def _pinned_walk(self, prompt: np.ndarray) -> List[_Node]:
        """Pin and LRU-touch the longest cached path over the prompt's
        matchable blocks — at most ``len(prompt) - 1`` tokens."""
        max_blocks = (len(prompt) - 1) // self.block
        toks = prompt.tolist()
        node = self._root
        path: List[_Node] = []
        for j in range(max_blocks):
            child = node.children.get(_block_key(toks, j, self.block))
            if child is None:
                break
            child.refs += 1
            self._touch(child)
            path.append(child)
            node = child
        return path

    def record_match(self, matched: int) -> None:
        """Count one admission's match outcome. Separate from the walk so
        a caller that may defer the admission (the paged engine's
        reservation) counts only admissions that proceed."""
        if matched:
            self.hits += 1
            self.tokens_reused += matched
            if obs.REGISTRY.enabled:
                _HITS.inc()
                _TOKENS_REUSED.inc(matched)
        else:
            self.misses += 1
            if obs.REGISTRY.enabled:
                _MISSES.inc()

    def release(self, nodes: List[_Node]) -> None:
        for n in nodes:
            n.refs -= 1
            assert n.refs >= 0, "prefix node ref underflow"

    def repin(self, nodes: List[_Node]) -> List[_Node]:
        """Take one more pin on each node of an already-pinned path (a
        second holder of the same path, without re-walking: the existing
        pins prove it is alive). Returns the nodes as the new holder's
        pinned set."""
        for n in nodes:
            assert n.refs > 0, "repin of an unpinned prefix node"
            n.refs += 1
            self._touch(n)
        return list(nodes)

    def total_pins(self) -> int:
        """Sum of every node's refcount: 0 on a drained engine."""
        total = 0
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            total += n.refs
        return total

    def _lru_scan(self, victim) -> Optional[_Node]:
        """The least recently used node satisfying ``victim(node)``, or
        None: the one traversal every victim rule (classic leaf eviction,
        device-tier demotion, host-tier drop) parameterizes."""
        best: Optional[_Node] = None
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if not victim(n):
                continue
            if best is None or n.last_use < best.last_use:
                best = n
        return best

    def _lru_leaf(self) -> Optional[_Node]:
        """The least recently used refcount-0 leaf, or None when every
        block is pinned (directly or through a pinned descendant)."""
        return self._lru_scan(lambda n: not n.children and not n.refs)


class PrefixCache(_RadixBase):
    """Device block pool + host radix tree over prompt prefixes, for the
    contiguous layout.

    The pool holds exact rows in the model dtype, ``(P + 1, L, Hkv, block,
    D)``: rows ``[0, P)`` are the cache's blocks and row ``P`` the drop row
    that padded publish ids write to. An int8 slot's hit lands in the exact
    staging cache and its prompt is quantized at the final chunk, so the
    pool never holds int8 rows.

    Args:
      cfg: the served model (the pool's ``(L, Hkv, D)`` and dtype).
      block: tokens per pool block (a power of two).
      blocks: pool capacity ``P`` in blocks.
      device: where the pool lives.
    """

    def __init__(self, cfg: TransformerConfig, *, block: int = 64,
                 blocks: int = 64,
                 device: Union[str, torch.device] = "cuda"):
        self._init_tree(block)
        if blocks < 1:
            raise ValueError(f"prefix pool needs >= 1 block, got {blocks}")
        self.blocks = blocks
        shape = (blocks + 1, cfg.n_layers, cfg.n_kv_heads, block, cfg.d_head)
        dev = resolve_device(device)
        self.pool_k = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        self.pool_v = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        self._free: List[int] = list(range(blocks))

    @property
    def blocks_used(self) -> int:
        return self.blocks - len(self._free)

    def stats(self) -> Dict[str, Any]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "tokens_reused": self.tokens_reused,
            "evictions": self.evictions,
            "pool_blocks_used": self.blocks_used,
            "pool_blocks": self.blocks,
        }

    def match(self, prompt: np.ndarray) -> Tuple[int, List[_Node]]:
        """Longest cached prefix of ``prompt`` in whole blocks, at least
        one suffix token left. Returns ``(matched_tokens, path)``, every
        path node pinned and LRU-touched; the caller holds the pins until
        :meth:`release` (the engine: until the request retires)."""
        path = self._pinned_walk(prompt)
        matched = len(path) * self.block
        self.record_match(matched)
        return matched, path

    def insert(self, prompt: np.ndarray) -> Tuple[List[_Node], List[int],
                                                  int]:
        """Make nodes exist for ``prompt``'s full-block prefix, allocating
        pool blocks (evicting LRU refcount-0 leaves as needed) for the
        missing tail; stops early, at a valid shorter prefix, when the pool
        is pinned full. Every path node is pinned as it is visited, so a
        later eviction of the same insert cannot take it. Returns ``(path,
        new_ids, start_block)``: the pinned path, the new pool rows still
        needing KV data, and the block index their data starts at."""
        nb_full = len(prompt) // self.block
        toks = prompt.tolist()
        node = self._root
        path: List[_Node] = []
        j = 0
        while j < nb_full:
            child = node.children.get(_block_key(toks, j, self.block))
            if child is None:
                break
            child.refs += 1
            self._touch(child)
            path.append(child)
            node = child
            j += 1
        start = j
        new_ids: List[int] = []
        while j < nb_full:
            bid = self._alloc()
            if bid is None:
                log.debug("prefix pool pinned full; publish stops at "
                          "block %d/%d", j, nb_full)
                break
            child = _Node(_block_key(toks, j, self.block), node, bid)
            child.refs = 1
            self._touch(child)
            node.children[child.key] = child
            path.append(child)
            new_ids.append(bid)
            node = child
            j += 1
        return path, new_ids, start

    def _alloc(self) -> Optional[int]:
        if not self._free:
            victim = self._lru_leaf()
            if victim is None:
                return None
            self._evict(victim)
        bid = self._free.pop()
        if obs.REGISTRY.enabled:
            _POOL_USED.set(self.blocks_used)
        return bid

    def _evict(self, node: _Node) -> None:
        assert not node.children and node.refs == 0
        del node.parent.children[node.key]
        self._free.append(node.block_id)
        self.evictions += 1
        if obs.REGISTRY.enabled:
            _POOL_USED.set(self.blocks_used)

    # -- device copies ----------------------------------------------------

    def _nb_bucket(self, n: int, capacity: int) -> int:
        """Power-of-two block-count bucket, capped so the copy window fits
        the cache (``nb * block <= capacity``): the engine's bucket rule."""
        from tree_attention_tpu_torch.serving.engine import _bucket

        return _bucket(n, capacity // self.block, floor=1)

    def copy_into(self, cache: KVCache, slot: int, nodes: List[_Node],
                  matched: int) -> KVCache:
        """The hit: one gather placing ``matched`` pooled tokens at offset
        0 of ``slot`` (its length set to ``matched``), in place. ``cache``
        is an exact :class:`KVCache` (the batch cache, or the B=1 staging
        cache under int8 serving)."""
        nb = self._nb_bucket(len(nodes), cache.capacity)
        ids = np.zeros((nb,), np.int64)  # padding gathers block 0, masked
        ids[:len(nodes)] = [n.block_id for n in nodes]
        return insert_prefix_blocks(cache, self.pool_k, self.pool_v,
                                    torch.from_numpy(ids), matched, slot)

    def publish_from(self, cache: KVCache, slot: int, new_ids: List[int],
                     start_block: int) -> None:
        """The publish: one scatter copying the slot's freshly prefilled
        blocks ``[start_block, start_block + len(new_ids))`` into their
        pool rows (padded ids name the drop row)."""
        if not new_ids:
            return
        nb = self._nb_bucket(len(new_ids), cache.capacity)
        ids = np.full((nb,), self.blocks, np.int64)
        ids[:len(new_ids)] = new_ids
        extract_prefix_blocks(self.pool_k, self.pool_v, cache.k, cache.v,
                              slot, torch.from_numpy(ids), start_block)


class PagedPrefixIndex(_RadixBase):
    """Radix prefix index over the engine's paged block pool, in place.

    The paged mirror of :class:`PrefixCache`: the same radix tree and
    pin/LRU-leaf discipline, but nodes name blocks of the one pool every
    slot reads through its block table, so prefix reuse moves no device
    byte:

    - a **hit** pins the matched path and hands the engine its block ids,
      which it writes into the slot's table row;
    - a **publish** ADOPTS the prefilling slot's private blocks
      (:meth:`adopt`): ownership moves to the tree through the allocator's
      ledger, and the KV stays where the prefill wrote it.

    ``max_cached`` bounds the blocks the tree may retain (``None``: as many
    as eviction pressure allows). The index registers itself as the
    allocator's evictor, so a slot allocation under a dry free list
    recycles an LRU refcount-0 leaf. With ``host_pool`` (a
    :class:`~tree_attention_tpu_torch.serving.host_pool.HostBlockPool`)
    that recycling DEMOTES the victim into a host row instead of
    forgetting it, and :meth:`restore_nodes` brings a matched demoted path
    back (module docstring of ``host_pool``).
    """

    def __init__(self, *, block: int, alloc: BlockAllocator,
                 max_cached: Optional[int] = None,
                 host_pool: Optional[Any] = None):
        self._init_tree(block)
        self.alloc = alloc
        self.max_cached = max_cached
        self._cached = 0  # device blocks the tree owns
        self._host_cached = 0  # demoted nodes (host-tier rows)
        self.host = host_pool
        alloc.set_evictor(self.evict_one, self.evictable_blocks)

    @property
    def blocks_used(self) -> int:
        return self._cached

    def stats(self) -> Dict[str, Any]:
        out = {
            "hits": self.hits,
            "misses": self.misses,
            "tokens_reused": self.tokens_reused,
            "evictions": self.evictions,
            "pool_blocks_used": self._cached,
            "pool_blocks": (self.max_cached if self.max_cached is not None
                            else self.alloc.blocks),
        }
        if self.host is not None:
            out.update(self.host.stats())
        return out

    def match(self, prompt: np.ndarray,
              record: bool = True) -> Tuple[int, List[_Node]]:
        """Longest cached prefix in whole blocks (one suffix token left),
        the path pinned and LRU-touched; the caller holds the pins until
        the request retires and reads the KV through ``node.block_id``.
        ``record=False`` defers the stats to :meth:`record_match`: the
        engine matches before it knows whether the admission's reservation
        fits, and a deferred admission matches again later."""
        path = self._pinned_walk(prompt)
        matched = len(path) * self.block
        if record:
            self.record_match(matched)
        return matched, path

    def adopt(self, prompt: np.ndarray, phys: Dict[int, int],
              held: List[_Node]) -> Tuple[List[_Node], List[int]]:
        """Publish a completed prompt by handing over the slot's blocks.

        ``phys`` maps the prompt's logical block ``j`` to the pool block
        the slot privately owns there; ``held`` is the request's pinned
        matched path (its pins carry over). Past it, a missing node adopts
        ``phys[j]`` (the tree owns it now, one pin held by this request
        until it retires). A node another request published since this
        admission is walked through under a call-scoped guard pin only:
        the slot keeps reading its own private copy (same bytes, freed at
        retire), and a lasting pin on a refcount-0 node could turn a block
        some admission's reservation counts on from evictable to pinned.
        The guard keeps the retention budget's eviction (LRU refcount-0
        leaves) off the node the walk stands on, which would otherwise
        leave the new child under a detached parent. Adoption stops early
        when the budget is pinned full. Returns ``(path, adopted)``: the
        nodes this request now holds (held + created) and the logical
        blocks that changed owner."""
        nb_full = len(prompt) // self.block
        toks = prompt.tolist()
        node = held[-1] if held else self._root
        path: List[_Node] = list(held)
        adopted: List[int] = []
        guard: List[_Node] = []
        for j in range(len(held), nb_full):
            key = _block_key(toks, j, self.block)
            child = node.children.get(key)
            if child is None:
                bid = phys.get(j)
                if bid is None:
                    break  # the slot holds no private block here
                if self.max_cached is not None \
                        and self._cached >= self.max_cached:
                    if not self.evict_one():
                        log.debug("prefix index pinned full; publish "
                                  "stops at block %d/%d", j, nb_full)
                        break
                child = _Node(key, node, bid)
                child.refs = 1
                self.alloc.publish(bid)
                self._cached += 1
                adopted.append(j)
                node.children[key] = child
                path.append(child)
            else:
                child.refs += 1
                guard.append(child)
            self._touch(child)
            node = child
        self.release(guard)
        if obs.REGISTRY.enabled:
            _POOL_USED.set(self._cached)
        return path, adopted

    # -- eviction and demotion (the allocator's hook) ---------------------

    def _lru_device_victim(self) -> Optional[_Node]:
        """The LRU refcount-0 DEVICE-tier node with no device-tier
        children, or None when every device block is pinned. Without a host
        tier this is the classic refcount-0 leaf; with one, a device node
        whose children were all demoted is a victim too (demoting it keeps
        the node and its host subtree's prefix)."""
        return self._lru_scan(
            lambda n: n.tier == TIER_DEVICE and not n.refs
            and not any(c.tier == TIER_DEVICE for c in n.children.values()))

    def _drop_host_lru(self) -> bool:
        """The host tier's own LRU eviction: delete the least recently used
        refcount-0 host-tier LEAF from the tree (leaf-only, so no prefix is
        orphaned). A still-pending demotion's device block frees directly:
        its copy never ran and never will."""
        best = self._lru_scan(
            lambda n: n.tier == TIER_HOST and not n.refs and not n.children)
        if best is None:
            return False
        del best.parent.children[best.key]
        bid = self.host.drop(best.block_id)
        if bid is not None:
            self.alloc.free_demoted(bid)
        self._host_cached -= 1
        return True

    def evict_one(self) -> bool:
        """Recycle one LRU refcount-0 device victim: DEMOTE it into the host
        tier when one is attached (the node survives; a later match
        restores it), evict it otherwise (or when the host tier is pinned
        full even after dropping its own LRU). False when every device
        block is pinned."""
        victim = self._lru_device_victim()
        if victim is None:
            return False
        if self.host is not None:
            row = self.host.alloc()
            while row is None and self._drop_host_lru():
                row = self.host.alloc()
            if row is not None:
                self.alloc.demote_cached(victim.block_id)
                self.host.enqueue(row, victim.block_id)
                victim.tier = TIER_HOST
                victim.block_id = row
                self._cached -= 1
                self._host_cached += 1
                self.evictions += 1
                if obs.REGISTRY.enabled:
                    _POOL_USED.set(self._cached)
                return True
            log.debug("host tier pinned full; falling back to eviction")
        # Classic eviction: the prefix is forgotten. A device victim with
        # host children reaches here only when the host tier could not take
        # it, and then it must not orphan them.
        if victim.children:
            return False
        del victim.parent.children[victim.key]
        self.alloc.free_cached(victim.block_id)
        self._cached -= 1
        self.evictions += 1
        if obs.REGISTRY.enabled:
            _POOL_USED.set(self._cached)
        return True

    def evictable_blocks(self) -> int:
        """DEVICE blocks in fully unpinned subtrees: exactly what repeated
        :meth:`evict_one` calls reach (device-leaf-first eviction drains an
        unpinned subtree; a pinned descendant protects its ancestors).
        Host-tier nodes hold no device block and count 0."""

        def walk(node: _Node) -> Tuple[bool, int, int]:
            has_pin = node.refs > 0
            dev_blocks = 1 if node.tier == TIER_DEVICE else 0
            kid_evictable = 0
            for c in node.children.values():
                p, b, e = walk(c)
                has_pin |= p
                dev_blocks += b
                kid_evictable += e
            if has_pin:
                return True, dev_blocks, kid_evictable
            return False, dev_blocks, dev_blocks

        return sum(walk(c)[2] for c in self._root.children.values())

    # -- restore (the engine's hit path) -----------------------------------

    def demoted_in(self, nodes: List[_Node]) -> List[_Node]:
        """The host-tier nodes of a matched (pinned) path, in path order."""
        return [n for n in nodes if n.tier == TIER_HOST]

    def restore_nodes(self, nodes: List[_Node], alloc_device: Any
                      ) -> Tuple[List[int], List[int]]:
        """Bring a pinned path's demoted nodes back to the device tier.

        A still-PENDING demotion cancels (the device bytes never left: the
        block goes straight back to the tree, zero copies); a flushed one
        takes a fresh device block from ``alloc_device()`` (the admission's
        reservation backs it) and joins the batched H2D copy the caller
        runs. Returns ``(host_rows, new_bids)``, equal-length lists of the
        rows to copy and their destination blocks; the caller reads the
        rows (:meth:`HostBlockPool.read`), scatters them, then releases
        them. Tiers and ownership flip here."""
        rows: List[int] = []
        bids: List[int] = []
        for n in nodes:
            assert n.tier == TIER_HOST and n.refs > 0, \
                "restore of an unpinned or device-tier node"
            row = n.block_id
            bid = self.host.cancel_pending(row)
            if bid is not None:
                self.alloc.undemote(bid)
            else:
                bid = alloc_device()
                self.alloc.publish(bid)  # private -> tree-owned
                rows.append(row)
                bids.append(bid)
            n.block_id = bid
            n.tier = TIER_DEVICE
            self._cached += 1
            self._host_cached -= 1
        if obs.REGISTRY.enabled:
            _POOL_USED.set(self._cached)
        return rows, bids
