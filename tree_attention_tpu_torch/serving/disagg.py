"""Disaggregated prefill/decode serving: two engines over one block pool with
a handoff that moves no KV byte.

Counterpart of ``tree_attention_tpu/serving/disagg.py``. Prefill is
compute-bound and bursty, decode memory-bound and steady; in one engine
chunked admission puts ``Tq > 1`` rows into decode ticks. DistServe
(arXiv:2401.09670) and Splitwise (arXiv:2311.18677) split the two phases
onto separate pools. :class:`DisaggServer` is that split in one process:

- a **prefill worker**, a :class:`~.engine.SlotServer` that runs admission
  and chunked prefill only: its slots go ``free -> prefill -> await ->
  handoff``, never ``live``, and its ticks never carry a decode row;
- a **decode worker**, a second ``SlotServer`` whose ticks are one-row
  decode (or speculative verify) steps, fed only by adoption from the
  handoff queue;
- **one block pool**: both workers are built over one
  :class:`~.block_pool.BlockAllocator` (and one
  :class:`~.prefix_cache.PagedPrefixIndex` with the prefix cache on), and
  both workers' caches are views of the SAME pool tensors — K, V and, under
  int8, the per-block scales. Every step writes the pool in place, so what
  one worker writes the other reads with no copy. A handoff moves ownership
  only: the allocator audits the finished prefill's blocks
  (:meth:`~.block_pool.BlockAllocator.transfer_private`), the decode worker
  writes the same block ids into its own table row, and the unspent
  worst-case reservation moves with the request — transferred, not
  reserved again, so no third request can take the blocks in between.

**The handoff queue is the prefill slot itself.** A request whose final
chunk completed parks in its prefill slot in state ``handoff`` until a
decode slot frees. That gives backpressure (a full decode pool stalls
prefill admission), and one retire path: a cancel or deadline while parked
retires through the prefill worker's ``_retire``, like every other arc.

**Time attribution.** Both workers share one device and one loop, so a
decode slot's wall-clock gap would include the prefill worker's tick. After
each prefill tick every live decode slot's last-token clock is shifted past
it: the recorded TBT (``ServeReport.tbt_s``) is the decode worker's own
tick time, not the gap a streaming client sees, which on one device still
includes the serialized prefill ticks. The serialized totals are reported
(``ServeReport.handoff["prefill_tick_s"/"decode_tick_s"]``).

**One tick body.** Both workers run :class:`SlotServer`'s own tick sections
(``_poll``, ``_sweep``, ``_admit_pending``, ``_tick``); this module adds
only the handoff, the sweep over both workers and the time attribution.
With the flight recorder armed each tick records two dicts, tagged
``worker: "prefill"`` (its chunk plan, the handoff queue and the pair's
sweep arcs) and ``worker: "decode"`` (occupancy, tokens emitted, the
pool's blocks); a sweep-only tick records one, tagged ``prefill``.

Threading: :meth:`cancel`, :meth:`fork` and :meth:`request_drain` are
mailboxes (under one lock) swept at tick start; everything else runs on the
serve loop's thread. ``DisaggServer`` has ``SlotServer``'s serving surface
(``serve``, ``cancel``, ``request_drain``, ``draining``, ``slots``,
``slo``, ``leak_report``), so the HTTP ingress drives it unchanged
(``--serve-disagg``, composable with ``--serve-http``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from tree_attention_tpu_torch import obs
from tree_attention_tpu_torch.obs.flight import FLIGHT
from tree_attention_tpu_torch.models.transformer import (
    Params,
    TransformerConfig,
)
from tree_attention_tpu_torch.parallel.mesh import AXIS_SEQ, Mesh
from tree_attention_tpu_torch.serving.block_pool import (
    BlockAllocator,
    ShardedBlockAllocator,
)
from tree_attention_tpu_torch.serving.engine import (
    Request,
    RequestSource,
    ServeReport,
    SlotServer,
    StaticRequestSource,
    _Run,
    _TickOut,
    _chunk_plan_rec,
)
from tree_attention_tpu_torch.serving.host_pool import HostBlockPool
from tree_attention_tpu_torch.serving.prefix_cache import PagedPrefixIndex
from tree_attention_tpu_torch.serving.speculation import Drafter
from tree_attention_tpu_torch.utils.logging import get_logger

log = get_logger("serving.disagg")

_HANDOFFS = obs.counter(
    "serving_handoff_total",
    "requests handed off prefill->decode (ownership moves; zero KV bytes "
    "moved)",
)
_HANDOFF_QUEUE = obs.gauge(
    "serving_handoff_queue",
    "requests parked in prefill slots awaiting decode-pool adoption",
)

# The pool tensors both workers' caches share.
_POOL_FIELDS = ("k", "v")
_POOL_FIELDS_Q = ("k", "v", "k_scale", "v_scale")


class DisaggServer:
    """Two ``SlotServer`` workers over one block pool, one tick loop.

    Args (shared ones as on :class:`SlotServer`; both workers get the same
    params and config):
      prefill_slots: the prefill worker's batch: prompts in chunked
        prefill or parked for handoff at once.
      decode_slots: the decode worker's batch: concurrent decoding
        requests.
      kv_blocks: the WHOLE pool's capacity in blocks (both workers and the
        prefix tree draw from it). Default ``(prefill_slots +
        decode_slots) * ceil(cache_len / kv_block)``: a fused engine's
        default at the same total slots.
      speculate / draft_k / drafter: speculative decoding on the decode
        worker (the prefill worker never drafts).
      prefix_cache: one radix tree for the pair: the prefill worker matches
        and adopts, the decode worker inherits each request's pins at the
        handoff and releases them at retire. Int8 too (per-block scales
        ride the pool).
      host_blocks: the host-RAM tier under the shared pool (0 = off);
        needs ``prefix_cache=True``. The prefill worker, where matches
        happen, runs its restores and flushes.
    """

    def __init__(
        self,
        params: Params,
        cfg: TransformerConfig,
        *,
        prefill_slots: int,
        decode_slots: int,
        cache_len: int,
        mesh: Optional[Mesh] = None,
        quantize: bool = False,
        quant_kernel: str = "q8q",
        temperature: float = 0.0,
        top_k: int = 0,
        seed: int = 0,
        prefill_chunk: int = 256,
        prefill_budget: Optional[int] = None,
        slo_ttft: float = 1.0,
        slo_tbt: float = 0.2,
        slo_window: int = 1024,
        prefix_cache: bool = False,
        prefix_block: int = 64,
        prefix_pool_blocks: Optional[int] = None,
        kv_block: Optional[int] = None,
        kv_blocks: Optional[int] = None,
        speculate: bool = False,
        draft_k: int = 4,
        drafter: Union[str, Drafter, None] = None,
        host_blocks: int = 0,
        kv_shard: str = "replicated",
    ):
        if prefill_slots < 1 or decode_slots < 1:
            raise ValueError(
                f"disaggregation needs >= 1 slot per pool, got "
                f"prefill_slots={prefill_slots} decode_slots={decode_slots}")
        if kv_shard not in ("replicated", "seq"):
            raise ValueError(
                f"kv_shard must be 'replicated' or 'seq', got {kv_shard!r}")
        if host_blocks < 0:
            raise ValueError(f"host_blocks must be >= 0, got {host_blocks}")
        if host_blocks and not prefix_cache:
            raise ValueError(
                "host_blocks KV tiering requires prefix_cache=True "
                "(demotion is what radix eviction becomes; with no radix "
                "tree nothing ever demotes)")
        if kv_block is None:
            kv_block = prefix_block if prefix_cache else 64
        self.prefill_slots = prefill_slots
        self.decode_slots = decode_slots
        self.slots = prefill_slots + decode_slots  # the ingress's capacity
        self.cache_len = cache_len
        self.cfg = cfg
        self.params = params
        self.quantize = quantize
        self.kv_layout = "paged"
        self.kv_block = kv_block
        self.kv_shard = kv_shard
        npb = -(-cache_len // kv_block)
        self.kv_blocks = self.slots * npb if kv_blocks is None else kv_blocks
        # ONE ledger for both workers: every reservation, allocation and
        # ownership change (the handoff's transfer included) runs through
        # it, so its audits cover the pair.
        if kv_shard == "seq":
            w = mesh.axis_size(AXIS_SEQ) if mesh is not None else 1
            self.kv_blocks = -(-self.kv_blocks // w) * w
            self.pool: BlockAllocator = ShardedBlockAllocator(
                self.kv_blocks, w)
        else:
            self.pool = BlockAllocator(self.kv_blocks)
        self.host_blocks = host_blocks
        self.host_pool: Optional[HostBlockPool] = None
        if host_blocks:
            self.host_pool = HostBlockPool(
                host_blocks, n_layers=cfg.n_layers,
                n_kv_heads=cfg.n_kv_heads, block=kv_block,
                d_head=cfg.d_head,
                dtype=torch.int8 if quantize else cfg.dtype,
                quantized=quantize,
                pin_memory=params["embed"].device.type == "cuda")
        self.prefix_index: Optional[PagedPrefixIndex] = None
        if prefix_cache:
            self.prefix_index = PagedPrefixIndex(
                block=kv_block, alloc=self.pool,
                max_cached=prefix_pool_blocks, host_pool=self.host_pool)
        common = dict(
            cache_len=cache_len, mesh=mesh, quantize=quantize,
            quant_kernel=quant_kernel, temperature=temperature, top_k=top_k,
            admission="chunked", slo_ttft=slo_ttft, slo_tbt=slo_tbt,
            slo_window=slo_window, kv_layout="paged", kv_block=kv_block,
            kv_shard=kv_shard, block_pool=self.pool,
            prefix_index=self.prefix_index)
        self.prefill = SlotServer(
            params, cfg, slots=prefill_slots, seed=seed,
            prefill_chunk=prefill_chunk, prefill_budget=prefill_budget,
            **common)
        # The decode worker runs chain verify rows only: a mid-stream fork
        # takes the fork-slot path, never the in-slot tree conversion.
        self.decode = SlotServer(
            params, cfg, slots=decode_slots, seed=seed + 1,
            prefill_chunk=prefill_chunk, speculate=speculate,
            draft_k=draft_k, drafter=drafter, tree_sampling=False, **common)
        # ONE SLO monitor: TTFT is observed on the prefill worker, TBT on
        # the decode worker, retires on whichever owns the request.
        self.slo = self.prefill.slo
        self.decode.slo = self.slo
        # ONE set of per-tick arc counts for the flight records: the pair's
        # sweep and both workers' ticks count into it.
        self.decode._tc = self.prefill._tc
        # ONE set of pool tensors: the decode worker's own (all-zero) pool
        # is dropped for the prefill worker's, so both caches are views of
        # the same storage — int8's per-block scales included.
        self._pool_fields = _POOL_FIELDS_Q if quantize else _POOL_FIELDS
        self._relay_pool(self.prefill, self.decode)
        if self.host_pool is not None:
            # The tier belongs to the shared tree: the prefill worker, the
            # matching side, restores demoted paths and flushes the staged
            # demotions (the allocator's flusher, so a dry reservation on
            # either worker can force one).
            self.prefill.attach_host_tier(self.host_pool)
        # A family would need sibling slots on both sides of the handoff:
        # n/best_of > 1 is refused at validation; fork(uid) applies on the
        # decode worker, where live slots are.
        self.prefill._fork_ok = False
        # The prefill worker parks finished prompts for the handoff; each
        # worker's tick has a span of its own.
        self.prefill._handoff = []
        self.prefill._tick_name = "disagg:prefill_tick"
        self.decode._tick_name = "disagg:decode_tick"
        self._lock = threading.RLock()
        self._cancel_uids: set = set()
        self._draining = False
        # Lifetime handoff count (serve() diffs it per run).
        self.handoffs = 0

    # -- control mailboxes (any thread) ------------------------------------

    def cancel(self, uid: int) -> None:
        """Cancel request ``uid`` (any thread), on whichever worker owns it
        at the next sweep: queued, prefilling, parked for handoff or
        decoding. An unknown uid is a no-op."""
        with self._lock:
            self._cancel_uids.add(uid)

    def fork(self, uid: int) -> None:
        """Branch live request ``uid`` mid-stream (any thread), applied by
        the sweep on the DECODE worker: the branch shares the request's full
        ancestor blocks in the one pool. The mailbox is the decode
        worker's, where a ``fork_at`` request forks itself too."""
        self.decode.fork(uid)

    def _take_forks(self) -> List[int]:
        return self.decode._take_forks()

    @property
    def _fork_carry(self) -> Dict[int, int]:
        """The decode worker's deferred-fork carry (the forks apply
        there)."""
        return self.decode._fork_carry

    def _apply_forks(self, forks: List[int], tick: int, pending) -> None:
        """The fork arc, on the decode worker. A request still queued,
        prefilling or parked lives on the prefill side, where the decode
        worker cannot see it: such uids wait in the carry (the fused
        engine's not-yet-live case) instead of aging out as unknown. A
        fork's tail copy writes the shared pool in place."""
        upstream = list(pending) + [
            rq for rq in self.prefill._slot_req if rq is not None]
        self.decode._apply_forks(forks, tick, upstream)

    def request_drain(self) -> None:
        """Begin a graceful drain (any thread): stop admitting, shed the
        queue, finish everything in flight, handoffs included."""
        with self._lock:
            self._draining = True

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    @property
    def all_slots_free(self) -> bool:
        return self.prefill.all_slots_free and self.decode.all_slots_free

    def _take_control(self) -> Tuple[set, bool]:
        with self._lock:
            cancels = self._cancel_uids
            self._cancel_uids = set()
            return cancels, self._draining

    def prefix_stats(self) -> Dict[str, Any]:
        return ({} if self.prefix_index is None
                else dict(self.prefix_index.stats()))

    def leak_report(self) -> Dict[str, int]:
        """The pair's no-leak invariant: after a drained run neither worker
        holds a private block, nothing is reserved, shared or pinned — a
        handoff that dropped or double-counted a block shows here."""
        out = {
            "blocks_private": (
                sum(len(s) for s in self.prefill._slot_private)
                + sum(len(s) for s in self.decode._slot_private)),
            "blocks_used": self.pool.used,
            "blocks_reserved": self.pool.reserved,
            "blocks_shared": self.pool.shared_count,
            "blocks_cached": 0,
            "pins": 0,
        }
        if self.prefix_index is not None:
            out["blocks_cached"] = self.prefix_index.blocks_used
            out["pins"] = self.prefix_index.total_pins()
        if self.host_pool is not None:
            out["host_blocks_used"] = self.host_pool.used
        return out

    def slots_snapshot(self) -> List[Dict[str, Any]]:
        """Both workers' slot rows, labelled: a parked handoff shows as a
        prefill slot in state ``handoff`` until a decode slot adopts it."""
        out: List[Dict[str, Any]] = []
        for worker, eng in (("prefill", self.prefill),
                            ("decode", self.decode)):
            for row in eng.slots_snapshot():
                row["worker"] = worker
                out.append(row)
        return out

    # -- the handoff -------------------------------------------------------

    def _relay_pool(self, src: SlotServer, dst: SlotServer) -> None:
        """Point ``dst``'s cache at ``src``'s pool tensors.

        The JAX package relays a functionally updated pool between its
        workers after every dispatch. Here every step, tail copy,
        compaction and insert writes the pool tensors in place, so after
        the constructor's one rebinding both caches keep naming the same
        storage and no relay moves anything: this only rebinds the cache
        object's Python fields, in case a step ever returns new tensors.
        Tables and lengths stay per worker."""
        for name in self._pool_fields:
            setattr(dst.cache, name, getattr(src.cache, name))

    def pool_shared(self) -> bool:
        """Whether both workers' caches are views of the same pool
        storage (the zero-copy handoff's precondition)."""
        return all(getattr(self.prefill.cache, n).data_ptr()
                   == getattr(self.decode.cache, n).data_ptr()
                   for n in self._pool_fields)

    def _adopt(self, p: int, d: int, tick: int) -> None:
        """Move the request parked in prefill slot ``p`` to decode slot
        ``d``: the handoff proper. The allocator audits that every block is
        privately owned (:meth:`BlockAllocator.transfer_private`); the table
        row, private set, unspent reservation, prefix pins and sampling
        state move to the decode worker; the prefill slot is cleared
        WITHOUT freeing anything. From here the request retires, on any
        arc, through the decode worker's one retire path."""
        pf, dc = self.prefill, self.decode
        req = pf._slot_req[p]
        plen = len(req.prompt)
        bids = pf._slot_private[p]
        nb = pf._slot_nblocks[p]
        self.pool.transfer_private(bids)
        dc._host_table[d, :nb] = pf._host_table[p, :nb]
        dc._host_table[d, nb:] = 0
        dc._slot_nblocks[d] = nb
        dc._slot_private[d] = bids
        dc._slot_reserve[d] = pf._slot_reserve[p]
        dc._table_dirty = True
        # The request's pinned radix path carries over and is released at
        # the decode worker's retire.
        dc._slot_nodes[d] = pf._slot_nodes[p]
        dc._slot_req[d] = req
        dc._slot_tokens[d] = pf._slot_tokens[p]  # [first token]
        dc._slot_admit[d] = pf._slot_admit[p]
        dc._slot_wait[d] = pf._slot_wait[p]
        dc._slot_ttft[d] = pf._slot_ttft[p]
        dc._slot_max_tbt[d] = pf._slot_max_tbt[p]
        dc._slot_prefix_hit[d] = pf._slot_prefix_hit[p]
        dc._prompt_np[d] = pf._prompt_np[p]
        dc._last_tok_t[d] = pf._last_tok_t[p]
        # Sampling state moves with the request: its key (draw j is keyed
        # fold_in(key, j) on either worker), temperature, top-k, branch
        # index and running log-probability.
        dc._keys[d] = pf._keys[p]
        dc._temp_np[d] = pf._temp_np[p]
        dc._topk_np[d] = pf._topk_np[p]
        dc._slot_index[d] = pf._slot_index[p]
        dc._slot_cum_lp[d] = pf._slot_cum_lp[p]
        dc._slot_shared[d] = set()
        dc._slot_logits[d] = None
        # Committed rows: the prompt; the first token is the pending tip.
        dc._slot_clen[d] = plen
        first = dc._slot_tokens[d][-1]
        dc._tok_host[d] = first  # the device vector: serve() pushes it
        if dc._speculate:
            dc._hist_buf[d, :plen] = dc._prompt_np[d]
            dc._hist_buf[d, plen] = first
            dc._hist_len[d] = plen + 1
        dc._slot_state[d] = "live"
        dc._slot_span[d] = pf._slot_span[p]
        # The decode worker's device length of slot d is stale (the prefill
        # ran in the other worker's length vector): its first decode step
        # resets it to the prompt length, as a forked slot's is (a verify
        # tick resets every slot to its committed length anyway).
        dc._live_reset[d] = plen
        # Clear the prefill slot without releasing anything (it all changed
        # owner) and without a generation bump (nothing became available).
        pf._slot_req[p] = None
        pf._slot_tokens[p] = []
        pf._slot_state[p] = "free"
        pf._prompt_np[p] = None
        pf._slot_nodes[p] = []
        pf._slot_private[p] = set()
        pf._slot_reserve[p] = 0
        pf._host_table[p, :] = 0
        pf._slot_nblocks[p] = 0
        pf._table_dirty = True
        pf._slot_span[p] = None
        self.handoffs += 1
        if obs.REGISTRY.enabled:
            _HANDOFFS.inc()
        if obs.TRACER.active:
            obs.instant("handoff", cat="serving", args={
                "rid": req.uid, "tick": tick, "from_slot": p, "to_slot": d,
                "blocks": nb, "kv_bytes_moved": 0})
            if req.trace is not None:
                obs.flow("t", obs.flow_id(req.trace[0]))

    # -- the split tick loop -------------------------------------------------

    def _prefill_rec(self, run: _Run, out: _TickOut, t_s: float,
                     queue_depth: int, handoff_queue: int,
                     draining: bool) -> Dict[str, Any]:
        """The prefill worker's flight record of one tick: its chunk plan,
        the handoff queue and the pair's sweep arcs (the JAX pair's keys;
        every value a host-side ledger's)."""
        pf, tc = self.prefill, self.prefill._tc
        return {
            "worker": "prefill",
            "tick": run.tick,
            "t_s": round(t_s, 6),
            "states": list(pf._slot_state),
            "chunk_plan": _chunk_plan_rec(out.plan),
            "chunk_tokens": sum(int(n) for _, n, _ in out.plan),
            "handoff_queue": handoff_queue,
            "pending": len(run.pending),
            "queue_depth": queue_depth,
            "prefix_hits": tc.prefix_hits,
            "prefix_reused": tc.prefix_reused,
            "cancelled": tc.cancelled,
            "deadline_expired": tc.deadline_expired,
            "shed": tc.shed,
            **({"restored_blocks": tc.restored_blocks,
                "host_blocks_used": self.host_pool.used}
               if self.host_pool is not None else {}),
            "draining": draining,
        }

    @torch.no_grad()
    def serve(self, requests: Union[Sequence[Request], RequestSource],
              max_ticks: Optional[int] = None) -> ServeReport:
        """Run both workers, interleaved, until the source drains: the
        contract of :meth:`SlotServer.serve` (a static trace or a live
        source, the control sweep at tick start, ``max_ticks`` bounding a
        runaway loop), each iteration one prefill-worker tick and one
        decode-worker tick.

        Both workers run the fused engine's own tick sections
        (``SlotServer._poll``, ``_sweep``, ``_admit_pending``, ``_tick``):
        the prefill worker's slots never go live, so its ticks carry chunks
        only and its finished prompts park for the handoff; the decode
        worker admits nothing, so its ticks carry one-row decode (or
        verify) rows only. This loop adds the handoff, the sweep across
        both workers and the time attribution."""
        pf, dc = self.prefill, self.decode
        live = isinstance(requests, RequestSource)
        if live:
            source: RequestSource = requests
        else:
            for r in requests:
                pf._validate(r)
            source = StaticRequestSource(requests)
            with self._lock:
                # A stale mailbox must not cancel or drain a fresh trace;
                # a live source keeps drains and cancels issued before the
                # loop's first tick.
                self._cancel_uids.clear()
                self._draining = False
        run = _Run.new(live)
        parked = pf._handoff  # prefill slots in state "handoff", FIFO
        queue_peak = 0
        prefill_s = decode_s = 0.0  # each worker's serialized wall time
        handoffs0 = self.handoffs
        transferred0 = self.pool.transferred
        peak_used = self.pool.used
        prefix0 = self.prefix_stats()
        host0 = (self.host_pool.stats() if self.host_pool is not None
                 else None)
        hit_bytes0 = pf._hit_bytes_moved
        spec0 = (dc._spec_proposed, dc._spec_accepted, dc._spec_ticks,
                 dc._spec_verifies)
        forks0 = dc._forks_life
        pf._defer_gen = -1
        t0 = time.monotonic()

        try:
            while True:
                if max_ticks is not None and run.tick >= max_ticks:
                    raise RuntimeError(
                        f"DisaggServer.serve() exceeded max_ticks="
                        f"{max_ticks} with {len(run.pending)} pending and "
                        f"{len(parked)} queued-for-handoff request(s)")
                now = time.monotonic()
                pf._tc.zero()
                pf._poll(run, source, now)
                # The control sweep, across BOTH workers. A request parked
                # for handoff occupies a prefill slot and retires through
                # that worker's _retire.
                cancels, draining = self._take_control()
                pf._sweep(run, source, now, cancels, draining, (pf, dc))
                parked[:] = [p for p in parked
                             if pf._slot_state[p] == "handoff"]
                forks = self._take_forks()
                if forks or self._fork_carry:
                    self._apply_forks(forks, run.tick, run.pending)

                # Adopt: the oldest parked request per free decode slot.
                free_d = [i for i, st in enumerate(dc._slot_state)
                          if st == "free"]
                adopted = bool(parked and free_d)
                while parked and free_d:
                    self._adopt(parked.pop(0), free_d.pop(0), run.tick)

                # Admit: the oldest visible request per free PREFILL slot,
                # reserving its worst case in the shared pool.
                pf._admit_pending(run, now)
                queue_depth = len(run.pending)
                queue_peak = max(queue_peak, len(parked))
                if obs.REGISTRY.enabled:
                    _HANDOFF_QUEUE.set(len(parked))

                if not (run.pending or parked or not pf.all_slots_free
                        or not dc.all_slots_free):
                    # Idle iterations stay before the tick body: recorded
                    # ticks are executed ticks (and sweep-only records).
                    if FLIGHT.enabled:
                        rec = pf._sweep_only_rec(run, queue_depth, draining)
                        if rec is not None:
                            FLIGHT.record({**rec, "worker": "prefill"})
                    if source.exhausted or draining:
                        break
                    nxt = source.next_arrival()
                    if nxt is not None:
                        run.tick = max(run.tick + 1, nxt)
                    else:
                        if FLIGHT.enabled:
                            FLIGHT.mark_idle()
                        source.wait(0.05)
                    continue

                # ---- the prefill worker's tick: chunks only, no decode
                # rows.
                tp0 = time.monotonic()
                pout = pf._tick(run)
                self._relay_pool(pf, dc)
                queue_peak = max(queue_peak, len(parked))
                dt_pf = time.monotonic() - tp0
                prefill_s += dt_pf
                # The serialized prefill section is not the decode worker's
                # own inter-token gap: shift every live decode slot's clock
                # past it (the recorded TBT is the decode worker's; a
                # streaming client on this one device does wait through
                # it).
                for i, st in enumerate(dc._slot_state):
                    if st == "live":
                        dc._last_tok_t[i] += dt_pf
                if FLIGHT.enabled:
                    FLIGHT.record(self._prefill_rec(
                        run, pout, now - t0, queue_depth, len(parked),
                        draining))

                # ---- the decode worker's tick: one-row decode or verify
                # only.
                td0 = time.monotonic()
                if adopted:
                    # The adopted slots' first tokens, one push of the
                    # token vector (not KV: the handoff itself issues no
                    # device op).
                    dc.tok.copy_(torch.from_numpy(dc._tok_host))
                dout = dc._tick(run)
                self._relay_pool(dc, pf)
                decode_s += time.monotonic() - td0
                peak_used = max(peak_used, self.pool.used)
                self.pool.publish_gauges()
                if self.host_pool is not None:
                    # The pair's staged D2H flush point, after both
                    # workers' steps.
                    pf._flush_demotions()
                    self.host_pool.publish_gauge()
                if FLIGHT.enabled:
                    FLIGHT.record({
                        "worker": "decode",
                        "tick": run.tick,
                        "t_s": round(now - t0, 6),
                        "occupancy": dout.occupancy,
                        "states": list(dc._slot_state),
                        "tokens_emitted": dout.tokens,
                        "handoff_queue": len(parked),
                        "kv_blocks_used": self.pool.used,
                        "kv_blocks_free": self.pool.free_count,
                        "draining": draining,
                    })
                self.slo.maybe_export(now)
                run.tick += 1
        except BaseException as e:
            # The black box: the pair's last ticks reach the disk before
            # the error propagates.
            FLIGHT.dump_if_armed(f"disagg_error:{type(e).__name__}")
            if obs.TRACER.active:
                obs.instant("engine_error", cat="serving", args={
                    "error": type(e).__name__, "tick": run.tick})
            raise

        if self.host_pool is not None:
            # A drained run leaves no demotion staged.
            pf._flush_demotions()
            self.host_pool.publish_gauge()
        if FLIGHT.enabled:
            FLIGHT.mark_idle()
        with self._lock:
            self._cancel_uids.clear()
            self._draining = False
        wall = time.monotonic() - t0
        self.slo.export_gauges()
        prefix_snap: Dict[str, Any] = {}
        if self.prefix_index is not None:
            p1 = self.prefix_stats()
            reused = p1["tokens_reused"] - prefix0["tokens_reused"]
            prompt_tokens = sum(r.prompt_len for r in run.results)
            prefix_snap = {
                "hits": p1["hits"] - prefix0["hits"],
                "misses": p1["misses"] - prefix0["misses"],
                "tokens_reused": reused,
                "reused_ratio": round(reused / prompt_tokens, 4)
                if prompt_tokens else 0.0,
                "evictions": p1["evictions"] - prefix0["evictions"],
                "pool_blocks_used": p1["pool_blocks_used"],
                "pool_blocks": p1["pool_blocks"],
                "hit_bytes_moved": pf._hit_bytes_moved - hit_bytes0,
            }
        kv_snap: Dict[str, Any] = {
            "layout": "paged",
            "block": self.kv_block,
            "pool_blocks": self.kv_blocks,
            "blocks_used": self.pool.used,
            "blocks_free": self.pool.free_count,
            "peak_blocks_used": peak_used,
        }
        if dc._forks_life - forks0:
            kv_snap["forks"] = dc._forks_life - forks0
        if self.host_pool is not None:
            h1 = self.host_pool.stats()
            kv_snap.update({
                "host_blocks": h1["host_blocks"],
                "host_blocks_used": h1["host_blocks_used"],
                "demotions": h1["demotions"] - host0["demotions"],
                "restores": h1["restores"] - host0["restores"],
                "host_drops": h1["host_drops"] - host0["host_drops"],
            })
        handoff_snap = {
            "handoffs": self.handoffs - handoffs0,
            "blocks_transferred": self.pool.transferred - transferred0,
            "queue_peak": queue_peak,
            # Ownership moves, the bytes do not: both workers' caches are
            # views of one pool (``pool_shared``), and ``transfer_private``
            # audits every handed block.
            "kv_bytes_moved": 0,
            "prefill_tick_s": round(prefill_s, 4),
            "decode_tick_s": round(decode_s, 4),
        }
        spec_snap: Dict[str, Any] = {}
        if dc._speculate:
            prop = dc._spec_proposed - spec0[0]
            acc = dc._spec_accepted - spec0[1]
            ver = dc._spec_verifies - spec0[3]
            spec_snap = {
                "drafter": type(dc._drafter).__name__,
                "draft_k": dc.draft_k,
                "proposed": prop,
                "accepted": acc,
                "acceptance_rate": round(acc / prop, 4) if prop else 0.0,
                "verify_ticks": dc._spec_ticks - spec0[2],
                "tokens_per_verify": round(1.0 + acc / ver, 4) if ver
                else 0.0,
            }
        log.info(
            "disagg served %d request(s): %d tokens, %d handoff(s), %d "
            "decode tick(s), %.1f tok/s, mean decode occupancy %.2f/%d",
            len(run.results), run.tokens, self.handoffs - handoffs0,
            run.decode_ticks, run.tokens / wall if wall > 0 else 0.0,
            run.occupancy / max(run.decode_ticks, 1), dc.slots)
        return ServeReport(
            results=sorted(run.results, key=lambda r: r.uid),
            ticks=run.tick,
            wall_s=wall,
            tokens_generated=run.tokens,
            mean_occupancy=run.occupancy / max(run.decode_ticks, 1),
            decode_ticks=run.decode_ticks,
            steps=run.steps,
            tbt_s=list(run.tbt),
            slo=self.slo.snapshot(),
            prefix=prefix_snap,
            kv=kv_snap,
            spec=spec_snap,
            handoff=handoff_snap,
        )
