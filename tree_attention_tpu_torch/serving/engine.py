"""Slot-based continuous batching with stall-free chunked prefill.

Counterpart of ``tree_attention_tpu/serving/engine.py`` for this slice. The
engine holds a fixed batch of S cache slots plus a request queue and runs a
tick loop:

1. **Admit** — every free slot takes the oldest visible request (under the
   paged layout only once the request's worst-case block count is reserved;
   otherwise it waits in the queue). The slot enters ``prefill``.
2. **Step** — ONE mixed-Tq :func:`forward_step` advances the whole batch:
   every live slot contributes its one decode token and prefilling slots
   ride along with prompt chunks of up to ``prefill_chunk`` tokens (padded
   to a power-of-two bucket, at most ``prefill_budget`` prompt tokens per
   tick), written straight into each slot's cache region (Sarathi-style,
   arXiv:2403.02310). Pure-decode ticks carry the token vector on the
   device.
3. **Fetch** — one host fetch per tick reads every new token (and its
   log-probability) of the tick.
4. **Retire** — a slot whose request sampled its ``eos_id`` or hit its
   token budget frees its blocks and is refilled at the next admission.

Slot lifecycle: ``free -> prefill -> await -> live -> free``; a slot's
first token is sampled by its final chunk and fetched with the tick. A fork
family's sibling slots wait in ``fpend`` from the family's admission until
the parent's first token, then go ``live`` (a mid-stream branch goes
``free -> live``).

``admission="whole"`` is the blocking alternative: the admission prefills
the whole prompt at once, on a B=1 cache of the prompt's power-of-two
bucket (one per bucket, allocated at its first use; B3 over the bucket
from 128 rows), zeroes the pad rows, samples the first token from row
``plen - 1`` into the device token vector, and inserts the rows (quantized
per block or per channel under int8) into the slot, which parks in
``await`` until the tick's one host fetch reads the token. A prefix hit
runs only its suffix, as one-slot mixed steps the other slots ride inertly;
int8 with the prefix cache on runs the staged path to completion.

The layouts are ``kv_layout="paged"`` (default: one block pool under every
slot, block tables, the B2 kernel streams blocks in place) and
``"contiguous"`` (per-slot regions, the B1 kernel). Prompt chunks of a
bucket >= 128 take the Q-tiled B3 kernel.

``quantize=True`` serves from an int8 cache (B5 on the paged layout, B4 on
the contiguous one; the cast route over B2/B1 with ``quant_kernel="q8"``).
Admission is then **staged**: a prompt's chunks run against ONE
preallocated B=1 exact staging cache (B1 or B3), one prompt at a time —
admission waits while one is staged — ahead of the tick's decode step over
the int8 cache. The final chunk samples the first token, masks the staging
cache's stale tail, quantizes the prompt (per block on the paged layout,
per channel on the contiguous one: the quantize-after-prefill contract) and
inserts its rows, scales and length into the slot.

Under a mesh, ``kv_shard="seq"`` serves from a sequence-SHARDED paged pool:
every rank runs the same engine with the same host ledger (global block
ids, a :class:`ShardedBlockAllocator`), each rank's device pool holds its
``1/W`` of the blocks, and the batched per-tick step attends through the
tree merge across ranks (B2 with ``local_blocks`` on each rank). The merged
result comes out of an all-reduce, so every rank samples the same tokens
and takes the same decisions with no further collective. The staging cache
of int8 admission stays whole on every rank.

``speculate=True`` turns every live slot's tick into a **draft-and-verify**
step (speculative decoding, arXiv:2211.17192): a host drafter proposes up
to ``draft_k`` tokens from the slot's own history (``"ngram"``
prompt-lookup chains, ``"ngram-tree"`` token trees verified under the
tree-attention ancestor mask — SpecInfer, arXiv:2305.09781 — or a small
draft model), the tick's ONE step scores them all beside any prefill
chunks, the longest accepted root path commits in a burst with the model's
bonus token, accepted tree rows are compacted to the front of the window
(:func:`compact_decode_window`), and rejections roll the slot's length back
through the next step's ``reset_val`` — with paged blocks past the rollback
unmapped back into the slot's reservation. Every draw is keyed by the
request and the token's stream index (:func:`sample_rows`), so where the
verify rows' logits equal the one-row decode's (the plain versions on a
CPU) greedy and sampled slots commit exactly the non-speculative stream.
On a GPU the decode kernel at a verify tick's Tq rounds differently from
Tq 1, and the streams part where the model's top logits nearly tie.

``prefix_cache=True`` reuses shared prompt prefixes across requests
(:mod:`~tree_attention_tpu_torch.serving.prefix_cache`, RadixAttention,
arXiv:2312.07104). An admission matches its prompt against a radix tree of
published ``block``-token spans (at least one suffix token stays to
prefill), keeps the matched path pinned until it retires, and prefills only
the suffix: its first chunk starts at the matched length. When the final
chunk completes, the prompt's whole blocks are published.

- **Paged** (:class:`PagedPrefixIndex` over the block pool): a hit writes
  the matched block ids into the slot's table row and reserves only the
  blocks it does not share — exact serving moves zero device bytes. A
  publish ADOPTS the slot's private prompt blocks: the tree owns them now,
  the table and the bytes stay. Under int8 the hit also dequantizes the
  matched blocks into the staging cache (the suffix's exact chunks attend
  them); the final staged chunk's insert starts at the matched length, so
  a shared block is never rewritten.
- **Contiguous** (:class:`PrefixCache`, a pool of exact rows of its own): a
  hit gathers the matched rows into the slot (into the staging cache under
  int8), a publish scatters the slot's new whole blocks (the staging
  cache's exact rows under int8) into the pool.

**Live serving.** :meth:`SlotServer.serve` takes a pre-built trace (every
request validated up front) or a live :class:`RequestSource` (the HTTP
ingress's :class:`~tree_attention_tpu_torch.serving.ingress.QueueRequestSource`):
requests appear as clients submit them, an invalid one finishes with outcome
``error`` instead of raising, and the loop idles on
:meth:`RequestSource.wait` between arrivals. Each tick starts with the
control sweep: mailboxed cancellations (:meth:`~SlotServer.cancel`; queued
requests finish unserved, in-flight ones retire mid-prefill, mid-stage or
mid-stream), expired ``deadline_s`` (queued, then in flight), and a
:meth:`~SlotServer.request_drain` (the source closes, the queue sheds,
in-flight requests finish). Every exit arc retires through the one
``_retire``, which frees exactly what a finished request frees. Per-request
``on_token`` / ``on_finish`` callbacks run on the engine thread, fed from
the tick's one host fetch.

**KV tiering.** ``host_blocks > 0`` (paged layout, prefix cache on) puts a
host-RAM tier under the pool
(:class:`~tree_attention_tpu_torch.serving.host_pool.HostBlockPool`, pinned
on a GPU): radix eviction demotes blocks instead of forgetting them, the
tick's end flushes the staged demotions (one gather and a ``non_blocking``
D2H copy, no sync), and a prefix hit on a demoted path restores it before
its suffix runs — pending demotions cancel with zero copies, flushed ones
land in fresh blocks of the slot's reservation through one batched H2D
copy and scatter.

**Copy-on-write forks.** A request with ``n > 1`` (or ``best_of > 1``)
is a fork FAMILY: one prefill, then ``n - 1`` siblings forked off the
parent the tick its first token lands (vLLM's fork over PagedAttention
block tables, arXiv:2309.06180). Admission reserves the whole family
atomically (one slot per branch, siblings parked in ``fpend``; the
parent's blocks plus each sibling's worst-case new blocks). A fork shares
every full ancestor block — radix-cached ones take one more pin, the
parent's private ones move to the allocator's refcounted ``shared`` state
on both sides — and copies only the partial tail block
(:func:`copy_pool_block`, under int8 with its block scales). Each
sibling's first token is drawn from the parent's stashed prompt-end logits
under its own key: branch ``b > 0`` draws its ``j``-th token under
``fold_in(fold_in(key, b), j)``, branch 0 under the request's own
``fold_in(key, j)``. ``best_of`` streams only the branch of highest
cumulative log-probability, at the family's last retire.
:meth:`SlotServer.fork` (a mailbox swept at tick start, like ``cancel``)
and ``Request.fork_at`` branch a live request mid-stream. Every branch
finishes as its own :class:`RequestResult` under the family's uid, tagged
by ``index``.

**Token-tree sibling decode** (``tree_sampling=True``, the default): a
family that fits the tree rule (paged pool, no speculation, a mask-capable
attention path, ``k * (max_new_tokens - 1) <= 32`` rows and the slot's
window) decodes every branch in ONE slot. The slot's committed rows freeze
at the shared ancestors (``base_len``); each tick replays every live
branch's divergent suffix as rows ``[r*s, (r+1)*s)`` of one verify-shaped
bundle (:func:`~.speculation.pack_siblings`) under a per-branch
lower-triangular ancestor mask, so the tick runs the ``tree`` variant of
B2 (exact) or B5 (int8), and each branch's next token is the draw at its
last row, keyed exactly as the fork-slot path keys it (branch ``b``'s
``j``-th token under ``fold_in(branch key, j)``): the two paths give the
same tokens under one seed. A retiring branch shrinks the slot's window
and reservation the same tick; one survivor is compacted to the front of
the window (:func:`compact_decode_window`) and the slot returns to plain
decode. ``fork(uid)`` on a plain live slot converts it into a two-branch
tree where the rule allows. A family outside the rule runs the fork-slot
path: one slot per branch.

**The flight recorder** (``obs.FLIGHT``, armed by ``--flight-out`` or
``--metrics-port``): after each executed tick :meth:`SlotServer.serve`
records one dict (slot states and lengths, the chunk plan, tokens emitted,
whether the tick paid its host fetch, queue depth, the tick's arcs: cancels,
deadlines, sheds, forks, tree branches, prefix hits, restores, speculative
proposals; the pool's blocks and fragmentation), built from host-side
ledgers only (:class:`_TickCounts` for the arcs); a sweep that retires
work on an otherwise idle tick records a ``sweep_only`` dict; an error
escaping the loop dumps the armed ring before it propagates.

Left for later slices of the port (see ROADMAP): speculation and the
prefix cache (so KV tiering) on a mesh, and the request ledger.
Disaggregated prefill/decode serving is
:class:`~tree_attention_tpu_torch.serving.disagg.DisaggServer`, two of these
engines over one block pool.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import (
    Any,
    Callable,
    Dict,
    List,
    NamedTuple,
    Optional,
    Sequence,
    Set,
    Tuple,
    Union,
)

import numpy as np
import torch

from tree_attention_tpu_torch import obs
from tree_attention_tpu_torch.models.decode import (
    KVCache,
    compact_decode_window,
    copy_pool_block,
    fold_in,
    forward_step,
    gather_kv_blocks,
    init_cache,
    init_paged_cache,
    insert_dequant_prefix,
    paged_insert_slot,
    quantize_cache,
    quantize_paged_blocks,
    sample_rows,
    sample_slots,
    scatter_kv_blocks,
)
from tree_attention_tpu_torch.ops.cuda_decode import resolve_q8_kernel
from tree_attention_tpu_torch.models.transformer import (
    Params,
    TransformerConfig,
)
from tree_attention_tpu_torch.obs.flight import FLIGHT
from tree_attention_tpu_torch.obs.metrics import percentile
from tree_attention_tpu_torch.obs.slo import SLOMonitor
from tree_attention_tpu_torch.parallel.mesh import AXIS_SEQ, Mesh
from tree_attention_tpu_torch.serving.block_pool import (
    BlockAllocator,
    ShardedBlockAllocator,
)
from tree_attention_tpu_torch.serving.host_pool import HostBlockPool
from tree_attention_tpu_torch.serving.prefix_cache import (
    TIER_DEVICE,
    PagedPrefixIndex,
    PrefixCache,
)
from tree_attention_tpu_torch.serving.speculation import (
    DraftProposal,
    Drafter,
    PackedSpec,
    accept_longest_path,
    accept_stochastic_path,
    make_drafter,
    pack_proposal,
    pack_siblings,
)
from tree_attention_tpu_torch.utils.logging import get_logger

log = get_logger("serving")

_SLOTS_OCCUPIED = obs.gauge(
    "serving_slots_occupied",
    "live slots in the serving batch (set once per tick)",
)
_QUEUE_WAIT = obs.histogram(
    "serving_queue_wait_seconds",
    "wall seconds a request waited between becoming visible and admission",
)
_TOKENS = obs.counter(
    "serving_tokens_total",
    "tokens decoded for live slots by executed serving ticks",
)
_REQUESTS = obs.counter(
    "serving_requests_total",
    "requests the engine finished, by outcome",
    labels=("outcome",),
)
_PREFILL_CHUNKS = obs.counter(
    "serving_prefill_chunks_total",
    "prefill chunks scheduled into serving ticks",
)
_TTFT = obs.histogram(
    "serving_ttft_seconds",
    "wall seconds from request visibility to its first sampled token",
)
_TBT = obs.histogram(
    "serving_tbt_seconds",
    "wall seconds between consecutive tokens of one live slot",
)
_SPEC_PROPOSED = obs.counter(
    "serving_spec_proposed_total",
    "draft tokens proposed into speculative verify ticks",
)
_SPEC_ACCEPTED = obs.counter(
    "serving_spec_accepted_total",
    "proposed draft tokens the verify pass accepted (bonus tokens — the "
    "model's own next token at the divergence point — are not drafts and "
    "do not count)",
)
_SPEC_ACCEPT_RATIO = obs.gauge(
    "serving_spec_acceptance_ratio",
    "lifetime accepted/proposed draft-token ratio (set per verify tick)",
)
_FORKS = obs.counter(
    "serving_forks_total",
    "copy-on-write forks performed (n>1 siblings, best-of-n branches, "
    "and mid-generation fork(uid) branches)",
)
_FORK_SHARED = obs.counter(
    "serving_fork_blocks_shared_total",
    "full ancestor KV blocks a fork SHARED (radix pins + refcounted "
    "CoW blocks) instead of copying or recomputing them",
)
_TREE_BRANCHES = obs.gauge(
    "serving_tree_branches",
    "live sibling branches decoding as token trees in single slots "
    "(set once per tick; 0 when no tree family is in flight)",
)
_SPEC_ACCEPT_SAMPLES = obs.counter(
    "serving_spec_accept_samples_total",
    "per-row stochastic draws consumed by sampled (temperature > 0) "
    "speculative accept walks — the Leviathan ratio test's coupled "
    "samples; greedy verifies draw nothing and do not count",
)

# The one retire-outcome vocabulary: every way a request leaves the engine,
# threaded unchanged through ``serving_requests_total{outcome}`` and
# ``ServeReport.outcomes``.
OUTCOME_EOS = "eos"              # sampled the request's eos_id
OUTCOME_BUDGET = "budget"        # hit max_new_tokens
OUTCOME_CANCELLED = "cancelled"  # client cancelled (disconnect) mid-flight
OUTCOME_DEADLINE = "deadline"    # per-request deadline expired
OUTCOME_SHED = "shed"            # dropped unserved (drain)
OUTCOME_ERROR = "error"          # live-submitted request failed validation
OUTCOMES = (OUTCOME_EOS, OUTCOME_BUDGET, OUTCOME_CANCELLED,
            OUTCOME_DEADLINE, OUTCOME_SHED, OUTCOME_ERROR)


@dataclasses.dataclass
class Request:
    """One generation request. ``arrival_tick`` is synthetic-trace time in
    ticks (0 = queued at start); ``eos_id`` stops generation early (the EOS
    token is included in the output). ``temperature``/``top_k`` override
    the engine's defaults; ``seed`` salts the request's sampling key
    (default: its uid).

    The ingress-facing fields all default off:

    - ``deadline_s`` — absolute ``time.monotonic()`` deadline; expired in
      the queue the request finishes unserved, expired in flight it retires
      with outcome ``deadline``.
    - ``on_token`` / ``on_finish`` — streaming callbacks, called ON THE
      ENGINE THREAD as tokens commit and at retire. They must hand off fast
      and should not raise (a raising callback is logged and dropped; the
      request keeps running).
    - ``visible_at`` — the ``time.monotonic()`` at which a live source
      took the request, so its queue-wait and TTFT clocks start when the
      client's request entered the system.
    - ``trace`` — ``(trace_id, parent span_id)`` of the request's W3C
      traceparent (adopted or minted by the ingress); ``None`` = untraced.

    Copy-on-write forks (module docstring): ``n > 1`` serves ``n``
    completions of one prompt as one prefill and ``n - 1`` forked
    siblings; ``best_of = k`` runs ``k`` branches and streams only the
    winner by cumulative log-probability (requires ``n == 1``); ``fork_at
    = j`` forks the request itself after its ``j``-th emitted token (the
    live loop checks it from the second token on, as the JAX engine
    does). Branch events go to ``on_branch_token(index, tok)`` /
    ``on_branch_finish(index, result)`` when set; otherwise only branch 0
    reaches ``on_token`` / ``on_finish``.
    """

    uid: int
    prompt: Sequence[int]
    max_new_tokens: int
    arrival_tick: int = 0
    eos_id: Optional[int] = None
    deadline_s: Optional[float] = None
    on_token: Optional[Callable[[int], None]] = None
    on_finish: Optional[Callable[["RequestResult"], None]] = None
    visible_at: Optional[float] = None
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    seed: Optional[int] = None
    trace: Optional[Tuple[str, str]] = None
    n: int = 1
    best_of: Optional[int] = None
    fork_at: Optional[int] = None
    on_branch_token: Optional[Callable[[int, int], None]] = None
    on_branch_finish: Optional[
        Callable[[int, "RequestResult"], None]] = None


@dataclasses.dataclass
class RequestResult:
    uid: int
    tokens: List[int]
    prompt_len: int
    arrival_tick: int
    admit_tick: int  # -1: never admitted (cancelled/expired/shed/invalid)
    finish_tick: int
    queue_wait_s: float
    completion_s: float  # visible -> finished, wall seconds
    outcome: str  # one of OUTCOMES
    ttft_s: float = 0.0  # visible -> first sampled token, wall seconds
    cum_logprob: float = 0.0  # sum of the model log-probs of the tokens
    # Prompt tokens served from the prefix cache at admission (0: cold or
    # the cache off).
    prefix_hit_tokens: int = 0
    # Fork-family branch index: 0 = the parent (or the only branch); a
    # family finishes once per branch, all under its one uid.
    index: int = 0
    # The finished request ledger (``obs.REQLOG.finish``'s dict: wall
    # segments, token and block attribution, trace ids); None while the
    # ledger is disarmed, and on every branch of a family but the one
    # that closed it.
    ledger: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class _ForkFamily:
    """Host bookkeeping of one ``n > 1`` / best-of-n request.

    Admission reserves the whole family atomically: the parent's
    worst-case blocks plus each sibling's worst-case NEW blocks (its total
    less the full ancestor blocks it will share), and one slot per branch
    (siblings park in ``fpend``, so two half-admitted families never
    deadlock each other). The siblings fork the tick the parent's first
    token lands, before its EOS check (a one-token parent still yields
    ``n`` samples)."""

    req: Request
    parent_slot: int
    sibling_slots: List[int]
    sib_reserve: int  # worst-case new blocks per sibling
    hold: int         # unspent family reservation (siblings not forked)
    best_of: bool
    branches: int
    forked: bool = False
    done: List[RequestResult] = dataclasses.field(default_factory=list)
    # Token-tree sibling decode: the family's branches share ONE slot. The
    # slot's committed rows freeze at ``base_len`` (the shared ancestors);
    # branch ``b``'s tokens past ``fork_len - 1`` are its divergent suffix,
    # replayed every tick. ``br_index`` is each branch's result index (and
    # key index); ``br_live`` False once it retired.
    tree: bool = False
    base_len: int = 0
    fork_len: int = 0
    br_tokens: List[List[int]] = dataclasses.field(default_factory=list)
    br_cum_lp: List[float] = dataclasses.field(default_factory=list)
    br_live: List[bool] = dataclasses.field(default_factory=list)
    br_index: List[int] = dataclasses.field(default_factory=list)
    br_ttft: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Run:
    """One ``serve()`` run's loop state, which the sections of a tick
    (:meth:`SlotServer._poll`, ``_sweep``, ``_admit_pending``, ``_tick``)
    share, and in :class:`~.disagg.DisaggServer` both workers' ticks."""

    results: Any
    tbt: Any
    pending: deque = dataclasses.field(default_factory=deque)
    # Unmatched cancels, by uid: the sweeps left before they age out.
    cancel_carry: Dict[int, int] = dataclasses.field(default_factory=dict)
    visible_wall: Dict[int, float] = dataclasses.field(default_factory=dict)
    tick: int = 0
    tokens: int = 0
    steps: int = 0
    decode_ticks: int = 0
    occupancy: int = 0

    @classmethod
    def new(cls, live: bool) -> "_Run":
        # A live server runs indefinitely: its retention is bounded (the
        # report covers the most recent window); a finite trace keeps all.
        return cls(results=deque(maxlen=4096) if live else [],
                   tbt=deque(maxlen=1 << 16) if live else [])


@dataclasses.dataclass
class _TickCounts:
    """The arcs of one tick, for its flight record: zeroed at the tick's
    top, counted where each arc happens. The two engines of a
    :class:`~.disagg.DisaggServer` share one (the pair's sweep and both
    workers' ticks count into it)."""

    cancelled: int = 0
    deadline_expired: int = 0
    shed: int = 0
    forks: int = 0
    shared_blocks: int = 0        # ancestor blocks forks shared
    tree_branches: int = 0        # tree-family branches advanced
    branch_retired: int = 0       # tree-family branches retired
    prefix_hits: int = 0
    prefix_reused: int = 0        # prompt tokens the hits reused
    restored_blocks: int = 0      # host-tier blocks restored by hits
    spec_slots: int = 0           # slots a verify tick walked
    spec_proposed: int = 0
    spec_accepted: int = 0

    def zero(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)


@dataclasses.dataclass
class ServeReport:
    """One serve() run: per-request results plus aggregate accounting."""

    results: List[RequestResult]
    ticks: int
    wall_s: float
    tokens_generated: int
    mean_occupancy: float  # live slots per executed decode tick
    decode_ticks: int = 0  # ticks that decoded live slots
    steps: int = 0  # batched per-tick steps run (decode and mixed ticks)
    tbt_s: List[float] = dataclasses.field(default_factory=list)
    slo: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Prefix reuse over THIS run (hits, misses, tokens_reused, ...: the
    # cache's lifetime stats diffed over the serve() call); empty when off.
    prefix: Dict[str, Any] = dataclasses.field(default_factory=dict)
    kv: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Speculative decoding (drafter, draft_k, proposed/accepted draft
    # tokens, acceptance_rate, verify ticks); empty when off.
    spec: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Disaggregated serving (handoffs, blocks transferred, queue peak,
    # kv_bytes_moved, each worker's serialized tick seconds); empty for
    # one engine.
    handoff: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # Request-ledger aggregates of this run (``obs.aggregate_ledgers`` over
    # the results' ledgers); empty while the ledger is disarmed.
    requests: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def tokens_per_sec(self) -> float:
        return self.tokens_generated / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def outcomes(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.results:
            out[r.outcome] = out.get(r.outcome, 0) + 1
        return {k: out[k] for k in sorted(out)}

    def completion_percentiles(self) -> Dict[str, float]:
        cs = sorted(r.completion_s for r in self.results)
        return {"p50_s": percentile(cs, 0.50), "p95_s": percentile(cs, 0.95)}

    def latency_percentiles(self) -> Dict[str, float]:
        """TTFT (visible -> first token) and inter-token latency (pooled
        over slots); requests without a token are excluded."""
        ttft = sorted(r.ttft_s for r in self.results if r.tokens)
        tbt = sorted(self.tbt_s)
        return {
            "ttft_p50_s": percentile(ttft, 0.50),
            "ttft_p95_s": percentile(ttft, 0.95),
            "tbt_p50_s": percentile(tbt, 0.50),
            "tbt_p95_s": percentile(tbt, 0.95),
        }

    def as_dict(self) -> Dict[str, Any]:
        waits = sorted(r.queue_wait_s for r in self.results)
        return {
            "requests": len(self.results),
            "ticks": self.ticks,
            "wall_s": round(self.wall_s, 4),
            "tokens_generated": self.tokens_generated,
            "tokens_per_sec": round(self.tokens_per_sec, 1),
            "mean_occupancy": round(self.mean_occupancy, 2),
            "decode_ticks": self.decode_ticks,
            "steps": self.steps,
            "queue_wait_p50_s": round(waits[len(waits) // 2], 4) if waits else 0.0,
            "outcomes": self.outcomes,
            **{k: round(v, 4) for k, v in self.completion_percentiles().items()},
            **{k: round(v, 5) for k, v in self.latency_percentiles().items()},
            **({"slo": self.slo} if self.slo else {}),
            **({"prefix": self.prefix} if self.prefix else {}),
            **({"kv": self.kv} if self.kv else {}),
            **({"spec": self.spec} if self.spec else {}),
            **({"handoff": self.handoff} if self.handoff else {}),
            **({"request_ledgers": self.requests} if self.requests else {}),
        }


def synthetic_trace(
    n_requests: int,
    *,
    prompt_len: int = 32,
    prompt_jitter: int = 0,
    max_new_tokens: int = 16,
    arrival_every: int = 0,
    vocab_size: int = 256,
    seed: int = 0,
    eos_id: Optional[int] = None,
    prefix_share: float = 0.0,
    prefix_len: int = 0,
    prefix_count: int = 1,
    prefix_seed: Optional[int] = None,
    n: int = 1,
    best_of: int = 0,
    fork_at: int = 0,
) -> List[Request]:
    """A reproducible request trace — the JAX engine's generator, draw for
    draw, so both engines serve the same prompts: random prompts with
    ``+-prompt_jitter`` lengths, arrivals every ``arrival_every`` ticks, and
    optionally a ``prefix_share`` of requests starting with one of
    ``prefix_count`` shared ``prefix_len``-token prefixes. ``n`` /
    ``best_of`` / ``fork_at`` stamp the fork fields onto every request
    (``best_of`` and ``fork_at`` only when above 1 and 0)."""
    if not 0.0 <= prefix_share <= 1.0:
        raise ValueError(f"prefix_share must be in [0, 1], "
                         f"got {prefix_share}")
    rng = np.random.default_rng(seed)
    prefix_rng = rng if prefix_seed is None else \
        np.random.default_rng(prefix_seed)
    shared = [
        prefix_rng.integers(0, vocab_size,
                            size=max(prefix_len, 0)).astype(np.int32)
        for _ in range(max(prefix_count, 1))
    ] if prefix_share > 0.0 and prefix_len > 0 else []
    reqs = []
    n_shared = 0
    for i in range(n_requests):
        lo = max(1, prompt_len - prompt_jitter)
        hi = prompt_len + prompt_jitter
        plen = int(rng.integers(lo, hi + 1))
        if shared and rng.random() < prefix_share:
            p = min(prefix_len, plen - 1)
            prompt = np.concatenate([
                shared[n_shared % len(shared)][:p],
                rng.integers(0, vocab_size, size=plen - p).astype(np.int32),
            ])
            n_shared += 1
        else:
            prompt = rng.integers(0, vocab_size, size=plen).astype(np.int32)
        reqs.append(Request(
            uid=i, prompt=prompt, max_new_tokens=max_new_tokens,
            arrival_tick=i * arrival_every, eos_id=eos_id, n=max(n, 1),
            best_of=best_of if best_of > 1 else None,
            fork_at=fork_at if fork_at > 0 else None,
        ))
    return reqs


class RequestSource:
    """Where the tick loop gets its work: :meth:`poll` once per tick for
    newly visible requests, :meth:`next_arrival` to fast-forward across
    idle gaps, :meth:`wait` to block briefly when a live feeder has nothing
    yet (returning early when work arrives), :meth:`close` when draining.
    The base class is an empty, exhausted source;
    :class:`StaticRequestSource` wraps a fixed trace, and the ingress's
    ``QueueRequestSource`` is the thread-safe live feeder."""

    def poll(self, tick: int) -> List[Request]:
        return []

    def next_arrival(self) -> Optional[int]:
        return None

    def wait(self, timeout: float) -> bool:
        return False

    def close(self) -> None:
        """Stop producing new requests."""

    @property
    def exhausted(self) -> bool:
        return True


class StaticRequestSource(RequestSource):
    """A fixed trace, visible by ``arrival_tick``."""

    def __init__(self, requests: Sequence[Request]):
        self._reqs = sorted(requests, key=lambda r: (r.arrival_tick, r.uid))
        self._pos = 0

    def poll(self, tick: int) -> List[Request]:
        out: List[Request] = []
        while (self._pos < len(self._reqs)
               and self._reqs[self._pos].arrival_tick <= tick):
            out.append(self._reqs[self._pos])
            self._pos += 1
        return out

    def next_arrival(self) -> Optional[int]:
        if self._pos >= len(self._reqs):
            return None
        return self._reqs[self._pos].arrival_tick

    def close(self) -> None:
        self._pos = len(self._reqs)

    @property
    def exhausted(self) -> bool:
        return self._pos >= len(self._reqs)


class _TickOut(NamedTuple):
    """What one :meth:`SlotServer._tick` did, for its flight record."""

    plan: List[tuple]   # the tick's prompt chunks, (slot, n, last)
    occupancy: int      # live slots at the tick's top
    host_sync: bool     # the tick paid its one host fetch
    tokens: int         # tokens it emitted (first tokens included)


def _chunk_plan_rec(plan: List[tuple]) -> List[list]:
    """A tick's chunk plan as its flight record holds it."""
    return [[int(s), int(n), bool(last)] for s, n, last in plan]


class _Verify(NamedTuple):
    """A verify tick's extra operands (:meth:`SlotServer._step`)."""

    depth: Optional[np.ndarray]  # (S, Tq) RoPE offsets; None: no tree
    bits: Optional[np.ndarray]   # (S, Tq, Tq) ancestor masks; None: no tree
    ridx: np.ndarray             # (S, Tq) stream index each row predicts
    rows: np.ndarray             # (S, Tq) bool: the rows whose draw is kept
    dev0: np.ndarray             # (S,) bool: row 0 from the device tokens
    keys: Optional[np.ndarray] = None  # (S, Tq) per-row keys (tree slots)


def _bucket(n: int, cap: int, floor: int = 8, multiple: int = 1) -> int:
    """Pad a length up to a power-of-two bucket (a small fixed set of step
    shapes), rounded to ``multiple`` and capped at ``cap``."""
    b = floor
    while b < n:
        b *= 2
    b = -(-b // max(multiple, 1)) * max(multiple, 1)
    return min(b, cap)


class SlotServer:
    """Continuous-batching engine: S slots, a queue, one mixed step a tick.

    Args:
      params / cfg: the model served; the engine runs on the device the
        parameters live on.
      slots: batch size S — the max concurrent requests.
      cache_len: per-slot KV capacity; every request needs
        ``prompt_len + max_new_tokens <= cache_len``.
      temperature / top_k / seed: sampling defaults (temperature 0 =
        greedy); each request's key is derived from ``seed`` and the
        request's own ``seed`` (or uid), and its ``j``-th token is drawn
        under ``fold_in(key, j)``.
      prefill_chunk: max prompt tokens one tick writes for one slot.
      prefill_budget: max prompt tokens per tick over all prefilling slots
        (default ``slots * prefill_chunk``).
      slo_ttft / slo_tbt / slo_window: the SLO monitor's targets (s).
      kv_layout: ``"paged"`` (default) or ``"contiguous"``.
      kv_block: tokens per pool block (power of two, default 64).
      kv_blocks: pool capacity in blocks (default
        ``slots * ceil(cache_len / kv_block)``, the contiguous layout's
        bytes); a smaller pool over-subscribes — admissions wait for
        blocks, and a request that could never fit fails validation.
      quantize: serve from an int8 cache with staged admission (module
        docstring).
      quant_kernel: the q8 route of the decode ticks: ``"q8q"`` (B4/B5) or
        ``"q8"`` (the cast route over B1/B2). A sequence-sharded int8 pool
        always runs B2's cast route with per-block scales.
      mesh / kv_shard: ``kv_shard="seq"`` (paged layout only) shards the
        block pool over the mesh's ``seq`` axis: ``kv_blocks`` rounds up to
        a multiple of its size W and each rank's pool holds ``kv_blocks /
        W`` blocks. ``"replicated"`` (default) keeps the whole pool on every
        rank, which then computes alike without collectives.
      speculate: draft-and-verify speculative decoding (module docstring);
        not with a mesh yet.
      draft_k: max draft tokens per slot per verify tick (1..31: a tree
        mask packs into int32 bitmasks). One verify commits 1 to
        ``draft_k + 1`` tokens.
      drafter: ``"ngram"`` (default), ``"ngram-tree"``, or any
        :class:`~.speculation.Drafter` (e.g. ``DraftModelDrafter``).
      admission: ``"chunked"`` (default: prefill chunks ride the tick's
        step) or ``"whole"`` (blocking whole-prompt prefill at admission;
        module docstring).
      prefix_cache: reuse shared prompt prefixes (module docstring); not
        with a mesh yet.
      prefix_block: tokens per prefix block (a power of two, at most
        ``cache_len``). On the paged layout it is the pool's block:
        ``kv_block`` defaults to it and must equal it when given.
      prefix_pool_blocks: how many blocks the prefix tree may retain (paged:
        a cap inside the one pool, default none; contiguous: the size of
        its own pool, default 64).
      block_pool / prefix_index: serve from a caller's allocator (paged
        only; ``kv_blocks`` must agree with it) and a caller's
        :class:`PagedPrefixIndex` built over that same allocator at
        ``kv_block`` granularity.
      host_blocks: KV tiering: the host-RAM tier's capacity in blocks (0
        = off). Radix eviction then demotes refcount-0 blocks into pinned
        host memory instead of freeing them, and a prefix hit on a demoted
        path restores them (module docstring). Needs the paged layout and
        ``prefix_cache=True``; not with a shared ``prefix_index``.
      tree_sampling: decode a fork family that fits the tree rule as one
        token tree in ONE slot (default; module docstring). ``False`` runs
        every family on the fork-slot path: one slot per branch.
    """

    # False on engines that cannot expand fork families (the prefill worker
    # of a disaggregated pair: a family would need slots on both sides of
    # the handoff).
    _fork_ok = True

    def __init__(
        self,
        params: Params,
        cfg: TransformerConfig,
        *,
        slots: int,
        cache_len: int,
        temperature: float = 0.0,
        top_k: int = 0,
        seed: int = 0,
        prefill_chunk: int = 256,
        prefill_budget: Optional[int] = None,
        slo_ttft: float = 1.0,
        slo_tbt: float = 0.2,
        slo_window: int = 1024,
        kv_layout: str = "paged",
        kv_block: Optional[int] = None,
        kv_blocks: Optional[int] = None,
        quantize: bool = False,
        quant_kernel: str = "q8q",
        mesh: Optional[Mesh] = None,
        kv_shard: str = "replicated",
        speculate: bool = False,
        draft_k: int = 4,
        drafter: Union[str, Drafter, None] = None,
        admission: str = "chunked",
        prefix_cache: bool = False,
        prefix_block: int = 64,
        prefix_pool_blocks: Optional[int] = None,
        block_pool: Optional[BlockAllocator] = None,
        prefix_index: Optional[PagedPrefixIndex] = None,
        host_blocks: int = 0,
        tree_sampling: bool = True,
    ):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if admission not in ("chunked", "whole"):
            raise ValueError(
                f"admission must be 'chunked' or 'whole', got {admission!r}")
        if host_blocks < 0:
            raise ValueError(f"host_blocks must be >= 0, got {host_blocks}")
        if host_blocks and kv_layout != "paged":
            raise ValueError(
                "host_blocks KV tiering requires kv_layout='paged' (the "
                "tier demotes pool blocks; the contiguous layout has none)")
        if mesh is not None and (prefix_cache or prefix_index is not None):
            raise NotImplementedError(
                "the prefix cache on a mesh is a later slice of the port "
                "(ROADMAP queue A, item 2); serve it on one device")
        if block_pool is not None and kv_layout != "paged":
            raise ValueError(
                "block_pool sharing requires kv_layout='paged' (the "
                "contiguous layout has no block ledger to share)")
        if speculate and mesh is not None:
            raise ValueError(
                "speculate=True under a mesh is not ported yet (ROADMAP); "
                "serve speculation on one device")
        if speculate and not 1 <= draft_k <= 31:
            raise ValueError(
                f"draft_k must be in [1, 31] (int32 tree bitmasks), "
                f"got {draft_k}")
        if kv_layout not in ("paged", "contiguous"):
            raise ValueError(
                f"kv_layout must be 'paged' or 'contiguous', got {kv_layout!r}"
            )
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        if prefill_budget is not None and prefill_budget < 1:
            raise ValueError(f"prefill_budget must be >= 1, got {prefill_budget}")
        if temperature < 0:
            raise ValueError("temperature must be >= 0 (0 = greedy)")
        if top_k < 0:
            raise ValueError("top_k must be >= 0 (0 = off)")
        resolve_q8_kernel(quant_kernel)  # validates the name
        if kv_shard not in ("replicated", "seq"):
            raise ValueError(
                f"kv_shard must be 'replicated' or 'seq', got {kv_shard!r}")
        if kv_shard == "seq" and kv_layout != "paged":
            raise ValueError(
                "kv_shard='seq' shards the paged block pool; use "
                "kv_layout='paged'")
        if (mesh is not None and mesh.axis_size(AXIS_SEQ) > 1
                and kv_layout != "paged"):
            raise NotImplementedError(
                "a contiguous cache sharded over the seq axis is a later "
                "slice of the port (ROADMAP); serve a mesh from the paged "
                "layout")
        self.mesh = mesh
        self.kv_shard = kv_shard
        # Only the batched per-tick step runs on the sharded pool; the B=1
        # staging cache of int8 admission is whole on every rank.
        self._fs_kw = ({"mesh": mesh, "kv_shard": "seq"}
                       if kv_shard == "seq" else {})
        self._seq_shards = (mesh.axis_size(AXIS_SEQ)
                            if mesh is not None else 1)
        self.params = params
        self.cfg = cfg
        self.device = params["embed"].device
        self.slots = slots
        self.cache_len = cache_len
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)
        self.prefill_chunk = min(prefill_chunk, cache_len)
        self.prefill_budget = (slots * self.prefill_chunk
                               if prefill_budget is None else prefill_budget)
        self.kv_layout = kv_layout
        self.admission = admission
        self.quantize = quantize
        self.quant_kernel = quant_kernel
        self._paged = kv_layout == "paged"
        # KV tiering's host tier (created with the paged pool below; the
        # prefix index attaches to it).
        self._host_pool: Optional[HostBlockPool] = None
        if self._paged:
            if kv_block is None:
                # Match granularity == page size: a matched prefix is whole
                # table entries.
                kv_block = prefix_block if prefix_cache else 64
            elif prefix_cache and kv_block != prefix_block:
                raise ValueError(
                    f"paged layout: prefix_block ({prefix_block}) must "
                    f"equal kv_block ({kv_block}) — radix matching happens "
                    f"at page granularity (pass one of them, or equal "
                    f"values)")
            self.kv_block = kv_block
            self._npb = -(-cache_len // self.kv_block)  # table width
            self.kv_blocks = (slots * self._npb if kv_blocks is None
                              else kv_blocks)
            if block_pool is not None:
                # One ledger: this engine's capacity is the pool's.
                if kv_blocks is not None and kv_blocks != block_pool.blocks:
                    raise ValueError(
                        f"kv_blocks {kv_blocks} contradicts the shared "
                        f"block_pool's capacity {block_pool.blocks}")
                if kv_shard == "seq" and (
                        not isinstance(block_pool, ShardedBlockAllocator)
                        or block_pool.shards != self._seq_shards):
                    raise ValueError(
                        "kv_shard='seq' with a shared block_pool needs a "
                        f"ShardedBlockAllocator over {self._seq_shards} "
                        "shards (one placement rule)")
                self.kv_blocks = block_pool.blocks
                self._pool = block_pool
            elif kv_shard == "seq":
                # Round up to whole per-shard slices: extra blocks only
                # ever add capacity.
                w = self._seq_shards
                self.kv_blocks = -(-self.kv_blocks // w) * w
                self._pool = ShardedBlockAllocator(self.kv_blocks, w)
            else:
                self._pool = BlockAllocator(self.kv_blocks)
            if host_blocks:
                if prefix_index is not None:
                    raise ValueError(
                        "host_blocks tiering with a shared prefix_index: "
                        "build the index with its own host_pool instead "
                        "(the tier belongs to the shared tree, not one "
                        "engine)")
                if not prefix_cache:
                    raise ValueError(
                        "host_blocks KV tiering requires prefix_cache=True "
                        "(demotion is what radix eviction becomes; with no "
                        "radix tree nothing ever demotes)")
                self.attach_host_tier(HostBlockPool(
                    host_blocks, n_layers=cfg.n_layers,
                    n_kv_heads=cfg.n_kv_heads, block=self.kv_block,
                    d_head=cfg.d_head,
                    dtype=torch.int8 if quantize else cfg.dtype,
                    quantized=quantize,
                    pin_memory=self.device.type == "cuda"))
            self._host_table = np.zeros((slots, self._npb), np.int32)
            self._table_dirty = False
            self._slot_nblocks = [0] * slots
            self._slot_private: List[set] = [set() for _ in range(slots)]
            self._slot_reserve = [0] * slots
            self._peak_blocks_used = 0
            self._defer_gen = -1
            self.cache = init_paged_cache(cfg, slots, cache_len,
                                          self.kv_blocks, block=self.kv_block,
                                          device=self.device,
                                          quantize=quantize, mesh=mesh,
                                          kv_shard=kv_shard)
        else:
            self.cache = init_cache(cfg, slots, cache_len, device=self.device,
                                    quantize=quantize)
        # Staged int8 admission's one exact B=1 staging cache: chunked int8
        # admission and, with the prefix cache on, whole int8 admission,
        # whose hits and publishes need exact staged rows.
        if quantize and (admission == "chunked" or prefix_cache
                         or prefix_index is not None):
            self._staging: KVCache = init_cache(cfg, 1, cache_len,
                                                device=self.device)
        # Whole-prompt admission's B=1 prefill caches, one per prompt
        # bucket, allocated at the bucket's first admission and reused.
        self._whole_caches: Dict[int, KVCache] = {}

        # Prefix reuse: the radix tree and, per slot, the nodes it matched
        # or published (pinned until it retires), where its prefill starts
        # (the matched length) and the tokens its hit reused.
        self._prefix: Union[PagedPrefixIndex, PrefixCache, None] = None
        if prefix_index is not None:
            if not self._paged:
                raise ValueError("prefix_index sharing requires paged "
                                 "serving (kv_layout='paged')")
            if block_pool is None or prefix_index.alloc is not block_pool:
                raise ValueError("prefix_index must be built over the same "
                                 "shared block_pool (one ledger, one tree)")
            if prefix_index.block != self.kv_block:
                raise ValueError(
                    f"prefix_index block {prefix_index.block} must equal "
                    f"kv_block {self.kv_block} (radix matching happens at "
                    f"page granularity)")
            self._prefix = prefix_index
        elif prefix_cache:
            if prefix_block > cache_len:
                raise ValueError(f"prefix_block {prefix_block} exceeds "
                                 f"cache_len {cache_len}")
            if self._paged:
                self._prefix = PagedPrefixIndex(
                    block=self.kv_block, alloc=self._pool,
                    max_cached=prefix_pool_blocks,
                    host_pool=self._host_pool)
            else:
                self._prefix = PrefixCache(
                    cfg, block=prefix_block,
                    blocks=(64 if prefix_pool_blocks is None
                            else prefix_pool_blocks),
                    device=self.device)
        self._paged_prefix = isinstance(self._prefix, PagedPrefixIndex)
        self._slot_nodes: List[list] = [[] for _ in range(slots)]
        self._prefill_start: List[int] = [0] * slots
        self._slot_prefix_hit: List[int] = [0] * slots
        # Device KV bytes the hits moved: a contiguous hit's gather, an
        # int8 paged hit's dequantized rows; 0 for an exact paged hit.
        self._hit_bytes_moved = 0
        self._kv_token_bytes = (2 * cfg.n_layers * cfg.n_kv_heads
                                * cfg.d_head * cfg.dtype.itemsize)
        self._kv_token_bytes_q = 2 * cfg.n_layers * cfg.n_kv_heads \
            * cfg.d_head
        self.tok = torch.zeros((slots,), dtype=torch.int32, device=self.device)
        self._lp = torch.zeros((slots,), dtype=torch.float32,
                               device=self.device)
        self._temp_np = np.zeros((slots,), np.float32)
        self._topk_np = np.zeros((slots,), np.int32)
        self._keys = [0] * slots  # each slot's request key

        # Speculative decoding: the drafter, the per-slot committed-length
        # ledger (the rollback truth: the device length over-counts by the
        # rejected rows until the next step's reset) and token history
        # (filled incrementally: admit writes the prompt, every commit
        # appends its burst; history = buf[i, :len]).
        self._speculate = bool(speculate)
        self.draft_k = draft_k
        self._drafter: Optional[Drafter] = None
        if self._speculate:
            self._drafter = (make_drafter(drafter or "ngram")
                             if isinstance(drafter, str) or drafter is None
                             else drafter)
        # Verify chunks ride power-of-two Tq buckets that must fit the
        # cache's write window: at most min(32, cache_len) rows.
        cap = 1
        while cap * 2 <= min(32, cache_len):
            cap *= 2
        self._spec_rows_cap = cap
        # Tree masks need a mask-capable attention path: a sequence-sharded
        # pool (B2 ``local_blocks`` takes no tree mask) and an int8 pool
        # under a mesh fall back to chains, and their families to fork
        # slots, as in the JAX engine.
        self._tree_ok = not (self._seq_shards > 1
                             and (kv_layout == "contiguous" or quantize
                                  or kv_shard == "seq"))
        # Token-tree sibling families by slot (each also in _families, whose
        # join and best-of machinery they share) and their lifetime counts.
        self._tree_sampling = bool(tree_sampling)
        self._tree_fams: Dict[int, _ForkFamily] = {}
        self._tree_fams_life = 0
        self._tree_branches_life = 0
        self._tree_ticks = 0  # ticks that ran a sibling bundle
        # This tick's arcs for the flight record (shared with the other
        # engine of a disaggregated pair).
        self._tc = _TickCounts()
        self._slot_clen = [0] * slots
        self._hist_buf = np.zeros((slots, cache_len + 1), np.int32)
        self._hist_len = [0] * slots
        self._spec_proposed = 0   # lifetime draft tokens proposed
        self._spec_accepted = 0   # lifetime draft tokens accepted
        self._spec_ticks = 0      # ticks that verified >= 1 draft token
        self._spec_verifies = 0   # per-slot verify events with >= 1 draft
        self._spec_tree_ticks = 0  # verify ticks that ran a tree mask

        # Host mirror of slot state (the scheduler's view).
        self._slot_req: List[Optional[Request]] = [None] * slots
        self._slot_tokens: List[List[int]] = [[] for _ in range(slots)]
        self._slot_admit: List[tuple] = [(0, 0.0)] * slots
        self._slot_state: List[str] = ["free"] * slots
        self._slot_ttft: List[float] = [0.0] * slots
        self._slot_wait: List[float] = [0.0] * slots
        self._slot_max_tbt: List[float] = [0.0] * slots
        self._slot_cum_lp: List[float] = [0.0] * slots
        self._prefill_pos: List[int] = [0] * slots
        self._prompt_np: List[Optional[np.ndarray]] = [None] * slots
        self._prefill_fifo: List[int] = []
        self._last_tok_t: List[float] = [0.0] * slots
        self._tok_host = np.zeros((slots,), np.int32)
        self.slo = SLOMonitor(ttft_slo=slo_ttft, tbt_slo=slo_tbt,
                              window=slo_window)
        # Each in-flight request's trace span (admit -> retire; tracer on).
        self._slot_span: List[Optional[Any]] = [None] * slots
        # Control mailboxes, written from any thread (an ingress handler, a
        # signal handler) and swept by the tick loop at tick start.
        self._ctl_lock = threading.Lock()
        self._cancel_uids: Set[int] = set()
        self._draining = False
        # Copy-on-write forks: each slot's branch index and its shared
        # (refcounted) ancestor blocks, the live families by uid, the
        # one-shot device-length resets of freshly forked slots, the fork
        # mailbox and its carry (uid -> sweeps left), the next branch index
        # per uid, each family parent's stashed prompt-end logits, and the
        # lifetime fork counts.
        self._slot_index: List[int] = [0] * slots
        self._slot_shared: List[set] = [set() for _ in range(slots)]
        self._families: Dict[int, _ForkFamily] = {}
        self._live_reset: Dict[int, int] = {}
        self._fork_uids: List[int] = []
        self._fork_carry: Dict[int, int] = {}
        self._uid_next_index: Dict[int, int] = {}
        self._slot_logits: List[Optional[torch.Tensor]] = [None] * slots
        self._last_rows: Optional[torch.Tensor] = None
        self._forks_life = 0
        self._fork_shared_life = 0
        # The tick's trace span, and on a disaggregated prefill worker the
        # handoff queue: slots whose first token landed park there (state
        # ``handoff``) instead of going live.
        self._tick_name = "serving:tick"
        self._handoff: Optional[List[int]] = None

    # -- the per-tick program ---------------------------------------------

    def _chunk_bucket(self, n: int) -> int:
        """Tq bucket of a chunk of ``n`` prompt tokens: power of two from 8,
        capped at ``prefill_chunk``."""
        return _bucket(n, self.prefill_chunk, floor=min(8, self.prefill_chunk))

    def _step(self, tokens: torch.Tensor, n_vec: np.ndarray,
              reset: np.ndarray, reset_val: np.ndarray,
              emit: np.ndarray, verify: Optional[_Verify] = None
              ) -> torch.Tensor:
        """THE per-tick step: one mixed-Tq forward_step for every slot.

        Slot ``i`` consumes ``n_vec[i]`` rows of ``tokens`` ``(S, Tq)`` (1
        for a decode slot, a chunk for a prefilling slot, 0 = inert);
        ``reset`` first sets a slot's length to ``reset_val`` (0 for a
        first chunk — the slot reuses a retired slot's region). Each slot
        samples from its last valid row; ``emit`` keeps the sample (decode
        slots and final chunks), otherwise the slot's row-0 token and
        parked logprob ride through. Returns the ``(S, 2)`` int32 fetch
        vehicle: tokens and bitcast logprobs.

        ``verify`` makes it the verify tick of speculation: ``depth`` and
        ``bits`` (tree ticks only) give the rows RoPE positions ``length +
        depth`` and the ancestor mask, every row marked in ``rows`` (the
        draft rows and each emit slot's last row) is sampled under its
        stream index ``ridx`` in one :func:`sample_rows` pass, and
        the slots in ``dev0`` (a staged first token parked in the device
        token vector) keep that token in row 0. The fetch vehicle is then
        ``(S, 1 + Tq, 2)``: the token vector, then every row's draw — still
        one host fetch per tick."""
        S = self.slots
        ctrl = torch.from_numpy(np.stack(
            [n_vec, reset, reset_val, emit]).astype(np.int32)).to(self.device)
        n_t, reset_t, reset_val_t, emit_t = ctrl[0], ctrl[1] > 0, ctrl[2], \
            ctrl[3] > 0
        length = torch.where(reset_t, reset_val_t, self.cache.length)
        cache = dataclasses.replace(self.cache, length=length)
        kw = dict(self._fs_kw)
        if verify is not None and verify.dev0.any():
            dev0 = torch.from_numpy(verify.dev0).to(self.device)
            tokens = tokens.clone()
            tokens[:, 0] = torch.where(dev0, self.tok, tokens[:, 0])
        if verify is not None and verify.depth is not None:
            depth = torch.from_numpy(verify.depth).to(self.device)
            kw["positions"] = length.long()[:, None] + depth
            kw["tree_mask"] = torch.from_numpy(verify.bits).to(self.device)
        logits, self.cache = forward_step(self.params, tokens, cache,
                                          self.cfg, n_tokens=n_t,
                                          quant_kernel=self.quant_kernel,
                                          **kw)
        ar = torch.arange(S, device=self.device)
        row = (n_t - 1).clamp(min=0).long()
        # Each slot's last-row logits (a family parent's final chunk stashes
        # its row for the siblings' first draws).
        self._last_rows = logits[ar, row]
        if verify is None:
            sidx = np.asarray([len(t) for t in self._slot_tokens], np.int64)
            tok_s, lp_s = sample_slots(self._last_rows, self._temp_np,
                                       self._topk_np, self._keys, sidx, emit)
        else:
            # One sampling pass: the emit slots' last rows are marked in
            # ``rows`` beside the draft rows (and a tree slot's branch
            # tips, each under its branch's key).
            all_tok, all_lp = sample_rows(
                logits, self._temp_np, self._topk_np,
                self._keys if verify.keys is None else verify.keys,
                verify.ridx, verify.rows)
            tok_s, lp_s = all_tok[ar, row], all_lp[ar, row]
        self.tok = torch.where(emit_t, tok_s, tokens[:, 0].int())
        self._lp = torch.where(emit_t, lp_s, self._lp)
        fused = torch.stack([self.tok, self._lp.view(torch.int32)], 1)
        if verify is None:
            return fused
        rest = torch.stack([all_tok, all_lp.view(torch.int32)], -1)
        return torch.cat([fused[:, None], rest], 1)

    def _run_staged_chunk(self, slot: int, n: int, last: bool) -> None:
        """Staged admission (int8 caches): advance one slot's exact prefill
        in the staging cache by ``n`` tokens. The final chunk samples the
        slot's first token from its last row (parked in the token vector
        until the tick's fetch), zeroes the staging cache's stale tail,
        quantizes the prompt, inserts it into the slot and publishes its
        prefix. A prefix hit's staging already holds the matched rows: the
        first chunk starts the staged length there, and the paged insert
        leaves the shared blocks below it alone."""
        start = self._prefill_start[slot]
        first = self._prefill_pos[slot] == start
        plen = len(self._prompt_np[slot])
        mat = np.zeros((1, self._chunk_bucket(n)), np.int32)
        mat[0, :n] = self._consume_chunk(slot, n, last)
        staging = self._staging
        if first:
            staging = dataclasses.replace(staging,
                                          length=torch.full_like(
                                              staging.length, start))
        n_t = torch.tensor([n], dtype=torch.int32, device=self.device)
        logits, self._staging = forward_step(
            self.params, torch.from_numpy(mat).to(self.device), staging,
            self.cfg, n_tokens=n_t)
        if not last:
            return
        self._stash_logits(slot, logits[0, n - 1])
        tok, lp = sample_slots(logits[:, n - 1], self._temp_np[slot:slot + 1],
                               self._topk_np[slot:slot + 1],
                               self._keys[slot:slot + 1],
                               np.zeros((1,), np.int64), np.ones((1,), bool))
        self.tok[slot] = tok[0]
        self._lp[slot] = lp[0]
        valid = (torch.arange(self.cache_len, device=self.device)
                 < plen)[None, None, None, :, None]
        k = torch.where(valid, self._staging.k, 0)
        v = torch.where(valid, self._staging.v, 0)
        if self._paged:
            # The insert scatters the whole prompt: map its blocks first.
            self._ensure_blocks(slot, plen)
            self._sync_table()
            kq, vq, ks, vs = quantize_paged_blocks(k, v, self.kv_block)
            paged_insert_slot(self.cache, slot, kq, vq, plen, ks, vs,
                              lo=start, **self._fs_kw)
        else:
            qc = quantize_cache(KVCache(k=k, v=v,
                                        length=self._staging.length))
            for name in ("k", "v", "k_scale", "v_scale"):
                getattr(self.cache, name)[:, slot] = getattr(qc, name)[:, 0]
            self.cache.length[slot] = plen
        # The staging cache holds the prompt's exact rows: publish before
        # the next prompt overwrites them.
        self._publish_prefix(slot)

    # -- whole-prompt admission -------------------------------------------

    def _whole_suffix(self, slot: int, n: int, last: bool) -> None:
        """One suffix chunk of a whole-admission prefix hit: ``slot``
        consumes ``n`` prompt rows while every other slot rides inert. Their
        row 0 comes from the DEVICE token vector (an ``await`` slot's parked
        first token exists only there until the tick's fetch), so their
        tokens pass through. The first chunk resets the slot's length to
        the matched length (where the paged hit's table row meets the
        device); the final chunk samples the first token."""
        S = self.slots
        first = self._prefill_pos[slot] == self._prefill_start[slot]
        mat = np.zeros((S, self._chunk_bucket(n)), np.int32)
        mat[slot, :n] = self._consume_chunk(slot, n, last)
        n_vec = np.zeros((S,), np.int32)
        reset = np.zeros((S,), np.int32)
        reset_val = np.zeros((S,), np.int32)
        emit = np.zeros((S,), bool)
        n_vec[slot] = n
        reset[slot] = first
        reset_val[slot] = self._prefill_start[slot]
        emit[slot] = last
        others = torch.from_numpy(np.arange(S) != slot).to(self.device)
        tokens = torch.from_numpy(mat).to(self.device)
        tokens[:, 0] = torch.where(others, self.tok, tokens[:, 0])
        self._sync_table()
        self._step(tokens, n_vec, reset, reset_val, emit)
        if last:
            self._stash_logits(slot, self._last_rows[slot])

    def _whole_cache(self, bucket: int) -> KVCache:
        """The B=1 prefill cache of one prompt bucket: allocated at the
        bucket's first admission, then reused (its length reset)."""
        mini = self._whole_caches.get(bucket)
        if mini is None:
            cfg = self.cfg
            shape = (cfg.n_layers, 1, cfg.n_kv_heads, bucket, cfg.d_head)
            mini = self._whole_caches[bucket] = KVCache(
                k=torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                v=torch.zeros(shape, dtype=cfg.dtype, device=self.device),
                length=torch.zeros((1,), dtype=torch.int32,
                                   device=self.device))
        mini.length.zero_()
        return mini

    def _prefill(self, slot: int, prompt: np.ndarray) -> KVCache:
        """The cold whole prefill: the prompt, padded to its bucket, in
        one step over the bucket's B=1 cache. Pad rows at positions >=
        ``plen`` are zeroed in place after the step (every row was written
        by this step, the pad rows from pad tokens), so the insert and the
        int8 scales see an unpadded prefill. The first token is sampled
        from row ``plen - 1`` into the slot's entry of the device token
        vector: no host sync. Returns the filled cache."""
        plen = len(prompt)
        bucket = _bucket(plen, self.cache_len, multiple=self._seq_shards)
        mat = np.zeros((1, bucket), np.int32)
        mat[0, :plen] = prompt
        mini = self._whole_cache(bucket)
        logits, mini = forward_step(self.params,
                                    torch.from_numpy(mat).to(self.device),
                                    mini, self.cfg)
        mini.k[:, :, :, plen:] = 0
        mini.v[:, :, :, plen:] = 0
        self._stash_logits(slot, logits[0, plen - 1])
        tok, lp = sample_slots(logits[:, plen - 1],
                               self._temp_np[slot:slot + 1],
                               self._topk_np[slot:slot + 1],
                               self._keys[slot:slot + 1],
                               np.zeros((1,), np.int64), np.ones((1,), bool))
        self.tok[slot] = tok[0]
        self._lp[slot] = lp[0]
        return mini

    def _insert(self, slot: int, mini: KVCache, plen: int) -> None:
        """Place a filled B=1 prefill cache into the slot: through its
        table row (mapped over ``[0, plen)`` first) on the paged layout,
        into the slot's region on the contiguous one (rows past the bucket
        keep the previous occupant's bytes: masked future, overwritten
        before they become visible). Under int8 the rows are quantized per
        block (paged) or per channel (contiguous) first."""
        if self._paged:
            self._ensure_blocks(slot, plen)
            self._sync_table()
            if self.quantize:
                kq, vq, ks, vs = quantize_paged_blocks(mini.k, mini.v,
                                                       self.kv_block)
                paged_insert_slot(self.cache, slot, kq, vq, plen, ks, vs,
                                  **self._fs_kw)
            else:
                paged_insert_slot(self.cache, slot, mini.k, mini.v, plen,
                                  **self._fs_kw)
            return
        bucket = mini.k.shape[3]
        if self.quantize:
            mini = quantize_cache(mini)
            self.cache.k_scale[:, slot] = mini.k_scale[:, 0]
            self.cache.v_scale[:, slot] = mini.v_scale[:, 0]
        self.cache.k[:, slot, :, :bucket] = mini.k[:, 0]
        self.cache.v[:, slot, :, :bucket] = mini.v[:, 0]
        self.cache.length[slot] = plen

    def _admit_whole(self, req: Request, slot: int, matched: int) -> None:
        """Blocking admission: the whole remaining prompt prefills before
        the admission returns; the slot then parks in ``await``. Three
        shapes:

        - cold, exact (or int8 with the prefix cache off): :meth:`_prefill`
          on the bucket's B=1 cache, then :meth:`_insert`;
        - a prefix hit, exact: the hit already placed ``matched`` tokens
          (table row or gather), so only the suffix runs, as
          :meth:`_whole_suffix` chunks;
        - int8 with the prefix cache on (hit or cold): the staged path runs
          to completion — exact chunks into the staging cache, quantize and
          insert at the final chunk — since the hit and the publish need
          exact staged rows."""
        plen = len(req.prompt)
        if self.quantize and self._prefix is not None:
            pos = matched
            while pos < plen:
                n = min(self.prefill_chunk, plen - pos)
                self._run_staged_chunk(slot, n, pos + n == plen)
                pos += n  # the final chunk published from staging
            return
        if matched:
            pos = matched
            while pos < plen:
                n = min(self.prefill_chunk, plen - pos)
                self._ensure_blocks(slot, pos + n)
                self._whole_suffix(slot, n, pos + n == plen)
                pos += n
            self._publish_prefix(slot)
            return
        mini = self._prefill(slot, self._prompt_np[slot])
        self._insert(slot, mini, plen)
        self._publish_prefix(slot)

    # -- KV tiering -------------------------------------------------------

    def attach_host_tier(self, host_pool: HostBlockPool) -> None:
        """Make ``host_pool`` this engine's KV demotion tier and register
        the staged flush on the allocator (a dry allocation forces it)."""
        self._host_pool = host_pool
        self._pool.set_demote_flusher(self._flush_demotions)

    def _flush_demotions(self) -> int:
        """Complete every staged demotion: one gather of the pending
        device blocks (padded to a power-of-two count; pad entries gather
        block 0 and are ignored), one ``non_blocking`` copy into their
        pinned host rows per run of consecutive rows, then the device
        blocks free — every later write to them is queued on this stream,
        after the copy. Called at the end of each tick and after a drain,
        and by a dry allocator mid-tick. Nothing pending: no launch, no
        sync. Returns how many device blocks it freed."""
        hp = self._host_pool
        if hp is None or not hp.pending:
            return 0
        items = hp.take_pending()
        bids = [b for _, b in items]
        nb = _bucket(len(bids), max(self._npb, len(bids)), floor=1)
        ids = np.zeros((nb,), np.int64)
        ids[:len(bids)] = bids
        ids_t = torch.from_numpy(ids).to(self.device)
        if self.quantize:
            out = gather_kv_blocks(self.cache.k, self.cache.v, ids_t,
                                   self.cache.k_scale, self.cache.v_scale)
        else:
            out = gather_kv_blocks(self.cache.k, self.cache.v, ids_t)
        hp.commit([r for r, _ in items], *out)
        for b in bids:
            self._pool.free_demoted(b)
        if self._admitting:
            # A dry allocator forced this flush mid-admission: the admitting
            # request's ledger is charged.
            self._adm_demoted += len(bids)
        if obs.TRACER.active:
            obs.instant("kv_demote_flush", cat="serving",
                        args={"blocks": len(bids)})
        return len(bids)

    def _restore_demoted(self, slot: int, nodes: list) -> None:
        """Bring a pinned path's host-tier nodes back onto the device:
        still-pending demotions cancel in place (zero copies); flushed ones
        take fresh blocks from the slot's reservation and land through one
        batched H2D copy (pinned rows, padded to a power-of-two count) and
        one scatter, whose pad entries go to the drop block."""
        demoted = self._prefix.demoted_in(nodes)
        if not demoted:
            return
        # Either arc counts: each was a device miss the host tier absorbed.
        self._tc.restored_blocks += len(demoted)
        self._adm_restored += len(demoted)

        def take_one() -> int:
            assert self._slot_reserve[slot] > 0, (
                f"slot {slot} restore outgrew its block reservation")
            bid = self._pool.alloc()
            self._slot_reserve[slot] -= 1
            return bid

        rows, bids = self._prefix.restore_nodes(demoted, take_one)
        if rows:
            hp = self._host_pool
            nb = _bucket(len(bids), self._npb, floor=1)
            ids = np.full((nb,), self.kv_blocks, np.int64)  # pad: dropped
            ids[:len(bids)] = bids
            staged = [t.to(self.device, non_blocking=True)
                      for t in hp.read(rows, pad_to=nb)]
            ids_t = torch.from_numpy(ids).to(self.device)
            if self.quantize:
                scatter_kv_blocks(self.cache.k, self.cache.v, ids_t,
                                  staged[0], staged[1], self.cache.k_scale,
                                  self.cache.v_scale, staged[2], staged[3])
            else:
                scatter_kv_blocks(self.cache.k, self.cache.v, ids_t,
                                  staged[0], staged[1])
            for row in rows:
                hp.release(row, restored=True)

    # -- scheduler --------------------------------------------------------

    def _validate(self, req: Request) -> None:
        plen = len(req.prompt)
        if plen < 1:
            raise ValueError(f"request {req.uid}: empty prompt")
        if req.temperature is not None and req.temperature < 0:
            raise ValueError(f"request {req.uid}: temperature must be >= 0")
        if req.top_k is not None and req.top_k < 0:
            raise ValueError(f"request {req.uid}: top_k must be >= 0")
        if req.n < 1:
            raise ValueError(f"request {req.uid}: n must be >= 1")
        if req.best_of is not None and req.best_of > 1 and req.n != 1:
            raise ValueError(
                f"request {req.uid}: best_of runs server-side selection "
                f"and streams ONE winner — it requires n == 1")
        if req.fork_at is not None and req.fork_at < 1:
            raise ValueError(f"request {req.uid}: fork_at must be >= 1")
        branches = self._branches(req)
        if branches > 1:
            if not self._paged:
                raise ValueError(
                    f"request {req.uid}: n/best_of > 1 forks over shared "
                    f"KV blocks — it requires kv_layout='paged'")
            if self._speculate:
                raise ValueError(
                    f"request {req.uid}: n/best_of > 1 is not supported "
                    f"with speculate=True (fork branches are sampled; "
                    f"speculation is greedy-only)")
            if not self._fork_ok:
                raise ValueError(
                    f"request {req.uid}: n/best_of > 1 is not supported "
                    f"on this engine (disaggregated workers cannot "
                    f"expand fork families; mid-generation fork(uid) "
                    f"on the decode pool still works)")
            if branches > self.slots and not self._tree_sibling_ok(req):
                # A tree family decodes every branch in ONE slot; only the
                # fork-slot path needs a slot per branch.
                raise ValueError(
                    f"request {req.uid}: {branches} parallel branches "
                    f"exceed the engine's {self.slots} slots (the whole "
                    f"family decodes concurrently)")
        if req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.uid}: max_new_tokens must be >= 1, "
                f"got {req.max_new_tokens}"
            )
        if plen + req.max_new_tokens > self.cache_len:
            raise ValueError(
                f"request {req.uid}: prompt {plen} + max_new "
                f"{req.max_new_tokens} exceeds slot capacity {self.cache_len}"
            )
        if self._paged:
            need = -(-(plen + req.max_new_tokens) // self.kv_block)
            if need > self.kv_blocks:
                raise ValueError(
                    f"request {req.uid}: worst case needs {need} KV blocks "
                    f"(prompt {plen} + max_new {req.max_new_tokens} at "
                    f"--kv-block {self.kv_block}) but the --kv-blocks pool "
                    f"holds {self.kv_blocks}; raise --kv-blocks or shrink "
                    f"the request"
                )
            if branches > 1:
                if self._tree_sibling_ok(req):
                    # One slot's frozen ancestors plus every branch's
                    # replayed suffix.
                    fam = -(-self._tree_span(req) // self.kv_block)
                else:
                    # Each sibling's worst case is its NEW blocks only:
                    # everything below the fork point is shared.
                    fam = need + (branches - 1) * (
                        need - (plen - 1) // self.kv_block)
                if fam > self.kv_blocks:
                    raise ValueError(
                        f"request {req.uid}: a {branches}-branch family "
                        f"worst-cases at {fam} KV blocks (shared ancestors "
                        f"counted once) but the pool holds "
                        f"{self.kv_blocks}; raise --kv-blocks or shrink "
                        f"the request")

    @staticmethod
    def _branches(req: Request) -> int:
        """How many completions ``req`` fans out to: ``best_of`` when
        server-side selection is on, else ``n``; at least 1."""
        bo = req.best_of if req.best_of is not None else 0
        return max(int(req.n), int(bo), 1)

    def _tree_span(self, req: Request) -> int:
        """Worst-case token span of an admission tree family: the frozen
        prompt rows plus every branch's full replayed suffix (each grows
        to ``max_new - 1`` rows before its last token retires it), at
        least the plain span the slot needs after a collapse to one
        survivor."""
        k = self._branches(req)
        plen = len(req.prompt)
        return max(plen + k * (req.max_new_tokens - 1),
                   plen + req.max_new_tokens)

    def _tree_sibling_ok(self, req: Request) -> bool:
        """Whether this ``n > 1`` / best-of request decodes as a token
        tree in ONE slot: the tree path is on, the pool is paged, the
        engine neither speculates nor forbids families, the attention path
        takes a tree mask, and the family's worst-case bundle fits both the
        int32 bitmask's rows (``k * (max_new - 1) <= 32``) and the slot's
        window. Otherwise the family runs the fork-slot path."""
        k = self._branches(req)
        if k <= 1 or not self._tree_sampling or not self._paged:
            return False
        if self._speculate or not self._tree_ok or not self._fork_ok:
            return False
        rows = k * (req.max_new_tokens - 1)
        if rows > self._spec_rows_cap:
            return False
        return len(req.prompt) + rows <= self.cache_len

    def _paged_reserve(self, req: Request) -> Optional[tuple]:
        """Match the prompt (pinning the path) and reserve the admission's
        worst-case private blocks: its whole span less the matched
        device-tier blocks it shares. A fork family reserves ATOMICALLY:
        the parent's blocks plus each sibling's worst-case new blocks (its
        span less the full blocks below the prompt's last row), so the
        siblings' forks never fail and two half-reserved families never
        deadlock the pool. ``None`` defers the admission (the pins are
        released); otherwise ``(matched, nodes, needed, fam_extra)``, the
        match recorded; the family holds ``fam_extra`` until its forks
        consume it."""
        total = -(-(len(req.prompt) + req.max_new_tokens) // self.kv_block)
        matched, nodes = 0, []
        if self._paged_prefix:
            matched, nodes = self._prefix.match(
                np.asarray(req.prompt, np.int32), record=False)
        # A matched node on the host tier still costs one reservation: its
        # restore takes a fresh device block (consumed in _paged_hit).
        branches = self._branches(req)
        fam_extra = 0
        if branches > 1:
            if self._tree_sibling_ok(req):
                # A tree family: ONE slot holds the whole family; its
                # reservation is the packed window's worst case.
                total = -(-self._tree_span(req) // self.kv_block)
            else:
                sib = total - (len(req.prompt) - 1) // self.kv_block
                fam_extra = (branches - 1) * sib
        needed = total - sum(1 for n in nodes if n.tier == TIER_DEVICE)
        if not self._pool.reserve(needed + fam_extra):
            if nodes:
                self._prefix.release(nodes)
            return None
        if self._paged_prefix:
            self._prefix.record_match(matched)
        return matched, nodes, needed, fam_extra

    def _ensure_blocks(self, slot: int, tokens_needed: int) -> None:
        """Map blocks covering ``[0, tokens_needed)`` of ``slot`` — before
        every step that writes the slot (backed by its reservation)."""
        if not self._paged:
            return
        need = -(-tokens_needed // self.kv_block)
        grew = self._slot_nblocks[slot] < need
        while self._slot_nblocks[slot] < need:
            assert self._slot_reserve[slot] > 0, (
                f"slot {slot} outgrew its block reservation"
            )
            bid = self._pool.alloc()
            self._slot_reserve[slot] -= 1
            self._host_table[slot, self._slot_nblocks[slot]] = bid
            self._slot_private[slot].add(bid)
            self._slot_nblocks[slot] += 1
            self._table_dirty = True
        if grew and obs.REQLOG.enabled:
            # The ledger integrates block-seconds at each block boundary.
            rq = self._slot_req[slot]
            if rq is not None:
                obs.REQLOG.blocks(rq.uid, self._slot_nblocks[slot])

    def _sync_table(self) -> None:
        """Push the host block table to the device when it changed."""
        if self._paged and self._table_dirty:
            self.cache.table.copy_(torch.from_numpy(self._host_table))
            self._table_dirty = False

    # The admission's host-tier attribution for the request ledger: blocks
    # its paged hit restored, demotions a dry allocator flushed while it
    # ran; folded into the ledger when it opens.
    _admitting = False
    _adm_restored = 0
    _adm_demoted = 0

    def _admit(self, req: Request, slot: int, tick: int, visible_at: float,
               resv: Optional[tuple]) -> None:
        waited = max(time.monotonic() - visible_at, 0.0)
        self._admitting = True
        self._adm_restored = 0
        self._adm_demoted = 0
        self._slot_req[slot] = req
        self._slot_tokens[slot] = []
        self._slot_admit[slot] = (tick, visible_at)
        self._slot_max_tbt[slot] = 0.0
        self._slot_ttft[slot] = 0.0
        self._slot_wait[slot] = waited
        self._slot_cum_lp[slot] = 0.0
        self._temp_np[slot] = (self.temperature if req.temperature is None
                               else req.temperature)
        self._topk_np[slot] = self.top_k if req.top_k is None else req.top_k
        self._keys[slot] = self._branch_key(req, 0)
        self._slot_index[slot] = 0
        self._slot_shared[slot] = set()
        self._slot_logits[slot] = None
        self.slo.observe_queue_wait(waited)
        self._prompt_np[slot] = np.asarray(req.prompt, np.int32)
        if self._speculate:
            plen = len(self._prompt_np[slot])
            self._hist_buf[slot, :plen] = self._prompt_np[slot]
            self._hist_len[slot] = plen
        if self._paged:
            # _paged_reserve took the reservation (and pinned the matched
            # path); the slot owns both now.
            self._slot_reserve[slot] = resv[2]
            self._slot_private[slot] = set()
            self._slot_nblocks[slot] = 0
        # Prefix reuse comes first: the matched length is where the
        # prefill starts.
        if self._paged_prefix:
            matched = self._paged_hit(slot, resv)
        else:
            matched = self._prefix_admit(slot)
        self._prefill_start[slot] = matched
        self._prefill_pos[slot] = matched
        self._slot_prefix_hit[slot] = matched
        if obs.REQLOG.enabled:
            obs.REQLOG.open(
                req.uid,
                trace_id=req.trace[0] if req.trace else "",
                span_id=obs.new_span_id(),
                parent_span_id=req.trace[1] if req.trace else "",
                prompt_tokens=len(req.prompt),
                prefix_hit_tokens=matched,
                arrival_tick=req.arrival_tick,
                admit_tick=tick,
                queue_wait_s=waited,
                nblocks=self._slot_nblocks[slot] if self._paged else 0,
            )
            if self._adm_restored or self._adm_demoted:
                obs.REQLOG.note(req.uid, host_restores=self._adm_restored,
                                host_demotes=self._adm_demoted)
        self._admitting = False
        if self.admission == "chunked":
            self._slot_state[slot] = "prefill"
            self._prefill_fifo.append(slot)
        else:
            self._admit_whole(req, slot, matched)
            # The first token is parked in the device token vector; the slot
            # sits out this tick's step (n = 0 holds it) and goes live when
            # the tick's one host fetch reads it: no sync per admission.
            self._slot_state[slot] = "await"
        if obs.REGISTRY.enabled:
            _QUEUE_WAIT.observe(waited)
        if obs.TRACER.active:
            # The request's life as one span (admit -> retire), and the
            # step point of its flow from the ingress.
            self._slot_span[slot] = obs.span(
                f"request:{req.uid}", cat="serving", args={
                    "rid": req.uid, "slot": slot, "admit_tick": tick,
                    "prompt_len": len(req.prompt),
                    "queue_wait_s": round(waited, 6),
                    **({"prefix_hit_len": matched}
                       if self._prefix is not None else {}),
                    **({"trace_id": req.trace[0]} if req.trace else {}),
                })
            if req.trace is not None:
                obs.flow("t", obs.flow_id(req.trace[0]))

    def _prefix_admit(self, slot: int) -> int:
        """The contiguous hit: match the prompt (pinned until retire) and
        gather the matched rows into the batch slot, or into the staging
        cache under int8 (pool rows are exact; the final chunk quantizes).
        Returns the matched token count (0: the cache off, or cold)."""
        if self._prefix is None:
            return 0
        matched, nodes = self._prefix.match(self._prompt_np[slot])
        self._slot_nodes[slot] = nodes
        if not matched:
            return 0
        if self.quantize:
            self._prefix.copy_into(self._staging, 0, nodes, matched)
        else:
            self._prefix.copy_into(self.cache, slot, nodes, matched)
        self._hit_bytes_moved += matched * self._kv_token_bytes
        self._tc.prefix_hits += 1
        self._tc.prefix_reused += matched
        return matched

    def _paged_hit(self, slot: int, resv: tuple) -> int:
        """The paged hit: demoted nodes of the matched path are restored
        first (KV tiering); then the path's block ids go into the slot's
        table row — host bookkeeping, zero device KV bytes on the exact
        pool (the device sees the new int32 row at the next sync). Under
        int8 the matched blocks are also dequantized into staging slot 0,
        so the suffix's exact staged chunks attend them; re-quantizing
        would reproduce their bytes, and the final insert leaves them
        alone. The bucket cap is floor-div: the window ``nb * kv_block``
        must fit the staging cache, and a match is at most ``(cache_len -
        1) // kv_block`` blocks."""
        matched, nodes = resv[0], resv[1]
        self._slot_nodes[slot] = nodes
        if not matched:
            return 0
        if self._host_pool is not None:
            # Demoted path nodes come back first (their bytes are the
            # admission's restore cost).
            self._restore_demoted(slot, nodes)
        for j, node in enumerate(nodes):
            self._host_table[slot, j] = node.block_id
        self._slot_nblocks[slot] = len(nodes)
        self._table_dirty = True
        if self.quantize:
            nb = _bucket(len(nodes), self.cache_len // self.kv_block,
                         floor=1)
            ids = np.zeros((nb,), np.int64)
            ids[:len(nodes)] = [n.block_id for n in nodes]
            insert_dequant_prefix(
                self._staging, self.cache.k, self.cache.v,
                self.cache.k_scale, self.cache.v_scale,
                torch.from_numpy(ids), matched)
            self._hit_bytes_moved += matched * self._kv_token_bytes_q
        self._tc.prefix_hits += 1
        self._tc.prefix_reused += matched
        return matched

    def _publish_prefix(self, slot: int) -> None:
        """At final-chunk completion: publish the prompt's whole blocks
        and swap the slot's pinned path for the published one. The paged
        index adopts the slot's private prompt blocks (ownership moves to
        the tree; table and bytes stay, exact and int8 alike). The
        contiguous pool takes a scatter of the new blocks' exact rows: from
        the batch slot, or from the staging cache under int8."""
        if self._prefix is None:
            return
        prompt = self._prompt_np[slot]
        if self._paged_prefix:
            private = self._slot_private[slot]
            phys = {j: int(self._host_table[slot, j])
                    for j in range(len(prompt) // self.kv_block)
                    if int(self._host_table[slot, j]) in private}
            path, adopted = self._prefix.adopt(prompt, phys,
                                               self._slot_nodes[slot])
            for j in adopted:
                private.discard(int(self._host_table[slot, j]))
            # The admission's pins carried over into ``path``.
            self._slot_nodes[slot] = path
            return
        path, new_ids, start = self._prefix.insert(prompt)
        if new_ids:
            src, src_slot = ((self._staging, 0) if self.quantize
                             else (self.cache, slot))
            self._prefix.publish_from(src, src_slot, new_ids, start)
        # Insert pinned the whole path; only then drop the admission's pins
        # (a matched node at refcount 0 could be evicted by the insert).
        self._prefix.release(self._slot_nodes[slot])
        self._slot_nodes[slot] = path

    def prefix_stats(self) -> Dict[str, Any]:
        """The prefix cache's lifetime counters (hits, misses,
        tokens_reused, ...); empty when the cache is off."""
        return {} if self._prefix is None else dict(self._prefix.stats())

    def _plan_chunks(self, max_n: Optional[int] = None) -> List[tuple]:
        """Budget pass: FIFO over prefilling slots, each taking up to a
        chunk (at most ``max_n`` rows when given), at most
        ``prefill_budget`` prompt tokens in all. Returns ``(slot, n,
        is_final)`` triples."""
        plan = []
        budget = self.prefill_budget
        chunk = (self.prefill_chunk if max_n is None
                 else min(self.prefill_chunk, max_n))
        for slot in self._prefill_fifo:
            if budget <= 0:
                break
            pos = self._prefill_pos[slot]
            n = min(chunk, len(self._prompt_np[slot]) - pos, budget)
            if n <= 0:
                continue
            budget -= n
            plan.append((slot, n, pos + n == len(self._prompt_np[slot])))
        return plan

    def _consume_chunk(self, slot: int, n: int, last: bool) -> np.ndarray:
        """Host bookkeeping of one scheduled chunk: its prompt rows, the
        slot's advanced position, ``await`` after the final chunk."""
        pos = self._prefill_pos[slot]
        rows = self._prompt_np[slot][pos:pos + n]
        self._prefill_pos[slot] = pos + n
        if last:
            self._slot_state[slot] = "await"
            if slot in self._prefill_fifo:  # whole admission never enqueues
                self._prefill_fifo.remove(slot)
        if obs.REGISTRY.enabled:
            _PREFILL_CHUNKS.inc()
        return rows

    # -- copy-on-write forks ----------------------------------------------

    def _branch_key(self, req: Request, index: int) -> int:
        """Branch ``index``'s sampling key: the request's key (from the
        engine seed and the request's ``seed``, or its uid) for branch 0 —
        a family's branch 0 is the plain stream of the same request — and
        ``fold_in(key, index)`` for every other branch. Draw ``j`` of a
        branch is then keyed ``fold_in(branch key, j)``."""
        salt = req.seed if req.seed is not None else req.uid
        key = (self.seed * 1_000_003 + salt) & 0x7FFF_FFFF_FFFF_FFFF
        return key if index == 0 else fold_in(key, index)

    def _stash_logits(self, slot: int, row: torch.Tensor) -> None:
        """Keep a family parent's prompt-end logits ``(V,)`` until its
        siblings fork: each draws its first token from them."""
        req = self._slot_req[slot]
        if req is not None and req.uid in self._families:
            self._slot_logits[slot] = row.clone()

    def _admit_family(self, req: Request, parent_slot: int,
                      free: List[int], resv: tuple) -> None:
        """Take the rest of an ``n > 1`` / best-of-n family at admission:
        one ``fpend`` slot per sibling, taken now, and the block hold
        :meth:`_paged_reserve` already took. The siblings fork in the
        awaits pass of the tick the parent's first token lands."""
        branches = self._branches(req)
        fam_extra = resv[3]
        sibs = [free.pop(0) for _ in range(branches - 1)]
        for s in sibs:
            self._slot_state[s] = "fpend"
        self._families[req.uid] = _ForkFamily(
            req=req, parent_slot=parent_slot, sibling_slots=sibs,
            sib_reserve=fam_extra // (branches - 1), hold=fam_extra,
            best_of=bool(req.best_of and req.best_of > 1),
            branches=branches)
        self._uid_next_index[req.uid] = branches

    def _fork_family(self, fam: _ForkFamily, parent_slot: int, tick: int,
                     now2: float, results) -> int:
        """Fork every reserved sibling off the parent whose first token
        just landed — before the parent's EOS check. Each sibling's block
        budget moves from the family hold to its slot; each sibling's first
        token (drawn from the parent's stashed logits) surfaces through ONE
        extra fetch per family, and the sibling goes live like a final
        chunk's slot, EOS and budget checks included. Returns the first
        tokens emitted."""
        req = fam.req
        for j, child in enumerate(fam.sibling_slots):
            self._fork_child(parent_slot, child, 1 + j, [], fam.sib_reserve,
                             tick)
            fam.hold -= fam.sib_reserve
        fam.forked = True
        self._slot_logits[parent_slot] = None
        # The family's one extra fetch: the siblings' first tokens and
        # their log-probabilities.
        fh = torch.stack([self.tok, self._lp.view(torch.int32)],
                         1).cpu().numpy()
        tok_h = fh[:, 0]
        lp_h = np.ascontiguousarray(fh[:, 1]).view(np.float32)
        emitted = 0
        for j, child in enumerate(fam.sibling_slots):
            t0 = int(tok_h[child])
            self._tok_host[child] = t0
            self._slot_tokens[child] = [t0]
            self._slot_cum_lp[child] = float(lp_h[child])
            self._slot_state[child] = "live"
            self._slot_clen[child] = len(self._prompt_np[child])
            self._push_token(req, t0, 1 + j)
            _, vis = self._slot_admit[child]
            self._slot_ttft[child] = max(now2 - vis, 0.0)
            self._last_tok_t[child] = now2
            emitted += 1
            self.slo.observe_ttft(self._slot_ttft[child])
            if obs.REGISTRY.enabled:
                _TOKENS.inc()
                _TTFT.observe(self._slot_ttft[child])
            if obs.TRACER.active:
                obs.instant("first_token", cat="serving", args={
                    "rid": req.uid, "slot": child, "tick": tick,
                    "index": 1 + j,
                    "ttft_s": round(self._slot_ttft[child], 6)})
            if req.eos_id is not None and t0 == req.eos_id:
                self._retire(child, tick, OUTCOME_EOS, results)
            elif req.max_new_tokens <= 1:
                self._retire(child, tick, OUTCOME_BUDGET, results)
        return emitted

    def _fork_child(self, parent_slot: int, child_slot: int, index: int,
                    tokens_prefix: List[int], resv_blocks: int,
                    tick: int) -> None:
        """THE copy-on-write fork: give ``child_slot`` the parent's history
        up to the fork point by SHARING every full ancestor block —
        radix-cached ones take one more pin, parent-private ones move into
        the allocator's refcounted shared state on both sides — and
        copying ONLY the partial tail block (:func:`copy_pool_block`,
        queued on the engine's stream before any step that reads the
        child's table row; none when the fork point is block-aligned).

        - An admission sibling (``tokens_prefix == []``): the fork point is
          the prompt's end; the child's first token is drawn from the
          parent's stashed prompt-end logits under the child's key and
          parked in the device vectors (state ``await``).
        - A mid-stream branch (``tokens_prefix`` = the parent's emitted
          tokens): the fork point is the last committed row; parent and
          child both consume the shared tip next, each into its own block,
          and draw their next tokens under their own keys.

        ``resv_blocks`` is the child's worst-case new-block budget, already
        reserved by the caller. The child's device length is reset to the
        fork point at its first consuming tick."""
        req = self._slot_req[parent_slot]
        prompt = self._prompt_np[parent_slot]
        plen = len(prompt)
        if tokens_prefix:
            tip = int(tokens_prefix[-1])
            L = plen + len(tokens_prefix) - 1
        else:
            tip = 0  # the sibling's own first draw replaces it
            L = plen
        B = self.kv_block
        nshare = L // B
        # Shared ancestors, radix tier first: the child pins the parent's
        # matched or published path like a second admission...
        pnodes = self._slot_nodes[parent_slot]
        n_pin = min(nshare, len(pnodes))
        self._slot_nodes[child_slot] = (self._prefix.repin(pnodes[:n_pin])
                                        if n_pin else [])
        # ... then the refcount for the rest (the parent's private decode
        # blocks, or its prompt blocks when the prefix cache is off).
        share_bids = [int(self._host_table[parent_slot, j])
                      for j in range(n_pin, nshare)]
        self._slot_shared[child_slot] = set(self._pool.fork_shared(
            share_bids))
        for bid in share_bids:
            self._slot_private[parent_slot].discard(bid)
            self._slot_shared[parent_slot].add(bid)
        self._host_table[child_slot, :nshare] = \
            self._host_table[parent_slot, :nshare]
        self._host_table[child_slot, nshare:] = 0
        self._slot_reserve[child_slot] = resv_blocks
        self._slot_private[child_slot] = set()
        self._slot_nblocks[child_slot] = nshare
        need_copy = L % B != 0
        if need_copy:
            src = int(self._host_table[parent_slot, nshare])
            assert self._slot_reserve[child_slot] > 0, (
                f"fork into slot {child_slot} outgrew its reservation")
            dst = self._pool.alloc()
            self._slot_reserve[child_slot] -= 1
            self._host_table[child_slot, nshare] = dst
            self._slot_private[child_slot].add(dst)
            self._slot_nblocks[child_slot] = nshare + 1
            self.cache = copy_pool_block(self.cache, src, dst,
                                         **self._fs_kw)
        self._table_dirty = True
        self._keys[child_slot] = self._branch_key(req, index)
        # Host mirrors: from here the child is an ordinary slot.
        self._slot_req[child_slot] = req
        self._slot_index[child_slot] = index
        self._slot_tokens[child_slot] = list(tokens_prefix)
        self._prompt_np[child_slot] = prompt
        self._slot_admit[child_slot] = self._slot_admit[parent_slot]
        self._slot_wait[child_slot] = self._slot_wait[parent_slot]
        self._slot_ttft[child_slot] = (self._slot_ttft[parent_slot]
                                       if tokens_prefix else 0.0)
        self._slot_max_tbt[child_slot] = 0.0
        self._slot_prefix_hit[child_slot] = nshare * B
        self._slot_cum_lp[child_slot] = (self._slot_cum_lp[parent_slot]
                                         if tokens_prefix else 0.0)
        self._temp_np[child_slot] = self._temp_np[parent_slot]
        self._topk_np[child_slot] = self._topk_np[parent_slot]
        self._prefill_start[child_slot] = self._prefill_pos[child_slot] = 0
        self._slot_clen[child_slot] = L
        self._live_reset[child_slot] = L
        self._last_tok_t[child_slot] = self._last_tok_t[parent_slot]
        if tokens_prefix:
            # Mid-stream branch: live at once; its next tick re-consumes
            # the shared tip (parked host- and device-side).
            self._slot_state[child_slot] = "live"
            self._tok_host[child_slot] = tip
            self.tok[child_slot] = tip
        else:
            # Admission sibling: its own first draw from the parent's
            # prompt-end logits, parked in the device vectors.
            row = self._slot_logits[parent_slot]
            assert row is not None, "fork family lost its logits stash"
            tok, lp = sample_slots(
                row[None], self._temp_np[child_slot:child_slot + 1],
                self._topk_np[child_slot:child_slot + 1],
                self._keys[child_slot:child_slot + 1],
                np.zeros((1,), np.int64), np.ones((1,), bool))
            self.tok[child_slot] = tok[0]
            self._lp[child_slot] = lp[0]
            self._slot_state[child_slot] = "await"
        if obs.TRACER.active:
            self._slot_span[child_slot] = obs.span(
                f"request:{req.uid}", cat="serving", args={
                    "rid": req.uid, "slot": child_slot, "admit_tick": tick,
                    "prompt_len": plen, "index": index,
                    "fork_of_slot": parent_slot})
            obs.instant("fork", cat="serving", args={
                "rid": req.uid, "tick": tick, "parent_slot": parent_slot,
                "child_slot": child_slot, "index": index,
                "shared_blocks": nshare, "copied_blocks": int(need_copy),
                "at_tokens": len(tokens_prefix)})
        self._forks_life += 1
        self._fork_shared_life += nshare
        self._tc.forks += 1
        self._tc.shared_blocks += nshare
        if obs.REGISTRY.enabled:
            _FORKS.inc()
            if nshare:
                _FORK_SHARED.inc(nshare)
        if obs.REQLOG.enabled and nshare:
            obs.REQLOG.note(req.uid, fork_shared_blocks=nshare)

    def _fork_live(self, uid: int, tick: int, pend_uids: Set[int]) -> str:
        """One mailboxed ``fork(uid)``: branch the request's lowest-index
        live slot onto a free slot. Returns ``"done"`` (forked, or a no-op
        for an unknown or finished uid), ``"wait"`` (the request is queued,
        prefilling or awaiting its first token: not forkable yet) or
        ``"retry"`` (no free slot or blocks)."""
        if self._speculate or not self._paged:
            log.warning("fork(%d) ignored: forking needs a paged, "
                        "non-speculative engine", uid)
            return "done"
        parent = None
        for i, rq in enumerate(self._slot_req):
            if rq is None or rq.uid != uid:
                continue
            if self._slot_state[i] != "live":
                return "wait"
            if parent is None \
                    or self._slot_index[i] < self._slot_index[parent]:
                parent = i
        if parent is None:
            return "wait" if uid in pend_uids else "done"
        req = self._slot_req[parent]
        toks = self._slot_tokens[parent]
        if len(toks) >= req.max_new_tokens:
            return "done"  # retiring this tick: nothing left to branch
        if parent in self._tree_fams:
            log.warning("fork(%d) ignored: the slot already decodes a token "
                        "tree (one conversion per request)", uid)
            return "done"
        t = len(toks)
        if (self._tree_sampling and self._tree_ok and self._fork_ok
                and req.uid not in self._families
                and 2 * (req.max_new_tokens - t) <= self._spec_rows_cap
                and len(self._prompt_np[parent]) + t - 1
                + 2 * (req.max_new_tokens - t) <= self.cache_len):
            # Tree conversion: both continuations share the slot — no new
            # slot, no copied block.
            return self._tree_convert_live(parent, uid, tick)
        free = [i for i, st in enumerate(self._slot_state) if st == "free"]
        if not free:
            return "retry"
        L = len(self._prompt_np[parent]) + max(len(toks) - 1, 0)
        need = (-(-(len(req.prompt) + req.max_new_tokens) // self.kv_block)
                - L // self.kv_block)
        if not self._pool.reserve(need):
            return "retry"
        idx = self._uid_next_index.get(uid, self._branches(req))
        self._uid_next_index[uid] = idx + 1
        self._fork_child(parent, free[0], idx, list(toks), need, tick)
        return "done"

    def _apply_forks(self, forks: List[int], tick: int, pending) -> None:
        """The control sweep's fork arc: apply mailboxed forks and retry
        deferred ones. A fork whose request exists but is not live yet
        ("wait") stays carried at full TTL; scarcity ("retry") burns one
        of 3 tries per sweep, then the fork expires; unknown uids age out
        as no-ops."""
        for uid in forks:
            if uid not in self._fork_carry:
                self._fork_carry[uid] = 3
        pend_uids = {r.uid for r in pending}
        for uid in list(self._fork_carry):
            verdict = self._fork_live(uid, tick, pend_uids)
            if verdict == "done":
                self._fork_carry.pop(uid, None)
            elif verdict == "wait":
                self._fork_carry[uid] = 3
            else:
                self._fork_carry[uid] -= 1
                if self._fork_carry[uid] <= 0:
                    del self._fork_carry[uid]
                    log.warning("fork(%d) expired unserved (slots/blocks "
                                "stayed scarce)", uid)

    def _family_branch_done(self, fam: _ForkFamily,
                            result: RequestResult) -> None:
        """A branch retired: collect it; the LAST one joins the family
        (best-of-n then streams its winner)."""
        fam.done.append(result)
        if len(fam.done) >= fam.branches:
            self._families.pop(fam.req.uid, None)
            if fam.best_of:
                self._emit_best_of(fam)

    def _cancel_unforked(self, fam: _ForkFamily, parent_result: RequestResult,
                         tick: int, results) -> None:
        """The parent retired before its first token (cancel or deadline
        mid-prefill): free the siblings' ``fpend`` slots, return the
        family's block hold, and finish each sibling unserved with the
        parent's outcome (one result per requested completion). A tree
        family holds neither: its whole worst case was the parent slot's
        reservation, which the retire freed."""
        if fam.tree:
            for j in range(1, fam.branches):
                self._finish_unforked_branch(fam, parent_result, j, results)
            return
        if fam.hold:
            self._pool.unreserve(fam.hold)
            fam.hold = 0
        for j, s in enumerate(fam.sibling_slots):
            self._slot_state[s] = "free"
            self._finish_unforked_branch(fam, parent_result, 1 + j, results)
        fam.sibling_slots = []

    def _finish_unforked_branch(self, fam: _ForkFamily,
                                parent_result: RequestResult, index: int,
                                results) -> None:
        """One never-started sibling finishes unserved with the parent's
        outcome."""
        res = dataclasses.replace(parent_result, index=index, tokens=[],
                                  cum_logprob=0.0, ttft_s=0.0)
        results.append(res)
        fam.done.append(res)
        if parent_result.outcome in (OUTCOME_DEADLINE, OUTCOME_SHED,
                                     OUTCOME_ERROR):
            self.slo.observe_miss()
        if obs.REGISTRY.enabled:
            _REQUESTS.labels(outcome=res.outcome).inc()
        self._notify_finish(fam.req, res, fam)

    def _emit_best_of(self, fam: _ForkFamily) -> None:
        """Best-of-n join: the winner by cumulative log-probability (ties
        to the lowest index) among cleanly finished branches (every branch
        failed: among all), streamed now as index 0."""
        req = fam.req
        happy = [r for r in fam.done
                 if r.outcome in (OUTCOME_EOS, OUTCOME_BUDGET)]
        winner = max(happy or fam.done,
                     key=lambda r: (r.cum_logprob, -r.index))
        if obs.TRACER.active:
            obs.instant("best_of_selected", cat="serving", args={
                "rid": req.uid, "index": winner.index,
                "cum_logprob": round(winner.cum_logprob, 6),
                "branches": len(fam.done)})
        out = dataclasses.replace(winner, index=0)
        for t in winner.tokens:
            self._deliver_token(req, 0, t)
        self._deliver_finish(req, 0, out)

    # -- token-tree sibling decode ------------------------------------------
    #
    # A tree family's k branches decode in ONE slot as one verify-shaped row
    # bundle per tick. The slot's committed rows freeze at ``base_len`` (the
    # shared ancestors: the prompt, or prompt + shared tokens for a live
    # conversion); every live branch's divergent suffix is replayed into the
    # window [base_len, base_len + k*s) each tick under tree_mask/positions,
    # so a suffix row attends to the frozen ancestors and its own branch
    # only. Each branch's last row draws its next token under the fork-slot
    # path's key, so the two layouts give the same tokens. A retiring branch
    # shrinks the window the same tick; one survivor collapses (its suffix
    # compacted to the front of the window, the slot back on plain decode),
    # none closes the slot.

    def _admit_tree_family(self, req: Request, slot: int) -> None:
        """Register a family that decodes as a token tree in ``slot`` (its
        tree-shaped reservation already taken by :meth:`_paged_reserve`).
        The branches start in the awaits pass of the tick the parent's
        first token lands."""
        branches = self._branches(req)
        fam = _ForkFamily(
            req=req, parent_slot=slot, sibling_slots=[], sib_reserve=0,
            hold=0, best_of=bool(req.best_of and req.best_of > 1),
            branches=branches, tree=True, base_len=len(req.prompt),
            fork_len=1)
        self._families[req.uid] = fam
        self._tree_fams[slot] = fam
        self._uid_next_index[req.uid] = branches
        self._tree_fams_life += 1

    def _tree_family_start(self, fam: _ForkFamily, slot: int, tick: int,
                           now2: float, results) -> int:
        """Branch the freshly live parent into its k tree siblings, before
        any EOS check (a one-token parent still yields k samples). The
        siblings' first tokens are drawn from the parent's stashed
        prompt-end logits under their branch keys, as the fork-slot path
        draws them: one small sampling pass and one fetch per family. Every
        branch's first token then takes its EOS and budget checks here,
        branch 0's included. Returns the sibling tokens emitted."""
        req = fam.req
        fam.forked = True
        k = fam.branches
        row = self._slot_logits[slot]
        assert row is not None, "tree family lost its logits stash"
        self._slot_logits[slot] = None
        tok, lp = sample_rows(
            row[None, None].expand(k - 1, 1, row.shape[-1]),
            np.full((k - 1,), self._temp_np[slot], np.float32),
            np.full((k - 1,), self._topk_np[slot], np.int32),
            [self._branch_key(req, b) for b in range(1, k)],
            np.zeros((k - 1, 1), np.int64), np.ones((k - 1, 1), bool))
        # The family's one fetch: the siblings' first tokens and logprobs.
        fh = torch.stack([tok[:, 0], lp[:, 0].view(torch.int32)],
                         1).cpu().numpy()
        lp_h = np.ascontiguousarray(fh[:, 1]).view(np.float32)
        fam.br_tokens = [self._slot_tokens[slot]] + [
            [int(t)] for t in fh[:, 0]]
        fam.br_cum_lp = [self._slot_cum_lp[slot]] + [float(x) for x in lp_h]
        fam.br_live = [True] * k
        fam.br_index = list(range(k))
        fam.br_ttft = [self._slot_ttft[slot]] * k
        emitted = 0
        dead: List[Tuple[int, str]] = []
        for b in range(k):
            t0 = fam.br_tokens[b][0]
            if b > 0:
                self._push_token(req, t0, b)
                emitted += 1
                self.slo.observe_ttft(fam.br_ttft[b])
                if obs.REGISTRY.enabled:
                    _TOKENS.inc()
                    _TTFT.observe(fam.br_ttft[b])
                if obs.TRACER.active:
                    obs.instant("first_token", cat="serving", args={
                        "rid": req.uid, "slot": slot, "tick": tick,
                        "index": b, "tree": True,
                        "ttft_s": round(fam.br_ttft[b], 6)})
            if req.eos_id is not None and t0 == req.eos_id:
                dead.append((b, OUTCOME_EOS))
            elif req.max_new_tokens <= 1:
                dead.append((b, OUTCOME_BUDGET))
        nshare = fam.base_len // self.kv_block
        self._forks_life += k - 1
        self._fork_shared_life += (k - 1) * nshare
        self._tc.forks += k - 1
        self._tc.shared_blocks += (k - 1) * nshare
        if obs.REGISTRY.enabled:
            _FORKS.inc(k - 1)
            if nshare:
                _FORK_SHARED.inc((k - 1) * nshare)
        if obs.TRACER.active:
            for b in range(1, k):
                obs.instant("fork", cat="serving", args={
                    "rid": req.uid, "tick": tick, "parent_slot": slot,
                    "child_slot": slot, "index": b, "tree": True,
                    "shared_blocks": nshare, "copied_blocks": 0,
                    "at_tokens": 0})
        for b, outcome in dead:
            self._tree_finish_branch(slot, fam, b, outcome, tick, now2,
                                     results)
        self._tree_settle(slot, fam, 0, [], bool(dead), tick)
        return emitted

    def _pack_tree(self, fam: _ForkFamily) -> Tuple[PackedSpec, List[int],
                                                    int]:
        """This tick's sibling bundle: every live branch's divergent suffix
        (its tokens past the frozen ancestors), packed branch-major; all
        have one length, since each branch gains one token a tick. Returns
        ``(pack, the live branches in packed order, the suffix length)``."""
        d = fam.fork_len - 1
        order = [b for b in range(fam.branches) if fam.br_live[b]]
        suffixes = [fam.br_tokens[b][d:] for b in order]
        return pack_siblings(suffixes), order, len(suffixes[0])

    def _tree_commit_all(self, tree_plan: Dict[int, tuple],
                         alltok: np.ndarray, alllp: np.ndarray, now: float,
                         tick: int, results: List[RequestResult],
                         tbt: List[float]) -> int:
        """The host half of a tree tick: each live branch's next token is
        the draw at its LAST packed row (the rows before it re-read the
        branch's own suffix). EOS and budget are checked per branch;
        retires shrink the family the same tick. Returns the tokens
        emitted."""
        emitted = 0
        for slot, (pack, order, s) in tree_plan.items():
            fam = self._tree_fams.get(slot)
            if fam is None:
                continue
            req = fam.req
            self._tree_branches_life += len(order)
            self._tc.tree_branches += len(order)
            gap = max(now - self._last_tok_t[slot], 0.0)
            self._last_tok_t[slot] = now
            self._slot_max_tbt[slot] = max(self._slot_max_tbt[slot], gap)
            self.slo.observe_tbt(gap)
            dead: List[Tuple[int, str]] = []
            for rank, b in enumerate(order):
                r = rank * s + s - 1
                t_new = int(alltok[slot, r])
                fam.br_tokens[b].append(t_new)
                fam.br_cum_lp[b] += float(alllp[slot, r])
                self._push_token(req, t_new, fam.br_index[b])
                emitted += 1
                tbt.append(gap if rank == 0 else 0.0)
                if obs.REGISTRY.enabled:
                    _TOKENS.inc()
                    _TBT.observe(gap if rank == 0 else 0.0)
                if req.eos_id is not None and t_new == req.eos_id:
                    dead.append((b, OUTCOME_EOS))
                elif len(fam.br_tokens[b]) >= req.max_new_tokens:
                    dead.append((b, OUTCOME_BUDGET))
            for b, outcome in dead:
                self._tree_finish_branch(slot, fam, b, outcome, tick, now,
                                         results)
            self._tree_settle(slot, fam, s, order, bool(dead), tick)
        return emitted

    def _tree_finish_branch(self, slot: int, fam: _ForkFamily, b: int,
                            outcome: str, tick: int, now: float,
                            results) -> None:
        """One branch leaves the family: its result (tokens, cumulative
        log-probability, its own outcome) is final now; the slot shrinks in
        :meth:`_tree_settle`."""
        fam.br_live[b] = False
        req = fam.req
        admit_tick, visible_at = self._slot_admit[slot]
        res = RequestResult(
            uid=req.uid, tokens=list(fam.br_tokens[b]),
            prompt_len=len(req.prompt), arrival_tick=req.arrival_tick,
            admit_tick=admit_tick, finish_tick=tick,
            queue_wait_s=self._slot_wait[slot],
            completion_s=max(now - visible_at, 0.0), outcome=outcome,
            ttft_s=fam.br_ttft[b], cum_logprob=fam.br_cum_lp[b],
            prefix_hit_tokens=self._slot_prefix_hit[slot],
            index=fam.br_index[b])
        results.append(res)
        if outcome in (OUTCOME_EOS, OUTCOME_BUDGET):
            self.slo.observe_request(fam.br_ttft[b],
                                     self._slot_max_tbt[slot])
        elif outcome in (OUTCOME_DEADLINE, OUTCOME_SHED, OUTCOME_ERROR):
            self.slo.observe_miss()
        self._tc.branch_retired += 1
        if obs.REGISTRY.enabled:
            _REQUESTS.labels(outcome=outcome).inc()
        if obs.TRACER.active:
            obs.instant("request_retired", cat="serving", args={
                "rid": req.uid, "slot": slot, "tick": tick,
                "outcome": outcome, "index": fam.br_index[b], "tree": True})
        if obs.REQLOG.enabled and not any(fam.br_live):
            # A token-tree family's ledger closes with its LAST branch (the
            # tick the slot closes, as the JAX engine's tree path closes
            # it), over every branch's tokens, before that branch's finish
            # is delivered: its usage block carries the ledger.
            res.ledger = obs.REQLOG.finish(
                req.uid, outcome=outcome, finish_tick=tick,
                tokens_decoded=sum(len(t) for t in fam.br_tokens), now=now)
        self._notify_finish(req, res, fam)
        self._family_branch_done(fam, res)

    def _tree_settle(self, slot: int, fam: _ForkFamily, s: int,
                     order: List[int], retired_any: bool,
                     tick: int) -> None:
        """Normalize the slot after a tree tick (or the family's start):
        two or more live branches keep the tree (the window's reservation
        trimmed the tick a branch retired), one survivor collapses the slot
        to plain decode, none closes it."""
        k_live = sum(fam.br_live)
        if k_live == 0:
            self._tree_close(slot, fam)
        elif k_live == 1:
            self._tree_collapse(slot, fam, s, order)
        elif retired_any:
            span = max(fam.base_len
                       + k_live * (fam.req.max_new_tokens - fam.fork_len),
                       len(fam.req.prompt) + fam.req.max_new_tokens)
            self._slot_trim(slot, -(-span // self.kv_block))

    def _slot_trim(self, slot: int, need: int) -> None:
        """Shrink ``slot`` to a ``need``-block worst case the tick its
        occupant got smaller: private tail blocks past the need (rows of
        retired branches) unmap — host bookkeeping, the device table
        changes at the next sync — and the excess reservation returns to
        the pool."""
        while self._slot_nblocks[slot] > need:
            j = self._slot_nblocks[slot] - 1
            bid = int(self._host_table[slot, j])
            if bid not in self._slot_private[slot]:
                break  # shared ancestors never sit past the need
            self._pool.unmap_private(bid)
            self._slot_private[slot].discard(bid)
            self._slot_reserve[slot] += 1
            self._host_table[slot, j] = 0
            self._slot_nblocks[slot] -= 1
            self._table_dirty = True
        excess = self._slot_nblocks[slot] + self._slot_reserve[slot] - need
        give = min(max(excess, 0), self._slot_reserve[slot])
        if give:
            self._pool.unreserve(give)
            self._slot_reserve[slot] -= give
            self._pool.gen += 1

    def _tree_collapse(self, slot: int, fam: _ForkFamily, s: int,
                       order: List[int]) -> None:
        """One branch left: move its replayed suffix to the front of the
        window (:func:`compact_decode_window`; nothing moves when it is
        already at rank 0), rebind the slot's mirrors and key to the
        survivor's, park its tip, and hand the slot back to plain decode.
        The survivor decodes on under the key its rows were drawn with."""
        req = fam.req
        b = fam.br_live.index(True)
        if s > 0:
            rank = order.index(b)
            if rank > 0:
                S = self.slots
                src = np.tile(np.arange(s, dtype=np.int64), (S, 1))
                src[slot] = rank * s + np.arange(s)
                n = np.zeros((S,), np.int64)
                n[slot] = s
                start = np.zeros((S,), np.int64)
                start[slot] = fam.base_len
                self.cache = compact_decode_window(
                    self.cache, *(torch.from_numpy(x).to(self.device)
                                  for x in (start, src, n)))
        self._slot_clen[slot] = fam.base_len + s
        self._live_reset[slot] = fam.base_len + s
        self._slot_tokens[slot] = fam.br_tokens[b]
        self._slot_index[slot] = fam.br_index[b]
        self._slot_cum_lp[slot] = fam.br_cum_lp[b]
        self._slot_ttft[slot] = fam.br_ttft[b]
        self._keys[slot] = self._branch_key(req, fam.br_index[b])
        tip = int(fam.br_tokens[b][-1])
        self._tok_host[slot] = tip
        self.tok[slot] = tip
        self._tree_fams.pop(slot, None)
        self._slot_trim(slot, -(-(len(req.prompt) + req.max_new_tokens)
                                // self.kv_block))
        if obs.TRACER.active:
            obs.instant("tree_collapse", cat="serving", args={
                "rid": req.uid, "slot": slot, "index": fam.br_index[b],
                "suffix": s})

    def _tree_close(self, slot: int, fam: _ForkFamily) -> None:
        """Every branch finished: close the request's span and free the
        slot — pins, private blocks, unspent reservation — the tick the
        last branch retired."""
        self._tree_fams.pop(slot, None)
        span = self._slot_span[slot]
        if span is not None:
            span.set(tokens=sum(len(t) for t in fam.br_tokens),
                     branches=fam.branches, tree=True)
            span.__exit__(None, None, None)
            self._slot_span[slot] = None
        uid = fam.req.uid
        self._free_slot_resources(slot)
        if not any(rq is not None and rq.uid == uid
                   for rq in self._slot_req):
            self._uid_next_index.pop(uid, None)

    def _tree_retire_all(self, slot: int, fam: _ForkFamily, tick: int,
                         outcome: str, results) -> None:
        """Cancel, deadline or shed of a started tree family: every live
        branch finishes with that outcome, then the slot closes."""
        now = time.monotonic()
        for b in range(fam.branches):
            if fam.br_live[b]:
                self._tree_finish_branch(slot, fam, b, outcome, tick, now,
                                         results)
        self._tree_close(slot, fam)

    def _tree_convert_live(self, parent: int, uid: int, tick: int) -> str:
        """A mid-stream ``fork(uid)`` as a tree conversion: the live slot
        keeps its committed rows as the shared ancestors and decodes both
        continuations as a two-branch tree — no new slot and no copied
        block (both branches re-consume the tip as their first suffix
        row). Host bookkeeping and the reservation's delta only."""
        req = self._slot_req[parent]
        toks = self._slot_tokens[parent]
        t = len(toks)
        plen = len(self._prompt_np[parent])
        base_len = plen + t - 1
        span = max(base_len + 2 * (req.max_new_tokens - t),
                   plen + req.max_new_tokens)
        delta = (-(-span // self.kv_block) - self._slot_nblocks[parent]
                 - self._slot_reserve[parent])
        if delta > 0:
            if not self._pool.reserve(delta):
                return "retry"
            self._slot_reserve[parent] += delta
        idx = self._uid_next_index.get(uid, self._branches(req))
        self._uid_next_index[uid] = idx + 1
        fam = _ForkFamily(
            req=req, parent_slot=parent, sibling_slots=[], sib_reserve=0,
            hold=0, best_of=False, branches=2, forked=True, tree=True,
            base_len=base_len, fork_len=t, br_tokens=[toks, list(toks)],
            br_cum_lp=[self._slot_cum_lp[parent]] * 2,
            br_live=[True, True], br_index=[self._slot_index[parent], idx],
            br_ttft=[self._slot_ttft[parent]] * 2)
        self._families[req.uid] = fam
        self._tree_fams[parent] = fam
        self._tree_fams_life += 1
        # Every tree tick resets the length to base_len: a pending fork or
        # collapse reset is subsumed.
        self._live_reset.pop(parent, None)
        self._slot_clen[parent] = base_len
        nshare = base_len // self.kv_block
        self._forks_life += 1
        self._fork_shared_life += nshare
        self._tc.forks += 1
        self._tc.shared_blocks += nshare
        if obs.REGISTRY.enabled:
            _FORKS.inc()
            if nshare:
                _FORK_SHARED.inc(nshare)
        if obs.TRACER.active:
            obs.instant("fork", cat="serving", args={
                "rid": req.uid, "tick": tick, "parent_slot": parent,
                "child_slot": parent, "index": idx, "tree": True,
                "shared_blocks": nshare, "copied_blocks": 0,
                "at_tokens": t})
        if obs.REQLOG.enabled and nshare:
            obs.REQLOG.note(req.uid, fork_shared_blocks=nshare)
        return "done"

    # -- speculation ------------------------------------------------------

    def _spec_bucket(self, n: int) -> int:
        """Tq bucket of a verify tick: power of two from 8 (shared with the
        chunk buckets), capped at the window-safe rows cap."""
        b = min(8, self._spec_rows_cap)
        while b < n:
            b *= 2
        return min(b, self._spec_rows_cap)

    def _draft_slot(self, i: int, tree_ok: bool = True) -> PackedSpec:
        """Slot ``i``'s verify chunk for this tick: the drafter's proposal
        clamped to the budget (never past the request's remaining tokens: a
        drafter proposing past ``max_new_tokens`` is truncated here, not
        trusted), cut to its root-path chain where the tick cannot run a
        tree mask (``tree_ok`` False: a prefill chunk widens Tq past 32),
        packed behind the committed tip at row 0. No proposal packs to one
        row: a plain decode row."""
        req = self._slot_req[i]
        tip = self._slot_tokens[i][-1]
        remaining = req.max_new_tokens - len(self._slot_tokens[i])
        budget = min(self.draft_k, remaining - 1, self._spec_rows_cap - 1)
        prop: Optional[DraftProposal] = None
        if budget >= 1:
            prop = self._drafter.propose(
                self._hist_buf[i, :self._hist_len[i]], budget)
        if prop is not None and len(prop) > 0:
            prop = prop.truncated(budget)
            if not tree_ok and not prop.is_chain:
                prop = prop.chain_prefix()
        else:
            prop = DraftProposal(tokens=np.empty((0,), np.int32),
                                 parents=np.empty((0,), np.int32))
        return pack_proposal(tip, prop)

    def _spec_unmap(self, slot: int) -> None:
        """Roll back the slot's block tail after a partial accept: blocks
        wholly past the committed length held only rejected rows; they go
        back to the pool and the reservation they used is restored
        (``unmap_private``), so the later re-allocation cannot fail and
        rolled-back KV never leaks capacity. Runs after the tick's
        compaction was queued; the device table changes at the next sync.
        Prefix blocks (shared on a hit, adopted at publish) lie inside the
        prompt, below ``keep``: only private blocks unmap."""
        keep = -(-self._slot_clen[slot] // self.kv_block)
        while self._slot_nblocks[slot] > keep:
            j = self._slot_nblocks[slot] - 1
            bid = int(self._host_table[slot, j])
            assert bid in self._slot_private[slot], (
                f"slot {slot}: rollback reached shared block {bid}")
            self._pool.unmap_private(bid)
            self._slot_private[slot].discard(bid)
            self._slot_reserve[slot] += 1
            self._host_table[slot, j] = 0
            self._slot_nblocks[slot] -= 1
            self._table_dirty = True

    def _verify_inputs(self, spec_plan: Dict[int, PackedSpec],
                       plan: List[tuple], tq: int,
                       tree_plan: Optional[Dict[int, tuple]] = None,
                       decode: Optional[tuple] = None):
        """The verify tick's host matrices: draft windows (tip at row 0,
        every spec slot reset to its committed length — the rollback), tree
        families' sibling bundles (reset to their frozen ancestors: every
        suffix is replayed past them, each branch's rows under its key),
        plain decode rows (``decode``: the ``(n_vec, reset, reset_val,
        emit)`` the tick already set for them) and the tick's prefill
        chunks. Returns ``(mat, n_vec, reset, reset_val, emit, verify)``,
        ``verify`` as :meth:`_step` takes it."""
        S = self.slots
        mat = np.zeros((S, tq), np.int32)
        n_vec = np.zeros((S,), np.int32)
        reset = np.zeros((S,), np.int32)
        reset_val = np.zeros((S,), np.int32)
        emit = np.zeros((S,), bool)
        if decode is not None:
            n_vec, reset, reset_val, emit = (x.copy() for x in decode)
        # A staged final chunk parked its slot's first token in the device
        # token vector only: that slot's row 0 comes from there.
        dev0 = np.asarray([st == "await" for st in self._slot_state])
        sidx = np.asarray([len(t) for t in self._slot_tokens], np.int64)
        ridx = sidx[:, None] + np.arange(tq)
        rows = np.zeros((S, tq), bool)
        depth = np.tile(np.arange(tq, dtype=np.int64), (S, 1))
        bits = np.broadcast_to(np.tril(np.ones((tq, tq), bool)),
                               (S, tq, tq)).copy()
        tree = False
        for i, pack in spec_plan.items():
            r = pack.rows
            self._ensure_blocks(i, self._slot_clen[i] + r)
            mat[i, :r] = pack.row_tokens
            n_vec[i] = r
            reset[i] = 1
            reset_val[i] = self._slot_clen[i]
            ridx[i, :r] = sidx[i] + pack.depth
            rows[i, :r] = True
            depth[i, :r] = pack.depth
            bits[i, :r, :r] = pack.anc
            tree |= not np.array_equal(pack.depth, np.arange(r))
        keys = None
        if tree_plan:
            tree = True
            keys = np.asarray(self._keys, np.int64)[:, None].repeat(tq, 1)
            for i, (pack, order, s) in tree_plan.items():
                fam = self._tree_fams[i]
                r = pack.rows
                self._ensure_blocks(i, fam.base_len + r)
                mat[i, :r] = pack.row_tokens
                n_vec[i] = r
                reset[i] = 1
                reset_val[i] = fam.base_len
                ridx[i, :r] = fam.fork_len + pack.depth
                rows[i, s - 1:r:s] = True  # each branch's last row
                depth[i, :r] = pack.depth
                bits[i, :r, :r] = pack.anc
                keys[i, :r] = np.repeat(
                    [self._branch_key(fam.req, fam.br_index[b])
                     for b in order], s)
        for i in np.flatnonzero((n_vec == 1) & emit):
            # Plain decode rows: the committed tip at row 0.
            mat[i, 0] = self._tok_host[i]
            rows[i, 0] = True
        for slot, n, last in plan:
            self._ensure_blocks(slot, self._prefill_pos[slot] + n)
            first = self._prefill_pos[slot] == self._prefill_start[slot]
            mat[slot, :n] = self._consume_chunk(slot, n, last)
            n_vec[slot] = n
            reset[slot] = first
            reset_val[slot] = self._prefill_start[slot]
            emit[slot] = last
            # A final chunk's last row draws the slot's first token.
            rows[slot, n - 1] = last
            ridx[slot, n - 1] = sidx[slot]
        # Chain slots and prefill chunks ride the arange / lower-triangular
        # defaults of a tree tick: the causal rule, bit for bit.
        verify = _Verify(depth if tree else None, bits if tree else None,
                         ridx, rows, dev0, keys)
        return mat, n_vec, reset, reset_val, emit, verify

    def _spec_commit_all(self, spec_plan: Dict[int, PackedSpec],
                         alltok: np.ndarray, alllp: np.ndarray, width: int,
                         now: float, tick: int,
                         results: List[RequestResult],
                         tbt: List[float]) -> int:
        """The host half of a verify tick: walk each slot's fetched per-row
        draws (argmax, or keyed samples for a sampled slot: the same walk),
        emit the committed burst (EOS and budget checked in stream order —
        an EOS inside the burst truncates it and retires the slot the same
        tick), advance the committed-length ledger (the next step's reset
        rolls the device back), queue ONE compaction for every tree commit
        of the tick, and unmap rolled-back paged blocks. Returns the number
        of tokens emitted."""
        emitted = 0
        compact = None
        t_prop = t_acc = t_ver = 0
        for i, pack in spec_plan.items():
            req = self._slot_req[i]
            if self._temp_np[i] > 0.0:
                kept, committed = accept_stochastic_path(pack, alltok[i])
                if obs.REGISTRY.enabled and pack.rows:
                    _SPEC_ACCEPT_SAMPLES.inc(pack.rows)
            else:
                kept, committed = accept_longest_path(pack, alltok[i])
            m = pack.rows - 1
            t_prop += m
            t_acc += len(kept)
            t_ver += m > 0
            remaining = req.max_new_tokens - len(self._slot_tokens[i])
            emit_list = committed[:remaining]
            outcome = None
            if req.eos_id is not None and req.eos_id in emit_list:
                emit_list = emit_list[:emit_list.index(req.eos_id) + 1]
                outcome = OUTCOME_EOS
            if outcome is None and (len(self._slot_tokens[i]) + len(emit_list)
                                    >= req.max_new_tokens):
                outcome = OUTCOME_BUDGET
            # The burst lands at one instant: its first token carries the
            # whole inter-token gap, the rest arrive with it.
            gap = max(now - self._last_tok_t[i], 0.0)
            self._last_tok_t[i] = now
            self._slot_max_tbt[i] = max(self._slot_max_tbt[i], gap)
            self.slo.observe_tbt(gap)
            hl = self._hist_len[i]
            rows_used = [0] + kept  # the window row each token came from
            for j, t in enumerate(emit_list):
                self._slot_tokens[i].append(int(t))
                self._slot_cum_lp[i] += float(alllp[i][rows_used[j]])
                self._hist_buf[i, hl + j] = int(t)
                self._push_token(req, int(t), self._slot_index[i])
                tbt.append(gap if j == 0 else 0.0)
                if obs.REGISTRY.enabled:
                    _TOKENS.inc()
                    _TBT.observe(gap if j == 0 else 0.0)
            self._hist_len[i] = hl + len(emit_list)
            emitted += len(emit_list)
            if obs.REGISTRY.enabled and m:
                _SPEC_PROPOSED.inc(m)
                if kept:
                    _SPEC_ACCEPTED.inc(len(kept))
            if obs.REQLOG.enabled and m:
                obs.REQLOG.note(req.uid, spec_proposed=m,
                                spec_accepted=len(kept))
            if outcome is not None:
                self._retire(i, tick, outcome, results)
                continue
            # Committed rows: the tip's (row 0) and every accepted draft
            # row; the bonus token is the new pending tip.
            a = len(kept)
            if kept != list(range(1, a + 1)):
                # A tree path's rows lie scattered in the window.
                if compact is None:
                    compact = (np.zeros((self.slots,), np.int64),
                               np.tile(np.arange(width), (self.slots, 1)),
                               np.zeros((self.slots,), np.int64))
                compact[0][i] = self._slot_clen[i]
                compact[1][i, 1:a + 1] = kept
                compact[2][i] = a + 1
            self._slot_clen[i] += 1 + a
        if compact is not None:
            # ONE batched gather-to-front; the device table still maps the
            # rolled-back blocks (the unmapping below reaches the device at
            # the next tick's sync, after this ran).
            self.cache = compact_decode_window(
                self.cache, *(torch.from_numpy(x).to(self.device)
                              for x in compact))
        if self._paged:
            for i in spec_plan:
                if self._slot_state[i] == "live":  # retired slots freed
                    self._spec_unmap(i)
        self._spec_proposed += t_prop
        self._spec_accepted += t_acc
        self._spec_verifies += t_ver
        if t_prop:
            self._spec_ticks += 1
        if obs.REGISTRY.enabled and self._spec_proposed:
            _SPEC_ACCEPT_RATIO.set(self._spec_accepted / self._spec_proposed)
        tc = self._tc
        tc.spec_slots, tc.spec_proposed, tc.spec_accepted = (
            len(spec_plan), t_prop, t_acc)
        return emitted

    def _retire(self, slot: int, tick: int, outcome: str,
                results) -> None:
        """Free a slot on ANY outcome arc: the happy ones (eos, budget) and
        the robustness ones (cancelled, deadline) release the same things
        — prefix pins, private paged blocks (a verify tick's rolled-back
        tail among them), the unspent reservation, and the int8 staging
        latch of a prompt cancelled mid-stage (its staged rows are garbage
        the next admission's first chunk overwrites) — so retiring a
        request mid-prefill or mid-stream is this, earlier. A started tree
        family retires every live branch with the outcome."""
        tfam = self._tree_fams.get(slot)
        if tfam is not None:
            if tfam.forked:
                self._tree_retire_all(slot, tfam, tick, outcome, results)
                return
            # Not started yet (prefilling or awaiting its first token):
            # the plain retire below settles it, and _cancel_unforked
            # finishes the other branches.
            self._tree_fams.pop(slot)
        req = self._slot_req[slot]
        admit_tick, visible_at = self._slot_admit[slot]
        now = time.monotonic()
        result = RequestResult(
            uid=req.uid,
            tokens=list(self._slot_tokens[slot]),
            prompt_len=len(req.prompt),
            arrival_tick=req.arrival_tick,
            admit_tick=admit_tick,
            finish_tick=tick,
            queue_wait_s=self._slot_wait[slot],
            completion_s=max(now - visible_at, 0.0),
            outcome=outcome,
            ttft_s=self._slot_ttft[slot],
            cum_logprob=self._slot_cum_lp[slot],
            prefix_hit_tokens=self._slot_prefix_hit[slot],
            index=self._slot_index[slot],
        )
        results.append(result)
        if outcome in (OUTCOME_EOS, OUTCOME_BUDGET):
            self.slo.observe_request(self._slot_ttft[slot],
                                     self._slot_max_tbt[slot])
        elif outcome in (OUTCOME_DEADLINE, OUTCOME_SHED, OUTCOME_ERROR):
            # The server failed this request; a client's cancellation is
            # not the server's SLO miss.
            self.slo.observe_miss()
        if slot in self._prefill_fifo:
            # Retired mid-prefill: out of the chunk plan (under int8 this
            # releases the one-prompt-at-a-time staging latch).
            self._prefill_fifo.remove(slot)
        span = self._slot_span[slot]
        if span is not None:
            span.set(outcome=outcome, tokens=len(result.tokens),
                     ttft_s=round(self._slot_ttft[slot], 6))
            if obs.TRACER.active and req.trace is not None:
                # The flow's finish, inside the still-open request span.
                obs.flow("f", obs.flow_id(req.trace[0]))
            span.__exit__(None, None, None)
            self._slot_span[slot] = None
        if obs.REQLOG.enabled:
            # Closed by the first branch of a fork-slot family to retire
            # (later branches find it closed and carry None).
            result.ledger = obs.REQLOG.finish(
                req.uid, outcome=outcome, finish_tick=tick,
                tokens_decoded=len(result.tokens), now=now)
        self._free_slot_resources(slot)
        if obs.REGISTRY.enabled:
            _REQUESTS.labels(outcome=outcome).inc()
        # Family bookkeeping: a parent retiring before its first token takes
        # its unforked siblings with it; the branch's finish is delivered
        # (held back under best-of), and the family collects the branch —
        # the last one joins.
        fam = self._families.get(req.uid)
        if fam is not None and slot == fam.parent_slot and not fam.forked:
            self._cancel_unforked(fam, result, tick, results)
        self._notify_finish(req, result, fam)
        if fam is not None:
            self._family_branch_done(fam, result)
        if not any(rq is not None and rq.uid == req.uid
                   for rq in self._slot_req):
            self._uid_next_index.pop(req.uid, None)

    def _free_slot_resources(self, slot: int) -> None:
        """Release everything a slot holds — prefix pins, private paged
        blocks, fork-shared refs, the unspent reservation — and mark it
        free: the one exit arc of :meth:`_retire` and a tree family's
        close."""
        self._slot_req[slot] = None
        self._slot_tokens[slot] = []
        self._slot_state[slot] = "free"
        self._prompt_np[slot] = None
        self._slot_logits[slot] = None
        if self._prefix is not None and self._slot_nodes[slot]:
            # The request's pinned prefix path becomes evictable.
            self._prefix.release(self._slot_nodes[slot])
            self._slot_nodes[slot] = []
        if self._paged:
            # Blocks the tree adopted stay cached; the slot's remaining
            # private blocks (decode tail, partial prompt block, a verify
            # tick's rolled-back tail) free.
            for bid in self._slot_private[slot]:
                self._pool.free_private(bid)
            self._slot_private[slot] = set()
            # Fork-shared ancestors: this owner's refcount drops on every
            # exit arc; the last branch's release frees the block.
            for bid in self._slot_shared[slot]:
                self._pool.release_shared(bid)
            self._slot_shared[slot] = set()
            self._live_reset.pop(slot, None)
            if self._slot_reserve[slot]:
                self._pool.unreserve(self._slot_reserve[slot])
                self._slot_reserve[slot] = 0
            self._host_table[slot, :] = 0  # stale ids must never be read
            self._slot_nblocks[slot] = 0
            self._table_dirty = True
            # Released pins can grow evictability without touching the
            # free list: let a deferred admission retry.
            self._pool.gen += 1

    def pool_bytes(self) -> int:
        """Device bytes of this rank's pool blocks (K, V and int8 scales;
        the drop block aside): ``1/W`` of the whole pool's on a pool
        sharded ``W`` ways."""
        if not self._paged:
            return 0
        n = self.cache.blocks
        parts = [self.cache.k, self.cache.v]
        if self.quantize:
            parts += [self.cache.k_scale, self.cache.v_scale]
        return sum(t[:, :n].numel() * t.element_size() for t in parts)

    def leak_report(self) -> Dict[str, int]:
        """The no-leak invariant as numbers: after a drained run no slot
        holds blocks (private or fork-shared), reservations or prefix pins,
        and the only blocks in
        use are the prefix tree's (``blocks_used == blocks_cached``; 0
        without the cache on the paged layout; with KV tiering,
        ``host_blocks_used`` is the host tier's retained cache)."""
        out = {
            "blocks_private": (sum(len(s) for s in self._slot_private)
                               if self._paged else 0),
            "blocks_used": self._pool.used if self._paged else 0,
            "blocks_reserved": self._pool.reserved if self._paged else 0,
            # Fork-shared ancestors still refcounted by a slot: 0 after a
            # drain, like blocks_private.
            "blocks_shared": self._pool.shared_count if self._paged else 0,
            "blocks_cached": (self._prefix.blocks_used
                              if self._prefix is not None else 0),
            "pins": (self._prefix.total_pins()
                     if self._prefix is not None else 0),
        }
        if self._host_pool is not None:
            # Host-tier occupancy is retained cache, like blocks_cached.
            out["host_blocks_used"] = self._host_pool.used
        return out

    # -- control mailboxes (any thread) -----------------------------------

    def cancel(self, uid: int) -> None:
        """Cancel request ``uid`` (any thread; e.g. a client disconnect).
        The next tick's sweep applies it: a queued request finishes
        unserved, an in-flight one retires mid-prefill, mid-stage or
        mid-stream (slot freed, prefix pins released, paged blocks back in
        the pool). An unknown or finished uid is a no-op."""
        with self._ctl_lock:
            self._cancel_uids.add(uid)

    def fork(self, uid: int) -> None:
        """Branch live request ``uid`` mid-stream (any thread). The next
        tick's sweep applies it: the request's lowest-index live branch
        gets a fresh slot whose table SHARES every full ancestor block,
        with only the partial tail block copied, and samples on under its
        own key; it finishes as one more indexed :class:`RequestResult`
        under the same uid. Scarce slots or blocks defer the fork for up to
        3 sweeps; a uid not live yet (queued, prefilling) waits; an unknown
        or finished uid ages out as a no-op."""
        with self._ctl_lock:
            self._fork_uids.append(uid)

    def _take_forks(self) -> List[int]:
        """Drain the fork mailbox (loop side), oldest first."""
        with self._ctl_lock:
            out = self._fork_uids
            self._fork_uids = []
            return out

    def request_drain(self) -> None:
        """Begin a graceful drain (any thread; e.g. a SIGTERM handler): the
        loop closes its source, sheds the queue (outcome ``shed``), runs
        the in-flight requests to completion and returns."""
        with self._ctl_lock:
            self._draining = True

    @property
    def draining(self) -> bool:
        with self._ctl_lock:
            return self._draining

    @property
    def all_slots_free(self) -> bool:
        """True when no request occupies a slot (one list read: safe to
        poll from other threads)."""
        return all(st == "free" for st in self._slot_state)

    def _take_control(self) -> Tuple[Set[int], bool]:
        """Drain the cancel mailbox and read the drain flag (loop side)."""
        with self._ctl_lock:
            cancels = self._cancel_uids
            self._cancel_uids = set()
            return cancels, self._draining

    def slots_snapshot(self) -> List[Dict[str, Any]]:
        """Per-slot live view (state, occupant uid, tokens generated,
        committed cache length; blocks mapped when paged), readable from
        other threads while the engine runs: every read is one list index,
        so a snapshot is at worst a tick stale, never torn."""
        out: List[Dict[str, Any]] = []
        for i in range(self.slots):
            req = self._slot_req[i]
            out.append({
                "slot": i,
                "state": self._slot_state[i],
                "uid": None if req is None else req.uid,
                "index": self._slot_index[i] if req is not None else 0,
                "tokens": len(self._slot_tokens[i]),
                "clen": self._slot_clen[i],
                **({"nblocks": self._slot_nblocks[i]}
                   if self._paged else {}),
            })
        return out

    # -- per-request callbacks (engine thread) -----------------------------

    def _deliver_token(self, req: Request, index: int, tok: int) -> None:
        """Raw token delivery: the branch callback when set (any index),
        else ``on_token`` for branch 0 only."""
        if req.on_branch_token is not None:
            try:
                req.on_branch_token(index, tok)
            except Exception:
                log.exception("on_branch_token failed (rid %s)", req.uid)
            return
        if index == 0 and req.on_token is not None:
            try:
                req.on_token(tok)
            except Exception:
                log.exception("on_token callback failed (rid %s)", req.uid)

    def _deliver_finish(self, req: Request, index: int,
                        result: RequestResult) -> None:
        if req.on_branch_finish is not None:
            try:
                req.on_branch_finish(index, result)
            except Exception:
                log.exception("on_branch_finish failed (rid %s)", req.uid)
            return
        if index == 0 and req.on_finish is not None:
            try:
                req.on_finish(result)
            except Exception:
                log.exception("on_finish callback failed (rid %s)", req.uid)

    def _push_token(self, req: Request, tok: int, index: int = 0) -> None:
        fam = self._families.get(req.uid)
        if fam is not None and fam.best_of:
            # Server-side selection: nothing streams until the family
            # joins and the winner is replayed.
            return
        self._deliver_token(req, index, tok)

    def _notify_finish(self, req: Request, result: RequestResult,
                       fam: Optional[_ForkFamily]) -> None:
        if fam is not None and fam.best_of:
            return  # the family's join emits the one winner's finish
        self._deliver_finish(req, result.index, result)

    def _finish_unadmitted(self, req: Request, tick: int, outcome: str,
                           results, visible_at: float, now: float) -> None:
        """Retire a request that never reached a slot (cancelled,
        deadline-expired or shed while queued; an invalid live request):
        no engine resource to release, only its results, the outcome
        counter, the SLO verdict and the client's callbacks. A family
        finishes whole: one result per requested completion."""
        branches = self._branches(req)
        for index in range(branches):
            res = RequestResult(
                uid=req.uid, tokens=[], prompt_len=len(req.prompt),
                arrival_tick=req.arrival_tick, admit_tick=-1,
                finish_tick=tick, queue_wait_s=max(now - visible_at, 0.0),
                completion_s=max(now - visible_at, 0.0), outcome=outcome,
                index=index,
            )
            results.append(res)
            if outcome in (OUTCOME_DEADLINE, OUTCOME_SHED, OUTCOME_ERROR):
                # A categorical SLO miss: the server failed to serve it (a
                # client's cancellation is not the server's miss).
                self.slo.observe_miss()
            if obs.REGISTRY.enabled:
                _REQUESTS.labels(outcome=outcome).inc()
            self._deliver_finish(req, index, res)
        if obs.TRACER.active:
            obs.instant("request_rejected", cat="serving", args={
                "rid": req.uid, "tick": tick, "outcome": outcome,
                "branches": branches})

    # -- the tick loop ----------------------------------------------------

    @torch.no_grad()
    # -- the tick loop's sections --------------------------------------------

    def _poll(self, run: _Run, source: RequestSource, now: float) -> None:
        """Queue the source's newly visible requests; a request that fails
        validation finishes with outcome ``error`` (a live request must not
        kill the loop serving everyone else; a static trace was validated
        up front)."""
        for r in source.poll(run.tick):
            vis = r.visible_at if r.visible_at is not None else now
            try:
                self._validate(r)
            except ValueError as e:
                log.warning("rejecting request %s: %s", r.uid, e)
                self._finish_unadmitted(r, run.tick, OUTCOME_ERROR,
                                        run.results, vis, now)
                continue
            run.pending.append(r)
            run.visible_wall[r.uid] = vis
            if obs.TRACER.active:
                obs.instant("request_queued", cat="serving",
                            args={"rid": r.uid, "tick": run.tick})

    def _sweep(self, run: _Run, source: RequestSource, now: float,
               cancels: Set[int], draining: bool,
               workers: Sequence["SlotServer"] = ()) -> None:
        """The control sweep, on the loop thread, over the slots of
        ``workers`` (default: this engine): cancellation beats deadline
        beats drain (a disconnected client's request is 'cancelled' even
        if its deadline also passed). EOS and budget retired at the end of
        the previous tick, so a request that finished and expired on the
        same tick keeps its outcome."""
        workers = workers or (self,)
        tc = self._tc
        cancels |= set(run.cancel_carry)
        if cancels:
            matched = set()
            for r in [r for r in run.pending if r.uid in cancels]:
                run.pending.remove(r)
                matched.add(r.uid)
                tc.cancelled += 1
                self._finish_unadmitted(
                    r, run.tick, OUTCOME_CANCELLED, run.results,
                    run.visible_wall.pop(r.uid, now), now)
            for eng in workers:
                for i, rq in enumerate(eng._slot_req):
                    if rq is not None and rq.uid in cancels:
                        matched.add(rq.uid)
                        tc.cancelled += 1
                        eng._retire(i, run.tick, OUTCOME_CANCELLED,
                                    run.results)
            # A cancel can race its own request's submission (the submit
            # lands after this tick's poll, the cancel before this sweep):
            # unmatched uids are carried for two sweeps; unknown or
            # finished ones age out as no-ops.
            for uid in cancels - matched:
                if uid not in run.cancel_carry:
                    run.cancel_carry[uid] = 2
                else:
                    run.cancel_carry[uid] -= 1
                    if run.cancel_carry[uid] <= 0:
                        del run.cancel_carry[uid]
            for uid in matched:
                run.cancel_carry.pop(uid, None)
        # Expired in the queue: finish unserved (admitting work that can no
        # longer meet its deadline steals ticks from work that can);
        # expired in flight: retire, the streamed tokens stand.
        for r in [r for r in run.pending
                  if r.deadline_s is not None and now >= r.deadline_s]:
            run.pending.remove(r)
            tc.deadline_expired += 1
            self._finish_unadmitted(r, run.tick, OUTCOME_DEADLINE,
                                    run.results,
                                    run.visible_wall.pop(r.uid, now), now)
        for eng in workers:
            for i, rq in enumerate(eng._slot_req):
                if (rq is not None and rq.deadline_s is not None
                        and now >= rq.deadline_s):
                    tc.deadline_expired += 1
                    eng._retire(i, run.tick, OUTCOME_DEADLINE, run.results)
        if draining:
            # Graceful drain: no new work, the queue sheds, in-flight
            # slots step on to completion.
            source.close()
            while run.pending:
                r = run.pending.popleft()
                tc.shed += 1
                self._finish_unadmitted(r, run.tick, OUTCOME_SHED,
                                        run.results,
                                        run.visible_wall.pop(r.uid, now), now)

    def _admit_pending(self, run: _Run, now: float) -> None:
        """Admit the oldest visible request per free slot; a paged
        admission that cannot reserve its worst case waits (FIFO). A fork
        family admits atomically: the parent's slot and one ``fpend`` slot
        per sibling, or it waits."""
        free = [i for i, st in enumerate(self._slot_state) if st == "free"]
        pending = run.pending
        while free and pending:
            if self.quantize and self._prefill_fifo:
                break  # staged admission: one prompt in flight
            branches = self._branches(pending[0])
            # A tree family needs ONE slot however many branches.
            tree_adm = branches > 1 and self._tree_sibling_ok(pending[0])
            if (1 if tree_adm else branches) > len(free):
                break
            resv = None
            if self._paged:
                if self._defer_gen == self._pool.gen:
                    break  # availability cannot have grown
                resv = self._paged_reserve(pending[0])
                if resv is None:
                    self._defer_gen = self._pool.gen
                    break
            req = pending.popleft()
            slot = free.pop(0)
            if branches > 1:
                # The family exists before the admission runs: whole
                # admission stashes the prompt-end logits inside it.
                if tree_adm:
                    self._admit_tree_family(req, slot)
                else:
                    self._admit_family(req, slot, free, resv)
            self._admit(req, slot, run.tick,
                        run.visible_wall.pop(req.uid, now), resv)

    def _tick(self, run: _Run) -> _TickOut:
        """One tick's step and its commits: plan the prefill chunks, run
        the tick's one step (verify, tree, mixed or pure decode), fetch its
        tokens once, land the first tokens of finished prompts (live, or
        parked for the handoff on a prefill worker) and commit every live
        slot's token, retiring on EOS and budget."""
        tick, results, tbt = run.tick, run.results, run.tbt
        tokens0 = run.tokens
        # Every started tree family's live suffixes, packed into one
        # bundle for its one slot (host work, like drafting).
        tree_plan = {i: self._pack_tree(f)
                     for i, f in self._tree_fams.items()
                     if f.forked and self._slot_state[i] == "live"}
        # While a tree family decodes, the chunks that share its step clamp
        # to the int32 bitmask's 32 rows: the sibling bundle never rides a
        # wider Tq. (The JAX engine clamps from the family's admission;
        # staged int8 chunks never share the step.)
        plan = self._plan_chunks(
            max_n=32 if tree_plan and not self.quantize else None)
        plan_rec = plan  # the staged path rebinds ``plan`` to []
        live_idx = [i for i, st in enumerate(self._slot_state)
                    if st == "live"]
        if obs.REGISTRY.enabled:
            _SLOTS_OCCUPIED.set(len(live_idx))
            _TREE_BRANCHES.set(sum(sum(f.br_live)
                                   for f in self._tree_fams.values()
                                   if f.forked))
        # The tick's span (closed after the fetch and retires; a shared
        # no-op while the tracer is off).
        tick_span = obs.span(
            self._tick_name, cat="serving",
            args=None if not obs.TRACER.active else {
                "tick": tick, "occupancy": len(live_idx),
                "prefilling": len(self._prefill_fifo),
                "chunk_tokens": sum(n for _, n, _ in plan),
                "queue_depth": len(run.pending)})
        S = self.slots
        n_vec = np.zeros((S,), np.int32)
        reset = np.zeros((S,), np.int32)
        reset_val = np.zeros((S,), np.int32)
        emit = np.zeros((S,), bool)
        if not self._speculate:
            for i in live_idx:
                if i in tree_plan:
                    continue
                self._ensure_blocks(i, len(self._slot_req[i].prompt)
                                    + len(self._slot_tokens[i]))
                n_vec[i] = 1
                emit[i] = True
            # A freshly forked or adopted slot's device length learns its
            # committed length at its first consuming tick.
            for i in list(self._live_reset):
                if self._slot_state[i] == "live" and i not in tree_plan:
                    reset[i] = 1
                    reset_val[i] = self._live_reset.pop(i)
        fused = None
        verified = False
        spec_plan: Dict[int, PackedSpec] = {}
        if self.quantize and plan:
            # Staged chunks run first; the tick's step is then the
            # decode-only step over the int8 cache.
            for slot, n, last in plan:
                self._run_staged_chunk(slot, n, last)
            plan = []
        if self._speculate and live_idx:
            # THE verify tick: every live slot's draft window (tip at row
            # 0; no proposal = a one-row decode) and the tick's prefill
            # chunks in one step. A chunk wider than 32 rows cannot ride
            # int32 tree masks: trees fall back to their root-path chains
            # for that tick. A tick with no draft anywhere runs the Tq = 1
            # shape.
            chunk_tq = (self._chunk_bucket(max(n for _, n, _ in plan))
                        if plan else 1)
            for i in live_idx:
                spec_plan[i] = self._draft_slot(i, chunk_tq <= 32)
            rows_max = max(p.rows for p in spec_plan.values())
            tq = self._spec_bucket(rows_max) if rows_max > 1 else 1
            if plan:
                tq = max(tq, chunk_tq)
            mat, n_vec, reset, reset_val, emit, verify = \
                self._verify_inputs(spec_plan, plan, tq)
            self._sync_table()
            fused = self._step(torch.from_numpy(mat).to(self.device),
                               n_vec, reset, reset_val, emit, verify)
            verified = True
            self._spec_tree_ticks += verify.depth is not None
            run.steps += 1
        elif tree_plan:
            # The tree tick: every tree family's sibling bundle, the plain
            # live slots' decode rows and the tick's prefill chunks in one
            # verify-shaped step under the ancestor masks (the ``tree``
            # variant of B2, or B5 under int8).
            rows_max = max(pk.rows for pk, _, _ in tree_plan.values())
            tq = self._spec_bucket(rows_max)
            if plan:
                tq = max(tq, self._chunk_bucket(max(n for _, n, _ in plan)))
            mat, n_vec, reset, reset_val, emit, verify = \
                self._verify_inputs({}, plan, tq, tree_plan,
                                    (n_vec, reset, reset_val, emit))
            self._sync_table()
            fused = self._step(torch.from_numpy(mat).to(self.device),
                               n_vec, reset, reset_val, emit, verify)
            verified = True
            self._tree_ticks += 1
            run.steps += 1
            for slot, _, last in plan:
                if last:
                    self._stash_logits(slot, self._last_rows[slot])
        elif plan:
            # The mixed tick: decode rows + prefill chunks in one step.
            mat = np.zeros((S, self._chunk_bucket(
                max(n for _, n, _ in plan))), np.int32)
            mat[live_idx, 0] = self._tok_host[live_idx]
            for slot, n, last in plan:
                self._ensure_blocks(slot, self._prefill_pos[slot] + n)
                first = (self._prefill_pos[slot]
                         == self._prefill_start[slot])
                mat[slot, :n] = self._consume_chunk(slot, n, last)
                n_vec[slot] = n
                reset[slot] = first
                reset_val[slot] = self._prefill_start[slot]
                emit[slot] = last
            self._sync_table()
            fused = self._step(torch.from_numpy(mat).to(self.device),
                               n_vec, reset, reset_val, emit)
            run.steps += 1
            for slot, _, last in plan:
                if last:
                    self._stash_logits(slot, self._last_rows[slot])
        elif live_idx:
            # Pure-decode tick: the tokens stay on the device.
            self._sync_table()
            fused = self._step(self.tok[:, None], n_vec, reset, reset_val,
                               emit)
            run.steps += 1
        if self._prefix is not None:
            # The tick's final chunks completed their prompts in the cache:
            # publish them (staged chunks published already).
            for slot, _, last in plan:
                if last:
                    self._publish_prefix(slot)

        awaits = [i for i, st in enumerate(self._slot_state)
                  if st == "await"]
        host_sync = bool(awaits or live_idx)
        if host_sync:
            # THE per-tick host fetch: every new token of the tick and its
            # logprob, one array (the token vector itself when no step ran:
            # a staged final chunk parked its first token).
            if fused is None:
                fused = torch.stack([self.tok, self._lp.view(torch.int32)],
                                    1)
            fh = fused.cpu().numpy()
            if verified:
                # (S, 1 + Tq, 2): the token vector, then every row draw.
                alltok = fh[:, 1:, 0]
                alllp = np.ascontiguousarray(fh[:, 1:, 1]).view(np.float32)
                fh = fh[:, 0]
            self._tok_host = fh[:, 0].copy()
            lp_host = np.ascontiguousarray(fh[:, 1]).view(np.float32)
            now2 = time.monotonic()
            if live_idx:
                run.decode_ticks += 1
                run.occupancy += len(live_idx)
            park = self._handoff is not None
            for i in awaits:
                req = self._slot_req[i]
                first = int(self._tok_host[i])
                self._slot_tokens[i] = [first]
                self._slot_cum_lp[i] = float(lp_host[i])
                self._push_token(req, first, self._slot_index[i])
                if not park:
                    self._slot_state[i] = "live"
                    # The committed rows are the prompt; the first token is
                    # the pending tip.
                    self._slot_clen[i] = len(req.prompt)
                    if self._speculate:
                        self._hist_buf[i, self._hist_len[i]] = first
                        self._hist_len[i] += 1
                _, vis = self._slot_admit[i]
                self._slot_ttft[i] = max(now2 - vis, 0.0)
                self._last_tok_t[i] = now2
                run.tokens += 1
                self.slo.observe_ttft(self._slot_ttft[i])
                if obs.REGISTRY.enabled:
                    _TOKENS.inc()
                    _TTFT.observe(self._slot_ttft[i])
                if obs.TRACER.active:
                    obs.instant("first_token", cat="serving", args={
                        "rid": req.uid, "slot": i, "tick": tick,
                        "ttft_s": round(self._slot_ttft[i], 6)})
                if obs.REQLOG.enabled:
                    obs.REQLOG.first_token(req.uid, now=now2)
                # A family forks HERE, before the parent's EOS and budget
                # checks: a one-token parent still yields n independent
                # samples.
                fam = self._families.get(req.uid)
                if fam is not None and not fam.forked \
                        and i == fam.parent_slot:
                    if fam.tree:
                        # Every branch's first token, branch 0's EOS and
                        # budget checks included, is handled there.
                        run.tokens += self._tree_family_start(
                            fam, i, tick, now2, results)
                        continue
                    run.tokens += self._fork_family(fam, i, tick, now2,
                                                    results)
                if req.eos_id is not None and first == req.eos_id:
                    self._retire(i, tick, OUTCOME_EOS, results)
                elif req.max_new_tokens <= 1:
                    self._retire(i, tick, OUTCOME_BUDGET, results)
                elif park:
                    # A prefill worker's finished prompt parks in its slot
                    # until a decode slot adopts it.
                    self._slot_state[i] = "handoff"
                    self._handoff.append(i)
                    if obs.TRACER.active:
                        obs.instant("handoff_queued", cat="serving", args={
                            "rid": req.uid, "slot": i, "tick": tick})
                    if obs.REQLOG.enabled:
                        # The ledger's handoff segment opens: parked until
                        # a decode slot adopts it.
                        obs.REQLOG.park(req.uid)
            if spec_plan:
                # Live slots' tokens come from the accept walk over the
                # fetched row draws: 1 to draft_k + 1 per slot.
                run.tokens += self._spec_commit_all(
                    spec_plan, alltok, alllp, mat.shape[1], now2, tick,
                    results, tbt)
            else:
                if tree_plan:
                    # Each live branch's token is its last row's draw;
                    # retires shrink the family the same tick.
                    run.tokens += self._tree_commit_all(
                        tree_plan, alltok, alllp, now2, tick, results, tbt)
                for i in live_idx:
                    if i in tree_plan:
                        continue
                    req = self._slot_req[i]
                    tok_i = int(self._tok_host[i])
                    self._slot_tokens[i].append(tok_i)
                    self._slot_cum_lp[i] += float(lp_host[i])
                    self._push_token(req, tok_i, self._slot_index[i])
                    run.tokens += 1
                    gap = max(now2 - self._last_tok_t[i], 0.0)
                    tbt.append(gap)
                    self._last_tok_t[i] = now2
                    self._slot_max_tbt[i] = max(self._slot_max_tbt[i], gap)
                    self.slo.observe_tbt(gap)
                    if obs.REGISTRY.enabled:
                        _TOKENS.inc()
                        _TBT.observe(gap)
                    if (req.fork_at is not None
                            and self._slot_index[i] == 0
                            and len(self._slot_tokens[i]) == req.fork_at):
                        # The replayable mid-stream branch: the request
                        # forks itself through the mailbox an API caller
                        # would use.
                        self.fork(req.uid)
                    if req.eos_id is not None and tok_i == req.eos_id:
                        self._retire(i, tick, OUTCOME_EOS, results)
                    elif len(self._slot_tokens[i]) >= req.max_new_tokens:
                        self._retire(i, tick, OUTCOME_BUDGET, results)
        tick_span.__exit__(None, None, None)
        return _TickOut(plan_rec, len(live_idx), host_sync,
                        run.tokens - tokens0)

    # -- the flight recorder's records (host-side ledgers only) -------------

    def _sweep_only_rec(self, run: _Run, queue_depth: int,
                        draining: bool) -> Optional[Dict[str, Any]]:
        """The record of a tick whose sweep retired work and left nothing
        to run (else its arcs would vanish at the next tick's zeroing), or
        None when the sweep retired nothing."""
        tc = self._tc
        if not (tc.cancelled or tc.deadline_expired or tc.shed):
            return None
        return {
            "tick": run.tick,
            "sweep_only": True,
            "occupancy": 0,
            "queue_depth": queue_depth,
            "pending": len(run.pending),
            "cancelled": tc.cancelled,
            "deadline_expired": tc.deadline_expired,
            "shed": tc.shed,
            "draining": draining,
        }

    def _tick_rec(self, run: _Run, out: _TickOut, t_s: float,
                  queue_depth: int, draining: bool) -> Dict[str, Any]:
        """One executed tick's flight record, the JAX engine's keys and
        values: lists are copies, every value a host-side ledger's."""
        tc = self._tc
        rec = {
            "tick": run.tick,
            "t_s": round(t_s, 6),
            "occupancy": out.occupancy,
            "states": list(self._slot_state),
            "lengths": [int(self._prefill_pos[i])
                        if self._slot_state[i] == "prefill"
                        else len(self._slot_tokens[i])
                        for i in range(self.slots)],
            "chunk_plan": _chunk_plan_rec(out.plan),
            "chunk_tokens": sum(int(n) for _, n, _ in out.plan),
            "tokens_emitted": out.tokens,
            "host_sync": out.host_sync,
            "queue_depth": queue_depth,
            "pending": len(run.pending),
            "prefix_hits": tc.prefix_hits,
            "prefix_reused": tc.prefix_reused,
            "cancelled": tc.cancelled,
            "deadline_expired": tc.deadline_expired,
            "shed": tc.shed,
            "forks": tc.forks,
            "shared_blocks": tc.shared_blocks,
            "tree_branches": tc.tree_branches,
            "branch_retired": tc.branch_retired,
            "draining": draining,
        }
        if self._paged:
            # Block occupancy and internal fragmentation: the share of the
            # mapped block capacity no written token occupies.
            mapped = sum(self._slot_nblocks)
            written = 0
            for i in range(self.slots):
                st = self._slot_state[i]
                if st == "prefill":
                    written += int(self._prefill_pos[i])
                elif st in ("await", "live"):
                    written += (len(self._slot_req[i].prompt)
                                + max(len(self._slot_tokens[i]) - 1, 0))
            rec["kv_blocks_used"] = self._pool.used
            rec["kv_blocks_free"] = self._pool.free_count
            rec["kv_frag"] = round(
                1.0 - written / (mapped * self.kv_block), 4) if mapped \
                else 0.0
            if self._host_pool is not None:
                rec["host_blocks_used"] = self._host_pool.used
                rec["restored_blocks"] = tc.restored_blocks
        if self._speculate:
            rec["spec_verify"] = {"slots": tc.spec_slots,
                                  "proposed": tc.spec_proposed,
                                  "accepted": tc.spec_accepted}
        return rec

    def serve(self, requests: Union[Sequence[Request], RequestSource],
              max_ticks: Optional[int] = None) -> ServeReport:
        """Run the tick loop until the request source drains.

        ``requests`` is a pre-built trace (every request validated up
        front, a bad one raises) or a live :class:`RequestSource` (invalid
        requests finish with outcome ``error``; the loop idles on
        :meth:`RequestSource.wait`). Each tick starts with the control
        sweep: cancellations, then expired deadlines, then a drain.
        ``max_ticks`` bounds runaway loops (raises if work remains). Grad
        mode is thread-local: the whole loop runs under ``no_grad`` on
        whichever thread calls it."""
        live = isinstance(requests, RequestSource)
        if live:
            source = requests
        else:
            for r in requests:
                self._validate(r)
            source = StaticRequestSource(requests)
            with self._ctl_lock:
                # A previous run's stale mailbox must not cancel or drain a
                # fresh trace (uids recycle). A live source keeps it: a
                # drain or cancel issued between starting the engine thread
                # and the loop's first tick is honoured.
                self._cancel_uids.clear()
                self._draining = False
        run = _Run.new(live)
        spec0 = (self._spec_proposed, self._spec_accepted, self._spec_ticks,
                 self._spec_verifies, self._spec_tree_ticks)
        prefix0 = self.prefix_stats()
        hit_bytes0 = self._hit_bytes_moved
        host0 = (self._host_pool.stats() if self._host_pool is not None
                 else None)
        fork0 = (self._forks_life, self._fork_shared_life)
        tree0 = (self._tree_fams_life, self._tree_branches_life,
                 self._tree_ticks)
        if self._paged:
            self._peak_blocks_used = self._pool.used
            self._defer_gen = -1
        t0 = time.monotonic()

        try:
            while True:
                if max_ticks is not None and run.tick >= max_ticks:
                    raise RuntimeError(
                        f"serve() exceeded max_ticks={max_ticks} with "
                        f"{len(run.pending)} pending request(s)"
                    )
                now = time.monotonic()
                self._tc.zero()
                self._poll(run, source, now)
                cancels, draining = self._take_control()
                self._sweep(run, source, now, cancels, draining)
                # Copy-on-write forks: mailboxed fork(uid)s branch live
                # requests onto free slots (deferred ones retry from the
                # carry).
                forks = self._take_forks()
                if forks or self._fork_carry:
                    self._apply_forks(forks, run.tick, run.pending)
                self._admit_pending(run, now)
                queue_depth = len(run.pending)  # visible, not admitted

                if not run.pending and all(st == "free"
                                           for st in self._slot_state):
                    # Idle iterations are handled here, before the body:
                    # recorded ticks are executed ticks (and sweep-only
                    # records).
                    if FLIGHT.enabled:
                        FLIGHT.record(self._sweep_only_rec(run, queue_depth,
                                                           draining))
                    if source.exhausted or draining:
                        break
                    nxt = source.next_arrival()
                    if nxt is not None:
                        run.tick = max(run.tick + 1, nxt)
                    else:
                        # A live feeder: idle, not stalled, while it blocks
                        # until a submission (or close) wakes the source;
                        # the timeout only bounds how late a mailboxed
                        # drain is seen while idle.
                        if FLIGHT.enabled:
                            FLIGHT.mark_idle()
                        source.wait(0.05)
                    continue

                out = self._tick(run)
                if self._paged:
                    self._peak_blocks_used = max(self._peak_blocks_used,
                                                 self._pool.used)
                    self._pool.publish_gauges()
                if self._host_pool is not None:
                    # The staged D2H flush point: the demotions this tick's
                    # evictions enqueued, in one batch behind the tick's
                    # work.
                    self._flush_demotions()
                    self._host_pool.publish_gauge()
                if FLIGHT.enabled:
                    FLIGHT.record(self._tick_rec(run, out, now - t0,
                                                 queue_depth, draining))
                self.slo.maybe_export(now)
                run.tick += 1
        except BaseException as e:
            # The black box: a crashed tick loop leaves its last ticks on
            # disk before the error propagates.
            FLIGHT.dump_if_armed(f"engine_error:{type(e).__name__}")
            if obs.TRACER.active:
                obs.instant("engine_error", cat="serving", args={
                    "error": type(e).__name__, "tick": run.tick})
            raise

        with self._ctl_lock:
            # This run consumed its control state: the engine is reusable
            # (a completed drain must not drain the next run).
            self._cancel_uids.clear()
            self._draining = False
        if self._host_pool is not None:
            # A drained run leaves no demotion staged (staged blocks would
            # read as leaked capacity).
            self._flush_demotions()
            self._host_pool.publish_gauge()
        if FLIGHT.enabled:
            # Drained, not wedged: /healthz stays 200 "idle" between runs.
            FLIGHT.mark_idle()
        if obs.REGISTRY.enabled:
            # The branch gauge is set at tick top; every family closed.
            _TREE_BRANCHES.set(0)
        wall = time.monotonic() - t0
        self.slo.export_gauges()
        kv_snap: Dict[str, Any] = {}
        if self._paged:
            kv_snap = {
                "layout": "paged",
                "block": self.kv_block,
                "pool_blocks": self.kv_blocks,
                "blocks_used": self._pool.used,
                "blocks_free": self._pool.free_count,
                "peak_blocks_used": self._peak_blocks_used,
            }
            if self._forks_life - fork0[0]:
                # Copy-on-write fork accounting for THIS run.
                kv_snap["forks"] = self._forks_life - fork0[0]
                kv_snap["fork_blocks_shared"] = (self._fork_shared_life
                                                 - fork0[1])
            if self._tree_fams_life - tree0[0]:
                # Token-tree sibling decode for THIS run: families, branch
                # rows committed (one per live branch a tick), tree ticks.
                kv_snap["tree_families"] = self._tree_fams_life - tree0[0]
                kv_snap["tree_branch_ticks"] = (self._tree_branches_life
                                                - tree0[1])
                kv_snap["tree_ticks"] = self._tree_ticks - tree0[2]
            if self._host_pool is not None:
                h1 = self._host_pool.stats()
                kv_snap.update({
                    "host_blocks": h1["host_blocks"],
                    "host_blocks_used": h1["host_blocks_used"],
                    "demotions": h1["demotions"] - host0["demotions"],
                    "restores": h1["restores"] - host0["restores"],
                    "host_drops": h1["host_drops"] - host0["host_drops"],
                })
            if self.kv_shard == "seq":
                kv_snap.update(
                    kv_shard="seq", shards=self._seq_shards,
                    free_per_shard=self._pool.free_per_shard(),
                    # This rank's pool rows, its drop block aside.
                    pool_bytes_rank=self.pool_bytes(),
                )
        prefix_snap: Dict[str, Any] = {}
        if self._prefix is not None:
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
                # Device KV bytes the run's hits moved: 0 for exact paged
                # hits, the gather for contiguous ones, the dequantized
                # rows for int8 paged ones.
                "hit_bytes_moved": self._hit_bytes_moved - hit_bytes0,
            }
        spec_snap: Dict[str, Any] = {}
        if self._speculate:
            prop = self._spec_proposed - spec0[0]
            acc = self._spec_accepted - spec0[1]
            ver = self._spec_verifies - spec0[3]
            spec_snap = {
                "drafter": type(self._drafter).__name__,
                "draft_k": self.draft_k,
                "proposed": prop,
                "accepted": acc,
                "acceptance_rate": round(acc / prop, 4) if prop else 0.0,
                "verify_ticks": self._spec_ticks - spec0[2],
                # Verify ticks that ran the tree variant of the decode
                # kernel (one launch per layer each).
                "tree_verify_ticks": self._spec_tree_ticks - spec0[4],
                # Accepted drafts per per-slot verify event, plus the free
                # bonus token (1 = no win, draft_k + 1 = every draft kept).
                "tokens_per_verify": round(1.0 + acc / ver, 4) if ver
                else 0.0,
            }
        log.info(
            "served %d request(s): %d tokens over %d decode tick(s), "
            "%.1f tok/s, mean occupancy %.2f/%d",
            len(run.results), run.tokens, run.decode_ticks,
            run.tokens / wall if wall > 0 else 0.0,
            run.occupancy / max(run.decode_ticks, 1), self.slots,
        )
        return ServeReport(
            results=sorted(run.results, key=lambda r: r.uid),
            ticks=run.tick,
            wall_s=wall,
            tokens_generated=run.tokens,
            mean_occupancy=run.occupancy / max(run.decode_ticks, 1),
            decode_ticks=run.decode_ticks,
            steps=run.steps,
            tbt_s=run.tbt,
            slo=self.slo.snapshot(),
            prefix=prefix_snap,
            kv=kv_snap,
            spec=spec_snap,
            requests=obs.aggregate_ledgers(
                [r.ledger for r in run.results if r.ledger is not None]
            ) or {},
        )
