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
first token is sampled by its final chunk and fetched with the tick.

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

Left for later slices of the port (see ROADMAP): speculation and the
prefix cache (so KV tiering) on a mesh, forks and tree-sibling decode,
disaggregation, the flight recorder and the request ledger.
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
) -> List[Request]:
    """A reproducible request trace — the JAX engine's generator, draw for
    draw, so both engines serve the same prompts: random prompts with
    ``+-prompt_jitter`` lengths, arrivals every ``arrival_every`` ticks, and
    optionally a ``prefix_share`` of requests starting with one of
    ``prefix_count`` shared ``prefix_len``-token prefixes."""
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
            arrival_tick=i * arrival_every, eos_id=eos_id,
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


class _Verify(NamedTuple):
    """A verify tick's extra operands (:meth:`SlotServer._step`)."""

    depth: Optional[np.ndarray]  # (S, Tq) RoPE offsets; None: no tree
    bits: Optional[np.ndarray]   # (S, Tq, Tq) ancestor masks; None: no tree
    ridx: np.ndarray             # (S, Tq) stream index each row predicts
    rows: np.ndarray             # (S, Tq) bool: the rows whose draw is kept
    dev0: np.ndarray             # (S,) bool: row 0 from the device tokens


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
    """

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
        if verify is None:
            sidx = np.asarray([len(t) for t in self._slot_tokens], np.int64)
            tok_s, lp_s = sample_slots(logits[ar, row], self._temp_np,
                                       self._topk_np, self._keys, sidx, emit)
        else:
            # One sampling pass: the emit slots' last rows are marked in
            # ``rows`` beside the draft rows.
            all_tok, all_lp = sample_rows(logits, self._temp_np,
                                          self._topk_np, self._keys,
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

    def _paged_reserve(self, req: Request) -> Optional[tuple]:
        """Match the prompt (pinning the path) and reserve the admission's
        worst-case private blocks: its whole span less the matched
        device-tier blocks it shares. ``None`` defers the admission (the
        pins are released); otherwise ``(matched, nodes, needed)``, the
        match recorded."""
        total = -(-(len(req.prompt) + req.max_new_tokens) // self.kv_block)
        matched, nodes = 0, []
        if self._paged_prefix:
            matched, nodes = self._prefix.match(
                np.asarray(req.prompt, np.int32), record=False)
        # A matched node on the host tier still costs one reservation: its
        # restore takes a fresh device block (consumed in _paged_hit).
        needed = total - sum(1 for n in nodes if n.tier == TIER_DEVICE)
        if not self._pool.reserve(needed):
            if nodes:
                self._prefix.release(nodes)
            return None
        if self._paged_prefix:
            self._prefix.record_match(matched)
        return matched, nodes, needed

    def _ensure_blocks(self, slot: int, tokens_needed: int) -> None:
        """Map blocks covering ``[0, tokens_needed)`` of ``slot`` — before
        every step that writes the slot (backed by its reservation)."""
        if not self._paged:
            return
        need = -(-tokens_needed // self.kv_block)
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

    def _sync_table(self) -> None:
        """Push the host block table to the device when it changed."""
        if self._paged and self._table_dirty:
            self.cache.table.copy_(torch.from_numpy(self._host_table))
            self._table_dirty = False

    def _admit(self, req: Request, slot: int, tick: int, visible_at: float,
               resv: Optional[tuple]) -> None:
        waited = max(time.monotonic() - visible_at, 0.0)
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
        salt = req.seed if req.seed is not None else req.uid
        self._keys[slot] = (self.seed * 1_000_003 + salt) \
            & 0x7FFF_FFFF_FFFF_FFFF
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
        matched, nodes, _ = resv
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

    def _plan_chunks(self) -> List[tuple]:
        """Budget pass: FIFO over prefilling slots, each taking up to a
        chunk, at most ``prefill_budget`` prompt tokens in all. Returns
        ``(slot, n, is_final)`` triples."""
        plan = []
        budget = self.prefill_budget
        for slot in self._prefill_fifo:
            if budget <= 0:
                break
            pos = self._prefill_pos[slot]
            n = min(self.prefill_chunk, len(self._prompt_np[slot]) - pos,
                    budget)
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
                       plan: List[tuple], tq: int):
        """The verify tick's host matrices: draft windows (tip at row 0,
        every spec slot reset to its committed length — the rollback) and
        the tick's prefill chunks. Returns ``(mat, n_vec, reset, reset_val,
        emit, verify)``, ``verify`` as :meth:`_step` takes it."""
        S = self.slots
        mat = np.zeros((S, tq), np.int32)
        n_vec = np.zeros((S,), np.int32)
        reset = np.zeros((S,), np.int32)
        reset_val = np.zeros((S,), np.int32)
        emit = np.zeros((S,), bool)
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
                         ridx, rows, dev0)
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
            accept = (accept_stochastic_path if self._temp_np[i] > 0.0
                      else accept_longest_path)
            kept, committed = accept(pack, alltok[i])
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
                self._deliver_token(req, int(t))
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
        return emitted

    def _retire(self, slot: int, tick: int, outcome: str,
                results) -> None:
        """Free a slot on ANY outcome arc: the happy ones (eos, budget) and
        the robustness ones (cancelled, deadline) release the same things
        — prefix pins, private paged blocks (a verify tick's rolled-back
        tail among them), the unspent reservation, and the int8 staging
        latch of a prompt cancelled mid-stage (its staged rows are garbage
        the next admission's first chunk overwrites) — so retiring a
        request mid-prefill or mid-stream is this, earlier."""
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
        self._slot_req[slot] = None
        self._slot_tokens[slot] = []
        self._slot_state[slot] = "free"
        self._prompt_np[slot] = None
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
            if self._slot_reserve[slot]:
                self._pool.unreserve(self._slot_reserve[slot])
                self._slot_reserve[slot] = 0
            self._host_table[slot, :] = 0  # stale ids must never be read
            self._slot_nblocks[slot] = 0
            self._table_dirty = True
            # Released pins can grow evictability without touching the
            # free list: let a deferred admission retry.
            self._pool.gen += 1
        if obs.REGISTRY.enabled:
            _REQUESTS.labels(outcome=outcome).inc()
        self._deliver_finish(req, result)

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
        holds blocks, reservations or prefix pins, and the only blocks in
        use are the prefix tree's (``blocks_used == blocks_cached``; 0
        without the cache on the paged layout; with KV tiering,
        ``host_blocks_used`` is the host tier's retained cache)."""
        out = {
            "blocks_private": (sum(len(s) for s in self._slot_private)
                               if self._paged else 0),
            "blocks_used": self._pool.used if self._paged else 0,
            "blocks_reserved": self._pool.reserved if self._paged else 0,
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
                "tokens": len(self._slot_tokens[i]),
                "clen": self._slot_clen[i],
                **({"nblocks": self._slot_nblocks[i]}
                   if self._paged else {}),
            })
        return out

    # -- per-request callbacks (engine thread) -----------------------------

    def _deliver_token(self, req: Request, tok: int) -> None:
        if req.on_token is not None:
            try:
                req.on_token(tok)
            except Exception:
                log.exception("on_token callback failed (rid %s)", req.uid)

    def _deliver_finish(self, req: Request, result: RequestResult) -> None:
        if req.on_finish is not None:
            try:
                req.on_finish(result)
            except Exception:
                log.exception("on_finish callback failed (rid %s)", req.uid)

    def _finish_unadmitted(self, req: Request, tick: int, outcome: str,
                           results, visible_at: float, now: float) -> None:
        """Retire a request that never reached a slot (cancelled,
        deadline-expired or shed while queued; an invalid live request):
        no engine resource to release, only its result, the outcome
        counter, the SLO verdict and the client's callback."""
        res = RequestResult(
            uid=req.uid, tokens=[], prompt_len=len(req.prompt),
            arrival_tick=req.arrival_tick, admit_tick=-1, finish_tick=tick,
            queue_wait_s=max(now - visible_at, 0.0),
            completion_s=max(now - visible_at, 0.0), outcome=outcome,
        )
        results.append(res)
        if outcome in (OUTCOME_DEADLINE, OUTCOME_SHED, OUTCOME_ERROR):
            # A categorical SLO miss: the server failed to serve it (a
            # client's cancellation is not the server's miss).
            self.slo.observe_miss()
        if obs.REGISTRY.enabled:
            _REQUESTS.labels(outcome=outcome).inc()
        if obs.TRACER.active:
            obs.instant("request_rejected", cat="serving", args={
                "rid": req.uid, "tick": tick, "outcome": outcome})
        self._deliver_finish(req, res)

    # -- the tick loop ----------------------------------------------------

    @torch.no_grad()
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
        pending: deque = deque()  # visible, validated, unadmitted
        cancel_carry: Dict[int, int] = {}  # unmatched cancels, sweep TTL
        # A live server runs indefinitely: its retention is bounded (the
        # report covers the most recent window); a finite trace keeps all.
        results: Any = deque(maxlen=4096) if live else []
        visible_wall: Dict[int, float] = {}
        tbt: Any = deque(maxlen=1 << 16) if live else []
        tick = decode_ticks = occupancy = tokens = steps = 0
        spec0 = (self._spec_proposed, self._spec_accepted, self._spec_ticks,
                 self._spec_verifies, self._spec_tree_ticks)
        prefix0 = self.prefix_stats()
        hit_bytes0 = self._hit_bytes_moved
        host0 = (self._host_pool.stats() if self._host_pool is not None
                 else None)
        if self._paged:
            self._peak_blocks_used = self._pool.used
            self._defer_gen = -1
        t0 = time.monotonic()

        while True:
            if max_ticks is not None and tick >= max_ticks:
                raise RuntimeError(
                    f"serve() exceeded max_ticks={max_ticks} with "
                    f"{len(pending)} pending request(s)"
                )
            now = time.monotonic()
            for r in source.poll(tick):
                vis = r.visible_at if r.visible_at is not None else now
                try:
                    self._validate(r)
                except ValueError as e:
                    # A live request must not kill the loop serving
                    # everyone else (a static trace was validated above).
                    log.warning("rejecting request %s: %s", r.uid, e)
                    self._finish_unadmitted(r, tick, OUTCOME_ERROR, results,
                                            vis, now)
                    continue
                pending.append(r)
                visible_wall[r.uid] = vis
                if obs.TRACER.active:
                    obs.instant("request_queued", cat="serving",
                                args={"rid": r.uid, "tick": tick})

            # The control sweep, on the loop thread: cancellation beats
            # deadline beats drain (a disconnected client's request is
            # 'cancelled' even if its deadline also passed). EOS and budget
            # retired at the end of the previous tick, so a request that
            # finished and expired on the same tick keeps its outcome.
            cancels, draining = self._take_control()
            cancels |= set(cancel_carry)
            if cancels:
                matched = set()
                for r in [r for r in pending if r.uid in cancels]:
                    pending.remove(r)
                    matched.add(r.uid)
                    self._finish_unadmitted(
                        r, tick, OUTCOME_CANCELLED, results,
                        visible_wall.pop(r.uid, now), now)
                for i, rq in enumerate(self._slot_req):
                    if rq is not None and rq.uid in cancels:
                        matched.add(rq.uid)
                        self._retire(i, tick, OUTCOME_CANCELLED, results)
                # A cancel can race its own request's submission (the
                # submit lands after this tick's poll, the cancel before
                # this sweep): unmatched uids are carried for two sweeps;
                # unknown or finished ones age out as no-ops.
                for uid in cancels - matched:
                    if uid not in cancel_carry:
                        cancel_carry[uid] = 2
                    else:
                        cancel_carry[uid] -= 1
                        if cancel_carry[uid] <= 0:
                            del cancel_carry[uid]
                for uid in matched:
                    cancel_carry.pop(uid, None)
            # Expired in the queue: finish unserved (admitting work that
            # can no longer meet its deadline steals ticks from work that
            # can); expired in flight: retire, the streamed tokens stand.
            for r in [r for r in pending
                      if r.deadline_s is not None and now >= r.deadline_s]:
                pending.remove(r)
                self._finish_unadmitted(r, tick, OUTCOME_DEADLINE, results,
                                        visible_wall.pop(r.uid, now), now)
            for i, rq in enumerate(self._slot_req):
                if (rq is not None and rq.deadline_s is not None
                        and now >= rq.deadline_s):
                    self._retire(i, tick, OUTCOME_DEADLINE, results)
            if draining:
                # Graceful drain: no new work, the queue sheds, in-flight
                # slots step on to completion.
                source.close()
                while pending:
                    r = pending.popleft()
                    self._finish_unadmitted(r, tick, OUTCOME_SHED, results,
                                            visible_wall.pop(r.uid, now), now)

            # Admit: oldest visible request per free slot; a paged
            # admission that cannot reserve its worst case waits (FIFO).
            free = [i for i, st in enumerate(self._slot_state) if st == "free"]
            while free and pending:
                if self.quantize and self._prefill_fifo:
                    break  # staged admission: one prompt in flight
                resv = None
                if self._paged:
                    if self._defer_gen == self._pool.gen:
                        break  # availability cannot have grown
                    resv = self._paged_reserve(pending[0])
                    if resv is None:
                        self._defer_gen = self._pool.gen
                        break
                req = pending.popleft()
                self._admit(req, free.pop(0), tick,
                            visible_wall.pop(req.uid, now), resv)

            if not pending and all(st == "free" for st in self._slot_state):
                if source.exhausted or draining:
                    break
                nxt = source.next_arrival()
                if nxt is not None:
                    tick = max(tick + 1, nxt)
                else:
                    # A live feeder: block until a submission (or close)
                    # wakes the source; the timeout only bounds how late a
                    # mailboxed drain is seen while idle.
                    source.wait(0.05)
                continue

            plan = self._plan_chunks()
            live_idx = [i for i, st in enumerate(self._slot_state)
                        if st == "live"]
            if obs.REGISTRY.enabled:
                _SLOTS_OCCUPIED.set(len(live_idx))
            # The tick's span (closed after the fetch and retires; a shared
            # no-op while the tracer is off).
            tick_span = obs.span(
                "serving:tick", cat="serving",
                args=None if not obs.TRACER.active else {
                    "tick": tick, "occupancy": len(live_idx),
                    "prefilling": len(self._prefill_fifo),
                    "chunk_tokens": sum(n for _, n, _ in plan),
                    "queue_depth": len(pending)})
            S = self.slots
            n_vec = np.zeros((S,), np.int32)
            reset = np.zeros((S,), np.int32)
            reset_val = np.zeros((S,), np.int32)
            emit = np.zeros((S,), bool)
            if not self._speculate:
                for i in live_idx:
                    self._ensure_blocks(i, len(self._slot_req[i].prompt)
                                        + len(self._slot_tokens[i]))
                    n_vec[i] = 1
                    emit[i] = True
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
                # THE verify tick: every live slot's draft window (tip at
                # row 0; no proposal = a one-row decode) and the tick's
                # prefill chunks in one step. A chunk wider than 32 rows
                # cannot ride int32 tree masks: trees fall back to their
                # root-path chains for that tick. A tick with no draft
                # anywhere runs the Tq = 1 shape.
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
                steps += 1
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
                steps += 1
            elif live_idx:
                # Pure-decode tick: the tokens stay on the device.
                self._sync_table()
                fused = self._step(self.tok[:, None], n_vec, reset,
                                   reset_val, emit)
                steps += 1
            if self._prefix is not None:
                # The tick's final chunks completed their prompts in the
                # cache: publish them (staged chunks published already).
                for slot, _, last in plan:
                    if last:
                        self._publish_prefix(slot)

            awaits = [i for i, st in enumerate(self._slot_state)
                      if st == "await"]
            if awaits or live_idx:
                # THE per-tick host fetch: every new token of the tick and
                # its logprob, one array (the token vector itself when no
                # step ran: a staged final chunk parked its first token).
                if fused is None:
                    fused = torch.stack([self.tok,
                                         self._lp.view(torch.int32)], 1)
                fh = fused.cpu().numpy()
                if verified:
                    # (S, 1 + Tq, 2): the token vector, then every row draw.
                    alltok = fh[:, 1:, 0]
                    alllp = np.ascontiguousarray(fh[:, 1:, 1]).view(
                        np.float32)
                    fh = fh[:, 0]
                self._tok_host = fh[:, 0].copy()
                lp_host = np.ascontiguousarray(fh[:, 1]).view(np.float32)
                now2 = time.monotonic()
                if live_idx:
                    decode_ticks += 1
                    occupancy += len(live_idx)
                for i in awaits:
                    req = self._slot_req[i]
                    first = int(self._tok_host[i])
                    self._slot_tokens[i] = [first]
                    self._slot_cum_lp[i] = float(lp_host[i])
                    self._deliver_token(req, first)
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
                    tokens += 1
                    self.slo.observe_ttft(self._slot_ttft[i])
                    if obs.REGISTRY.enabled:
                        _TOKENS.inc()
                        _TTFT.observe(self._slot_ttft[i])
                    if obs.TRACER.active:
                        obs.instant("first_token", cat="serving", args={
                            "rid": req.uid, "slot": i, "tick": tick,
                            "ttft_s": round(self._slot_ttft[i], 6)})
                    if req.eos_id is not None and first == req.eos_id:
                        self._retire(i, tick, OUTCOME_EOS, results)
                    elif req.max_new_tokens <= 1:
                        self._retire(i, tick, OUTCOME_BUDGET, results)
                if spec_plan:
                    # Live slots' tokens come from the accept walk over the
                    # fetched row draws: 1 to draft_k + 1 per slot.
                    tokens += self._spec_commit_all(
                        spec_plan, alltok, alllp, mat.shape[1], now2, tick,
                        results, tbt)
                else:
                    for i in live_idx:
                        req = self._slot_req[i]
                        tok_i = int(self._tok_host[i])
                        self._slot_tokens[i].append(tok_i)
                        self._slot_cum_lp[i] += float(lp_host[i])
                        self._deliver_token(req, tok_i)
                        tokens += 1
                        gap = max(now2 - self._last_tok_t[i], 0.0)
                        tbt.append(gap)
                        self._last_tok_t[i] = now2
                        self._slot_max_tbt[i] = max(self._slot_max_tbt[i],
                                                    gap)
                        self.slo.observe_tbt(gap)
                        if obs.REGISTRY.enabled:
                            _TOKENS.inc()
                            _TBT.observe(gap)
                        if req.eos_id is not None and tok_i == req.eos_id:
                            self._retire(i, tick, OUTCOME_EOS, results)
                        elif len(self._slot_tokens[i]) >= req.max_new_tokens:
                            self._retire(i, tick, OUTCOME_BUDGET, results)
            tick_span.__exit__(None, None, None)
            if self._paged:
                self._peak_blocks_used = max(self._peak_blocks_used,
                                             self._pool.used)
                self._pool.publish_gauges()
            if self._host_pool is not None:
                # The staged D2H flush point: the demotions this tick's
                # evictions enqueued, in one batch behind the tick's work.
                self._flush_demotions()
                self._host_pool.publish_gauge()
            self.slo.maybe_export(now)
            tick += 1

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
            prompt_tokens = sum(r.prompt_len for r in results)
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
            len(results), tokens, decode_ticks,
            tokens / wall if wall > 0 else 0.0,
            occupancy / max(decode_ticks, 1), self.slots,
        )
        return ServeReport(
            results=sorted(results, key=lambda r: r.uid),
            ticks=tick,
            wall_s=wall,
            tokens_generated=tokens,
            mean_occupancy=occupancy / max(decode_ticks, 1),
            decode_ticks=decode_ticks,
            steps=steps,
            tbt_s=tbt,
            slo=self.slo.snapshot(),
            prefix=prefix_snap,
            kv=kv_snap,
            spec=spec_snap,
        )
