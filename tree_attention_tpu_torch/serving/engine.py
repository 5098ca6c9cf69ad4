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

Left for later slices of the port (see ROADMAP): whole-prompt admission,
the prefix cache, speculation, forks and tree-sibling decode, KV tiering,
disaggregation, cancellation/deadlines/drain and the HTTP ingress, tracing
and the flight recorder.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from tree_attention_tpu_torch import obs
from tree_attention_tpu_torch.models.decode import (
    KVCache,
    forward_step,
    init_cache,
    init_paged_cache,
    paged_insert_slot,
    quantize_cache,
    quantize_paged_blocks,
    sample_slots,
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

OUTCOME_EOS = "eos"        # sampled the request's eos_id
OUTCOME_BUDGET = "budget"  # hit max_new_tokens


@dataclasses.dataclass
class Request:
    """One generation request. ``arrival_tick`` is synthetic-trace time in
    ticks (0 = queued at start); ``eos_id`` stops generation early (the EOS
    token is included in the output). ``temperature``/``top_k`` override
    the engine's defaults; ``seed`` seeds the request's sampling generator
    (default: its uid)."""

    uid: int
    prompt: Sequence[int]
    max_new_tokens: int
    arrival_tick: int = 0
    eos_id: Optional[int] = None
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    seed: Optional[int] = None


@dataclasses.dataclass
class RequestResult:
    uid: int
    tokens: List[int]
    prompt_len: int
    arrival_tick: int
    admit_tick: int
    finish_tick: int
    queue_wait_s: float
    completion_s: float  # visible -> finished, wall seconds
    outcome: str
    ttft_s: float = 0.0  # visible -> first sampled token, wall seconds
    cum_logprob: float = 0.0  # sum of the model log-probs of the tokens


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
    kv: Dict[str, Any] = dataclasses.field(default_factory=dict)

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
            **({"kv": self.kv} if self.kv else {}),
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
    yet. The base class is an empty, exhausted source."""

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
        greedy); each request's generator is seeded from ``seed`` and the
        request's own ``seed`` (or uid).
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
    ):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
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
        self.quantize = quantize
        self.quant_kernel = quant_kernel
        self._paged = kv_layout == "paged"
        if self._paged:
            self.kv_block = 64 if kv_block is None else kv_block
            self._npb = -(-cache_len // self.kv_block)  # table width
            self.kv_blocks = (slots * self._npb if kv_blocks is None
                              else kv_blocks)
            if kv_shard == "seq":
                # Round up to whole per-shard slices: extra blocks only
                # ever add capacity.
                w = self._seq_shards
                self.kv_blocks = -(-self.kv_blocks // w) * w
                self._pool = ShardedBlockAllocator(self.kv_blocks, w)
            else:
                self._pool = BlockAllocator(self.kv_blocks)
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
        if quantize:
            # The one exact B=1 staging cache of staged admission.
            self._staging: KVCache = init_cache(cfg, 1, cache_len,
                                                device=self.device)
        self.tok = torch.zeros((slots,), dtype=torch.int32, device=self.device)
        self._lp = torch.zeros((slots,), dtype=torch.float32,
                               device=self.device)
        self._temp_np = np.zeros((slots,), np.float32)
        self._topk_np = np.zeros((slots,), np.int32)
        self._gens = [torch.Generator(device=self.device)
                      for _ in range(slots)]

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

    # -- the per-tick program ---------------------------------------------

    def _chunk_bucket(self, n: int) -> int:
        """Tq bucket of a chunk of ``n`` prompt tokens: power of two from 8,
        capped at ``prefill_chunk``."""
        return _bucket(n, self.prefill_chunk, floor=min(8, self.prefill_chunk))

    def _step(self, tokens: torch.Tensor, n_vec: np.ndarray,
              reset: np.ndarray, reset_val: np.ndarray,
              emit: np.ndarray) -> torch.Tensor:
        """THE per-tick step: one mixed-Tq forward_step for every slot.

        Slot ``i`` consumes ``n_vec[i]`` rows of ``tokens`` ``(S, Tq)`` (1
        for a decode slot, a chunk for a prefilling slot, 0 = inert);
        ``reset`` first sets a slot's length to ``reset_val`` (0 for a
        first chunk — the slot reuses a retired slot's region). Each slot
        samples from its last valid row; ``emit`` keeps the sample (decode
        slots and final chunks), otherwise the slot's row-0 token and
        parked logprob ride through. Returns the ``(S, 2)`` int32 fetch
        vehicle: tokens and bitcast logprobs."""
        S = self.slots
        ctrl = torch.from_numpy(np.stack(
            [n_vec, reset, reset_val, emit]).astype(np.int32)).to(self.device)
        n_t, reset_t, reset_val_t, emit_t = ctrl[0], ctrl[1] > 0, ctrl[2], \
            ctrl[3] > 0
        length = torch.where(reset_t, reset_val_t, self.cache.length)
        cache = dataclasses.replace(self.cache, length=length)
        logits, self.cache = forward_step(self.params, tokens, cache,
                                          self.cfg, n_tokens=n_t,
                                          quant_kernel=self.quant_kernel,
                                          **self._fs_kw)
        row = (n_t - 1).clamp(min=0).long()
        last = logits[torch.arange(S, device=self.device), row]
        tok_s, lp_s = sample_slots(last, self._temp_np, self._topk_np,
                                   self._gens, emit)
        self.tok = torch.where(emit_t, tok_s, tokens[:, 0].int())
        self._lp = torch.where(emit_t, lp_s, self._lp)
        return torch.stack([self.tok, self._lp.view(torch.int32)], 1)

    def _run_staged_chunk(self, slot: int, n: int, last: bool) -> None:
        """Staged admission (int8 caches): advance one slot's exact prefill
        in the staging cache by ``n`` tokens. The final chunk samples the
        slot's first token from its last row (parked in the token vector
        until the tick's fetch), zeroes the staging cache's stale tail,
        quantizes the prompt and inserts it into the slot."""
        first = self._prefill_pos[slot] == 0
        plen = len(self._prompt_np[slot])
        mat = np.zeros((1, self._chunk_bucket(n)), np.int32)
        mat[0, :n] = self._consume_chunk(slot, n, last)
        staging = self._staging
        if first:
            staging = dataclasses.replace(staging,
                                          length=torch.zeros_like(
                                              staging.length))
        n_t = torch.tensor([n], dtype=torch.int32, device=self.device)
        logits, self._staging = forward_step(
            self.params, torch.from_numpy(mat).to(self.device), staging,
            self.cfg, n_tokens=n_t)
        if not last:
            return
        tok, lp = sample_slots(logits[:, n - 1], self._temp_np[slot:slot + 1],
                               self._topk_np[slot:slot + 1],
                               self._gens[slot:slot + 1],
                               np.ones((1,), bool))
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
                              **self._fs_kw)
            return
        qc = quantize_cache(KVCache(k=k, v=v, length=self._staging.length))
        for name in ("k", "v", "k_scale", "v_scale"):
            getattr(self.cache, name)[:, slot] = getattr(qc, name)[:, 0]
        self.cache.length[slot] = plen

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

    def _paged_reserve(self, req: Request) -> Optional[int]:
        """Reserve the admission's worst-case blocks; ``None`` defers it."""
        need = -(-(len(req.prompt) + req.max_new_tokens) // self.kv_block)
        return need if self._pool.reserve(need) else None

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
               needed: Optional[int]) -> None:
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
        self._gens[slot].manual_seed(
            (self.seed * 1_000_003 + salt) & 0x7FFF_FFFF_FFFF_FFFF
        )
        self.slo.observe_queue_wait(waited)
        self._prompt_np[slot] = np.asarray(req.prompt, np.int32)
        if self._paged:
            self._slot_reserve[slot] = needed
            self._slot_private[slot] = set()
            self._slot_nblocks[slot] = 0
        self._prefill_pos[slot] = 0
        self._slot_state[slot] = "prefill"
        self._prefill_fifo.append(slot)
        if obs.REGISTRY.enabled:
            _QUEUE_WAIT.observe(waited)

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
            self._prefill_fifo.remove(slot)
        if obs.REGISTRY.enabled:
            _PREFILL_CHUNKS.inc()
        return rows

    def _retire(self, slot: int, tick: int, outcome: str,
                results: List[RequestResult]) -> None:
        """Free a slot: record its result, return its blocks and unspent
        reservation, mark it free."""
        req = self._slot_req[slot]
        admit_tick, visible_at = self._slot_admit[slot]
        now = time.monotonic()
        results.append(RequestResult(
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
        ))
        self.slo.observe_request(self._slot_ttft[slot],
                                 self._slot_max_tbt[slot])
        self._slot_req[slot] = None
        self._slot_tokens[slot] = []
        self._slot_state[slot] = "free"
        self._prompt_np[slot] = None
        if self._paged:
            for bid in self._slot_private[slot]:
                self._pool.free_private(bid)
            self._slot_private[slot] = set()
            if self._slot_reserve[slot]:
                self._pool.unreserve(self._slot_reserve[slot])
                self._slot_reserve[slot] = 0
            self._host_table[slot, :] = 0  # stale ids must never be read
            self._slot_nblocks[slot] = 0
            self._table_dirty = True
        if obs.REGISTRY.enabled:
            _REQUESTS.labels(outcome=outcome).inc()

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
        holds blocks or reservations (no prefix tree: ``blocks_used`` must
        be 0)."""
        return {
            "blocks_private": (sum(len(s) for s in self._slot_private)
                               if self._paged else 0),
            "blocks_used": self._pool.used if self._paged else 0,
            "blocks_reserved": self._pool.reserved if self._paged else 0,
            "blocks_cached": 0,
            "pins": 0,
        }

    # -- the tick loop ----------------------------------------------------

    def serve(self, requests: Union[Sequence[Request], RequestSource],
              max_ticks: Optional[int] = None) -> ServeReport:
        """Run the tick loop until the request source drains. A pre-built
        trace is validated up front; ``max_ticks`` bounds runaway loops
        (raises if work remains)."""
        if isinstance(requests, RequestSource):
            source = requests
        else:
            for r in requests:
                self._validate(r)
            source = StaticRequestSource(requests)
        pending: deque = deque()
        results: List[RequestResult] = []
        visible_wall: Dict[int, float] = {}
        tbt: List[float] = []
        tick = decode_ticks = occupancy = tokens = steps = 0
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
                self._validate(r)
                pending.append(r)
                visible_wall[r.uid] = now

            # Admit: oldest visible request per free slot; a paged
            # admission that cannot reserve its worst case waits (FIFO).
            free = [i for i, st in enumerate(self._slot_state) if st == "free"]
            while free and pending:
                if self.quantize and self._prefill_fifo:
                    break  # staged admission: one prompt in flight
                needed = None
                if self._paged:
                    if self._defer_gen == self._pool.gen:
                        break  # availability cannot have grown
                    needed = self._paged_reserve(pending[0])
                    if needed is None:
                        self._defer_gen = self._pool.gen
                        break
                req = pending.popleft()
                self._admit(req, free.pop(0), tick,
                            visible_wall.pop(req.uid, now), needed)

            if not pending and all(st == "free" for st in self._slot_state):
                if source.exhausted:
                    break
                nxt = source.next_arrival()
                if nxt is not None:
                    tick = max(tick + 1, nxt)
                else:
                    source.wait(0.05)
                continue

            plan = self._plan_chunks()
            live_idx = [i for i, st in enumerate(self._slot_state)
                        if st == "live"]
            if obs.REGISTRY.enabled:
                _SLOTS_OCCUPIED.set(len(live_idx))
            S = self.slots
            n_vec = np.zeros((S,), np.int32)
            reset = np.zeros((S,), np.int32)
            reset_val = np.zeros((S,), np.int32)
            emit = np.zeros((S,), bool)
            for i in live_idx:
                self._ensure_blocks(i, len(self._slot_req[i].prompt)
                                    + len(self._slot_tokens[i]))
                n_vec[i] = 1
                emit[i] = True
            fused = None
            if self.quantize and plan:
                # Staged chunks run first; the tick's step is then the
                # decode-only step over the int8 cache.
                for slot, n, last in plan:
                    self._run_staged_chunk(slot, n, last)
                plan = []
            if plan:
                # The mixed tick: decode rows + prefill chunks in one step.
                mat = np.zeros((S, self._chunk_bucket(
                    max(n for _, n, _ in plan))), np.int32)
                mat[live_idx, 0] = self._tok_host[live_idx]
                for slot, n, last in plan:
                    self._ensure_blocks(slot, self._prefill_pos[slot] + n)
                    first = self._prefill_pos[slot] == 0
                    mat[slot, :n] = self._consume_chunk(slot, n, last)
                    n_vec[slot] = n
                    reset[slot] = first
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
                    self._slot_state[i] = "live"
                    _, vis = self._slot_admit[i]
                    self._slot_ttft[i] = max(now2 - vis, 0.0)
                    self._last_tok_t[i] = now2
                    tokens += 1
                    self.slo.observe_ttft(self._slot_ttft[i])
                    if obs.REGISTRY.enabled:
                        _TOKENS.inc()
                        _TTFT.observe(self._slot_ttft[i])
                    if req.eos_id is not None and first == req.eos_id:
                        self._retire(i, tick, OUTCOME_EOS, results)
                    elif req.max_new_tokens <= 1:
                        self._retire(i, tick, OUTCOME_BUDGET, results)
                for i in live_idx:
                    req = self._slot_req[i]
                    tok_i = int(self._tok_host[i])
                    self._slot_tokens[i].append(tok_i)
                    self._slot_cum_lp[i] += float(lp_host[i])
                    tokens += 1
                    gap = max(now2 - self._last_tok_t[i], 0.0)
                    tbt.append(gap)
                    self._last_tok_t[i] = now2
                    self._slot_max_tbt[i] = max(self._slot_max_tbt[i], gap)
                    self.slo.observe_tbt(gap)
                    if obs.REGISTRY.enabled:
                        _TOKENS.inc()
                        _TBT.observe(gap)
                    if req.eos_id is not None and tok_i == req.eos_id:
                        self._retire(i, tick, OUTCOME_EOS, results)
                    elif len(self._slot_tokens[i]) >= req.max_new_tokens:
                        self._retire(i, tick, OUTCOME_BUDGET, results)
            if self._paged:
                self._peak_blocks_used = max(self._peak_blocks_used,
                                             self._pool.used)
                self._pool.publish_gauges()
            self.slo.maybe_export(now)
            tick += 1

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
            if self.kv_shard == "seq":
                kv_snap.update(
                    kv_shard="seq", shards=self._seq_shards,
                    free_per_shard=self._pool.free_per_shard(),
                    # This rank's pool rows, its drop block aside.
                    pool_bytes_rank=self.pool_bytes(),
                )
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
            kv=kv_snap,
        )
