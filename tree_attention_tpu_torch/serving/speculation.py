"""Speculative decoding: drafters, tree packing, and the accept walks.

Counterpart of ``tree_attention_tpu/serving/speculation.py`` (its own copy:
the port imports nothing of the JAX package). The mixed-Tq serving tick
already runs per-slot ``n_tokens > 1``, which is the **verify** step of
speculative decoding (Leviathan et al., arXiv:2211.17192): a cheap drafter
proposes candidate continuations, the model scores them all in one forward
pass, and the longest prefix the model agrees with commits at once. Row
``j`` of the verify logits is the model's next token after consuming the
path ending at row ``j``, so under greedy decoding the committed stream is
token-for-token the non-speculative one. Generalizing the draft from a
chain to a token **tree** (SpecInfer, arXiv:2305.09781) scores several
branches at once under the ancestor mask of ``forward_step``'s
``tree_mask`` (the tree variants of the decode kernels).

- :class:`DraftProposal` — a draft (chain or tree) in topological order:
  ``tokens[i]`` hangs off ``parents[i]`` (``-1`` = the committed tip).
- :func:`pack_proposal` — the verify chunk's row tokens (the tip at row 0),
  per-row depths (RoPE offsets) and the ``(rows, rows)`` ancestor mask.
- :func:`accept_longest_path` / :func:`accept_stochastic_path` — the accept
  walk over the fetched per-row argmaxes (or keyed samples): the accepted
  path plus the model's one **bonus** token at the first divergence.
- :func:`pack_siblings` — sibling branches' suffixes as one row bundle.
- Drafters: :class:`PromptLookupDrafter` (prompt-lookup n-grams over the
  slot's own history), :class:`PromptLookupTreeDrafter` (its multi-branch
  tree variant), :class:`DraftModelDrafter` (a small draft model through
  the port's own ``forward_step`` on the drafter's device).

Everything here is host work on small numpy arrays; the device sees only
the packed chunk the engine builds from it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tree_attention_tpu_torch.models.decode import forward_step, init_cache


@dataclasses.dataclass
class DraftProposal:
    """A packed draft tree: ``tokens[i]`` is a candidate token whose
    parent is draft node ``parents[i]`` (or the committed tip when
    ``parents[i] == -1``). Topological packing (``parents[i] < i``) is
    required — it makes every prefix of the arrays a valid tree, so the
    engine can clamp a proposal to its token budget by truncation."""

    tokens: np.ndarray   # (m,) int32 candidate tokens
    parents: np.ndarray  # (m,) int32, parents[i] < i, -1 = the tip

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32)
        self.parents = np.asarray(self.parents, np.int32)
        if self.tokens.shape != self.parents.shape or self.tokens.ndim != 1:
            raise ValueError(
                f"tokens/parents must be equal-length vectors, got "
                f"{self.tokens.shape}/{self.parents.shape}"
            )
        if any(p < -1 or p >= i for i, p in enumerate(self.parents)):
            raise ValueError(
                f"parents must be topological (-1 <= parents[i] < i), "
                f"got {self.parents.tolist()}"
            )

    def __len__(self) -> int:
        return len(self.tokens)

    @property
    def is_chain(self) -> bool:
        """A linear draft: node i hangs off node i-1 — verifiable under
        the plain causal mask (no tree-mask program needed)."""
        return all(int(p) == i - 1 for i, p in enumerate(self.parents))

    def truncated(self, m: int) -> "DraftProposal":
        """The first ``m`` nodes (a valid tree by topological packing)."""
        if m >= len(self):
            return self
        return DraftProposal(tokens=self.tokens[:m],
                             parents=self.parents[:m])

    def chain_prefix(self) -> "DraftProposal":
        """The root path through first children — the fallback when the
        verify path cannot run a tree mask (seq-sharded contiguous
        cache): keep following each node's first packed child."""
        keep: List[int] = []
        cur = -1
        while True:
            nxt = next((i for i, p in enumerate(self.parents)
                        if int(p) == cur), None)
            if nxt is None:
                break
            keep.append(nxt)
            cur = nxt
        return DraftProposal(
            tokens=self.tokens[keep],
            parents=np.arange(-1, len(keep) - 1, dtype=np.int32),
        )


@dataclasses.dataclass
class PackedSpec:
    """One slot's verify chunk, device-facing: row 0 is the committed tip
    token (its KV is the one pending write), rows ``1..m`` the draft
    nodes. ``depth[j]`` is the row's distance below the committed length
    (its RoPE offset); ``anc[j]`` its window visibility row (ancestors +
    itself). ``row_parents`` is in ROW ids (tip = row 0)."""

    row_tokens: np.ndarray   # (rows,) int32
    row_parents: np.ndarray  # (rows,) int32; row_parents[0] = -1
    depth: np.ndarray        # (rows,) int32; depth[0] = 0
    anc: np.ndarray          # (rows, rows) bool

    @property
    def rows(self) -> int:
        return len(self.row_tokens)


def pack_proposal(tip_token: int, prop: DraftProposal) -> PackedSpec:
    """Prefix the committed tip as row 0 and derive depths + the ancestor
    mask. A chain proposal yields ``depth == arange`` and a
    lower-triangular ``anc`` — exactly the plain causal contract, so the
    linear program needs neither operand."""
    m = len(prop)
    rows = m + 1
    row_tokens = np.empty((rows,), np.int32)
    row_tokens[0] = tip_token
    row_tokens[1:] = prop.tokens
    row_parents = np.empty((rows,), np.int32)
    row_parents[0] = -1
    row_parents[1:] = prop.parents + 1  # -1 (tip) maps to row 0
    depth = np.zeros((rows,), np.int32)
    anc = np.zeros((rows, rows), bool)
    anc[0, 0] = True
    for j in range(1, rows):
        p = row_parents[j]
        depth[j] = depth[p] + 1
        anc[j] = anc[p]
        anc[j, j] = True
    return PackedSpec(row_tokens=row_tokens, row_parents=row_parents,
                      depth=depth, anc=anc)


def accept_longest_path(
    pack: PackedSpec, row_argmax: Sequence[int]
) -> Tuple[List[int], List[int]]:
    """The greedy accept rule over one slot's fetched verify argmaxes.

    ``row_argmax[j]`` is the model's greedy next token after consuming
    the root path ending at row ``j``. Walk from the tip: at each row,
    the model's true next token either matches a child (accept it, keep
    walking) or nobody (that token is the **bonus** — the model said it,
    so it commits for free). Returns ``(kept_rows, committed_tokens)``:
    ``kept_rows`` the accepted draft rows in path order (ascending, by
    topological packing; row 0 is implicit — its KV is always kept) and
    ``committed_tokens`` the ``len(kept_rows) + 1`` tokens that commit,
    IDENTICAL to what non-speculative greedy decode would have emitted.
    """
    kept: List[int] = []
    committed: List[int] = []
    cur = 0
    rows = pack.rows
    while True:
        nxt = int(row_argmax[cur])
        committed.append(nxt)
        child = next(
            (j for j in range(cur + 1, rows)
             if int(pack.row_parents[j]) == cur
             and int(pack.row_tokens[j]) == nxt),
            None,
        )
        if child is None:
            return kept, committed
        kept.append(child)
        cur = child


def accept_stochastic_path(
    pack: PackedSpec, row_sample: Sequence[int]
) -> Tuple[List[int], List[int]]:
    """The STOCHASTIC accept rule — Leviathan et al.'s
    speculative-sampling ratio test (arXiv:2211.17192) specialized to
    point-mass drafters, which is what every drafter here proposes.

    ``row_sample[j]`` is a draw from the TARGET model's (temperature /
    top-k adjusted) distribution after consuming the path ending at row
    ``j`` (``models.decode.sample_rows`` under the request's
    ``fold_in(key, stream_index)`` seed). For a draft that proposes
    token ``x`` with probability 1, the ratio test accepts with
    probability ``p(x)`` and otherwise emits a sample from the residual
    ``(p - q)+ / Z`` — which for a point mass at ``x`` is exactly
    ``p`` restricted to ``y != x``. Drawing ``s ~ p`` once and
    accepting iff ``s == x`` (else emitting ``s``) realizes both cases
    with the correct joint law, so each committed token is distributed
    EXACTLY as non-speculative sampling — and, because the draw's key
    is a pure function of the request key and the token's stream index,
    the committed stream is bit-identical to the non-speculative
    sampled stream under the same seed.

    Multi-child tree nodes chain the same test over the packed
    children; the marginal emission law is unchanged (each rejected
    point mass removes only the mass the next test renormalizes over).

    The walk is therefore the SAME walk as the greedy rule with samples
    in place of argmaxes — this wrapper exists to carry the contract.
    """
    return accept_longest_path(pack, row_sample)


def pack_siblings(suffixes: Sequence[Sequence[int]]) -> PackedSpec:
    """Pack k sibling branches' divergent suffixes into ONE verify-shaped
    row bundle (token-tree sibling decode; SpecInfer's tree pointed at
    futures, arXiv:2305.09781).

    Every live branch must carry an EQUAL-length suffix (each gains
    exactly one token per tick, so this is an invariant, asserted):
    branch ``r``'s suffix occupies rows ``[r*s, (r+1)*s)`` in branch
    order, ``depth[r*s + j] = j`` (its RoPE offset below the frozen
    fork-point length), and the ancestor mask is per-branch
    lower-triangular — rows NEVER see another branch's rows, which is
    what lets k divergent futures share one slot's committed history.

    The bundle must fit the attention kernels' int32 bitmask packing:
    ``rows <= 32`` (the same Tq contract the decode kernels' tree variant
    enforces); the engine's admission fit gate guarantees it, and the
    assert here is the packer's own last line of defense.
    """
    k = len(suffixes)
    if k < 1:
        raise ValueError("pack_siblings needs >= 1 live branch")
    s = len(suffixes[0])
    if any(len(sx) != s for sx in suffixes):
        raise ValueError(
            f"sibling suffixes must be equal length, got "
            f"{[len(sx) for sx in suffixes]}"
        )
    rows = k * s
    assert rows <= 32, (
        f"sibling bundle of {k} branches x {s} tokens = {rows} rows "
        f"exceeds the 32-row tree-mask contract (admission fit gate "
        f"should have forced the fork-slot path)"
    )
    row_tokens = np.empty((rows,), np.int32)
    row_parents = np.empty((rows,), np.int32)
    depth = np.empty((rows,), np.int32)
    anc = np.zeros((rows, rows), bool)
    for r in range(k):
        o = r * s
        row_tokens[o:o + s] = np.asarray(suffixes[r], np.int32)
        depth[o:o + s] = np.arange(s, dtype=np.int32)
        row_parents[o] = -1
        row_parents[o + 1:o + s] = np.arange(o, o + s - 1, dtype=np.int32)
        anc[o:o + s, o:o + s] = np.tril(np.ones((s, s), bool))
    return PackedSpec(row_tokens=row_tokens, row_parents=row_parents,
                      depth=depth, anc=anc)


# ---------------------------------------------------------------------------
# Drafters
# ---------------------------------------------------------------------------


class Drafter:
    """The drafter interface: given a slot's full token history (prompt +
    emitted tokens, the last of which is the committed tip), propose up
    to ``k`` candidate tokens hanging off the tip. ``None`` (or an empty
    proposal) means "nothing to speculate" — the slot decodes normally
    that tick. Drafters are host-side and per-engine (not per-slot): all
    state they need is the history they are handed."""

    def propose(self, history: np.ndarray, k: int) -> Optional[DraftProposal]:
        raise NotImplementedError


class PromptLookupDrafter(Drafter):
    """Prompt-lookup decoding: n-gram match against the slot's OWN
    history. The last ``g`` tokens (longest ``g`` first) are searched for
    an earlier occurrence; the ``k`` tokens that followed that occurrence
    are proposed as a chain. Zero extra model, zero device work — the
    drafter that wins on repetitive/templated traffic (code, retrieval,
    chat boilerplate), and loses nothing elsewhere (a miss proposes
    nothing and the tick is a plain decode)."""

    def __init__(self, ngram_max: int = 3, ngram_min: int = 1,
                 lookback: int = 1024):
        if not 1 <= ngram_min <= ngram_max:
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max, got "
                f"{ngram_min}/{ngram_max}"
            )
        if lookback < ngram_max + 1:
            raise ValueError(f"lookback too small: {lookback}")
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min
        # The match scan is O(lookback) per call and runs on the serving
        # hot path every verify tick — bound it (recent history is where
        # the repetition that accepts lives anyway).
        self.lookback = lookback

    @staticmethod
    def _matches(h: np.ndarray, g: int) -> np.ndarray:
        """Start indices p < len(h) - g with h[p:p+g] == h[-g:]."""
        n = len(h)
        if n <= g:
            return np.empty((0,), np.int64)
        win = np.lib.stride_tricks.sliding_window_view(h, g)  # (n-g+1, g)
        eq = (win[:-1] == h[n - g:]).all(axis=1)
        return np.flatnonzero(eq)

    def propose(self, history: np.ndarray, k: int) -> Optional[DraftProposal]:
        h = np.asarray(history, np.int32)[-self.lookback:]
        for g in range(self.ngram_max, self.ngram_min - 1, -1):
            starts = self._matches(h, g)
            if len(starts) == 0:
                continue
            # Most recent match whose continuation is a FULL k tokens
            # (matches near the tail cap the draft at the distance to
            # the end — on a looping stream that would freeze speculation
            # depth at 1); fall back to the most recent match otherwise.
            p = int(starts[-1])
            for q in starts[::-1]:
                if len(h) - (int(q) + g) >= k:
                    p = int(q)
                    break
            cont = h[p + g:p + g + k]
            if len(cont) == 0:
                continue
            return DraftProposal(
                tokens=cont,
                parents=np.arange(-1, len(cont) - 1, dtype=np.int32),
            )
        return None


class PromptLookupTreeDrafter(PromptLookupDrafter):
    """The tree variant of prompt lookup: when the history's n-gram
    matches continue in more than one way, propose up to ``width``
    distinct branches (most recent match first) and split the ``k``-node
    budget across them — one verify pass scores them all under the tree
    mask, and the longest accepted root path commits."""

    def __init__(self, ngram_max: int = 3, ngram_min: int = 1,
                 width: int = 2, lookback: int = 1024):
        super().__init__(ngram_max=ngram_max, ngram_min=ngram_min,
                         lookback=lookback)
        if width < 1:
            raise ValueError(f"width must be >= 1, got {width}")
        self.width = width

    def propose(self, history: np.ndarray, k: int) -> Optional[DraftProposal]:
        h = np.asarray(history, np.int32)[-self.lookback:]
        branches: List[np.ndarray] = []
        seen: Dict[int, bool] = {}
        for g in range(self.ngram_max, self.ngram_min - 1, -1):
            starts = self._matches(h, g)
            # Most recent context first — it gets the deepest branch.
            for p in starts[::-1]:
                cont = h[p + g:p + g + k]
                if len(cont) == 0:
                    continue
                first = int(cont[0])
                if first in seen:
                    continue
                seen[first] = True
                branches.append(cont)
                if len(branches) >= self.width:
                    break
            if len(branches) >= self.width:
                break
        if not branches:
            return None
        # Never more branches than budget (a 1-node branch is the
        # minimum spend; more would push the primary's share negative).
        branches = branches[:max(k, 1)]
        # Split the node budget: the primary branch keeps the remainder.
        per = max(k // len(branches), 1)
        lens = [per] * len(branches)
        lens[0] += k - per * len(branches)
        tokens: List[int] = []
        parents: List[int] = []
        for br, ln in zip(branches, lens):
            prev = -1
            for t in br[:ln]:
                parents.append(prev)
                prev = len(tokens)
                tokens.append(int(t))
        if not tokens:
            return None
        return DraftProposal(
            tokens=np.asarray(tokens, np.int32),
            parents=np.asarray(parents, np.int32),
        )


class DraftModelDrafter(Drafter):
    """A small draft model proposes a greedy chain — the classic two-model
    speculative setup (Leviathan et al., arXiv:2211.17192), behind the
    same interface as the free drafters. Each call prefills the history
    into a fresh contiguous cache on the draft model's device and takes
    ``k - 1`` greedy steps (the port's :func:`forward_step` and
    :func:`init_cache`): stateless per call, so engine-side rollbacks need
    no mirroring here. One host fetch returns the ``k`` tokens."""

    def __init__(self, params, cfg):
        self.params = params
        self.cfg = cfg

    def propose(self, history: np.ndarray, k: int) -> Optional[DraftProposal]:
        h = np.asarray(history, np.int32)
        plen = len(h)
        if plen < 1 or k < 1:
            return None
        dev = self.params["embed"].device
        with torch.no_grad():
            cache = init_cache(self.cfg, 1, plen + k, device=dev)
            logits, cache = forward_step(
                self.params, torch.from_numpy(h)[None].to(dev), cache,
                self.cfg)
            toks = [logits[:, -1].argmax(-1)]
            for _ in range(k - 1):
                logits, cache = forward_step(self.params, toks[-1][:, None],
                                             cache, self.cfg)
                toks.append(logits[:, -1].argmax(-1))
        cont = torch.cat(toks).cpu().numpy().astype(np.int32)
        return DraftProposal(
            tokens=cont,
            parents=np.arange(-1, len(cont) - 1, dtype=np.int32),
        )


def make_drafter(name: str, **kw) -> Drafter:
    """The CLI-facing registry: ``"ngram"`` (prompt-lookup chain, the
    zero-cost default), ``"ngram-tree"`` (its multi-branch tree variant),
    ``"model"`` (requires ``params=``/``cfg=`` of a draft model)."""
    if name == "ngram":
        return PromptLookupDrafter(**kw)
    if name == "ngram-tree":
        return PromptLookupTreeDrafter(**kw)
    if name == "model":
        if "params" not in kw or "cfg" not in kw:
            raise ValueError(
                "drafter 'model' needs params= and cfg= of a draft model"
            )
        return DraftModelDrafter(kw["params"], kw["cfg"])
    raise ValueError(
        f"unknown drafter {name!r} (expected 'ngram', 'ngram-tree' or "
        f"'model')"
    )
