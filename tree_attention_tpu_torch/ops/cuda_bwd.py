"""Flash-attention backward on Hopper: kernels B6 (dQ) and B7 (dK/dV).

Counterpart of ``tree_attention_tpu/ops/pallas_bwd.py``; the kernels are
``csrc/flash_bwd.cu`` (design notes and the bound there). Both recompute
``p = exp(q.k^T * scale - lse)`` from the forward's lse and read
``delta = rowsum(dO * O) - dlse`` (the lse cotangent folded in, as
``ops/vjp.py`` explains). :func:`bwd_residuals` computes delta and remaps
the lse of rows that see no key from ``-inf`` to ``+inf``, so that p is
exactly 0 on those rows instead of ``exp(-inf - (-inf)) = NaN`` — plain torch
ops, as JAX computes them outside its kernels. JAX's 128-lane residual
packing is a TPU layout and does not carry over.

B6 and B7 each have two bodies, chosen by dtype alone: bf16 runs on the
tensor cores (``wgmma`` fed by a TMA ring; B6 with Q resident, B7 with K/V
resident and Q/dO streamed), float32 on the CUDA cores. Their tiles are
``ops/tuning.DQ_TILES`` and ``DKV_TILES``, checked against the built
library; :func:`dkv_walk` states the (query head, Q tile) walk of B7's bf16
body. Each wrapper runs its kernel for a CUDA tensor
and its plain version (:func:`dq_plain`, :func:`dkv_plain`) for a CPU
tensor — nothing else: a build or launch failure raises. ``.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from tree_attention_tpu_torch.ops import _build
from tree_attention_tpu_torch.ops.block_utils import (
    NEG_INF,
    Offset,
    first_live_q,
    offsets,
)
from tree_attention_tpu_torch.ops.cuda_attention import check_tiles
from tree_attention_tpu_torch.ops.cuda_decode import _DTYPES, _check
from tree_attention_tpu_torch.ops.reference import _group, default_scale
from tree_attention_tpu_torch.ops.tuning import DKV_TILES, DQ_TILES

_fns = None


def _launchers():
    global _fns
    if _fns is None:
        lib = _build.library("flash_bwd")
        check_tiles(lib, "flash_dq", DQ_TILES)
        check_tiles(lib, "flash_dkv", DKV_TILES)
        dq, dkv = lib.flash_dq_launch, lib.flash_dkv_launch
        dq.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        dkv.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                        + [ctypes.c_float, ctypes.c_void_p])
        dq.restype = dkv.restype = ctypes.c_int
        _fns = (dq, dkv)
    return _fns


def bwd_residuals(out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                  dlse: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lse_f, delta)`` f32 ``(B, Hq, Tq)``: lse with ``-inf`` rows mapped
    to ``+inf``, and ``rowsum(dO * O) - dlse`` (``dlse`` None = zeros)."""
    delta = (dout.float() * out.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
    lse_f = torch.where(torch.isneginf(lse), float("inf"), lse.float())
    return lse_f.contiguous(), delta.contiguous()


def _p_ds(q, k, v, dout, lse, delta, *, causal, scale, q_offset, kv_offset):
    """Dense ``(p, ds)`` f32 ``(B, Hkv, G, Tq, Tk)`` — the kernels'
    arithmetic in one materialised pass: scores in f32, masked entries
    ``-inf`` so ``p = exp(s - lse)`` is exactly 0 there (and on ``+inf``
    rows)."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    G = _group(q, k)
    s = torch.einsum("bhgqd,bhkd->bhgqk",
                     q.reshape(B, Hkv, G, Tq, D).float(), k.float())
    s = s * default_scale(D, scale)
    visible = torch.ones((B, Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        offs = offsets(q_offset, kv_offset, B, q.device).long()
        qpos = offs[0][:, None] + torch.arange(Tq, device=q.device)
        kpos = offs[1][:, None] + torch.arange(Tk, device=q.device)
        visible = kpos[:, None, :] <= qpos[:, :, None]
    s = s.masked_fill(~visible[:, None, None], NEG_INF)
    p = torch.exp(s - lse.reshape(B, Hkv, G, Tq, 1))
    dp = torch.einsum("bhgqd,bhkd->bhgqk",
                      dout.reshape(B, Hkv, G, Tq, D).float(), v.float())
    return p, p * (dp - delta.reshape(B, Hkv, G, Tq, 1))


def dq_plain(q, k, v, dout, lse, delta, *, causal: bool = False,
             scale: Optional[float] = None, q_offset: Offset = 0,
             kv_offset: Offset = 0) -> torch.Tensor:
    """B6's plain version (any device): ``dq = (ds in K's dtype) . K *
    scale`` in f32, returned in q's dtype. ``lse``/``delta`` as from
    :func:`bwd_residuals`. One batch row at a time (bounded memory)."""
    B, Hq, Tq, D = q.shape
    out = []
    for b in range(B):
        sl = slice(b, b + 1)
        _, ds = _p_ds(q[sl], k[sl], v[sl], dout[sl], lse[sl], delta[sl],
                      causal=causal, scale=scale,
                      q_offset=_row(q_offset, b), kv_offset=_row(kv_offset, b))
        dq = torch.einsum("bhgqk,bhkd->bhgqd", ds.to(k.dtype).float(),
                          k[sl].float()) * default_scale(D, scale)
        out.append(dq.reshape(1, Hq, Tq, D).to(q.dtype))
    return torch.cat(out)


def dkv_plain(q, k, v, dout, lse, delta, *, causal: bool = False,
              scale: Optional[float] = None, q_offset: Offset = 0,
              kv_offset: Offset = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """B7's plain version (any device): ``dk = (ds in Q's dtype)^T . Q *
    scale`` and ``dv = (p in dO's dtype)^T . dO``, reduced over each KV
    head's query-head group, in f32, returned in k's and v's dtypes."""
    D = q.shape[-1]
    dks, dvs = [], []
    for b in range(q.shape[0]):
        sl = slice(b, b + 1)
        p, ds = _p_ds(q[sl], k[sl], v[sl], dout[sl], lse[sl], delta[sl],
                      causal=causal, scale=scale,
                      q_offset=_row(q_offset, b), kv_offset=_row(kv_offset, b))
        qg = q[sl].reshape(*p.shape[:4], D).float()
        dg = dout[sl].reshape(*p.shape[:4], D).float()
        dks.append((torch.einsum("bhgqk,bhgqd->bhkd", ds.to(q.dtype).float(),
                                 qg) * default_scale(D, scale)).to(k.dtype))
        dvs.append(torch.einsum("bhgqk,bhgqd->bhkd", p.to(dout.dtype).float(),
                                dg).to(v.dtype))
    return torch.cat(dks), torch.cat(dvs)


def dq_one_key_bound(q, k, v, dout, delta, *, causal: bool = False,
                     scale: Optional[float] = None, q_offset: Offset = 0,
                     kv_offset: Offset = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """How far two correct dq may differ on the rows where dq is 0 by
    cancellation: ``(rows, bound)``, the ``(B, 1, Tq, 1)`` bool of the
    query rows that see exactly one key, and the ``(B, Hq, Tq, D)`` f32
    bound on ``|dq_a - dq_b|`` there.

    Such a row sees key 0 alone: p = 1 and O = V_0, so the exact ds =
    dO.V_0^T - delta is 0 and dq holds only rounding. Each side forms
    dO.V_0^T as an f32 sum of D products, off by at most
    ``D * eps * sum|dO * V_0|`` (eps = 2^-23, one addition's error rounded
    or truncated), and subtracts ``delta``, which is itself within that of
    the same sum (here ``|dO.V_0^T - delta|`` as computed, plus the sum's
    own error); p is at most ``exp(2 * D * eps * sum|q * k_0| * scale)``
    (the recomputed score against lse); ds goes to K's dtype and dq to
    q's (two roundings, each within 2^-8 relative), and dq = ds * K_0 *
    scale. The bound is twice one side's."""
    B, Hq, Tq, D = q.shape
    Tk = k.shape[2]
    if causal:
        offs = offsets(q_offset, kv_offset, B, q.device).long()
        seen = (offs[0] - offs[1] + 1)[:, None] + torch.arange(
            Tq, device=q.device)
        rows = seen.clamp(0, Tk) == 1
    else:
        rows = torch.full((B, Tq), Tk == 1, device=q.device)
    G = _group(q, k)
    k0 = k[:, :, :1].float().repeat_interleave(G, 1)  # (B, Hq, 1, D)
    v0 = v[:, :, :1].float().repeat_interleave(G, 1)
    sc = default_scale(D, scale)
    err = D * torch.finfo(torch.float32).eps
    dov = dout.float() * v0
    ds = ((2 * err * dov.abs().sum(-1) + (dov.sum(-1) - delta).abs())
          * torch.exp(2 * err * sc * (q.float() * k0).abs().sum(-1))
          * (1 + 2.0 ** -6))
    return rows[:, None, :, None], 2 * ds[..., None] * k0.abs() * sc


def grad_rows_close(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor],
                    tol: float,
                    one_key: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> Tuple[bool, float, float]:
    """Hold gradients ``got`` against their plain versions ``want`` row by
    row: each row (a dq row per query, a dk or dv row per key) within
    ``tol`` of that row's largest plain |value|, so a row that is 0 in the
    plain version must be exactly 0. With ``one_key`` (from
    :func:`dq_one_key_bound`; ``got[0]`` is then dq) dq's rows that see
    exactly one key are held to that bound instead. Returns ``(ok, max
    |d|, max relative |d|)``, the last in units of the row scale, so that
    it passes at or below ``tol`` (a one-key row's bound counts as ``tol``
    of its scale)."""
    ok, eabs, erel = True, 0.0, 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if not (a.shape == b.shape and torch.isfinite(a).all()):
            return False, math.inf, math.inf
        d = (a.float() - b.float()).abs()
        allowed = tol * b.float().abs().amax(-1, keepdim=True)
        if i == 0 and one_key is not None:
            allowed = torch.where(one_key[0], one_key[1], allowed)
        ok = ok and bool((d <= allowed).all())
        eabs = max(eabs, d.max().item())
        erel = max(erel, (d * tol / allowed.clamp_min(1e-30)).max().item())
    return ok, eabs, erel


def dkv_walk(ki: int, n_q_per_kv: int, n_q: int, *, block_q: int,
             block_k: int, causal: bool, q_offset: int = 0,
             kv_offset: int = 0) -> list:
    """The ``(query head of the group, Q tile)`` pairs B7's bf16 body walks,
    in order, for K/V tile ``ki`` of one batch row (``n_q`` Q tiles of
    ``block_q`` rows, ``block_k`` keys a K/V tile): every query head of the
    group in turn, each from the first live Q tile
    (:func:`~.block_utils.first_live_q`) to the last; under causality no Q
    tile before it holds a row that sees the tile's first key, so none
    holds a row that sees any of its keys. A K/V tile no row sees walks
    nothing. The rule ``sm90::KRing::init`` computes on the card."""
    first = 0
    if causal:
        ahead = kv_offset + ki * block_k - q_offset
        if ahead >= n_q * block_q:  # no row sees the tile's first key
            return []
        first = first_live_q(ki, block_q, block_k, q_offset, kv_offset, n_q)
    return [(g, qt) for g in range(n_q_per_kv) for qt in range(first, n_q)]


def _row(x: Offset, b: int) -> Offset:
    """Batch row ``b``'s offset: a scalar passes through, a ``(B,)`` tensor
    gives its one-element slice."""
    if isinstance(x, torch.Tensor) and x.ndim:
        return x[b:b + 1]
    return x


def _prepare(q, k, v, dout, lse, delta, q_offset, kv_offset):
    _check(q, k, v, dout)
    B, Hq, Tq, D = q.shape
    Hkv = k.shape[1]
    if Hq % Hkv:
        raise ValueError(
            f"query heads ({Hq}) must be a multiple of kv heads ({Hkv})"
        )
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (B, Hq, Tq):
            raise ValueError(f"{name} must be float32 {(B, Hq, Tq)}")
    offs = offsets(q_offset, kv_offset, B, q.device).contiguous()
    return ([t.contiguous() for t in (q, k, v, dout, lse, delta)], offs)


def attention_cuda_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      dout: torch.Tensor, lse: torch.Tensor,
                      delta: torch.Tensor, *, causal: bool = False,
                      scale: Optional[float] = None, q_offset: Offset = 0,
                      kv_offset: Offset = 0) -> torch.Tensor:
    """B6: dq ``(B, Hq, Tq, D)`` in q's dtype; ``lse``/``delta`` as from
    :func:`bwd_residuals`; offsets scalar or ``(B,)``."""
    kw = dict(causal=causal, scale=scale, q_offset=q_offset,
              kv_offset=kv_offset)
    if q.device.type == "cpu":
        return dq_plain(q, k, v, dout, lse, delta, **kw)
    (q, k, v, dout, lse, delta), offs = _prepare(q, k, v, dout, lse, delta,
                                                 q_offset, kv_offset)
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    attention_cuda_dq.launches += 1
    err = _launchers()[0](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), offs.data_ptr(), dq.data_ptr(),
        _DTYPES[q.dtype], D, B, Hq, Hkv, Tq, Tk, int(causal),
        float(default_scale(D, scale)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_dq kernel launch failed: CUDA error {err}")
    return dq


attention_cuda_dq.launches = 0


def attention_cuda_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       dout: torch.Tensor, lse: torch.Tensor,
                       delta: torch.Tensor, *, causal: bool = False,
                       scale: Optional[float] = None, q_offset: Offset = 0,
                       kv_offset: Offset = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B7: ``(dk, dv)`` ``(B, Hkv, Tk, D)`` in k's and v's dtypes, reduced
    over each KV head's query-head group. For bf16 the tensor-core body
    bulk-copies lse and delta in Q-tile slices, so they go in padded to a
    multiple of its Q tile (lse ``+inf``, delta 0: no padded row counts)."""
    kw = dict(causal=causal, scale=scale, q_offset=q_offset,
              kv_offset=kv_offset)
    if q.device.type == "cpu":
        return dkv_plain(q, k, v, dout, lse, delta, **kw)
    (q, k, v, dout, lse, delta), offs = _prepare(q, k, v, dout, lse, delta,
                                                 q_offset, kv_offset)
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    ld = Tq
    if q.dtype == torch.bfloat16:
        block_q = DKV_TILES["bfloat16"][0]
        ld = -(-Tq // block_q) * block_q
        lse = F.pad(lse, (0, ld - Tq), value=math.inf).contiguous()
        delta = F.pad(delta, (0, ld - Tq)).contiguous()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    attention_cuda_dkv.launches += 1
    err = _launchers()[1](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), offs.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _DTYPES[q.dtype], D, B, Hq, Hkv, Tq, ld, Tk,
        int(causal),
        float(default_scale(D, scale)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_dkv kernel launch failed: CUDA error {err}")
    return dk, dv


attention_cuda_dkv.launches = 0


def _bwd(dq_fn, dkv_fn, q, k, v, out, lse, dout, dlse, **kw):
    B, Hq, Tq, D = q.shape
    if k.shape[2] == 0 or Tq == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    lse_f, delta = bwd_residuals(out, lse, dout, dlse)
    dq = dq_fn(q, k, v, dout, lse_f, delta, **kw)
    dk, dv = dkv_fn(q, k, v, dout, lse_f, delta, **kw)
    return dq, dk, dv


def attention_cuda_bwd(q, k, v, out, lse, dout, dlse=None, *,
                       causal: bool = False, scale: Optional[float] = None,
                       q_offset: Offset = 0, kv_offset: Offset = 0):
    """The flash backward through B6 and B7 (their plain versions for CPU
    tensors): ``(dq, dk, dv)`` of the forward that gave ``(out, lse)``."""
    return _bwd(attention_cuda_dq, attention_cuda_dkv, q, k, v, out, lse,
                dout, dlse, causal=causal, scale=scale, q_offset=q_offset,
                kv_offset=kv_offset)


def bwd_plain(q, k, v, out, lse, dout, dlse=None, *, causal: bool = False,
              scale: Optional[float] = None, q_offset: Offset = 0,
              kv_offset: Offset = 0):
    """:func:`attention_cuda_bwd` through the plain versions on any
    device."""
    return _bwd(dq_plain, dkv_plain, q, k, v, out, lse, dout, dlse,
                causal=causal, scale=scale, q_offset=q_offset,
                kv_offset=kv_offset)
