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

Each wrapper runs its kernel for a CUDA tensor and its plain version
(:func:`dq_plain`, :func:`dkv_plain`) for a CPU tensor — nothing else: a
build or launch failure raises. ``.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from tree_attention_tpu_torch.ops import _build
from tree_attention_tpu_torch.ops.block_utils import NEG_INF, Offset, offsets
from tree_attention_tpu_torch.ops.cuda_decode import _DTYPES, _check
from tree_attention_tpu_torch.ops.reference import _group, default_scale
from tree_attention_tpu_torch.ops.tuning import BWD_BLOCK_K, BWD_BLOCK_Q

_fns = None


def _launchers():
    global _fns
    if _fns is None:
        lib = _build.library("flash_bwd")
        built = (lib.flash_bwd_block_q(), lib.flash_bwd_block_k())
        if built != (BWD_BLOCK_Q, BWD_BLOCK_K):
            raise RuntimeError(
                f"flash_bwd was built with (Q, KV) tiles {built}, "
                f"ops/tuning.py says {(BWD_BLOCK_Q, BWD_BLOCK_K)}"
            )
        dq, dkv = lib.flash_dq_launch, lib.flash_dkv_launch
        dq.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        dkv.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
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
    over each KV head's query-head group."""
    kw = dict(causal=causal, scale=scale, q_offset=q_offset,
              kv_offset=kv_offset)
    if q.device.type == "cpu":
        return dkv_plain(q, k, v, dout, lse, delta, **kw)
    (q, k, v, dout, lse, delta), offs = _prepare(q, k, v, dout, lse, delta,
                                                 q_offset, kv_offset)
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    attention_cuda_dkv.launches += 1
    err = _launchers()[1](
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), offs.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _DTYPES[q.dtype], D, B, Hq, Hkv, Tq, Tk, int(causal),
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
