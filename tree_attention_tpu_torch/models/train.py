"""Training step: loss, backward, clip, AdamW; on one device or a seq mesh.

Counterpart of ``tree_attention_tpu/models/train.py``: the gradients come
from autograd through :func:`.transformer.loss_fn`, whose attention
backward is the flash recompute (kernels B6/B7 on the card, see
``ops/vjp.py``). The optimizer is the JAX package's
``optax.chain(clip_by_global_norm(1.0), adamw(3e-4, b1=0.9, b2=0.95,
weight_decay=0.01))`` as :func:`clip_by_global_norm` (optax's rule: scale
by ``max_norm / norm`` only when the global norm reaches the bound)
followed by ``torch.optim.AdamW`` over every parameter; the moments keep each
parameter's dtype, as optax's do. Unlike JAX's immutable train state, the
step updates the parameters and the optimizer state in place.

Under a mesh that shards ``seq`` (one process per rank), every rank holds
the whole model (checked equal at init), computes its rows' loss and the
gradients through the tree-attention collectives, and one SUM all-reduce
of a flat bucket of every gradient (and the loss) gives every rank the
global gradient; the clip and AdamW then run alike everywhere, so the
parameters stay bit-identical across ranks. The JAX package's sharded
parameter and optimizer layouts shard over ``data``/``model``, which the
port's mesh does not have yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import torch

from tree_attention_tpu_torch.models.transformer import (
    Params,
    TransformerConfig,
    init_params,
    local_rows,
    loss_fn,
    named_params,
)
from tree_attention_tpu_torch.parallel.mesh import (
    AXIS_SEQ,
    Mesh,
    check_ranks_agree,
    seq_sharded,
)
from tree_attention_tpu_torch.parallel.tree import all_reduce

TrainState = Tuple[Params, torch.optim.Optimizer]


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """Global-norm clip followed by AdamW; :meth:`init` binds it to a
    parameter dictionary."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    grad_clip: float = 1.0

    def init(self, params: Params) -> torch.optim.AdamW:
        """Mark every parameter as requiring grad and return its AdamW."""
        leaves = [t.requires_grad_(True) for _, t in named_params(params)]
        return torch.optim.AdamW(
            leaves, lr=self.learning_rate, betas=(0.9, 0.95), eps=1e-8,
            weight_decay=self.weight_decay,
        )


def default_optimizer(learning_rate: float = 3e-4, weight_decay: float = 0.01,
                      grad_clip: float = 1.0) -> OptimizerSpec:
    return OptimizerSpec(learning_rate=learning_rate,
                         weight_decay=weight_decay, grad_clip=grad_clip)


def params_digest(params: Params) -> int:
    """A digest of every parameter's bits, computed on their device: the
    position-weighted integer sum of each tensor's raw words (exact and
    order-free), folded over the tensors in :func:`named_params` order. In
    ``[0, 2^62)``."""
    h = 0
    for _, t in named_params(params):
        flat = t.detach().contiguous().flatten()
        words = flat.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                           8: torch.int64}[flat.element_size()]).long()
        weight = torch.arange(1, words.numel() + 1, device=words.device)
        h = (h * 1_000_003 + int((words * (weight * 2_654_435_761)).sum())
             ) % (1 << 62)
    return h


def init_train_state(cfg: TransformerConfig, optimizer: OptimizerSpec, *,
                     seed: int = 0,
                     device: Union[str, torch.device] = "cuda",
                     mesh: Optional[Mesh] = None) -> TrainState:
    """``(params, optimizer)`` with random parameters from ``seed``. On a
    seq mesh every rank builds the same parameters, checked (not assumed)
    by one MAX all-reduce of their digest and its negation."""
    params = init_params(cfg, seed, device)
    if seq_sharded(mesh):
        check_ranks_agree(params_digest(params), mesh, "initial parameters")
    return params, optimizer.init(params)


def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """Clip ``grads`` (an iterable of tensors) in place as
    ``optax.clip_by_global_norm(max_norm)`` does: one global L2 norm over
    every gradient (f32 sums), and where it is at least ``max_norm`` each
    gradient becomes ``g / norm * max_norm`` (the norm cast to its dtype);
    below the bound every gradient is left bit for bit. The choice is a
    device ``where``: no host sync. Returns the norm."""
    grads = list(grads)
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


def loss_and_grads(params: Params, batch: Mapping[str, torch.Tensor],
                   cfg: TransformerConfig, mesh: Optional[Mesh] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss and every parameter's gradient (left in ``.grad`` too);
    the parameters must require grad. On a seq mesh both are this rank's
    share: its rows' loss (:func:`.transformer.loss_fn`) and its
    gradient of the ranks' summed loss."""
    leaves = named_params(params)
    for _, t in leaves:
        t.grad = None
    loss = loss_fn(params, batch, cfg, mesh=mesh)
    loss.backward()
    return loss.detach(), {n: t.grad for n, t in leaves}


def sum_over_ranks(loss: torch.Tensor, grads: Dict[str, torch.Tensor],
                   mesh: Mesh) -> torch.Tensor:
    """One SUM all-reduce over the seq axis of a flat f32 bucket of every
    gradient and the loss, counted as ``("train_step", "psum_grads")``; the
    sums go back into the gradients (in their dtypes). Returns the summed
    loss (the global mean)."""
    parts = [g.float().flatten() for g in grads.values()]
    bucket = torch.cat(parts + [loss.float().reshape(1)])
    all_reduce(bucket, mesh, AXIS_SEQ, "train_step", "psum_grads")
    off = 0
    for g in grads.values():
        g.copy_(bucket[off:off + g.numel()].view_as(g))
        off += g.numel()
    return bucket[-1]


def make_train_step(cfg: TransformerConfig, optimizer: OptimizerSpec, *,
                    mesh: Optional[Mesh] = None
                    ) -> Callable[[TrainState, Mapping[str, torch.Tensor]],
                                  Tuple[TrainState, torch.Tensor]]:
    """``step(state, batch) -> (state, loss)``: one clipped AdamW step
    (``state`` is updated in place and returned). On a seq mesh ``batch``
    is the global batch on every rank and ``loss`` the global mean."""
    def step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        params, opt = state
        loss, grads = loss_and_grads(params, batch, cfg, mesh)
        if seq_sharded(mesh):
            loss = sum_over_ranks(loss, grads, mesh)
        clip_by_global_norm(grads.values(), optimizer.grad_clip)
        opt.step()
        return state, loss

    return step


def shard_batch(mesh: Mesh, batch: Mapping[str, torch.Tensor],
                cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global ``(B, T)`` batch under
    ``cfg.seq_layout`` (:func:`.transformer.local_rows`), for callers that
    want the slice; the train step takes the global batch."""
    out = {}
    for name, x in batch.items():
        out[name] = (x[:, local_rows(x.shape[1], mesh, cfg, x.device)]
                     if seq_sharded(mesh) else x)
    return out
