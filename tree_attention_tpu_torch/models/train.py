"""Training step on one device: loss, backward, clip, AdamW.

Counterpart of ``tree_attention_tpu/models/train.py`` without the mesh: the
gradients come from autograd through :func:`.transformer.loss_fn`, whose
attention backward is the flash recompute (kernels B6/B7 on the card, see
``ops/vjp.py``). The optimizer is the JAX package's
``optax.chain(clip_by_global_norm(1.0), adamw(3e-4, b1=0.9, b2=0.95,
weight_decay=0.01))`` as ``torch.nn.utils.clip_grad_norm_`` followed by
``torch.optim.AdamW`` over every parameter; the moments keep each
parameter's dtype, as optax's do. Unlike JAX's immutable train state, the
step updates the parameters and the optimizer state in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Tuple, Union

import torch

from tree_attention_tpu_torch.models.transformer import (
    Params,
    TransformerConfig,
    init_params,
    loss_fn,
    named_params,
)

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


def init_train_state(cfg: TransformerConfig, optimizer: OptimizerSpec, *,
                     seed: int = 0,
                     device: Union[str, torch.device] = "cuda"
                     ) -> TrainState:
    """``(params, optimizer)`` with random parameters from ``seed``."""
    params = init_params(cfg, seed, device)
    return params, optimizer.init(params)


def loss_and_grads(params: Params, batch: Mapping[str, torch.Tensor],
                   cfg: TransformerConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss and every parameter's gradient (left in ``.grad`` too);
    the parameters must require grad."""
    leaves = named_params(params)
    for _, t in leaves:
        t.grad = None
    loss = loss_fn(params, batch, cfg)
    loss.backward()
    return loss.detach(), {n: t.grad for n, t in leaves}


def make_train_step(cfg: TransformerConfig, optimizer: OptimizerSpec
                    ) -> Callable[[TrainState, Mapping[str, torch.Tensor]],
                                  Tuple[TrainState, torch.Tensor]]:
    """``step(state, batch) -> (state, loss)``: one clipped AdamW step
    (``state`` is updated in place and returned)."""

    def step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        params, opt = state
        loss, grads = loss_and_grads(params, batch, cfg)
        torch.nn.utils.clip_grad_norm_(list(grads.values()),
                                       optimizer.grad_clip)
        opt.step()
        return state, loss

    return step
