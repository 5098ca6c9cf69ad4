"""Seeded model parameters for the port's JAX-comparing CPU tests.

Both sides take the same weights, drawn once with numpy from a seed (the
port's ``init_params``) and handed to the JAX package as arrays. Drawing
them with ``jax.random`` instead costs every test process about 3 s of JAX
compiles; the comparison is the same either way: the two frameworks on one
set of weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tree_attention_tpu_torch import models as tm


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A copy of ``t`` as numpy (bf16 as ml_dtypes' bfloat16, the dtype
    JAX arrays of bf16 turn into)."""
    if t.dtype == torch.bfloat16:
        return np.asarray(jnp.asarray(t.float().numpy(), jnp.bfloat16))
    return t.numpy().copy()


def seeded_params(t_cfg, seed: int = 0):
    """``(jax_params, port_params)``: the port's ``init_params(t_cfg,
    seed)`` on the CPU, and the same values as the JAX pytree (same keys,
    dtypes and stacked layer weights; copies, so the port's in-place
    updates never reach the JAX side)."""
    tp = tm.init_params(t_cfg, seed, "cpu")
    return jax.tree.map(lambda t: jnp.asarray(to_numpy(t)), tp), tp


class _NoReuse(dict):
    """A scratch table whose lookups always miss: each admission gets a
    fresh host buffer."""

    def get(self, key, default=None):
        return None


def fresh_whole_scratch(jax_engine):
    """Give a JAX ``SlotServer`` a fresh host buffer per whole admission.

    Its whole admission lays each prompt into one reused per-bucket numpy
    buffer and hands it to the jitted prefill through ``jnp.asarray``, on
    the premise that ``jnp.asarray`` copies (``tree_attention_tpu/serving/
    engine.py``, ``_admit_whole``). On the CPU backend it aliases a 64-byte
    aligned buffer instead, and the prefill runs asynchronously: under
    load the next admission in the bucket overwrites the buffer before the
    earlier prefill reads it (a repeated prompt then decodes another
    prompt's stream). A buffer per admission, kept alive by the array that
    aliases it, removes the race without touching the JAX package."""
    jax_engine._whole_scratch = _NoReuse()
    return jax_engine
