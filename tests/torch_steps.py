"""Parameters after AdamW steps, held in units of each entry's own step.

The port's train step and the JAX package's compute their gradients in f32
along different summation orders. Where an entry's gradient cancels to the
order of Adam's ``eps`` (1e-8), the two rounded gradients differ by a few
percent of themselves while sitting well inside the gradient tolerance
(1e-4), and Adam's direction ``m / (sqrt(v) + eps)``, which is free of the
gradient's scale, carries that relative difference into the step. Held at
a fixed absolute bound such an entry passes or fails with the host's
rounding, not with the port's arithmetic.

:func:`hold_params` therefore holds every entry to the fixed bound (1e-5
relative plus 3e-6 absolute) plus the part of its own path that the
measured gradient disagreement accounts for: at step ``k`` a relative
gradient difference ``rho`` moves Adam's step by about ``rho`` of itself
(at most two steps' worth, a reversal). ``rho`` is the largest relative
difference of the entry's gradients up to that step (Adam's moments carry
earlier gradients forward). Where the gradients agree to f32 rounding the
allowance is ~1e-9 and the bound is the fixed one. The gradients
themselves are held at 1e-4 elsewhere, and the optimizer alone on identical
gradients to 2e-6 (``tests/test_torch_train.py``).

Imports numpy only: the sequence-parallel tests' spawned ranks import this
file's neighbours without JAX.
"""

from typing import Dict, List, Sequence

import numpy as np

ATOL, RTOL = 3e-6, 1e-5
REVERSAL = 2.0  # an entry's step can at most reverse: two steps apart


def relative_gap(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """``|got - want| / |want|`` in float64: 0 where both are 0, capped at
    :data:`REVERSAL`."""
    got = got.astype(np.float64)
    want = want.astype(np.float64)
    diff = np.abs(got - want)
    with np.errstate(divide="ignore", invalid="ignore"):
        rho = np.where(diff == 0, 0.0, diff / np.abs(want))
    return np.minimum(np.nan_to_num(rho, nan=REVERSAL, posinf=REVERSAL),
                      REVERSAL)


def step_allowance(path: Sequence[np.ndarray], grads_got: Sequence[np.ndarray],
                   grads_want: Sequence[np.ndarray]) -> np.ndarray:
    """Per entry: ``sum_k |step_k| * max_{j <= k} rho_j``, where ``path``
    holds the reference's parameters before the first step and after each
    step, and ``rho_j`` is step ``j``'s relative gradient gap."""
    allow = np.zeros(path[0].shape, np.float64)
    rho = np.zeros(path[0].shape, np.float64)
    for k, (g, w) in enumerate(zip(grads_got, grads_want)):
        rho = np.maximum(rho, relative_gap(g, w))
        step = np.abs(path[k + 1].astype(np.float64) - path[k])
        allow += step * rho
    return allow


def hold_params(got: Dict[str, np.ndarray],
                path: List[Dict[str, np.ndarray]],
                grads_got: List[Dict[str, np.ndarray]],
                grads_want: List[Dict[str, np.ndarray]], what: str) -> None:
    """Assert each entry of ``got`` (the port's parameters after
    ``len(grads_got)`` steps) within ``ATOL + RTOL |want| + allowance`` of
    the reference's ``path[-1]``."""
    for name, want in path[-1].items():
        allow = step_allowance([p[name] for p in path],
                               [g[name] for g in grads_got],
                               [g[name] for g in grads_want])
        diff = np.abs(got[name].astype(np.float64) - want)
        bound = ATOL + RTOL * np.abs(want.astype(np.float64)) + allow
        bad = diff > bound
        assert not bad.any(), (
            f"{what}: {name}: {int(bad.sum())} of {bad.size} entries past "
            f"the bound; worst {float((diff - bound).max()):.3e} over it at "
            f"{np.unravel_index(np.argmax(diff - bound), diff.shape)}")
