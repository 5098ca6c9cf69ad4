"""Checkpoint and resume of a train state with ``torch.save``.

Counterpart of ``tree_attention_tpu/checkpoint.py`` on one device: a
step-indexed directory of ``step_<n>.pt`` files (parameters by name and the
optimizer's ``state_dict``), written atomically, the newest ``max_to_keep``
kept, plus a JSON sidecar of the model config so a directory describes
itself. The format is the port's own; the JAX package's orbax checkpoints
are not read.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import List, Optional, Tuple

import torch

from tree_attention_tpu_torch.models.train import TrainState
from tree_attention_tpu_torch.models.transformer import (
    TransformerConfig,
    named_params,
)
from tree_attention_tpu_torch.utils.logging import get_logger

log = get_logger("checkpoint")

_CONFIG_FILE = "model_config.json"
_STEP_RE = re.compile(r"^step_(\d+)\.pt$")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def save_model_config(directory: str, cfg: TransformerConfig) -> None:
    """Write the architecture sidecar (dtype stored by name)."""
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(cfg.dtype).removeprefix("torch.")
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, _CONFIG_FILE), "w") as f:
        json.dump(d, f, indent=2)


def load_model_config(directory: str) -> TransformerConfig:
    with open(os.path.join(directory, _CONFIG_FILE)) as f:
        d = json.load(f)
    d["dtype"] = _DTYPES[d["dtype"]]
    return TransformerConfig(**d)


class Checkpointer:
    """Step-indexed checkpoints of a ``(params, optimizer)`` train state.

    Usage::

        ckpt = Checkpointer(dir, save_interval_steps=1)
        ckpt.save(step, state, cfg=cfg)       # on the interval, or force
        state, step = ckpt.restore(state)     # the latest step, in place
    """

    def __init__(self, directory: str, *, max_to_keep: Optional[int] = 3,
                 save_interval_steps: int = 1):
        if save_interval_steps < 1:
            raise ValueError("save_interval_steps must be >= 1")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def save(self, step: int, state: TrainState, *,
             cfg: Optional[TransformerConfig] = None,
             force: bool = False) -> bool:
        """Save ``state`` at ``step`` when the step is on the save interval
        (or ``force``); returns whether it saved."""
        if not force and step % self.save_interval_steps:
            return False
        params, opt = state
        blob = {
            "step": step,
            "params": {n: t.detach() for n, t in named_params(params)},
            "optimizer": opt.state_dict(),
        }
        tmp = self._path(step) + f".tmp{os.getpid()}"
        torch.save(blob, tmp)
        os.replace(tmp, self._path(step))  # a reader never sees half a file
        if cfg is not None and not os.path.exists(
                os.path.join(self.directory, _CONFIG_FILE)):
            save_model_config(self.directory, cfg)
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self._path(old))
        log.info("checkpoint saved: step %d -> %s", step, self.directory)
        return True

    def restore(self, state: TrainState, step: Optional[int] = None
                ) -> Tuple[TrainState, int]:
        """Load the checkpoint of ``step`` (default: the latest) into
        ``state`` in place; returns ``(state, step)``."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoint found under {self.directory}"
                )
        blob = torch.load(self._path(step), map_location="cpu",
                          weights_only=True)
        params, opt = state
        with torch.no_grad():
            for name, t in named_params(params):
                saved = blob["params"][name]
                if saved.shape != t.shape or saved.dtype != t.dtype:
                    raise ValueError(
                        f"checkpoint {name}: {tuple(saved.shape)} "
                        f"{saved.dtype}, state {tuple(t.shape)} {t.dtype}"
                    )
                t.copy_(saved)
        opt.load_state_dict(blob["optimizer"])
        log.info("checkpoint restored: step %d from %s", step, self.directory)
        return state, step

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _STEP_RE.match(f)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def close(self) -> None:
        """Saves are synchronous: nothing is in flight to wait for."""
