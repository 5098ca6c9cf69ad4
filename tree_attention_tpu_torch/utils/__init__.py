"""Configuration, logging and device selection.

Importing this package does not import torch (``utils.logging`` rides the
torch-free telemetry plane, ``obs``); :func:`resolve_device` imports it.
"""

from __future__ import annotations

from typing import Union


def resolve_device(device: Union[str, "torch.device"] = "cuda"
                   ) -> "torch.device":
    """The device an entry point runs on: the GPU unless the caller asks for
    the CPU. Asking for CUDA on a host without a usable GPU raises — an
    entry point never carries on silently on the CPU."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: tree_attention_tpu_torch runs on "
            "an NVIDIA GPU by default; pass device='cpu' (--device cpu) to "
            "run the kernels' plain versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev
