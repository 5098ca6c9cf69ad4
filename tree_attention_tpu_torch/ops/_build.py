"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles, at first use, into
``build/torch_kernels/lib<name>-<digest>.so`` beside the package (the
directory ``.gitignore`` lists), where ``<digest>`` hashes the sources, so an
edited kernel rebuilds and an unchanged one loads from disk. The sources
expose a plain C interface (no PyTorch headers), which keeps a build at
seconds. Nothing here runs at import: the CPU tests import every module on
a host with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNELS = ("flash_decode", "flash_decode_tiled", "flash_decode_tiled_cast",
           "flash_decode_tiled_q8q", "decode_tick", "flash_fwd", "flash_bwd")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from "
        "tree_attention_tpu_torch/csrc with the CUDA toolkit at first use"
    )


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every missing library of ``names``, one ``nvcc`` per source,
    all started together. Returns the wall seconds of each build, from the
    common start to its own end (0.0 for one already on disk); the
    compiler's register/shared-memory report goes to ``<lib>.log`` beside
    it. Raises with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    secs = {}
    t0 = time.monotonic()
    for name in names:
        out = _target(name)
        if out.exists():
            secs[name] = 0.0
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        log = out.with_suffix(".log")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        with open(log, "w") as f:
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
        procs[name] = (proc, tmp, out, log)
    while procs:
        for name, (proc, tmp, out, log) in list(procs.items()):
            if proc.poll() is None:
                continue
            secs[name] = time.monotonic() - t0
            del procs[name]
            if proc.returncode != 0:
                for other, *_ in procs.values():
                    other.kill()
                    other.wait()
                raise RuntimeError(
                    f"nvcc failed for {name}.cu:\n{log.read_text()}")
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half
        time.sleep(0.05)
    return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _LIBS[name] = lib
        return lib
