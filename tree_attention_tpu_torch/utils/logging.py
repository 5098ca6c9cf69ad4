"""Structured logging on stdlib ``logging``.

Counterpart of ``tree_attention_tpu/utils/logging.py``: every record carries
a ``[pK]`` process prefix, by default only process 0 logs below WARNING, and
an optional rotating file sink keeps the 10 MB rotation. The process index is
the ``RANK`` that ``torch.distributed`` launchers export (0 when absent).
"""

from __future__ import annotations

import logging
import logging.handlers
import os
import sys
from typing import Optional

_ROOT_NAME = "tree_attention_tpu_torch"
_FORMAT = "%(asctime)s %(levelname).1s %(process_prefix)s %(name)s: %(message)s"


def _process_index() -> int:
    try:
        return int(os.environ.get("RANK", "0"))
    except ValueError:
        return 0  # malformed export: fail open to rank 0


class _ProcessPrefixFilter(logging.Filter):
    """Stamps the process index and clamps non-zero ranks to WARNING."""

    def __init__(self, clamp_nonzero: bool):
        super().__init__()
        self.clamp_nonzero = clamp_nonzero

    def filter(self, record: logging.LogRecord) -> bool:
        idx = _process_index()
        record.process_prefix = f"[p{idx}]"
        return not (self.clamp_nonzero and idx != 0
                    and record.levelno < logging.WARNING)


def get_logger(name: str = _ROOT_NAME) -> logging.Logger:
    """Namespaced logger; children of the package root inherit its handlers."""
    if name != _ROOT_NAME and not name.startswith(_ROOT_NAME + "."):
        name = f"{_ROOT_NAME}.{name}"
    return logging.getLogger(name)


def setup_logging(level: int = logging.INFO, *,
                  log_file: Optional[str] = None, rotate_mb: int = 10,
                  all_processes: bool = False,
                  stream=None) -> logging.Logger:
    """Configure the package root logger. Idempotent (replaces handlers)."""
    root = logging.getLogger(_ROOT_NAME)
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    root.setLevel(level)
    root.propagate = False
    flt = _ProcessPrefixFilter(clamp_nonzero=not all_processes)
    fmt = logging.Formatter(_FORMAT)
    console = logging.StreamHandler(stream if stream is not None else sys.stderr)
    console.setFormatter(fmt)
    console.addFilter(flt)
    root.addHandler(console)
    if log_file:
        fileh = logging.handlers.RotatingFileHandler(
            log_file, maxBytes=rotate_mb * 1024 * 1024, backupCount=3
        )
        fileh.setFormatter(fmt)
        fileh.addFilter(flt)
        root.addHandler(fileh)
    return root
