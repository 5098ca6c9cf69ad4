"""The prefix-cache serve on the card (skips without a GPU).

Kept apart from ``tests/test_torch_prefix.py``, which holds the port
against the JAX package on the CPU: this file imports no JAX. The
full-width witness is ``chip_smoke.py``'s prefix phase.
"""

import numpy as np
import pytest
import torch

from tree_attention_tpu_torch import models as tm
from tree_attention_tpu_torch import serving as ts

# Head dim 64: the CUDA wrappers take 64 or 128.
CFG = dict(vocab_size=128, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
           d_head=64, d_ff=512)


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 128, n).astype(np.int32)


@pytest.mark.gpu
def test_prefix_serve_on_gpu():
    """The prefix serve on the card, paged exact and int8: every request
    retires with its budget, the two later requests hit the shared 96
    tokens (six 16-token blocks), and the pool drains to tree-owned
    blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode (tests/test_torch_prefix.py holds the plain "
                    "versions against JAX)")
    cfg = tm.TransformerConfig(**CFG, dtype=torch.bfloat16)
    tp = tm.init_params(cfg, 0, "cuda")
    for quant in (False, True):
        kw = dict(slots=2, cache_len=160, prefill_chunk=64, kv_block=16,
                  quantize=quant)
        reqs = [ts.Request(uid=i, prompt=np.concatenate(
            [_prompt(1, 100), _prompt(s, 20)]), max_new_tokens=8,
            arrival_tick=8 * i) for i, s in enumerate((2, 3, 4))]
        server = ts.SlotServer(tp, cfg, **kw, prefix_cache=True,
                               prefix_block=16)
        rep = server.serve(reqs)
        assert rep.outcomes == {"budget": 3}
        assert [r.prefix_hit_tokens for r in rep.results] == [0, 96, 96]
        leaks = server.leak_report()
        assert leaks["blocks_used"] == leaks["blocks_cached"] > 0
        assert leaks["pins"] == leaks["blocks_private"] == 0
