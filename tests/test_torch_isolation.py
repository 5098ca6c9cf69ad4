"""The port stands alone: no JAX, nothing of the JAX package, GPU by default.

Each check runs in a fresh interpreter so that no other test's imports leak
into ``sys.modules``.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = [
    "tree_attention_tpu_torch",
    "tree_attention_tpu_torch.__main__",
    "tree_attention_tpu_torch.checkpoint",
    "tree_attention_tpu_torch.cli",
    "tree_attention_tpu_torch.data",
    "tree_attention_tpu_torch.models",
    "tree_attention_tpu_torch.models.decode",
    "tree_attention_tpu_torch.models.train",
    "tree_attention_tpu_torch.models.transformer",
    "tree_attention_tpu_torch.obs",
    "tree_attention_tpu_torch.obs.flight",
    "tree_attention_tpu_torch.obs.http",
    "tree_attention_tpu_torch.obs.metrics",
    "tree_attention_tpu_torch.obs.slo",
    "tree_attention_tpu_torch.obs.tracing",
    "tree_attention_tpu_torch.ops",
    "tree_attention_tpu_torch.ops._build",
    "tree_attention_tpu_torch.ops.block_utils",
    "tree_attention_tpu_torch.ops.cuda_attention",
    "tree_attention_tpu_torch.ops.cuda_bwd",
    "tree_attention_tpu_torch.ops.cuda_decode",
    "tree_attention_tpu_torch.ops.decode",
    "tree_attention_tpu_torch.ops.reference",
    "tree_attention_tpu_torch.ops.tuning",
    "tree_attention_tpu_torch.ops.vjp",
    "tree_attention_tpu_torch.parallel",
    "tree_attention_tpu_torch.parallel.accounting",
    "tree_attention_tpu_torch.parallel.mesh",
    "tree_attention_tpu_torch.parallel.tree",
    "tree_attention_tpu_torch.serving",
    "tree_attention_tpu_torch.serving.block_pool",
    "tree_attention_tpu_torch.serving.disagg",
    "tree_attention_tpu_torch.serving.engine",
    "tree_attention_tpu_torch.serving.host_pool",
    "tree_attention_tpu_torch.serving.ingress",
    "tree_attention_tpu_torch.serving.prefix_cache",
    "tree_attention_tpu_torch.serving.speculation",
    "tree_attention_tpu_torch.utils",
    "tree_attention_tpu_torch.utils.config",
    "tree_attention_tpu_torch.utils.httpd",
    "tree_attention_tpu_torch.utils.logging",
    "tree_attention_tpu_torch.utils.profiling",
]


def _run(args, **kw):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "CUDA_VISIBLE_DEVICES")}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"  # tiny shapes: one intra-op thread
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120, **kw)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, json, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'tree_attention_tpu' "
        "or m.startswith('tree_attention_tpu.'))\n"
        "print(json.dumps(bad))\n"
    )
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_cli_serve_on_cpu_prints_its_record():
    proc = _run([
        "-m", "tree_attention_tpu_torch", "--mode", "serve", "--device",
        "cpu", "--slots", "2", "--requests", "3", "--prompt-len", "12",
        "--prompt-jitter", "4", "--max-new-tokens", "3", "--model-dim", "32",
        "--heads", "2", "--n-layers", "1", "--vocab-size", "64",
        "--prefill-chunk", "8", "--dtype", "float32", "--temperature", "0",
    ])
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["mode"] == "serve" and rec["device"] == "cpu"
    assert rec["requests"] == 3 and rec["outcomes"] == {"budget": 3}
    assert rec["tokens_generated"] == 9
    assert rec["leaks"]["blocks_used"] == 0


def test_cli_without_a_gpu_exits_with_a_clear_error():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the CUDA default runs")
    proc = _run(["-m", "tree_attention_tpu_torch", "--mode", "decode",
                 "--seq-len", "64"])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert proc.stdout.strip() == ""
