"""The port's training path against the JAX package's (CPU).

Both packages run the SAME parameters (``tests/torch_params.py``'s
``seeded_params``: the port's numpy-seeded ``init_params`` handed to JAX as
arrays) on the same numpy batch, in float32, on a
tiny config (2 layers, d_model 64, 4 heads over 2 KV heads, vocab 256,
T = 128, B = 2). T = 128 puts the port's attention on the Q-tiled route
(B3 forward, B6/B7 backward; their plain versions on the CPU) and JAX's on
its blockwise custom VJP. Tolerances: the loss within 1e-5 relative, every
gradient within 1e-4 absolute and relative (f32 sums in different orders
through two layers and the cross entropy), and after two optimizer steps the
losses within 1e-5 relative and the parameters within 1e-5 relative plus
3e-6 absolute (see ``test_two_train_steps_match_jax``, which keeps the
JAX package's own ``init_params`` draw: its docstring says why). The clip
alone is held against ``optax.clip_by_global_norm`` on the same numpy
gradients.
"""

import contextlib
import dataclasses
import io
import json
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tree_attention_tpu import models as jm

from tree_attention_tpu_torch import cli
from tree_attention_tpu_torch import models as tm
from tree_attention_tpu_torch.checkpoint import (
    Checkpointer,
    load_model_config,
    save_model_config,
)
from tree_attention_tpu_torch.data import make_lm_batch, make_qkv
from tree_attention_tpu_torch.models.train import clip_by_global_norm
from tree_attention_tpu_torch.models.transformer import LAYER_KEYS
from tree_attention_tpu_torch.ops import cuda_bwd
from tests.torch_params import seeded_params
from tests.torch_steps import hold_params
from tests.torch_threads import few_torch_threads  # noqa: F401

J_CFG = jm.TransformerConfig(
    vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=192, max_seq_len=128, dtype=jnp.float32,
)
T_CFG = tm.TransformerConfig(
    vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=192, max_seq_len=128, dtype=torch.float32,
)



def _flat(tree):
    """Dotted-name dict of a parameter tree (JAX pytree or port dict)."""
    return {"embed": tree["embed"], "ln_f": tree["ln_f"],
            "wout": tree["wout"],
            **{f"layers.{k}": v for k, v in tree["layers"].items()}}


@pytest.fixture(scope="module")
def setup():
    jp, _ = seeded_params(T_CFG)
    toks = np.random.default_rng(0).integers(0, 256, (2, 129))
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    jbatch = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn),
                            static_argnums=2)(jp, jbatch, J_CFG)
    return dict(jp=jp, batch=batch, jbatch=jbatch, jloss=float(jloss),
                jgrads=_flat(jax.tree.map(np.asarray, jgrads)))


@pytest.fixture(scope="module")
def jax_drawn():
    """The JAX package's own ``init_params`` draw (the two-step test's
    weights)."""
    return jm.init_params(jax.random.PRNGKey(0), J_CFG)


def _port_params(jp):
    return tm.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax(setup, remat):
    cfg = dataclasses.replace(T_CFG, remat=remat)
    params = _port_params(setup["jp"])
    for _, t in tm.named_params(params):
        t.requires_grad_(True)
    launches = cuda_bwd.attention_cuda_dq.launches  # stays 0 on the CPU
    loss, grads = tm.loss_and_grads(params, _tbatch(setup["batch"]), cfg)
    np.testing.assert_allclose(float(loss), setup["jloss"], rtol=1e-5)
    assert grads.keys() == setup["jgrads"].keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), setup["jgrads"][name],
                                   atol=1e-4, rtol=1e-4, err_msg=name)
    assert cuda_bwd.attention_cuda_dq.launches == launches


def _clipped(grads):
    """JAX's gradients as the optimizer's AdamW stage sees them (optax's
    clip, the first link of ``default_optimizer``'s chain)."""
    return optax.clip_by_global_norm(1.0).update(grads, None)[0]


def test_two_train_steps_match_jax(jax_drawn):
    """Clip + AdamW, two steps, each side on its own trajectory: the losses
    within 1e-5 relative; each step's clipped gradients (the port's
    ``.grad`` after the step, JAX's through optax's clip) within this
    file's gradient tolerance, 1e-4; the parameters after both steps held
    in units of each entry's own step (``tests/torch_steps.py``: 1e-5
    relative plus 3e-6 absolute, 1% of one step at lr 3e-4, plus the part
    of the entry's path that its measured gradient gap accounts for).

    On this draw one ``layers.w2`` entry's first gradient is 1.38e-8 in
    JAX and 1.44e-8 in the port, 1.4 of Adam's eps, a cancelling sum
    whose f32 rounding the two frameworks do not share: a 4% gap Adam's
    scale-free direction carries into the step (0.579 against 0.590 of
    lr), 3.1e-6 apart after two steps. A fixed bound on the parameters
    passed or failed with the host's rounding; the optimizer alone is held
    on identical gradients below (``test_clip_adamw_matches_optax``)."""
    jopt = jm.default_optimizer()
    jstate = (jax_drawn, jopt.init(jax_drawn))
    jstep = jm.make_train_step(J_CFG, jopt, mesh=None, donate=False)
    jgrad = jax.jit(jax.grad(jm.loss_fn), static_argnums=2)
    topt = tm.default_optimizer()
    params = _port_params(jax_drawn)
    tstate = (params, topt.init(params))
    tstep = tm.make_train_step(T_CFG, topt)
    rng = np.random.default_rng(1)
    path = [_flat(jax.tree.map(np.asarray, jax_drawn))]
    grads_got, grads_want = [], []
    for k in range(2):
        toks = rng.integers(0, 256, (2, 129))
        batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
        jbatch = {n: jnp.asarray(v, jnp.int32) for n, v in batch.items()}
        want = _flat(jax.tree.map(np.asarray, _clipped(
            jgrad(jstate[0], jbatch, J_CFG))))
        jstate, jloss = jstep(jstate, jbatch)
        tstate, tloss = tstep(tstate, _tbatch(batch))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        got = {n: t.grad.numpy().copy() for n, t in tm.named_params(tstate[0])}
        for name, g in got.items():
            np.testing.assert_allclose(g, want[name], atol=1e-4, rtol=1e-4,
                                       err_msg=f"step {k}: {name}")
        grads_got.append(got)
        grads_want.append(want)
        path.append(_flat(jax.tree.map(np.asarray, jstate[0])))
    hold_params({n: t.detach().numpy() for n, t in tm.named_params(tstate[0])},
                path, grads_got, grads_want, "two steps")


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["below", "above"])
def test_clip_adamw_matches_optax(scale):
    """The port's optimizer (``clip_by_global_norm`` then the
    ``OptimizerSpec``'s AdamW, as ``make_train_step`` runs them) against
    JAX's ``default_optimizer`` (optax's clip and adamw) on the same numpy
    parameters and gradients, two steps: every parameter and both moments
    within 2e-6 (as the clip alone below) of the scale they are rounded
    from: the old value plus one step (lr) for a parameter, the sum of the
    two terms' magnitudes for a moment. A tenth of the
    gradient entries are of the order of Adam's eps, where its direction
    turns: on identical gradients the two agree there too."""
    rng = np.random.default_rng(4)
    shapes = {"embed": (6, 5), "ln_f": (5,), "wout": (5, 6),
              **{f"layers.{k}": (2, 3, 4) for k in LAYER_KEYS}}
    p0 = {k: (rng.standard_normal(s) * 0.02).astype(np.float32)
          for k, s in shapes.items()}
    steps = []
    for _ in range(2):
        g = {k: (rng.standard_normal(s) * scale).astype(np.float32)
             for k, s in shapes.items()}
        for k, s in shapes.items():
            tiny = rng.random(s) < 0.1
            g[k][tiny] = (rng.standard_normal(int(tiny.sum())) * 1e-8
                          ).astype(np.float32)
        steps.append(g)
    jopt = jm.default_optimizer()
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jos = jopt.init(jp)
    spec = tm.default_optimizer()
    lr = spec.learning_rate
    tp = {"embed": None, "ln_f": None, "wout": None, "layers": {}}
    for k, v in p0.items():
        t = torch.from_numpy(v.copy())
        if k.startswith("layers."):
            tp["layers"][k[len("layers."):]] = t
        else:
            tp[k] = t
    topt = spec.init(tp)
    named = tm.named_params(tp)
    prev = {n: (p0[n].astype(np.float64), 0.0, 0.0) for n, _ in named}
    for k, g in enumerate(steps):
        upd, jos = jopt.update({n: jnp.asarray(v) for n, v in g.items()},
                               jos, jp)
        jp = optax.apply_updates(jp, upd)
        for n, t in named:
            t.grad = torch.from_numpy(g[n].copy())
        clip_by_global_norm([t.grad for _, t in named], spec.grad_clip)
        topt.step()
        adam = jos[1][0]
        for n, t in named:
            st = topt.state[t]
            g = t.grad.numpy().astype(np.float64)
            # Each value against the scale of the terms it is rounded from:
            # a moment's update cancels where g and the old moment part.
            for got, want, scale, what in (
                    (t.detach().numpy(), jp[n], np.abs(prev[n][0]) + lr,
                     "param"),
                    (st["exp_avg"].numpy(), adam.mu[n],
                     0.9 * np.abs(prev[n][1]) + 0.1 * np.abs(g), "mu"),
                    (st["exp_avg_sq"].numpy(), adam.nu[n],
                     0.95 * prev[n][2] + 0.05 * g * g, "nu")):
                gap = np.abs(got.astype(np.float64) - np.asarray(want))
                assert (gap <= 2e-6 * scale).all(), (
                    f"step {k} {what} {n}: {float((gap / scale).max()):.2e}")
            prev[n] = (t.detach().numpy().astype(np.float64),
                       st["exp_avg"].numpy().astype(np.float64),
                       st["exp_avg_sq"].numpy().astype(np.float64))


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["below", "above"])
def test_clip_by_global_norm_matches_optax(scale):
    """The same numpy gradients through the port's clip and optax's:
    below the bound unchanged bit for bit, above it equal to f32 rounding
    (the norm's sums run in another order)."""
    rng = np.random.default_rng(3)
    grads = {f"g{i}": (rng.standard_normal(shape) * scale).astype(np.float32)
             for i, shape in enumerate([(7, 5), (64,), (3, 4, 6)])}
    want, _ = optax.clip_by_global_norm(1.0).update(
        {k: jnp.asarray(v) for k, v in grads.items()}, None)
    got = {k: torch.from_numpy(v.copy()) for k, v in grads.items()}
    norm = clip_by_global_norm(got.values(), 1.0)
    assert (float(norm) < 1.0) == (scale < 1.0)
    for k, v in grads.items():
        if scale < 1.0:
            np.testing.assert_array_equal(got[k].numpy(), v)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2e-6, atol=0, err_msg=k)


def test_count_params_and_cross_entropy_match_jax(setup):
    params = _port_params(setup["jp"])
    assert tm.count_params(params) == jm.count_params(setup["jp"])
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 5, 11), np.float32)
    targets = rng.integers(0, 11, (2, 5))
    mask = rng.integers(0, 2, (2, 5))
    for m in (None, mask):
        want = jm.cross_entropy_loss(
            jnp.asarray(logits), jnp.asarray(targets),
            None if m is None else jnp.asarray(m))
        got = tm.cross_entropy_loss(
            torch.from_numpy(logits), torch.from_numpy(targets),
            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_forward_under_no_grad_records_nothing(setup):
    """Serving callers wrap forward in no_grad: no graph, no checkpoint."""
    params = _port_params(setup["jp"])
    for _, t in tm.named_params(params):
        t.requires_grad_(True)
    with torch.no_grad():
        logits = tm.forward(params, torch.from_numpy(setup["batch"]["inputs"]),
                            T_CFG)
    assert logits.grad_fn is None


def test_make_lm_batch_and_qkv():
    g = torch.Generator().manual_seed(3)
    b = make_lm_batch(g, 2, 16, 50, "cpu")
    assert b["inputs"].shape == b["targets"].shape == (2, 16)
    assert torch.equal(b["inputs"][:, 1:], b["targets"][:, :-1])
    assert int(b["inputs"].max()) < 50
    again = make_lm_batch(torch.Generator().manual_seed(3), 2, 16, 50, "cpu")
    assert torch.equal(b["inputs"], again["inputs"])
    q, k, v = make_qkv(g, batch=2, heads=4, kv_heads=2, q_len=3, seq_len=8,
                       head_dim=16, dtype=torch.float32, device="cpu")
    assert q.shape == (2, 4, 3, 16) and k.shape == v.shape == (2, 2, 8, 16)


def test_checkpointer_round_trip(tmp_path, setup):
    opt = tm.default_optimizer()
    params = _port_params(setup["jp"])
    state = (params, opt.init(params))
    step = tm.make_train_step(T_CFG, opt)
    state, _ = step(state, _tbatch(setup["batch"]))
    ck = Checkpointer(str(tmp_path), max_to_keep=2, save_interval_steps=2)
    assert not ck.save(1, state)  # off the interval
    for i in (0, 2, 4):
        assert ck.save(i, state, cfg=T_CFG)
    assert ck.all_steps() == [2, 4] and ck.latest_step() == 4
    assert load_model_config(str(tmp_path)) == T_CFG
    fresh = _port_params(setup["jp"])
    fresh_state = (fresh, opt.init(fresh))
    (restored, ropt), at = ck.restore(fresh_state)
    assert at == 4
    for (n, a), (_, b) in zip(tm.named_params(restored),
                              tm.named_params(params)):
        torch.testing.assert_close(a, b, atol=0, rtol=0, msg=n)
    assert ropt.state_dict()["state"][0]["step"] == 1
    # Equal states take equal next steps.
    batch = _tbatch(setup["batch"])
    _, la = step(state, batch)
    _, lb = step((restored, ropt), batch)
    assert float(la) == float(lb)


def _train(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


TINY = ["--mode", "train", "--device", "cpu", "--seq-len", "128",
        "--model-dim", "64", "--heads", "4", "--kv-heads", "2",
        "--n-layers", "1", "--vocab-size", "128", "--batch", "2",
        "--dtype", "float32", "--iters", "1"]


def test_cli_train_resume_continues_from_the_latest_step(tmp_path):
    ck = ["--ckpt-dir", str(tmp_path)]
    first = _train(TINY + ck + ["--steps", "2"])
    assert len(first["losses"]) == 2
    assert Checkpointer(str(tmp_path)).latest_step() == 1
    resumed = _train(TINY + ck + ["--steps", "1", "--resume"])
    assert len(resumed["losses"]) == 1
    assert Checkpointer(str(tmp_path)).latest_step() == 2
    # The resumed step is step 2 of the uninterrupted run.
    straight = _train(TINY + ["--ckpt-dir", str(tmp_path / "b"),
                              "--steps", "3"])
    np.testing.assert_allclose(resumed["losses"][0], straight["losses"][2],
                               rtol=1e-6)


def test_cli_train_refuses_a_mismatched_checkpoint(tmp_path):
    save_model_config(str(tmp_path), dataclasses.replace(T_CFG, d_model=32))
    torch.save({}, tmp_path / "step_0.pt")
    with pytest.raises(SystemExit, match="disagrees"):
        cli.main(TINY + ["--ckpt-dir", str(tmp_path), "--resume"])


@pytest.mark.parametrize("argv,match", [
    (["--steps", "0"], "--steps >= 1"),
    (["--resume"], "--resume requires --ckpt-dir"),
])
def test_cli_train_rejects_bad_flags(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(TINY + argv)


def test_cli_train_prints_its_record(monkeypatch):
    """``python -m tree_attention_tpu_torch --mode train ...``, run as
    ``__main__`` in this process (a fresh interpreter would spend seconds
    importing torch): it exits 0 with its record as the last line."""
    monkeypatch.setattr(sys, "argv", ["tree_attention_tpu_torch", *TINY,
                                      "--steps", "2"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as exit_:
        runpy.run_module("tree_attention_tpu_torch", run_name="__main__",
                         alter_sys=True)
    assert exit_.value.code == 0
    rec = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rec["mode"] == "train" and rec["device"] == "cpu"
    assert len(rec["losses"]) == 2 and all(np.isfinite(rec["losses"]))
    assert rec["tokens_per_sec"] > 0 and rec["iters"] == 1
    assert {"median_s", "mean_s", "min_s", "max_s"} <= rec.keys()
