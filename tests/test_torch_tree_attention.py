"""Sequence-parallel training in the port against the JAX package's (CPU).

``tree_attention`` (Q, K and V all sharded over the sequence), the zigzag
layout, and the train step on a ``seq`` mesh. W ranks are spawned once per
W with ``test_torch_parallel``'s helpers (gloo, ``file://`` rendezvous,
every join timed out); each rank computes its rows, and the result is held
against the JAX function on ``cpu_mesh(W)`` over the same numpy inputs:

- ``tree_attention`` at W = 2 and 4: contiguous and zigzag, causal and
  not, GQA, Tq < Tk, a forced ``q_chunk`` that gives several chunks (one
  that does not divide the local rows), both merge payloads; out and lse
  within 2e-5, the gradients of q, k and v under a random ``dout`` and a
  random non-zero ``dlse`` within 3e-5 (JAX's own tolerances,
  ``tests/test_tree_parallel.py``). One case has 128-row runs, so the port
  takes the route the card runs (B3 forward, B6/B7 backward; their plain
  versions here), the others the decode route (B1, blockwise backward).
  Per chunk the forward issues 1 all-gather, 1 MAX and 1 reduce-scatter,
  the backward 1 reduce-scatter and 1 all-gather; the accounted bytes
  equal JAX's.
- One train step of a tiny model (2 layers, d_model 64, T 256) at W = 2,
  contiguous and zigzag: loss and updated parameters against JAX's
  ``make_train_step(mesh=cpu_mesh(2))`` and against the port's own
  single-rank step, within ``test_torch_train``'s Adam tolerance (1e-5
  relative, 3e-6 absolute); the parameters bit-identical across ranks.
- ``cli.main --mode train --mesh seq=2`` in both layouts (one record, from
  rank 0), checkpoint save at W = 2 and a resume that continues the
  uninterrupted run's losses, and ``--mode generate`` still refused.

JAX is imported inside the tests, so a spawned rank imports torch only.
"""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import (
    _bytes,
    _delta,
    _jax_accounted,
    run_ranks,
)
from tree_attention_tpu_torch import models as tm
from tree_attention_tpu_torch.models.transformer import LAYER_KEYS
from tree_attention_tpu_torch.ops import cuda_attention, cuda_bwd
from tree_attention_tpu_torch.parallel import mesh as tmesh
from tree_attention_tpu_torch.parallel import tree as ttree
from tests.torch_steps import hold_params
from tests.torch_threads import few_torch_threads  # noqa: F401

TOL, TOL_GRAD = 2e-5, 3e-5
D = 16
PAYLOADS = ("split", "packed")

# name -> (B, Hq, Hkv, Tq, Tk, causal, layout, q_chunk): global lengths.
CASES = {
    "contig-causal-b3": (1, 2, 2, 256, 256, True, "contiguous", None),
    "zigzag-causal-gqa": (2, 4, 2, 128, 128, True, "zigzag", None),
    "contig-noncausal-gqa": (2, 4, 2, 64, 64, False, "contiguous", None),
    "zigzag-noncausal": (1, 2, 2, 64, 64, False, "zigzag", None),
    "contig-tq-lt-tk": (1, 4, 2, 64, 128, True, "contiguous", None),
    "zigzag-tq-lt-tk": (1, 2, 2, 64, 128, True, "zigzag", None),
    "zigzag-chunked-ragged": (1, 2, 1, 128, 128, True, "zigzag", 40),
    "contig-chunked": (1, 2, 2, 128, 128, True, "contiguous", 16),
}
# (case, W) pairs held against JAX (each JAX program compiles on its own,
# 1-5 s): the first seven in tier 1, the last two with -m slow.
PAIRS = [("contig-causal-b3", 2), ("zigzag-causal-gqa", 2),
         ("zigzag-causal-gqa", 4), ("contig-noncausal-gqa", 2),
         ("zigzag-noncausal", 4), ("contig-tq-lt-tk", 4),
         ("zigzag-chunked-ragged", 2), ("zigzag-tq-lt-tk", 2),
         ("contig-chunked", 2)]
SLOW_PAIRS = PAIRS[7:]

T_TRAIN = 256
T_CFG = tm.TransformerConfig(
    vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=192, max_seq_len=T_TRAIN, dtype=torch.float32,
)
LAYOUTS = ("contiguous", "zigzag")
CLI_TRAIN = ["--device", "cpu", "--mesh", "seq=2", "--mode", "train",
             "--seq-len", str(T_TRAIN), "--model-dim", "64", "--heads", "4",
             "--kv-heads", "2", "--n-layers", "2", "--vocab-size", "256",
             "--dtype", "float32", "--iters", "1", "--log-level", "warning"]


def case_arrays(name):
    """Natural-order ``q, k, v, dout, dlse`` of a case (numpy, f32)."""
    B, Hq, Hkv, Tq, Tk, _, _, _ = CASES[name]
    rng = np.random.default_rng(100 + sorted(CASES).index(name))
    return (rng.standard_normal((B, Hq, Tq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Tk, D)).astype(np.float32),
            rng.standard_normal((B, Hq, Tq, D)).astype(np.float32),
            rng.standard_normal((B, Hq, Tq)).astype(np.float32))


def arranged(x, layout, world):
    """``x`` in the layout's global order along the sequence axis (2)."""
    if layout == "contiguous":
        return x
    return np.take(x, ttree.zigzag_perm(x.shape[2], world)[0], axis=2)


def train_batch(seed=7):
    toks = np.random.default_rng(seed).integers(0, 256, (2, T_TRAIN + 1))
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def _np_params(params):
    return {n: t.detach().numpy().copy() for n, t in tm.named_params(params)}


# -- the ranks' side ---------------------------------------------------------

def _tree_cases(rank, world, mesh):
    out = {}
    for name, w in PAIRS:
        if w != world:
            continue
        B, Hq, Hkv, Tq, Tk, causal, layout, q_chunk = CASES[name]
        arrs = [arranged(a, layout, world) for a in case_arrays(name)]
        local = [torch.from_numpy(np.ascontiguousarray(
            np.array_split(a, world, axis=2)[rank])) for a in arrs]
        for payload in PAYLOADS:
            leaves = [t.clone().requires_grad_() for t in local[:3]]
            c0, b0 = dict(ttree.COLLECTIVES), _bytes()
            o, lse = ttree.tree_attention(
                *leaves, mesh=mesh, causal=causal, layout=layout,
                q_chunk=q_chunk, merge_payload=payload)
            c1, b1 = dict(ttree.COLLECTIVES), _bytes()
            ((o * local[3]).sum() + (lse * local[4]).sum()).backward()
            out[(name, payload)] = {
                "res": (o.detach().numpy(), lse.detach().numpy()),
                "grads": tuple(t.grad.numpy() for t in leaves),
                "fwd": _delta(c1, c0), "bwd": _delta(dict(ttree.COLLECTIVES),
                                                     c1),
                "bytes": _delta(b1, b0)}
    return out


def _collective_forms(mesh):
    """The native collectives (NCCL's) and the gloo all-reduce forms agree
    bit for bit (gloo runs both on CPU tensors)."""
    g = torch.Generator().manual_seed(mesh.rank)
    x = torch.randn(3, 5, generator=g)
    xs = torch.randn(mesh.size, 4, 2, generator=g)
    a = [ttree.gather_rows(x, mesh, "seq", "probe", native=n)
         for n in (True, False)]
    b = [ttree.scatter_rows(xs, mesh, "seq", "probe", native=n)
         for n in (True, False)]
    return {"gather": [t.numpy() for t in a],
            "scatter": [t.numpy() for t in b]}


def _train_steps(mesh):
    out = {}
    opt = tm.default_optimizer()
    batch = {k: torch.from_numpy(v) for k, v in train_batch().items()}
    for layout in LAYOUTS:
        cfg = dataclasses.replace(T_CFG, seq_layout=layout)
        state = tm.init_train_state(cfg, opt, seed=0, device="cpu",
                                    mesh=mesh)
        c0 = dict(ttree.COLLECTIVES)
        state, loss = tm.make_train_step(cfg, opt, mesh=mesh)(state, batch)
        out[layout] = {"loss": float(loss),
                       "params": _np_params(state[0]),
                       # The global gradient as AdamW took it (clipped).
                       "grads": {n: t.grad.numpy().copy()
                                 for n, t in tm.named_params(state[0])},
                       "digest": tm.params_digest(state[0]),
                       "colls": _delta(dict(ttree.COLLECTIVES), c0),
                       "shard": {k: v.numpy() for k, v in tm.shard_batch(
                           mesh, batch, cfg).items()}}
    return out


def _cli(args):
    from tree_attention_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    lines = buf.getvalue().strip().splitlines()
    return rc, [json.loads(s) for s in lines]


def _cli_runs(ckpt_dir):
    from tree_attention_tpu_torch import cli

    out = {}
    for layout in LAYOUTS:
        out[layout] = _cli(CLI_TRAIN + ["--seq-layout", layout,
                                        "--steps", "3"])
    out["ckpt"] = _cli(CLI_TRAIN + ["--steps", "2", "--ckpt-dir", ckpt_dir])
    out["resume"] = _cli(CLI_TRAIN + ["--steps", "1", "--ckpt-dir", ckpt_dir,
                                      "--resume"])
    try:
        cli.main(["--device", "cpu", "--mesh", "seq=2", "--mode",
                  "generate"])
        out["generate"] = None
    except SystemExit as e:
        out["generate"] = str(e)
    return out


def _bf16_gates(rank, world, mesh):
    """bf16 ``tree_attention`` gradients against the unsharded plain
    backward under the card's gate (row gate, one-key rule, the merge's
    cotangent-rounding allowance): passed, and failed with ``dlse`` left
    out of the backward."""
    from tree_attention_tpu_torch.ops import vjp

    B, H, T, Dh = 1, 2, 256, 32
    g = torch.Generator().manual_seed(3)
    q, k, v, dout = (torch.randn(B, H, T, Dh, generator=g).to(torch.bfloat16)
                     for _ in range(4))
    dlse = torch.randn(B, H, T, generator=g)
    ro, rl = cuda_attention.fwd_plain(q, k, v, causal=True)
    want = cuda_bwd.bwd_plain(q, k, v, ro, rl, dout, dlse, causal=True)
    lse_f, delta = cuda_bwd.bwd_residuals(ro, rl, dout, dlse)
    one_key = cuda_bwd.dq_one_key_bound(q, k, v, dout, delta, causal=True,
                                        dlse=dlse)
    out = {}
    for layout in LAYOUTS:
        rows = torch.from_numpy(ttree.local_positions(T, mesh, layout))

        def mine(x):
            return x.index_select(2, rows)

        allow = [mine(x) for x in cuda_bwd.merge_cotangent_allowance(
            q, k, v, dout, lse_f, ttree.partial_key_groups(T, world, layout),
            causal=True)]

        def grads():
            leaves = [mine(t).requires_grad_() for t in (q, k, v)]
            o, lse = ttree.tree_attention(*leaves, mesh=mesh, causal=True,
                                          layout=layout)
            torch.autograd.backward([o, lse], [mine(dout), mine(dlse)])
            return [t.grad for t in leaves]

        gate = [mine(x) for x in want], 2e-2, tuple(mine(x) for x in one_key)
        ok = cuda_bwd.grad_rows_close(grads(), *gate, allow)[0]
        fns = {n: getattr(vjp, n) for n in ("attention_cuda_bwd",
                                             "attention_bwd_blockwise")}
        for n, fn in fns.items():
            setattr(vjp, n, lambda *a, _fn=fn, **kw: _fn(*a[:6], None, **kw))
        try:
            dropped = cuda_bwd.grad_rows_close(grads(), *gate, allow)[0]
        finally:
            for n, fn in fns.items():
                setattr(vjp, n, fn)
        out[layout] = (ok, dropped)
    return out


def _rank_all(rank, world, ckpt_dir):
    from tree_attention_tpu_torch import obs

    obs.enable()
    mesh = tmesh.make_mesh({"seq": world})
    out = {"tree": _tree_cases(rank, world, mesh)}
    if world == 2:
        out["bf16"] = _bf16_gates(rank, world, mesh)
        out["forms"] = _collective_forms(mesh)
        out["train"] = _train_steps(mesh)
        out["cli"] = _cli_runs(ckpt_dir)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``ranks(W)``: every rank's results at W ranks. The W = 2 and W = 4
    groups are spawned once for the module, side by side (most of a
    group's time is its processes starting)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        runs = {}
        for world in (2, 4):
            tmp = tmp_path_factory.mktemp(f"tree_w{world}")
            runs[world] = pool.submit(run_ranks, world, _rank_all, tmp,
                                      str(tmp / "ckpt"))
        runs = {w: f.result() for w, f in runs.items()}
    return runs.__getitem__


@pytest.mark.parametrize("name,world", [
    pytest.param(*p, marks=pytest.mark.slow) if p in SLOW_PAIRS else p
    for p in PAIRS])
def test_tree_attention_matches_jax(ranks, name, world):
    import jax
    import jax.numpy as jnp

    from tree_attention_tpu.parallel.mesh import cpu_mesh
    from tree_attention_tpu.parallel.tree import tree_attention

    B, Hq, Hkv, Tq, Tk, causal, layout, q_chunk = CASES[name]
    q, k, v, do, dl = (jnp.asarray(arranged(a, layout, world))
                       for a in case_arrays(name))
    mesh = cpu_mesh(world)

    def f(q, k, v):
        o, lse = tree_attention(q, k, v, mesh=mesh, causal=causal,
                                layout=layout, q_chunk=q_chunk)
        return jnp.sum(o * do) + jnp.sum(lse * dl), (o, lse)

    ((_, (o, lse)), grads), jbytes = _jax_accounted(
        lambda: jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2),
                                           has_aux=True))(q, k, v))
    want = [np.asarray(x) for x in (o, lse, *grads)]
    res = ranks(world)
    tl, kl = Tq // world, Tk // world
    n_chunks = 1 if q_chunk is None else -(-tl // q_chunk)
    for payload in PAYLOADS:
        for r, rr in enumerate(res):
            c = rr["tree"][(name, payload)]
            rows = [slice(r * tl, (r + 1) * tl)] * 2 + [
                slice(r * tl, (r + 1) * tl), slice(r * kl, (r + 1) * kl),
                slice(r * kl, (r + 1) * kl)]
            got = [*c["res"], *c["grads"]]
            for i, (g, w, sl) in enumerate(zip(got, want, rows)):
                w = w[:, :, sl]
                tol = TOL if i < 2 else TOL_GRAD
                np.testing.assert_array_equal(np.isneginf(g),
                                              np.isneginf(w))
                fin = np.isfinite(w)
                np.testing.assert_allclose(
                    g[fin], w[fin], atol=tol, rtol=0 if i < 2 else tol,
                    err_msg=f"{name} W{world} {payload} rank {r} output {i}")
            assert c["fwd"] == {("tree_attention", "all_gather"): n_chunks,
                                ("tree_attention", "pmax"): n_chunks,
                                ("tree_attention", "psum_scatter"): n_chunks}
            assert c["bwd"] == {("tree_attention", "all_gather"): n_chunks,
                                ("tree_attention", "psum_scatter"): n_chunks}
            assert c["bytes"] == jbytes


def test_b3_route_case_runs_128_rows():
    """The case that stands for the card's route: its runs have 128 rows,
    the Q-tiled kernel's (B3/B6/B7), not the decode kernel's."""
    from tree_attention_tpu_torch.ops.tuning import kernel_for

    B, Hq, Hkv, Tq, Tk, causal, layout, q_chunk = CASES["contig-causal-b3"]
    assert kernel_for(Tq // 2) == "fwd" and kernel_for(Tq // 4) == "decode"


def test_bf16_gradients_pass_the_card_gate_and_reject_dlse_dropped(ranks):
    """The gate ``chip_smoke.py`` holds the card's two-rank gradients to,
    on the plain route in bf16: passed; failed without the lse
    cotangent."""
    for r in ranks(2):
        for layout in LAYOUTS:
            assert r["bf16"][layout] == (True, False), layout


def test_partial_key_groups():
    c = ttree.partial_key_groups(8, 2, "contiguous")
    assert len(c) == 1 and c[0].tolist() == [0, 0, 0, 0, 1, 1, 1, 1]
    z = ttree.partial_key_groups(8, 2, "zigzag")
    # Natural key order: half-blocks 0 and 3 on rank 0, 1 and 2 on rank 1.
    assert z[0].tolist() == [0, 0, 1, 1, 1, 1, 0, 0]
    assert z[1].tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
    assert len(ttree.partial_key_groups(8, 2, "zigzag", causal=False)) == 1


def test_merge_cotangent_allowance_is_its_formula():
    """Element by element, at a tiny GQA shape: ``sigmas 2^-8 / sqrt(3)``
    times the root sum over rows of ``p^2 m`` with ``m`` from each
    partial's own output."""
    rng = np.random.default_rng(4)
    B, Hq, Hkv, T, Dh = 1, 4, 2, 8, 4
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s, np.float32))
                   for s in ((B, Hq, T, Dh), (B, Hkv, T, Dh),
                             (B, Hkv, T, Dh), (B, Hq, T, Dh)))
    _, lse = cuda_attention.fwd_plain(q, k, v, causal=True)
    groups = ttree.partial_key_groups(T, 2, "zigzag")
    got = cuda_bwd.merge_cotangent_allowance(q, k, v, do, lse, groups,
                                             causal=True)
    u = 6 * 2.0 ** -8 / np.sqrt(3)
    sc = Dh ** -0.5
    qn, kn, vn, don = (x.double().numpy()[0] for x in (q, k, v, do))
    s = np.einsum("hqd,hkd->hqk", qn, np.repeat(kn, 2, 0)) * sc
    s[:, np.triu_indices(T, 1)[0], np.triu_indices(T, 1)[1]] = -np.inf
    p = np.exp(s - lse.double().numpy()[0][..., None])
    vr = np.repeat(vn, 2, 0)
    m = np.zeros_like(p)
    for gr in groups:
        gr = gr.numpy()
        for h in range(Hq):
            for i in range(T):
                for j in range(T):
                    sel = gr == gr[j]
                    w = p[h, i, sel]
                    og = (w @ vr[h, sel]) / max(w.sum(), 1e-30)
                    m[h, i, j] += (don[h, i] ** 2 * (vr[h, j] - og) ** 2).sum()
    a = p * p * m
    dq = np.sqrt(np.einsum("hqk,hkd->hqd", a, np.repeat(kn, 2, 0) ** 2))
    dk = np.sqrt(np.einsum("hqk,hqd->hkd", a, qn ** 2).reshape(
        Hkv, 2, T, Dh).sum(1))
    dv = np.sqrt(np.einsum("hqk,hqd->hkd", p * p, don ** 2).reshape(
        Hkv, 2, T, Dh).sum(1))
    # m is expanded into matrix products (V^2 - 2 O V + O^2) in f32: where
    # a partial is one key (O = V) it is 0 only up to that rounding.
    for a, want in zip(got, (dq * u * sc, dk * u * sc, dv * u * np.sqrt(2))):
        np.testing.assert_allclose(a[0].numpy(), want, rtol=1e-4,
                                   atol=2e-3 * want.max())


def test_native_and_gloo_collective_forms_agree(ranks):
    """The NCCL path's collectives and gloo's all-reduce forms give the
    same bits (the layout logic above is shared by both)."""
    for r in ranks(2):
        for key in ("gather", "scatter"):
            native, gloo = r["forms"][key]
            np.testing.assert_array_equal(native, gloo)


# -- the train step ----------------------------------------------------------

def _jax_params(np_params):
    import jax.numpy as jnp

    return {"embed": jnp.asarray(np_params["embed"]),
            "ln_f": jnp.asarray(np_params["ln_f"]),
            "wout": jnp.asarray(np_params["wout"]),
            "layers": {k: jnp.asarray(np_params[f"layers.{k}"])
                       for k in LAYER_KEYS}}


def _flat(tree):
    return {"embed": tree["embed"], "ln_f": tree["ln_f"],
            "wout": tree["wout"],
            **{f"layers.{k}": v for k, v in tree["layers"].items()}}


def _hold(params, loss, want_params, want_loss, what):
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5, err_msg=what)
    for name, want in want_params.items():
        np.testing.assert_allclose(params[name], np.asarray(want),
                                   rtol=1e-5, atol=3e-6,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_train_step_matches_single_rank(ranks, layout):
    """The W = 2 step against the port's own single-rank step on the same
    parameters and batch; bit-identical parameters across the ranks; the
    collectives of one step; ``shard_batch``'s rows."""
    res = ranks(2)
    got = [r["train"][layout] for r in res]
    for name, a in got[0]["params"].items():
        np.testing.assert_array_equal(a, got[1]["params"][name])
    assert got[0]["digest"] == got[1]["digest"]
    assert got[0]["loss"] == got[1]["loss"]
    # One step: 2 layers x (3 gathers, 2 MAX, 3 reduce-scatters: forward,
    # its recomputation under remat, backward) and one gradient bucket.
    assert got[0]["colls"] == {("tree_attention", "all_gather"): 6,
                               ("tree_attention", "pmax"): 4,
                               ("tree_attention", "psum_scatter"): 6,
                               ("train_step", "psum_grads"): 1}
    batch = train_batch()
    opt = tm.default_optimizer()
    params = tm.init_params(T_CFG, 0, "cpu")
    state, loss = tm.make_train_step(T_CFG, opt)(
        (params, opt.init(params)),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    _hold(got[0]["params"], got[0]["loss"], _np_params(state[0]),
          float(loss), f"{layout} vs the single-rank step")
    perm = (ttree.zigzag_perm(T_TRAIN, 2)[0] if layout == "zigzag"
            else np.arange(T_TRAIN))
    for r, g in enumerate(got):
        rows = perm[r * T_TRAIN // 2:(r + 1) * T_TRAIN // 2]
        for key in ("inputs", "targets"):
            np.testing.assert_array_equal(g["shard"][key], batch[key][:, rows])


# JAX's zigzag mesh step compiles in ~7 s: with -m slow.
@pytest.mark.parametrize("layout", [
    "contiguous", pytest.param("zigzag", marks=pytest.mark.slow)])
def test_train_step_matches_jax(ranks, layout):
    """One W = 2 step against JAX's on ``cpu_mesh(2)`` (the body of its
    ``make_train_step``: the loss's value and gradient, then
    ``default_optimizer``'s update): the loss within 1e-5 relative, the
    clipped global gradient within ``test_torch_train``'s gradient
    tolerance (1e-4), the parameters in units of each entry's own step
    (``tests/torch_steps.py``; one ``layers.w2`` entry's gradient sits at
    Adam's eps, where a fixed bound passed or failed with f32 rounding)."""
    import jax
    import jax.numpy as jnp
    import optax

    from tree_attention_tpu import models as jm
    from tree_attention_tpu.models import shard_batch as j_shard_batch
    from tree_attention_tpu.models.train import _axes_in_mesh
    from tree_attention_tpu.parallel.mesh import cpu_mesh

    got = ranks(2)[0]["train"][layout]
    batch = train_batch()
    jcfg = jm.TransformerConfig(
        vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_head=16, d_ff=192, max_seq_len=T_TRAIN, dtype=jnp.float32,
        seq_layout=layout)
    mesh = cpu_mesh(2)
    axes = dict(zip(("data_axis", "seq_axis", "model_axis"),
                    _axes_in_mesh(mesh, "data", "seq", "model")))
    jopt = jm.default_optimizer()
    p0 = _np_params(tm.init_params(T_CFG, 0, "cpu"))
    jp = _jax_params(p0)
    jloss, grads = jax.jit(lambda p, b: jax.value_and_grad(jm.loss_fn)(
        p, b, jcfg, mesh=mesh, **axes))(
        jp, j_shard_batch(mesh, {k: jnp.asarray(v, jnp.int32)
                                 for k, v in batch.items()}))
    upd, _ = jopt.update(grads, jopt.init(jp), jp)
    jparams = optax.apply_updates(jp, upd)
    what = f"{layout} vs JAX"
    np.testing.assert_allclose(got["loss"], float(jloss), rtol=1e-5,
                               err_msg=what)
    want = _flat(jax.tree.map(
        np.asarray, optax.clip_by_global_norm(1.0).update(grads, None)[0]))
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g, want[name], atol=1e-4, rtol=1e-4,
                                   err_msg=f"{what}: gradient {name}")
    hold_params(got["params"],
                [p0, _flat(jax.tree.map(np.asarray, jparams))],
                [got["grads"]], [want], what)


def test_loss_is_layout_invariant_and_sums_to_the_mean(ranks):
    """The ranks' step losses are the global mean, the same under both
    layouts (the mean does not depend on the row order)."""
    res = ranks(2)
    np.testing.assert_allclose(res[0]["train"]["zigzag"]["loss"],
                               res[0]["train"]["contiguous"]["loss"],
                               rtol=1e-6)


# -- the CLI ----------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
def test_cli_train_on_a_mesh_prints_one_record(ranks, layout):
    res = ranks(2)
    (rc0, recs0), (rc1, recs1) = (r["cli"][layout] for r in res)
    assert rc0 == rc1 == 0 and recs1 == [] and len(recs0) == 1
    rec = recs0[0]
    assert rec["mode"] == "train" and rec["seq_layout"] == layout
    assert rec["mesh"] == {"seq": 2} and rec["dist_backend"] == "gloo"
    assert rec["params_equal_across_ranks"] is True
    assert len(rec["losses"]) == 3 and all(np.isfinite(rec["losses"]))
    assert rec["collectives_per_step"] == {
        "tree_attention/all_gather": 6, "tree_attention/pmax": 4,
        "tree_attention/psum_scatter": 6, "train_step/psum_grads": 1}


def test_cli_checkpoint_resume_on_a_mesh(ranks, tmp_path_factory):
    """Rank 0 saves, every rank restores: the resumed step's loss is the
    uninterrupted run's third."""
    res = ranks(2)
    (rc, recs), _ = (r["cli"]["ckpt"] for r in res)
    assert rc == 0 and len(recs[0]["losses"]) == 2
    (rc, resumed), (rc1, none) = (r["cli"]["resume"] for r in res)
    assert rc == rc1 == 0 and none == []
    full = res[0]["cli"]["contiguous"][1][0]["losses"]
    np.testing.assert_allclose(resumed[0]["losses"], full[2:], rtol=1e-6)
    assert recs[0]["losses"] == full[:2]


def test_cli_generate_on_a_mesh_is_refused(ranks):
    for r in ranks(2):
        assert "--mode generate on a mesh" in r["cli"]["generate"]


# -- one process -------------------------------------------------------------

@pytest.mark.parametrize("t,n", [(8, 2), (16, 4), (24, 3), (64, 8)])
def test_zigzag_matches_jax(t, n):
    import jax.numpy as jnp

    from tree_attention_tpu.parallel import tree as jtree

    perm, inv = ttree.zigzag_perm(t, n)
    jperm, jinv = jtree.zigzag_perm(t, n)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(inv, jinv)
    x = np.random.default_rng(t).standard_normal((2, t, 3)).astype(
        np.float32)
    z = ttree.shard_zigzag(torch.from_numpy(x), 1, n)
    np.testing.assert_array_equal(
        z.numpy(), np.asarray(jtree.shard_zigzag(jnp.asarray(x), 1, n)))
    back = ttree.unshard_zigzag(z, 1, n)
    np.testing.assert_array_equal(
        back.numpy(),
        np.asarray(jtree.unshard_zigzag(jnp.asarray(z.numpy()), 1, n)))
    np.testing.assert_array_equal(back.numpy(), x)


def test_zigzag_rejects_odd_half_blocks_like_jax():
    from tree_attention_tpu.parallel import tree as jtree

    with pytest.raises(ValueError, match="half-blocks") as ours:
        ttree.zigzag_perm(10, 3)
    with pytest.raises(ValueError) as theirs:
        jtree.zigzag_perm(10, 3)
    assert str(ours.value) == str(theirs.value)


def test_make_lm_batch_divisibility_error_matches_jax():
    import jax

    from tree_attention_tpu import data as jdata
    from tree_attention_tpu.parallel.mesh import cpu_mesh
    from tree_attention_tpu_torch.data import make_lm_batch

    m = tmesh.Mesh(shape={"seq": 3}, coords={"seq": 0}, groups={"seq": None})
    with pytest.raises(ValueError) as ours:
        make_lm_batch(torch.Generator().manual_seed(0), 2, 16, 50, "cpu",
                      mesh=m)
    with pytest.raises(ValueError) as theirs:
        jdata.make_lm_batch(jax.random.PRNGKey(0), batch=2, seq_len=16,
                            vocab_size=50, mesh=cpu_mesh(3))
    assert str(ours.value) == str(theirs.value)
    a = make_lm_batch(torch.Generator().manual_seed(4), 2, 12, 50, "cpu",
                      mesh=m)
    b = make_lm_batch(torch.Generator().manual_seed(4), 2, 12, 50, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)  # the global batch


@pytest.mark.parametrize("seg_len", [4, 5])
def test_segment_relation_is_the_causal_rule(seg_len):
    """"full" / "masked" / "diagonal" from JAX's static arithmetic equal
    the brute-force visibility of every (row, key) pair."""
    for q_off in range(-6, 20):
        for n_rows in (1, 3, 7):
            for h in range(6):
                qp = q_off + np.arange(n_rows)[:, None]
                kp = h * seg_len + np.arange(seg_len)[None]
                vis = kp <= qp
                want = ("full" if vis.all() else
                        "masked" if not vis.any() else "diagonal")
                assert ttree.segment_relation(q_off, n_rows, h,
                                              seg_len) == want


def test_local_positions_and_gather_chunk(monkeypatch):
    m = tmesh.Mesh(shape={"seq": 2}, coords={"seq": 1}, groups={"seq": None})
    np.testing.assert_array_equal(
        ttree.local_positions(8, m, "contiguous"), [4, 5, 6, 7])
    np.testing.assert_array_equal(
        ttree.local_positions(8, m, "zigzag"), [2, 3, 4, 5])
    with pytest.raises(ValueError, match="layout"):
        ttree.local_positions(8, m, "ring")
    kw = dict(batch=2, heads=16, head_dim=128, itemsize=2, n_shards=2)
    # The training shape fits the default budget in one chunk ...
    assert ttree.gather_chunk(None, tq_local=2048, **kw) == 2048
    # ... a small budget chunks at a multiple of 128, the cap at 16 chunks.
    monkeypatch.setenv("TREE_ATTN_GATHER_BUDGET", str(1 << 24))
    assert ttree.gather_chunk(None, tq_local=2048, **kw) == 128
    monkeypatch.setenv("TREE_ATTN_GATHER_BUDGET", "1")
    assert ttree.gather_chunk(None, tq_local=4096, **kw) == 256
    assert ttree.gather_chunk(40, tq_local=32, **kw) == 32
    with pytest.raises(ValueError, match="q_chunk"):
        ttree.gather_chunk(0, tq_local=32, **kw)


def test_tree_attention_on_one_rank_is_flash_attention():
    """On a size-1 axis nothing is issued and the merge is exact."""
    from tree_attention_tpu_torch.ops import flash_attention

    q, k, v, _, _ = case_arrays("contig-tq-lt-tk")
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    c0 = dict(ttree.COLLECTIVES)
    o, lse = ttree.tree_attention(q, k, v, mesh=tmesh.make_mesh(),
                                  causal=True)
    assert dict(ttree.COLLECTIVES) == c0
    ro, rl = flash_attention(q, k, v, causal=True, q_offset=64)
    torch.testing.assert_close(o, ro, atol=1e-6, rtol=0)
    torch.testing.assert_close(lse, rl, atol=1e-6, rtol=0)


def test_tree_attention_refuses_other_axes_and_layouts():
    q = torch.zeros(1, 2, 8, D)
    mesh = tmesh.make_mesh()
    with pytest.raises(NotImplementedError, match="seq axis only"):
        ttree.tree_attention(q, q, q, mesh=mesh, data_axis="data")
    with pytest.raises(ValueError, match="layout"):
        ttree.tree_attention(q, q, q, mesh=mesh, layout="ring")
    with pytest.raises(ValueError, match="even local lengths"):
        ttree.tree_attention(q[:, :, :5], q, q, mesh=mesh, causal=True,
                             layout="zigzag")


def test_grad_gate_one_key_rows_with_an_lse_cotangent():
    """With a non-zero ``dlse`` the one-key dq rows are ``dlse K_0
    scale``, no longer 0: two correct summation orders pass the gate, and
    ``dlse`` left out of delta is rejected there (the bound covers only the
    cancellation's rounding; before it took |dO.V - delta| ~ |dlse| as
    rounding and passed such rows at twice their value)."""
    B, Hq, Hkv, Tq, Tk = 2, 4, 2, 40, 60
    rng = np.random.default_rng(8)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s, np.float32)
                                    ).to(torch.bfloat16)
                   for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D),
                             (B, Hq, Tq, D)))
    dlse = torch.from_numpy(rng.standard_normal((B, Hq, Tq), np.float32))
    kw = dict(causal=True, q_offset=torch.tensor([-3, 10]),
              kv_offset=torch.tensor([0, 12]))
    out, lse = cuda_attention.fwd_plain(q, k, v, **kw)
    lse_f, delta = cuda_bwd.bwd_residuals(out, lse, do, dlse)
    _, delta0 = cuda_bwd.bwd_residuals(out, lse, do)
    want = (cuda_bwd.dq_plain(q, k, v, do, lse_f, delta, **kw),)
    perm = torch.from_numpy(rng.permutation(D))
    inv = torch.argsort(perm)
    pq, pk, pv, pdo = (t[..., perm] for t in (q, k, v, do))
    got = (cuda_bwd.dq_plain(pq, pk, pv, pdo, lse_f, delta, **kw)[..., inv],)
    one_key = cuda_bwd.dq_one_key_bound(q, k, v, do, delta, dlse=dlse, **kw)
    rows = one_key[0]
    assert int(rows.sum()) == 2
    assert cuda_bwd.grad_rows_close(got, want, 2e-2, one_key)[0]
    # dlse dropped, only on the one-key rows: rejected.
    dropped = cuda_bwd.dq_plain(q, k, v, do, lse_f, delta0, **kw)
    faulty = (torch.where(rows, dropped, want[0]),)
    assert not cuda_bwd.grad_rows_close(faulty, want, 2e-2, one_key)[0]
    old_rule = cuda_bwd.dq_one_key_bound(q, k, v, do, delta, **kw)
    assert (old_rule[1] >= (faulty[0] - want[0]).float().abs())[
        rows.expand_as(old_rule[1])].all()
