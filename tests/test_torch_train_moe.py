"""Training the mixtral and deepseek-v3 smoke configs: the port against the
JAX package, on the CPU.

Both sides start from the JAX package's train state (parameters with every
norm scale and router bias perturbed as ``tests/test_torch_serve_moe.py``
does, AdamW state, PowerSGD error buffers and Q factors), carried across
by ``repro_torch.convert.state_from_jax``, and take the same batches from
their ``batch_for_step``. Both run under a policy with lowered classifier
thresholds and ``split=2``, so the routers route to tsm2r and PowerSGD's
projections to the TSM2X kernels' plain versions. ``min_size=4096``
compresses ``embed`` and ``lm_head``: every stacked leaf of the smoke
models is 3-D or more in the JAX layout (the expert stacks 4-D), so
neither package compresses it. One step of two microbatches, f32, remat
on; the loss carries the balance term ``1e-2 * moe_balance_loss /
n_layers``. Metrics, gradients (``router_bias``'s zero: it reaches the
loss only through the top-k selection) and every leaf of the state agree
at rtol = atol = 1e-4 (``tests/test_torch_train.py``'s tolerance); a
PowerSGD Q is drawn with crc32 as ``tests/test_torch_train_zamba.py``
does.

Then: a parameter the loss does not reach gets a zero gradient (before,
``torch.autograd.grad`` raised on the first MoE step); the launcher
trains mixtral's smoke config for 2 steps on the CPU and matches the JAX
launcher from the same state; a bf16 ``params_from_jax`` round trip over
deepseek's two segments and 4-D expert leaves; ``quantize_weights``
leaves the expert stacks dense.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import tsmm as jtsmm
from repro.data import pipeline as jpipeline
from repro.kernels import quant as jquant
from repro.launch import train as jlaunch
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.optim import powersgd as jpowersgd
from repro.optim import schedule as jschedule
from repro.train import train_step as jtrain
from repro_torch import convert, layout
from repro_torch.configs import registry
from repro_torch.core import tsmm
from repro_torch.data import pipeline
from repro_torch.kernels import quant
from repro_torch.launch import train as launch
from repro_torch.models import model
from repro_torch.optim import adamw, powersgd, schedule
from repro_torch.train import train_step
from test_torch_serve_moe import perturb
from test_torch_train import _np, _snap
from test_torch_train_zamba import _flat, _path_hash

TOL = dict(rtol=1e-4, atol=1e-4)
THRESH = dict(min_tall=32, max_skinny=32, skinny_ratio=2)
N_MICRO = 2
DATA = dict(seed=0, seq_len=32, global_batch=4, vocab_size=256)
MIN_SIZE = 4096
ARCHS = ["mixtral-8x7b", "deepseek-v3-671b"]


def _jax_state(jcfg, jps, jopt):
    jstate = jtrain.init_train_state(jax.random.PRNGKey(0), jcfg, jopt)
    params = perturb(jax.tree.map(np.asarray, jstate["params"]),
                     np.random.default_rng(0))
    params = jax.tree.map(jnp.asarray, params)
    with mock.patch.object(jpowersgd, "hash", _path_hash, create=True):
        extra = jpowersgd.init(jps, params, jax.random.PRNGKey(17))
    return {**jstate, "params": params, "extra": extra}


def _batch(i):
    jb = jpipeline.batch_for_step(jpipeline.DataConfig(**DATA), i)
    b = pipeline.batch_for_step(pipeline.DataConfig(**DATA), i)
    return ({k: jnp.asarray(v) for k, v in jb.items()},
            {k: torch.from_numpy(v).long() for k, v in b.items()})


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    arch = request.param
    jcfg = jregistry.get_config(arch, smoke=True)
    cfg = registry.get_config(arch, smoke=True)
    jps = jpowersgd.PowerSGDConfig(rank=4, min_size=MIN_SIZE)
    ps = powersgd.PowerSGDConfig(rank=4, min_size=MIN_SIZE)
    jopt = jadamw.AdamWConfig(lr=jschedule.linear_warmup_cosine(1e-3, 2, 3))
    opt = adamw.AdamWConfig(lr=schedule.linear_warmup_cosine(1e-3, 2, 3))
    jstate = _jax_state(jcfg, jps, jopt)
    state = convert.state_from_jax(cfg, jax.tree.map(np.asarray, jstate),
                                   device="cpu")
    jb, b = _batch(0)

    # The loss and every gradient of the whole batch.
    jgrads = jax.grad(lambda p: jtrain.make_loss_fn(jcfg)(p, jb)[0])(
        jstate["params"])
    pol = tsmm.GemmPolicy(**THRESH, split=2)
    with tsmm.policy(pol):
        loss, grads, aux = train_step._grads(train_step.make_loss_fn(cfg),
                                             state["params"], b)
    jloss, jaux = jtrain.make_loss_fn(jcfg)(jstate["params"], jb)

    jstep = jax.jit(jtrain.make_train_step(
        jcfg, jopt, n_micro=N_MICRO,
        grad_transform=lambda g, st: jpowersgd.compress_tree(jps, g, st)))
    step = train_step.make_train_step(
        cfg, opt, n_micro=N_MICRO,
        grad_transform=lambda g, st: powersgd.compress_tree(ps, g, st))
    with jtsmm.policy(jtsmm.GemmPolicy(**THRESH, split=2)):
        jstate, jm = jstep(jstate, jb)
    with tsmm.policy(pol), tsmm.record_dispatches() as log:
        state, m = step(state, b)
    return dict(cfg=cfg, jgrads=jgrads, grads=grads, loss=loss, aux=aux,
                jloss=jloss, jaux=jaux, jstate=jax.tree.map(np.asarray,
                                                            jstate),
                jm=jm, state=_snap(state), m=m, log=log)


def test_loss_carries_the_balance_term(run):
    cfg = run["cfg"]
    np.testing.assert_allclose(float(run["loss"]), float(run["jloss"]),
                               **TOL)
    for k in ("moe_balance_loss", "moe_dropped_frac", "moe_max_load"):
        np.testing.assert_allclose(float(run["aux"][k]),
                                   float(run["jaux"][k]), **TOL, err_msg=k)
    lm = float(run["aux"]["loss"])
    balance = 1e-2 * float(run["aux"]["moe_balance_loss"]) / cfg.n_layers
    np.testing.assert_allclose(float(run["loss"]), lm + balance, rtol=1e-6)


def test_grads_match_jax(run):
    named = run["grads"]
    params = {}
    for path, names in layout.jax_leaves(named).items():
        shape = layout.jax_shape(named, names)
        params[path] = torch.stack([named[n] for n in names]).reshape(
            shape) if layout.stacked(names) else named[names[0]]
    want = _flat(run["jgrads"])
    assert sorted(params) == sorted(want)
    for path, g in params.items():
        np.testing.assert_allclose(_np(g), np.asarray(want[path]), **TOL,
                                   err_msg=path)
        if path.endswith("router_bias"):
            assert not g.any() and not np.asarray(want[path]).any()


def test_metrics_agree(run):
    m, jm = run["m"], run["jm"]
    for key in ("loss", "grad_norm", "powersgd_compression", "accuracy",
                "lr", "moe_balance_loss", "moe_dropped_frac", "moe_max_load"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), **TOL,
                                   err_msg=key)
    assert bool(m["step_ok"]) and bool(jm["step_ok"])


def test_state_agrees(run):
    cfg, got = run["cfg"], run["state"]
    want = _snap(convert.state_from_jax(cfg, run["jstate"], device="cpu"))
    assert got["step"] == want["step"] == 1
    for name, p in got["params"].items():
        np.testing.assert_allclose(p, want["params"][name], **TOL,
                                   err_msg=name)
        for f in ("m", "v"):
            np.testing.assert_allclose(got["moments"][name][f],
                                       want["moments"][name][f], **TOL,
                                       err_msg=f"{name}.{f}")
    assert sorted(got["extra"]) == ["embed.table", "lm_head.table"]
    for path, st in got["extra"].items():
        for f in ("err", "q"):
            np.testing.assert_allclose(st[f], want["extra"][path][f], **TOL,
                                       err_msg=f"{path}.{f}")


def test_router_routes_to_tsm2r(run):
    """Each microbatch's router runs on tsm2r twice a MoE layer (forward
    and remat recompute); its weight gradient ``x^T dy`` goes through
    ``tsmm_t`` once."""
    cfg = run["cfg"]
    tokens = DATA["global_batch"] * DATA["seq_len"] // N_MICRO
    router = (tokens, cfg.d_model, cfg.moe.n_experts)
    hits = [e for e in run["log"] if e.shape == router]
    n_moe = cfg.n_layers - cfg.first_k_dense
    fwd = [e for e in hits if e.entry == "mm"]
    assert len(fwd) == 2 * n_moe * N_MICRO
    assert all(e.kind == "tsm2r" and e.executor == "torch-ref" for e in fwd)
    assert len(hits) - len(fwd) == n_moe * N_MICRO


def test_unreached_parameters_get_zero_gradients():
    """``router_bias`` has no path to the loss: ``torch.autograd.grad``
    alone raises on it; ``_grads`` gives zeros, as ``jax.grad`` does."""
    cfg = registry.get_config("mixtral-8x7b", smoke=True)
    params = model.init(cfg, 0, device="cpu").requires_grad_(True)
    _, b = _batch(0)
    loss, _ = train_step.make_loss_fn(cfg)(params, b)
    with pytest.raises(RuntimeError, match="not have been used"):
        torch.autograd.grad(loss, [params.layers[0].ffn.router_bias])
    _, grads, _ = train_step._grads(train_step.make_loss_fn(cfg), params, b)
    for name, g in grads.items():
        assert g.shape == dict(params.named_parameters())[name].shape
        assert bool(g.any()) != name.endswith("router_bias"), name


_BASE = ["--arch", "mixtral-8x7b", "--smoke", "--global-batch", "4",
         "--seq-len", "32", "--log-every", "100"]


def test_launcher_trains_mixtral_smoke_two_steps():
    out = launch.main(_BASE + ["--device", "cpu", "--steps", "2",
                               "--powersgd-rank", "4"])
    assert out["final_step"] == 1
    assert np.isfinite(out["final_loss"])


def test_launcher_matches_jax_from_the_same_state(monkeypatch):
    argv = _BASE + ["--steps", "2"]
    want = jlaunch.main(argv)
    jcfg = jregistry.get_config("mixtral-8x7b", smoke=True)

    def from_jax(seed, cfg, opt_cfg, extra=None, *, device=None):
        assert seed == 0 and extra is None
        jstate = jtrain.init_train_state(jax.random.PRNGKey(0), jcfg,
                                         jadamw.AdamWConfig())
        return convert.state_from_jax(cfg, jax.tree.map(np.asarray, jstate),
                                      device=device)

    monkeypatch.setattr(train_step, "init_train_state", from_jax)
    got = launch.main(argv + ["--device", "cpu"])
    assert got["final_step"] == want["final_step"] == 1
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=1e-4)


def _bf16_tree(arch):
    jcfg = dataclasses.replace(jregistry.get_config(arch, smoke=True),
                               dtype="bfloat16")
    cfg = dataclasses.replace(registry.get_config(arch, smoke=True),
                              dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(3), jcfg))
    return cfg, perturb(tree, np.random.default_rng(3))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_round_trip_keeps_every_leaf(arch):
    """JAX tree -> port -> the same numbers and dtypes, leaf by leaf, in
    bf16 (the routers f32): deepseek's two segments, the expert stacks
    (4-D in JAX, 3-D a layer in the port) and MLA's leaves."""
    cfg, tree = _bf16_tree(arch)
    params = convert.params_from_jax(cfg, tree, device="cpu")
    named = dict(params.named_parameters())
    groups = layout.jax_leaves(named)
    flat = _flat(tree)
    assert sorted(groups) == sorted(flat)
    seg = "1" if cfg.mla else "0"
    assert flat[f"segments.{seg}.ffn.experts.w_down"].shape == (
        cfg.n_layers - cfg.first_k_dense, cfg.moe.n_experts,
        cfg.moe.d_ff_expert, cfg.d_model)
    assert str(flat[f"segments.{seg}.ffn.router_w"].dtype) == "float32"
    for key, leaf in flat.items():
        names = groups[key]
        got = torch.stack([named[n] for n in names]).reshape(
            layout.jax_shape(named, names))
        assert str(got.dtype)[6:] == str(leaf.dtype), key
        np.testing.assert_array_equal(_np(got), leaf.astype(np.float32),
                                      err_msg=key)


def test_quantize_weights_leaves_expert_stacks_dense():
    """In the JAX layout only 2-D leaves become int8 records (the heads
    and the stacked norm scales and router biases at this ``min_size``),
    the reference's own choice; never an expert stack (4-D) or a stacked
    matrix (3-D). PowerSGD picks the same leaves."""
    cfg, tree = _bf16_tree("deepseek-v3-671b")
    params = convert.params_from_jax(cfg, tree, device="cpu")
    q = quant.quantize_weights(params, min_size=16)
    want = _flat(jquant.quantize_weights(jax.tree.map(jnp.asarray, tree),
                                         min_size=16))
    records = sorted({k.rsplit(".", 1)[0] for k in want
                      if k.endswith(".q8")})
    assert sorted(q.records) == records
    assert not [r for r in records if "experts" in r or "router_w" in r]
    assert "embed.table" in records and "lm_head.table" in records
    ps = powersgd.init(powersgd.PowerSGDConfig(min_size=16),
                       convert.params_from_jax(cfg, tree, device="cpu"))
    assert sorted(ps) == records
