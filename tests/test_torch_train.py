"""Training the chatglm3 smoke config with PowerSGD: the port against the
JAX package, on the CPU.

Both sides start from the JAX package's train state (parameters, AdamW
state, PowerSGD error buffers and Q factors), carried across by
``repro_torch.convert.state_from_jax``, and take the same batches from
their ``batch_for_step`` (which must be equal arrays). Both run under a
policy with lowered classifier thresholds and ``split=2``, so the smoke
model's ``wk``/``wv`` projections route to tsm2r and PowerSGD's
projections of ``embed``/``lm_head`` to tsm2r and the split tsmt, as
chatglm3-6b's do at full width. ``min_size=1024`` compresses exactly those
two leaves at the smoke width (the stacked per-layer vectors, (2, 64) and
smaller in the JAX layout, stay dense), as the default ``min_size`` does
at full width. Two microbatches, three steps, f32; every metric and every
leaf of the state agrees at rtol = atol = 1e-4.

AdamW runs with ``eps=1e-6`` on both sides. Half of each ``bk`` entry is
not rotated by the partial RoPE, so adding it shifts every score of a
query by the same amount and its gradient is zero up to rounding; with
the default ``eps=1e-8`` Adam scales that noise (a few 1e-9) to steps of
a third of the learning rate, in directions the two packages' roundings
pick differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import tsmm as jtsmm
from repro.data import pipeline as jpipeline
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.optim import powersgd as jpowersgd
from repro.optim import schedule as jschedule
from repro.train import train_step as jtrain
from repro_torch.configs import registry
from repro_torch.convert import state_from_jax
from repro_torch.core import tsmm
from repro_torch.data import pipeline
from repro_torch.optim import adamw, powersgd, schedule
from repro_torch.train import train_step

TOL = dict(rtol=1e-4, atol=1e-4)
THRESH = dict(min_tall=32, max_skinny=32, skinny_ratio=2)
STEPS, N_MICRO = 3, 2
EPS = 1e-6
DATA = dict(seed=0, seq_len=32, global_batch=4, vocab_size=256)


def _np(t):
    return t.detach().float().cpu().numpy().copy()


def _snap(state):
    """Numpy copy of a port train state (it is updated in place)."""
    return {"params": {n: _np(p) for n, p in
                       state["params"].named_parameters()},
            "moments": {n: {f: _np(t) for f, t in mv.items()}
                        for n, mv in state["opt"]["moments"].items()},
            "step": int(state["opt"]["step"]),
            "extra": {path: {f: _np(t) for f, t in st.items()}
                      for path, st in state.get("extra", {}).items()}}


@pytest.fixture(scope="module")
def runs():
    jcfg = jregistry.get_config("chatglm3-6b", smoke=True)
    cfg = registry.get_config("chatglm3-6b", smoke=True)
    jps = jpowersgd.PowerSGDConfig(rank=4, min_size=1024)
    ps = powersgd.PowerSGDConfig(rank=4, min_size=1024)
    jopt = jadamw.AdamWConfig(lr=jschedule.linear_warmup_cosine(1e-3, 2, 3),
                              eps=EPS)
    opt = adamw.AdamWConfig(lr=schedule.linear_warmup_cosine(1e-3, 2, 3),
                            eps=EPS)

    params0 = jmodel.init(jax.random.PRNGKey(0), jcfg)
    extra = jpowersgd.init(jps, params0, jax.random.PRNGKey(17))
    jstate = jtrain.init_train_state(jax.random.PRNGKey(0), jcfg, jopt,
                                     extra=extra)
    state = state_from_jax(cfg, jax.tree.map(np.asarray, jstate),
                           device="cpu")

    jstep = jtrain.make_train_step(
        jcfg, jopt, n_micro=N_MICRO,
        grad_transform=lambda g, st: jpowersgd.compress_tree(jps, g, st))
    step = train_step.make_train_step(
        cfg, opt, n_micro=N_MICRO,
        grad_transform=lambda g, st: powersgd.compress_tree(ps, g, st))
    jpol = jtsmm.GemmPolicy(**THRESH, split=2)
    pol = tsmm.GemmPolicy(**THRESH, split=2)
    jstep = jax.jit(jstep)

    out = []
    for i in range(STEPS):
        jb = jpipeline.batch_for_step(jpipeline.DataConfig(**DATA), i)
        b = pipeline.batch_for_step(pipeline.DataConfig(**DATA), i)
        for k in jb:
            np.testing.assert_array_equal(b[k], jb[k])
        with jtsmm.policy(jpol), jtsmm.record_dispatches() as jlog:
            jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in jb.items()})
        with tsmm.policy(pol), tsmm.record_dispatches() as log:
            state, m = step(state, {k: torch.from_numpy(v).long()
                                    for k, v in b.items()})
        out.append((jax.tree.map(np.asarray, jstate), jm, _snap(state), m,
                    jlog, log))
    return cfg, out


def test_state_carries_two_compressed_leaves(runs):
    _, out = runs
    state = out[-1][2]
    assert sorted(state["extra"]) == ["embed.table", "lm_head.table"]
    assert state["step"] == STEPS


@pytest.mark.parametrize("i", range(STEPS))
def test_metrics_agree(runs, i):
    _, out = runs
    _, jm, _, m, _, _ = out[i]
    for key in ("loss", "grad_norm", "powersgd_compression", "accuracy",
                "lr"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), **TOL,
                                   err_msg=key)
    assert bool(m["step_ok"]) and bool(jm["step_ok"])


@pytest.mark.parametrize("i", range(STEPS))
def test_state_agrees(runs, i):
    cfg, out = runs
    jstate, _, got, _, _, _ = out[i]
    want = _snap(state_from_jax(cfg, jstate, device="cpu"))
    assert got["step"] == want["step"] == i + 1
    for name, p in got["params"].items():
        np.testing.assert_allclose(p, want["params"][name], **TOL,
                                   err_msg=name)
        for f in ("m", "v"):
            np.testing.assert_allclose(got["moments"][name][f],
                                       want["moments"][name][f], **TOL,
                                       err_msg=f"{name}.{f}")
    assert sorted(got["extra"]) == sorted(want["extra"])
    for path, st in got["extra"].items():
        for f in ("err", "q"):
            np.testing.assert_allclose(st[f], want["extra"][path][f], **TOL,
                                       err_msg=f"{path}.{f}")


def test_dispatch_kinds_agree(runs):
    cfg, out = runs
    _, _, _, _, jlog, log = out[0]     # JAX traces on its first call
    seen = {(e.entry, e.kind, e.shape) for e in log}
    assert seen == {(e.entry, e.kind, e.shape) for e in jlog}
    kv = cfg.n_kv_heads * cfg.resolved_head_dim
    tokens = DATA["global_batch"] // N_MICRO * DATA["seq_len"]
    assert ("mm", "tsm2r", (tokens, cfg.d_model, kv)) in seen
    assert ("mm", "tsm2r", (cfg.vocab_size, cfg.d_model, 4)) in seen
    assert ("mmt", "tsmt", (cfg.vocab_size, cfg.d_model, 4)) in seen
    split_tsmt = [lm for e in log if e.kind == "tsmt" for lm in e.launches]
    assert split_tsmt and all(lm.splits == 2 for lm in split_tsmt)


def test_dense_arm_matches_kernel_arm(runs):
    """From the same state and batch, a ``mode="dense"`` scope gives the
    kernel arm's first step."""
    cfg, out = runs
    jcfg = jregistry.get_config("chatglm3-6b", smoke=True)
    jps = jpowersgd.PowerSGDConfig(rank=4, min_size=1024)
    jopt = jadamw.AdamWConfig(lr=jschedule.linear_warmup_cosine(1e-3, 2, 3),
                              eps=EPS)
    params0 = jmodel.init(jax.random.PRNGKey(0), jcfg)
    jstate = jtrain.init_train_state(
        jax.random.PRNGKey(0), jcfg, jopt,
        extra=jpowersgd.init(jps, params0, jax.random.PRNGKey(17)))
    np_state = jax.tree.map(np.asarray, jstate)
    ps = powersgd.PowerSGDConfig(rank=4, min_size=1024)
    step = train_step.make_train_step(
        cfg, adamw.AdamWConfig(lr=schedule.linear_warmup_cosine(1e-3, 2, 3),
                               eps=EPS),
        n_micro=N_MICRO,
        grad_transform=lambda g, st: powersgd.compress_tree(ps, g, st))
    batch = {k: torch.from_numpy(v).long() for k, v in pipeline.batch_for_step(
        pipeline.DataConfig(**DATA), 0).items()}
    with tsmm.policy(mode="dense"), tsmm.record_dispatches() as log:
        dense_state, dm = step(state_from_jax(cfg, np_state, device="cpu"),
                               batch)
    assert log and all(e.executor == "torch-dense" for e in log)
    _, _, got, m, _, _ = out[0]
    np.testing.assert_allclose(float(dm["loss"]), float(m["loss"]), **TOL)
    np.testing.assert_allclose(float(dm["grad_norm"]),
                               float(m["grad_norm"]), **TOL)
    for name, p in _snap(dense_state)["params"].items():
        np.testing.assert_allclose(p, got["params"][name], **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_losses_match_jax(z_loss):
    from repro.models import losses as jlosses
    from repro_torch.models import losses

    rng = np.random.default_rng(5)
    logits = rng.normal(0, 3, (2, 12, 40)).astype(np.float32)
    targets = rng.integers(0, 40, (2, 12)).astype(np.int32)
    mask = (rng.random((2, 12)) < 0.7).astype(np.float32)
    batch = {"targets": targets, "loss_mask": mask}
    got, gm = losses.lm_loss(torch.from_numpy(logits),
                             {k: torch.from_numpy(v) for k, v in
                              batch.items()}, z_loss)
    want, jm = jlosses.lm_loss(jnp.asarray(logits),
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               z_loss)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for key in jm:
        np.testing.assert_allclose(float(gm[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    # The chunked loss over a hidden state and a head gives the same.
    hidden = rng.normal(0, 1, (2, 12, 8)).astype(np.float32)
    head = rng.normal(0, 1, (40, 8)).astype(np.float32)
    got, gm = losses.chunked_lm_loss(
        lambda x: x @ torch.from_numpy(head).T, torch.from_numpy(hidden),
        {"targets": torch.from_numpy(targets)}, chunk=5, z_loss=z_loss)
    want, jm = jlosses.chunked_lm_loss(
        lambda x: x @ jnp.asarray(head).T, jnp.asarray(hidden),
        {"targets": jnp.asarray(targets)}, chunk=5, z_loss=z_loss)
    for key in jm:
        np.testing.assert_allclose(float(gm[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)


def test_schedules_match_jax():
    sched = schedule.linear_warmup_cosine(3e-3, 20, 100)
    jsched = jschedule.linear_warmup_cosine(3e-3, 20, 100)
    for step in (0, 1, 19, 20, 21, 60, 100, 150):
        np.testing.assert_allclose(
            float(sched(torch.tensor(step))),
            float(jsched(jnp.asarray(step))), rtol=1e-6)
    assert float(schedule.constant(0.5)(torch.tensor(3))) == 0.5
