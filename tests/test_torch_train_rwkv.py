"""Training the rwkv6 smoke config with PowerSGD: the port against the JAX
package, on the CPU.

Both sides start from the JAX package's train state (parameters with every
constant leaf perturbed as ``tests/test_torch_serve_rwkv.py`` does, AdamW
state, PowerSGD error buffers and Q factors), carried across by
``repro_torch.convert.state_from_jax``, and take the same batches from
their ``batch_for_step``. Both run under a policy with lowered classifier
thresholds and ``split=2``, so the decay LoRA's down projection routes to
tsm2r (forward and remat recompute) and PowerSGD's projections of
``embed``/``lm_head`` to tsm2r and the split tsmt, as rwkv6-1.6b's do at
full width.
``min_size=1024`` compresses exactly those two leaves at the smoke width,
as the default ``min_size`` does at full width (``tests/
test_torch_configs.py``). Two microbatches, two steps, f32; every metric
and every leaf of the state agrees at rtol = atol = 1e-4
(``tests/test_torch_train.py``'s tolerance).

Then the launcher: ``launch.train.main --arch rwkv6-1.6b --smoke`` runs on
the CPU with PowerSGD and a chaos rollback, and matches the JAX launcher
from the same state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import tsmm as jtsmm
from repro.data import pipeline as jpipeline
from repro.launch import train as jlaunch
from repro.models import model as jmodel
from repro.optim import adamw as jadamw
from repro.optim import powersgd as jpowersgd
from repro.optim import schedule as jschedule
from repro.train import train_step as jtrain
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.core import tsmm
from repro_torch.data import pipeline
from repro_torch.launch import train as launch
from repro_torch.optim import adamw, powersgd, schedule
from repro_torch.train import train_step
from test_torch_serve_rwkv import perturb
from test_torch_train import _np, _snap

TOL = dict(rtol=1e-4, atol=1e-4)
THRESH = dict(min_tall=32, max_skinny=32, skinny_ratio=2)
STEPS, N_MICRO = 2, 2
DATA = dict(seed=0, seq_len=32, global_batch=4, vocab_size=256)
ARCH = "rwkv6-1.6b"


def _jax_state(jcfg, jps, jopt):
    jstate = jtrain.init_train_state(jax.random.PRNGKey(0), jcfg, jopt)
    params = perturb(jax.tree.map(np.asarray, jstate["params"]),
                     np.random.default_rng(0))
    params = jax.tree.map(jnp.asarray, params)
    extra = jpowersgd.init(jps, params, jax.random.PRNGKey(17))
    return {**jstate, "params": params, "extra": extra}


@pytest.fixture(scope="module")
def runs():
    jcfg = jregistry.get_config(ARCH, smoke=True)
    cfg = registry.get_config(ARCH, smoke=True)
    jps = jpowersgd.PowerSGDConfig(rank=4, min_size=1024)
    ps = powersgd.PowerSGDConfig(rank=4, min_size=1024)
    jopt = jadamw.AdamWConfig(lr=jschedule.linear_warmup_cosine(1e-3, 2, 3))
    opt = adamw.AdamWConfig(lr=schedule.linear_warmup_cosine(1e-3, 2, 3))
    jstate = _jax_state(jcfg, jps, jopt)
    state = convert.state_from_jax(cfg, jax.tree.map(np.asarray, jstate),
                                   device="cpu")
    jstep = jax.jit(jtrain.make_train_step(
        jcfg, jopt, n_micro=N_MICRO,
        grad_transform=lambda g, st: jpowersgd.compress_tree(jps, g, st)))
    step = train_step.make_train_step(
        cfg, opt, n_micro=N_MICRO,
        grad_transform=lambda g, st: powersgd.compress_tree(ps, g, st))
    jpol = jtsmm.GemmPolicy(**THRESH, split=2)
    pol = tsmm.GemmPolicy(**THRESH, split=2)
    out = []
    for i in range(STEPS):
        jb = jpipeline.batch_for_step(jpipeline.DataConfig(**DATA), i)
        b = pipeline.batch_for_step(pipeline.DataConfig(**DATA), i)
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
    want = _snap(convert.state_from_jax(cfg, jstate, device="cpu"))
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
    """The port's dispatches equal JAX's, and a step launches tsm2r at the
    LoRA's down shape twice a layer and microbatch (forward and remat
    recompute), plus PowerSGD's two P; tsmt only for the two Q. The up
    projection is dense, and a dense product's backward is autograd's in
    both packages, so its ``dh = dy·bᵀ`` never reaches the dispatcher;
    the down projection's own backward GEMMs classify dense."""
    cfg, out = runs
    _, _, _, _, jlog, log = out[0]     # JAX traces on its first call
    seen = {(e.entry, e.kind, e.shape) for e in log}
    assert seen == {(e.entry, e.kind, e.shape) for e in jlog}
    tokens = DATA["global_batch"] // N_MICRO * DATA["seq_len"]
    down = ("mm", "tsm2r", (tokens, cfg.d_model, cfg.rwkv.decay_lora_rank))
    p_proj = ("mm", "tsm2r", (cfg.vocab_size, cfg.d_model, 4))
    q_proj = ("mmt", "tsmt", (cfg.vocab_size, cfg.d_model, 4))
    for _, _, _, _, _, log in out:
        kinds = [(e.entry, e.kind, e.shape) for e in log if e.kind != "dense"]
        assert kinds.count(down) == 2 * cfg.n_layers * N_MICRO
        assert kinds.count(p_proj) == kinds.count(q_proj) == 2
        assert len(kinds) == 2 * cfg.n_layers * N_MICRO + 4


def test_dense_arm_matches_kernel_arm(runs):
    """From the same state and batch, a ``mode="dense"`` scope gives the
    kernel arm's first step."""
    cfg, out = runs
    jcfg = jregistry.get_config(ARCH, smoke=True)
    jps = jpowersgd.PowerSGDConfig(rank=4, min_size=1024)
    jopt = jadamw.AdamWConfig(lr=jschedule.linear_warmup_cosine(1e-3, 2, 3))
    np_state = jax.tree.map(np.asarray, _jax_state(jcfg, jps, jopt))
    ps = powersgd.PowerSGDConfig(rank=4, min_size=1024)
    step = train_step.make_train_step(
        cfg, adamw.AdamWConfig(lr=schedule.linear_warmup_cosine(1e-3, 2, 3)),
        n_micro=N_MICRO,
        grad_transform=lambda g, st: powersgd.compress_tree(ps, g, st))
    batch = {k: torch.from_numpy(v).long() for k, v in pipeline.batch_for_step(
        pipeline.DataConfig(**DATA), 0).items()}
    with tsmm.policy(mode="dense"), tsmm.record_dispatches() as log:
        dense_state, dm = step(convert.state_from_jax(cfg, np_state,
                                                      device="cpu"), batch)
    assert log and all(e.executor == "torch-dense" for e in log)
    _, _, got, m, _, _ = out[0]
    np.testing.assert_allclose(float(dm["loss"]), float(m["loss"]), **TOL)
    np.testing.assert_allclose(float(dm["grad_norm"]),
                               float(m["grad_norm"]), **TOL)
    for name, p in _snap(dense_state)["params"].items():
        np.testing.assert_allclose(p, got["params"][name], **TOL,
                                   err_msg=name)


_BASE = ["--arch", ARCH, "--smoke", "--global-batch", "4", "--seq-len", "32",
         "--log-every", "100"]


def test_launcher_runs_rwkv6_with_powersgd_and_a_rollback(capsys):
    """The chaos drill poisons ``embed.table[0, 0]``, which step 3's batch
    reads (``tests/test_torch_launch.py``'s step, on the same batches)."""
    argv = _BASE + ["--device", "cpu", "--steps", "6",
                    "--powersgd-rank", "4"]
    clean = launch.main(argv)
    chaos = launch.main(argv + ["--chaos-step", "3"])
    out = capsys.readouterr().out
    assert "[ft] step 3 fault: rolled back to snapshot at step 2" in out
    assert clean["final_step"] == chaos["final_step"] == 5
    assert (chaos["fault_events"], chaos["fault_retries"]) == (1, 1)
    assert np.isfinite(clean["final_loss"])
    assert chaos["final_loss"] == clean["final_loss"]


def test_launcher_matches_jax_from_the_same_state(monkeypatch):
    argv = _BASE + ["--steps", "3"]
    want = jlaunch.main(argv)
    jcfg = jregistry.get_config(ARCH, smoke=True)

    def from_jax(seed, cfg, opt_cfg, extra=None, *, device=None):
        assert seed == 0 and extra is None
        jstate = jtrain.init_train_state(jax.random.PRNGKey(0), jcfg,
                                         jadamw.AdamWConfig())
        return convert.state_from_jax(cfg, jax.tree.map(np.asarray, jstate),
                                      device=device)

    monkeypatch.setattr(train_step, "init_train_state", from_jax)
    got = launch.main(argv + ["--device", "cpu"])
    assert got["final_step"] == want["final_step"] == 2
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=1e-4)


def test_params_from_jax_round_trip_keeps_every_leaf():
    """JAX tree -> port -> the same numbers and dtypes, leaf by leaf, at
    the smoke size in bfloat16 (the full-size dtypes are
    ``tests/test_torch_configs.py``'s)."""
    import dataclasses

    jcfg = dataclasses.replace(jregistry.get_config(ARCH, smoke=True),
                               dtype="bfloat16")
    cfg = dataclasses.replace(registry.get_config(ARCH, smoke=True),
                              dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(3), jcfg))
    params = convert.params_from_jax(cfg, tree, device="cpu")
    named = dict(params.named_parameters())
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == len(
        {convert.layout.jax_path(n)[0] for n in named})
    for path, leaf in flat:
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        names = [n for n in named if convert.layout.jax_path(n)[0] == key]
        got = torch.stack([named[n] for n in names]) if len(names) > 1 or \
            convert.layout.stacked(names) else named[names[0]]
        assert str(got.dtype)[6:] == str(leaf.dtype), key
        np.testing.assert_array_equal(_np(got), leaf.astype(np.float32),
                                      err_msg=key)
