"""Training hubert-xlarge's smoke config with PowerSGD: the port against
the JAX package, on the CPU.

Both sides start from the JAX package's train state (parameters with
every constant leaf perturbed as ``tests/test_torch_hubert.py`` does,
AdamW state, PowerSGD error buffers and Q factors drawn with the crc32
hash of ``tests/test_torch_train_zamba.py``), carried across by
``repro_torch.convert.state_from_jax``, and take the same frame batches
from their pipelines (``mode="frames"``: the port's frames equal JAX's
bit for bit). The smoke config runs 4 layers here, so that the stacked
``(L, d_ff)`` ``ffn.b_up`` has as many rows as PowerSGD's rank 4
(with 2 its P would hold columns that degenerate, which the packages
redraw from different generators). ``min_size=512`` then compresses the
four leaves the default picks at full width (``tests/test_torch_configs.
py``): ``frame_proj.w``, ``embed.table``, ``lm_head.table`` and the
stacked ``b_up``. Both run under a policy with lowered classifier
thresholds, so PowerSGD's P and Q reach the TSM2X kernels' plain
versions. Two microbatches, two steps, f32, remat on. Every metric and
every leaf of the state agrees at rtol = atol = 1e-4
(``tests/test_torch_train.py``'s tolerance), except a parameter entry
whose gradient is f32 rounding noise in both packages, where AdamW's
normalised step is bounded instead (``test_torch_train_zamba.py``'s
``test_state_agrees``). ``embed.table`` is never read with frames: its
gradient is zero in both packages (AdamW still decays it).
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import registry as jregistry
from repro.core import tsmm as jtsmm
from repro.data import pipeline as jpipeline
from repro.optim import adamw as jadamw
from repro.optim import powersgd as jpowersgd
from repro.optim import schedule as jschedule
from repro.train import train_step as jtrain
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.core import tsmm
from repro_torch.data import pipeline
from repro_torch.launch.train import to_tensors
from repro_torch.optim import adamw, powersgd, schedule
from repro_torch.train import train_step
from test_torch_hubert import perturb
from test_torch_train import _snap
from test_torch_train_zamba import _noise, _path_hash

TOL = dict(rtol=1e-4, atol=1e-4)
THRESH = dict(min_tall=32, max_skinny=32, skinny_ratio=2)
STEPS, N_MICRO, LAYERS = 2, 2, 4
ARCH = "hubert-xlarge"
DATA = dict(seed=0, seq_len=32, global_batch=4, vocab_size=64,
            mode="frames", frame_dim=32)
MIN_SIZE = 512
LEAVES = ["embed.table", "frame_proj.w", "lm_head.table",
          "segments.0.ffn.b_up"]


def _configs():
    jcfg = dataclasses.replace(jregistry.get_config(ARCH, smoke=True),
                               n_layers=LAYERS)
    cfg = dataclasses.replace(registry.get_config(ARCH, smoke=True),
                              n_layers=LAYERS)
    jps = jpowersgd.PowerSGDConfig(rank=4, min_size=MIN_SIZE)
    ps = powersgd.PowerSGDConfig(rank=4, min_size=MIN_SIZE)
    jopt = jadamw.AdamWConfig(lr=jschedule.linear_warmup_cosine(1e-3, 2, 3))
    opt = adamw.AdamWConfig(lr=schedule.linear_warmup_cosine(1e-3, 2, 3))
    return jcfg, cfg, jps, ps, jopt, opt


def _jax_state(jcfg, jps, jopt):
    jstate = jtrain.init_train_state(jax.random.PRNGKey(0), jcfg, jopt)
    params = perturb(jax.tree.map(np.asarray, jstate["params"]),
                     np.random.default_rng(0))
    params = jax.tree.map(jnp.asarray, params)
    with mock.patch.object(jpowersgd, "hash", _path_hash, create=True):
        extra = jpowersgd.init(jps, params, jax.random.PRNGKey(17))
    return {**jstate, "params": params, "extra": extra}


@pytest.fixture(scope="module")
def runs():
    jcfg, cfg, jps, ps, jopt, opt = _configs()
    jstate = _jax_state(jcfg, jps, jopt)
    state = convert.state_from_jax(cfg, jax.tree.map(np.asarray, jstate),
                                   device="cpu")
    jstep = jax.jit(jtrain.make_train_step(
        jcfg, jopt, n_micro=N_MICRO,
        grad_transform=lambda g, st: jpowersgd.compress_tree(jps, g, st)))
    step = train_step.make_train_step(
        cfg, opt, n_micro=N_MICRO,
        grad_transform=lambda g, st: powersgd.compress_tree(ps, g, st))
    jpol, pol = jtsmm.GemmPolicy(**THRESH), tsmm.GemmPolicy(**THRESH)
    out, batches = [], []
    for i in range(STEPS):
        jb = jpipeline.batch_for_step(jpipeline.DataConfig(**DATA), i)
        b = pipeline.batch_for_step(pipeline.DataConfig(**DATA), i)
        batches.append((jb, b))
        if i == 0:
            with tsmm.policy(pol):
                _, grads, _ = train_step._grads(
                    train_step.make_loss_fn(cfg), state["params"],
                    to_tensors(b, "cpu"))
            embed_grad = float(grads["embed.table"].abs().max())
        with jtsmm.policy(jpol), jtsmm.record_dispatches() as jlog:
            jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in jb.items()})
        with tsmm.policy(pol), tsmm.record_dispatches() as log:
            state, m = step(state, to_tensors(b, "cpu"))
        out.append((jax.tree.map(np.asarray, jstate), jm, _snap(state), m,
                    jlog, log))
    return cfg, out, batches, embed_grad


def test_frames_are_the_references_bit_for_bit(runs):
    _, _, batches, _ = runs
    for jb, b in batches:
        assert sorted(b) == sorted(jb) == ["frames", "targets"]
        assert b["frames"].dtype == np.float32
        assert b["frames"].shape == (4, 32, 32)
        for k in b:
            np.testing.assert_array_equal(b[k], jb[k])


def test_state_compresses_the_four_leaves(runs):
    _, out, _, _ = runs
    state = out[-1][2]
    assert sorted(state["extra"]) == LEAVES
    assert state["extra"]["segments.0.ffn.b_up"]["err"].shape == (LAYERS,
                                                                  128)
    assert state["step"] == STEPS


@pytest.mark.parametrize("i", range(STEPS))
def test_metrics_agree(runs, i):
    _, out, _, _ = runs
    _, jm, _, m, _, _ = out[i]
    for key in ("loss", "grad_norm", "powersgd_compression", "accuracy",
                "lr", "z"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), **TOL,
                                   err_msg=key)
    assert bool(m["step_ok"]) and bool(jm["step_ok"])


@pytest.mark.parametrize("i", range(STEPS))
def test_state_agrees(runs, i):
    """Moments and PowerSGD state at rtol = atol = 1e-4; parameters too,
    except entries whose gradient was f32 rounding noise in both packages
    (see ``test_torch_train_zamba.test_state_agrees``)."""
    cfg, out, _, _ = runs
    jstate, _, got, _, _, _ = out[i]
    want = _snap(convert.state_from_jax(cfg, jstate, device="cpu"))
    assert got["step"] == want["step"] == i + 1
    lr_sum = sum(float(o[1]["lr"]) for o in out[:i + 1])
    noise = _noise(cfg, out, i)
    for name, p in got["params"].items():
        for f in ("m", "v"):
            np.testing.assert_allclose(got["moments"][name][f],
                                       want["moments"][name][f], **TOL,
                                       err_msg=f"{name}.{f}")
        w = want["params"][name]
        close = np.abs(p - w) <= TOL["atol"] + TOL["rtol"] * np.abs(w)
        assert (close | noise[name]).all(), name
        assert np.abs(p - w)[noise[name]].max(initial=0) <= 2 * lr_sum, name
        assert (~close).sum() <= max(1, p.size // 1000), name
    assert sorted(got["extra"]) == sorted(want["extra"])
    for path, st in got["extra"].items():
        for f in ("err", "q"):
            np.testing.assert_allclose(st[f], want["extra"][path][f], **TOL,
                                       err_msg=f"{path}.{f}")


def test_embed_table_gets_a_zero_gradient_and_is_decayed(runs):
    """Nothing reads ``embed.table`` with frames: its gradient and its
    moments are zero in both packages, and only AdamW's decoupled weight
    decay moves it, ``p <- p (1 - lr wd)`` a step."""
    cfg, out, _, embed_grad = runs
    assert embed_grad == 0.0
    for jstate, _, got, _, _, _ in out:
        want = _snap(convert.state_from_jax(cfg, jstate, device="cpu"))
        for snap in (got, want):
            for f in ("m", "v"):
                assert not snap["moments"]["embed.table"][f].any()
    jcfg, _, jps, _, jopt, opt = _configs()
    first = _jax_state(jcfg, jps, jopt)["params"]["embed"]["table"]
    decay = np.float32(1.0)
    for o in out:
        decay *= 1 - np.float32(o[3]["lr"]) * np.float32(opt.weight_decay)
    np.testing.assert_allclose(out[-1][2]["params"]["embed.table"],
                               np.asarray(first) * decay, rtol=1e-6,
                               atol=0)


def test_dispatch_kinds_agree(runs):
    """The port's dispatches equal JAX's: the projections route dense at
    the smoke width under the lowered thresholds; P and Q of the
    compressed leaves route as the JAX package routes them."""
    _, out, _, _ = runs
    _, _, _, _, jlog, log = out[0]     # JAX traces on its first call
    assert ({(e.entry, e.kind, e.shape) for e in log}
            == {(e.entry, e.kind, e.shape) for e in jlog})
    assert any(e.kind != "dense" for e in log)
