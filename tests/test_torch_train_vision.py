"""Training llama-3.2-vision-11b's smoke config with PowerSGD: the port
against the JAX package, on the CPU.

Both sides start from the JAX package's train state (parameters with the
gates and norm scales perturbed as ``tests/test_torch_vision.py`` does:
at zero gates every cross parameter but the gates would get a zero
gradient; AdamW state; PowerSGD error buffers and Q factors drawn with
the crc32 hash of ``tests/test_torch_train_zamba.py``), carried across
by ``repro_torch.convert.state_from_jax``, and take the same batches
from their pipelines: tokens, targets and the f32 image embeddings
(``vision_seq`` x ``vision_dim`` a row), equal bit for bit. ``min_size``
1024 compresses exactly ``embed.table`` and ``lm_head.table``, the two
leaves the default picks at full width (``tests/test_torch_configs.
py``): the stacked cross norms (2, 64) stay under it, the gates are 1-D
and the other stacks 3-D or 4-D. Both run under a policy with lowered
classifier thresholds, so PowerSGD's P and Q reach the TSM2X kernels'
plain versions (``[256,64]·[64,4]`` on tsm2r, ``[256,64]^T·[256,4]`` on
tsmt, as ``[128256,4096]`` does at full width under the defaults). Two
microbatches, two steps, f32, remat on. Every metric and every leaf of
the state agrees at rtol = atol = 1e-4 (``tests/test_torch_train.py``'s
tolerance), except a parameter entry whose gradient is f32 rounding
noise in both packages, where AdamW's normalised step is bounded instead
(``test_torch_train_zamba.py``'s ``test_state_agrees``). The cross
layers' own ``attn.wk`` / ``attn.wv`` get zero gradients in both
(AdamW's weight decay alone moves them).

The launcher: ``--arch llama-3.2-vision-11b --smoke`` through both
launchers from one state with the gates drawn, on the pipeline's image
embeddings, to the same final loss.
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
from repro.launch import train as jlauncher
from repro.optim import adamw as jadamw
from repro.optim import powersgd as jpowersgd
from repro.optim import schedule as jschedule
from repro.train import train_step as jtrain
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.core import tsmm
from repro_torch.data import pipeline
from repro_torch.launch import train as launcher
from repro_torch.launch.train import to_tensors
from repro_torch.optim import adamw, powersgd, schedule
from repro_torch.train import train_step
from test_torch_train import _snap
from test_torch_train_zamba import _noise, _path_hash
from test_torch_vision import perturb

TOL = dict(rtol=1e-4, atol=1e-4)
THRESH = dict(min_tall=32, max_skinny=32, skinny_ratio=2)
STEPS, N_MICRO = 2, 2
ARCH = "llama-3.2-vision-11b"
MIN_SIZE = 1024
LEAVES = ["embed.table", "lm_head.table"]


def _configs():
    jcfg = jregistry.get_config(ARCH, smoke=True)
    cfg = registry.get_config(ARCH, smoke=True)
    jps = jpowersgd.PowerSGDConfig(rank=4, min_size=MIN_SIZE)
    ps = powersgd.PowerSGDConfig(rank=4, min_size=MIN_SIZE)
    jopt = jadamw.AdamWConfig(lr=jschedule.linear_warmup_cosine(1e-3, 2, 3))
    opt = adamw.AdamWConfig(lr=schedule.linear_warmup_cosine(1e-3, 2, 3))
    return jcfg, cfg, jps, ps, jopt, opt


def _data(cfg):
    return dict(seed=0, seq_len=32, global_batch=4,
                vocab_size=cfg.vocab_size, vision_seq=cfg.vision_seq,
                vision_dim=cfg.vision_dim)


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
        jb = jpipeline.batch_for_step(jpipeline.DataConfig(**_data(jcfg)), i)
        b = pipeline.batch_for_step(pipeline.DataConfig(**_data(cfg)), i)
        batches.append((jb, b))
        if i == 0:
            with tsmm.policy(pol):
                _, grads, _ = train_step._grads(
                    train_step.make_loss_fn(cfg), state["params"],
                    to_tensors(b, "cpu"))
            unread = {n: float(g.abs().max()) for n, g in grads.items()
                      if ".cross." in n}
            del grads
        with jtsmm.policy(jpol), jtsmm.record_dispatches() as jlog:
            jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in jb.items()})
        with tsmm.policy(pol), tsmm.record_dispatches() as log:
            state, m = step(state, to_tensors(b, "cpu"))
        out.append((jax.tree.map(np.asarray, jstate), jm, _snap(state), m,
                    jlog, log))
    return cfg, out, batches, unread


def test_batches_carry_the_references_images(runs):
    cfg, _, batches, _ = runs
    for jb, b in batches:
        assert sorted(b) == sorted(jb) == ["image_embeds", "targets",
                                           "tokens"]
        assert b["image_embeds"].dtype == np.float32
        assert b["image_embeds"].shape == (4, cfg.vision_seq,
                                           cfg.vision_dim)
        for k in b:
            np.testing.assert_array_equal(b[k], jb[k])
    assert not np.array_equal(batches[0][1]["image_embeds"],
                              batches[1][1]["image_embeds"])


def test_state_compresses_embed_and_lm_head(runs):
    _, out, _, _ = runs
    state = out[-1][2]
    assert sorted(state["extra"]) == LEAVES
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


def test_unread_cross_wk_wv_get_zero_gradients(runs):
    """The cross layers' own ``attn.wk`` / ``attn.wv``: a zero gradient
    and zero moments in both packages; every other cross leaf moves."""
    cfg, out, _, unread = runs
    n_groups = cfg.n_layers // cfg.cross_attn_period
    dead = {f"groups.{g}.cross.attn.{k}" for g in range(n_groups)
            for k in ("wk", "wv")}
    assert sorted(n for n, v in unread.items() if v == 0.0) == sorted(dead)
    for jstate, _, got, _, _, _ in out:
        want = _snap(convert.state_from_jax(cfg, jstate, device="cpu"))
        for snap in (got, want):
            for name in dead:
                assert not snap["moments"][name]["m"].any(), name


def test_dispatch_kinds_agree(runs):
    """The port's dispatches equal JAX's: P and Q of ``embed`` and
    ``lm_head`` on tsm2r and tsmt, and under the lowered thresholds the
    self layers' wk / wv of a 64-row microbatch on tsm2r too (at full
    width their n = 1024 is past ``MAX_SKINNY``), as the JAX package
    routes them."""
    _, out, _, _ = runs
    _, _, _, _, jlog, log = out[0]     # JAX traces on its first call
    assert ({(e.entry, e.kind, e.shape) for e in log}
            == {(e.entry, e.kind, e.shape) for e in jlog})
    assert {(e.kind, e.shape) for e in log if e.kind != "dense"} == {
        ("tsm2r", (256, 64, 4)), ("tsmt", (256, 64, 4)),
        ("tsm2r", (64, 64, 32))}


def _gated_init(init, gates):
    """``init`` (the JAX package's ``init_train_state``) with both gates of
    every cross layer set to ``gates``."""
    def wrapped(*args, **kw):
        state = init(*args, **kw)
        cross = state["params"]["segments"][0]["cross"]
        for key, value in gates.items():
            cross[key] = jnp.asarray(value)
        return state
    return wrapped


def test_launcher_matches_jax_on_image_embeddings(monkeypatch, capsys):
    """``--arch llama-3.2-vision-11b --smoke`` through both launchers from
    the same state, its gates drawn: both data configs take ``vision_seq``
    and ``vision_dim``, so both models read the same f32 image
    embeddings and end on the same loss; the same run with the images
    drawn from another seed ends elsewhere."""
    argv = ["--arch", ARCH, "--smoke", "--global-batch", "4",
            "--seq-len", "32", "--log-every", "100", "--steps", "3"]
    jcfg = jregistry.get_config(ARCH, smoke=True)
    rng = np.random.default_rng(3)
    gates = {k: rng.normal(0, 1, (2,)).astype(np.float32)
             for k in ("gate_attn", "gate_ffn")}
    jinit = _gated_init(jtrain.init_train_state, gates)
    monkeypatch.setattr(jtrain, "init_train_state", jinit)
    want = jlauncher.main(argv)

    def from_jax(seed, cfg, opt_cfg, extra=None, *, device=None):
        assert seed == 0 and extra is None
        jstate = jinit(jax.random.PRNGKey(0), jcfg, jadamw.AdamWConfig())
        return convert.state_from_jax(cfg, jax.tree.map(np.asarray, jstate),
                                      device=device)

    monkeypatch.setattr(train_step, "init_train_state", from_jax)
    got = launcher.main(argv + ["--device", "cpu"])
    real = pipeline.batch_for_step

    def other_images(cfg, step):
        batch = real(cfg, step)
        batch["image_embeds"] = real(dataclasses.replace(cfg, seed=7),
                                     step)["image_embeds"]
        return batch

    monkeypatch.setattr(pipeline, "batch_for_step", other_images)
    other = launcher.main(argv + ["--device", "cpu"])
    capsys.readouterr()
    assert got["final_step"] == want["final_step"] == 2
    assert got["fault_retries"] == want["fault_retries"] == 0
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=1e-4)
    assert abs(other["final_loss"] - got["final_loss"]) > 1e-4
