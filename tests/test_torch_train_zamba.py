"""Training the zamba2 smoke config with PowerSGD: the port against the JAX
package, on the CPU.

Both sides start from the JAX package's train state (parameters with every
constant leaf perturbed as ``tests/test_torch_serve_zamba.py`` does, AdamW
state, PowerSGD error buffers and Q factors), carried across by
``repro_torch.convert.state_from_jax``, and take the same batches from
their ``batch_for_step``. Both run under a policy with lowered classifier
thresholds and ``split=2``, so the shared LoRAs' down projection routes to
tsm2r and PowerSGD's projections to the TSM2X kernels' plain versions.
``min_size=4096`` compresses nine leaves at the smoke width: ``embed``,
``lm_head`` and the seven matrices of the shared block, the leaves the
default ``min_size`` picks at full width (``tests/test_torch_configs.py``);
every stacked leaf of the smoke model is 3-D or under it. Two
microbatches, two steps, f32, remat on (each Mamba2 layer checkpointed,
the shared block not); every metric and every leaf of the state agrees at
rtol = atol = 1e-4 (``tests/test_torch_train.py``'s tolerance), except a
parameter entry whose gradient is f32 rounding noise in both packages,
where AdamW's normalised step is bounded instead (``test_state_agrees``).

Then the launcher: ``launch.train.main --arch zamba2-1.2b --smoke`` runs
on the CPU with PowerSGD and a chaos rollback, and matches the JAX
launcher from the same state; a bf16 ``params_from_jax`` round trip over
the leaves stacked twice; and ``layout``'s index tuples.
"""

import dataclasses
import zlib
from unittest import mock

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
from repro_torch import convert, layout
from repro_torch.configs import registry
from repro_torch.core import tsmm
from repro_torch.data import pipeline
from repro_torch.kernels import quant
from repro_torch.launch import train as launch
from repro_torch.models import model
from repro_torch.optim import adamw, powersgd, schedule
from repro_torch.train import train_step
from test_torch_serve_zamba import perturb
from test_torch_train import _np, _snap

TOL = dict(rtol=1e-4, atol=1e-4)
THRESH = dict(min_tall=32, max_skinny=32, skinny_ratio=2)
STEPS, N_MICRO = 2, 2
DATA = dict(seed=0, seq_len=32, global_batch=4, vocab_size=256)
ARCH = "zamba2-1.2b"
MIN_SIZE = 4096
NOISE = 1e-6
SHARED = ["shared_block.attn.wk", "shared_block.attn.wo",
          "shared_block.attn.wq", "shared_block.attn.wv",
          "shared_block.ffn.w_down", "shared_block.ffn.w_gate",
          "shared_block.ffn.w_up"]


def _path_hash(s: str) -> int:
    """A hash of a leaf's path that every process agrees on."""
    return zlib.crc32(s.encode())


def _jax_state(jcfg, jps, jopt):
    """The reference's train state. Its ``powersgd.init`` draws each Q
    from ``hash(str(path))``, which Python salts per process, so each
    process would start (and follow) another trajectory; the draw runs
    here with a hash every process agrees on."""
    jstate = jtrain.init_train_state(jax.random.PRNGKey(0), jcfg, jopt)
    params = perturb(jax.tree.map(np.asarray, jstate["params"]),
                     np.random.default_rng(0))
    params = jax.tree.map(jnp.asarray, params)
    with mock.patch.object(jpowersgd, "hash", _path_hash, create=True):
        extra = jpowersgd.init(jps, params, jax.random.PRNGKey(17))
    return {**jstate, "params": params, "extra": extra}


def _configs():
    jps = jpowersgd.PowerSGDConfig(rank=4, min_size=MIN_SIZE)
    ps = powersgd.PowerSGDConfig(rank=4, min_size=MIN_SIZE)
    jopt = jadamw.AdamWConfig(lr=jschedule.linear_warmup_cosine(1e-3, 2, 3))
    opt = adamw.AdamWConfig(lr=schedule.linear_warmup_cosine(1e-3, 2, 3))
    return jps, ps, jopt, opt


@pytest.fixture(scope="module")
def runs():
    jcfg = jregistry.get_config(ARCH, smoke=True)
    cfg = registry.get_config(ARCH, smoke=True)
    jps, ps, jopt, opt = _configs()
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


def test_state_compresses_the_shared_block(runs):
    _, out = runs
    state = out[-1][2]
    assert sorted(state["extra"]) == sorted(
        ["embed.table", "lm_head.table", *SHARED])
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


def _noise(cfg, out, i):
    """Per parameter, the entries whose (clipped) gradient was f32
    rounding noise in both packages at some step up to ``i``: under
    ``NOISE`` of the leaf's largest. Each step's gradient is read back
    from the first moments, ``g = (m_j - b1 m_{j-1}) / (1 - b1)``."""
    b1 = adamw.AdamWConfig().b1
    prev = prev_want = None
    masks = {}
    for j in range(i + 1):
        got = out[j][2]["moments"]
        want = _snap(convert.state_from_jax(cfg, out[j][0],
                                            device="cpu"))["moments"]
        for name in got:
            g = got[name]["m"] - (b1 * prev[name]["m"] if prev else 0)
            w = want[name]["m"] - (b1 * prev_want[name]["m"]
                                   if prev_want else 0)
            scale = NOISE * max(np.abs(w).max(), 1e-30)
            hit = (np.abs(g) <= scale) & (np.abs(w) <= scale)
            masks[name] = masks.get(name, False) | hit
        prev, prev_want = got, want
    return masks


@pytest.mark.parametrize("i", range(STEPS))
def test_state_agrees(runs, i):
    """Moments and PowerSGD state at rtol = atol = 1e-4; parameters too,
    except an entry whose gradient was under ``NOISE`` of its leaf's
    largest in both packages at some step so far: there the gradient is
    f32 rounding noise of the sums (1e-8 beside 1e-2), AdamW's
    ``m / sqrt(v)`` turns it into a step of up to ``lr`` either way, and
    the parameter may differ by at most twice the learning rates so far.
    At most 0.1% of a leaf's entries may be such."""
    cfg, out = runs
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


def test_dispatch_kinds_agree(runs):
    """The port's dispatches equal JAX's. A step launches tsm2r at the
    LoRAs' down shape twice a group and microbatch (attention and FFN;
    the shared block is not checkpointed, so no recompute), and P and Q
    once a compressed leaf; the LoRAs' up projection is dense, and a dense
    product's backward is autograd's in both packages."""
    cfg, out = runs
    _, _, _, _, jlog, log = out[0]     # JAX traces on its first call
    seen = {(e.entry, e.kind, e.shape) for e in log}
    assert seen == {(e.entry, e.kind, e.shape) for e in jlog}
    tokens = DATA["global_batch"] // N_MICRO * DATA["seq_len"]
    n_groups = cfg.n_layers // cfg.hybrid_period
    down = ("mm", "tsm2r", (tokens, cfg.d_model, cfg.shared_lora_rank))
    for _, _, _, _, _, log in out:
        kinds = [(e.entry, e.kind, e.shape) for e in log if e.kind != "dense"]
        assert kinds.count(down) == 2 * n_groups * N_MICRO
        # P of all nine leaves; Q only for embed and lm_head: the shared
        # block's Q (m = 64 or 128) classifies dense at the smoke width
        p_ev = [k for k in kinds if k[0] == "mm" and k[2][2] == 4]
        q_ev = [k for k in kinds if k[0] == "mmt" and k[2][2] == 4]
        assert len(p_ev) == 2 + len(SHARED) and len(q_ev) == 2
        assert len(kinds) == 2 * n_groups * N_MICRO + len(p_ev) + 2


def test_dense_arm_matches_kernel_arm(runs):
    """From the same state and batch, a ``mode="dense"`` scope gives the
    kernel arm's first step."""
    cfg, out = runs
    jcfg = jregistry.get_config(ARCH, smoke=True)
    jps, ps, jopt, opt = _configs()
    np_state = jax.tree.map(np.asarray, _jax_state(jcfg, jps, jopt))
    step = train_step.make_train_step(
        cfg, opt, n_micro=N_MICRO,
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


def test_launcher_runs_zamba2_with_powersgd_and_a_rollback(capsys):
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


def _bf16_trees():
    jcfg = dataclasses.replace(jregistry.get_config(ARCH, smoke=True),
                               dtype="bfloat16")
    cfg = dataclasses.replace(registry.get_config(ARCH, smoke=True),
                              dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(3), jcfg))
    return cfg, perturb(tree, np.random.default_rng(3))


def _flat(tree):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_params_from_jax_round_trip_keeps_every_leaf():
    """JAX tree -> port -> the same numbers and dtypes, leaf by leaf, at
    the smoke size in bfloat16: stacking each group's tensors in index
    order and reshaping to ``jax_shape`` gives the JAX leaf, for the
    leaves stacked twice too."""
    cfg, tree = _bf16_trees()
    params = convert.params_from_jax(cfg, tree, device="cpu")
    named = dict(params.named_parameters())
    groups = layout.jax_leaves(named)
    flat = _flat(tree)
    assert sorted(groups) == sorted(flat)
    for key, leaf in flat.items():
        names = groups[key]
        shape = layout.jax_shape(named, names)
        got = torch.stack([named[n] for n in names]).reshape(shape)
        assert str(got.dtype)[6:] == str(leaf.dtype), key
        np.testing.assert_array_equal(_np(got), leaf.astype(np.float32),
                                      err_msg=key)


def test_quantize_weights_round_trips_the_stacked_leaves():
    """``quantize_weights`` at a ``min_size`` low enough to take the tail's
    stacked ``(1, d)`` vectors: each record is the JAX leaf's shape, and
    dequantizing gives every parameter back at its own shape."""
    cfg, tree = _bf16_trees()
    params = convert.params_from_jax(cfg, tree, device="cpu")
    shapes = {n: tuple(p.shape) for n, p in params.named_parameters()}
    q = quant.quantize_weights(params, min_size=4)
    flat = _flat(tree)
    assert "segments.1.mixer.conv_b" in q.records
    for path, rec in q.records.items():
        assert tuple(rec["q8"].shape) == flat[path].shape, path
        assert flat[path].ndim == 2, path
    with quant.dequantized(q) as m:
        for n, p in m.named_parameters():
            assert tuple(p.shape) == shapes[n], n


def test_layout_index_tuples():
    assert layout.jax_path("groups.2.mamba.3.mixer.in_proj") == (
        "segments.0.mamba.mixer.in_proj", (2, 3))
    assert layout.jax_path("groups.2.lora_attn.a") == (
        "segments.0.lora_attn.a", (2,))
    assert layout.jax_path("tail.1.mixer.D") == ("segments.1.mixer.D", (1,))
    assert layout.jax_path("shared_block.ffn.w_up") == (
        "shared_block.ffn.w_up", ())
    # the dense and RWKV6 names map as before, one stacked axis
    assert layout.jax_path("layers.3.attn.bq") == ("segments.0.attn.bq",
                                                   (3,))
    assert layout.jax_path("embed.table") == ("embed.table", ())
    lm = model.LM(registry.get_config(ARCH, smoke=True), device="meta")
    named = dict(lm.named_parameters())
    groups = layout.jax_leaves(named)
    names = groups["segments.0.mamba.mixer.D"]
    assert names == [f"groups.{g}.mamba.{i}.mixer.D"
                     for g in range(2) for i in range(2)]
    assert layout.stack_shape(names) == (2, 2)
    assert layout.jax_shape(named, names) == (2, 2, 4)
    assert layout.jax_shape(named, groups["segments.1.norm1.scale"]) == (
        1, 64)
    assert not layout.stacked(groups["shared_block.norm1.scale"])
    with pytest.raises(ValueError, match="do not fill"):
        layout.stack_shape(names[:3])
