"""rwkv6's and zamba2's smoke models on DTensor parameters: the port's
serve and train step on a two-rank mesh against the JAX package's
two-device run. The tests live in ``tests/test_torch_mesh_rwkv.py`` and
``tests/test_torch_mesh_zamba.py``, which name the arch (``ARCH``) and
import them from here; each file runs one world.

As ``tests/test_torch_mesh.py`` does for chatglm3, with its sizes,
thresholds, tolerance and batches: one two-rank gloo world
(``tests/torch_dist_harness.py``) runs the port on ``("data", "model")``
meshes of shape (1, 2) and (2, 1); a subprocess with two host devices runs
the JAX package on the same meshes. Both start from the JAX package's
train state (the leaves that start constant perturbed as
``tests/test_torch_serve_rwkv.py`` / ``test_torch_serve_zamba.py`` do;
PowerSGD's Q drawn with the crc32 hash of ``tests/test_torch_train_zamba.
py``, which every process agrees on), the port's through ``convert``,
each placed by its own package's ``make_param_specs``, both under a
policy with lowered classifier thresholds, so the LoRAs' down projections
classify as tsm2r (the shard_map executor on the (1, 2) mesh). f32. The
tests read the two records:

* serving (``generate(sharded_projections=True)``, caches from
  ``cache_specs``): the greedy tokens equal; the prefill logits and every
  decode step's at rtol = atol = 1e-4, as the plain serve tests hold them;
* training (``make_train_step(acc_shardings=, mesh=)``, PowerSGD rank 4
  on ``embed`` / ``lm_head`` (and zamba2's shared block), 2 microbatches,
  2 steps, AdamW's eps 1e-6 as ``tests/test_torch_mesh.py``): each step's
  loss and every parameter after the second at rtol = atol = 1e-4, except
  an entry whose gradient was f32 rounding noise in both packages, where
  AdamW's normalised step is bounded instead (``test_torch_train_zamba.
  py``'s exception);
* the placements: ``wr`` (rwkv6) or ``in_proj`` and ``conv_w`` (zamba2)
  where ``make_param_specs`` puts them before and after the steps, and
  the ``wkv`` / ``ssm`` / ``conv`` caches where ``cache_specs`` puts them
  after a prefill and a decode step;
* the prefill's dispatch events: the same executors as the JAX run's;
* on the port alone: sampling at temperature 1 draws the same tokens on
  both ranks, equal to the one-process port's from the same seed;
  ``abft.encode_tree`` of the DTensor leaves equals that of the full
  leaves (f32, within 1e-5 of each leaf's largest checksum; ``MIN_LEAF``
  lowered so the smoke leaves get checksums), and ``verify_tree``
  passes clean parameters and fails after ``ft.inject.poison_tree``.

The ranks import this module, so it imports no JAX.
"""

import functools
import pickle
import types
from unittest import mock

import numpy as np
import pytest
import torch

import torch_dist_harness as harness
from test_torch_mesh import (B, DATA, N_MICRO, NEW, SHAPES, STEPS, THRESH,
                             TOL, S, _batches, _full, _places, _tags)

# PowerSGD's leaves at the smoke width: embed and lm_head (rwkv6), and
# the shared block's seven matrices too (zamba2), as at full width.
MIN_SIZE = {"rwkv6-1.6b": 1024, "zamba2-1.2b": 4096}
# The parameters whose placements the tests read, and the cache entries.
WATCHED = {"rwkv6-1.6b": ("layers.0.time_mix.wr",),
           "zamba2-1.2b": ("groups.0.mamba.0.mixer.in_proj",
                           "groups.0.mamba.0.mixer.conv_w")}
STATES = ("wkv", "ssm", "conv")
ABFT_MIN_LEAF = 1024
NOISE = 1e-6


# ---------------------------------------------------------------------------
# The port's side: run on each rank of the world
# ---------------------------------------------------------------------------

def _cache_places(cfg, mesh, cache):
    """(placements, the spec's placements) of every SSM state of
    ``cache``, by ``layer.name``."""
    from repro_torch.distributed import sharding
    specs = sharding.cache_specs(cfg, mesh, cache)
    return {f"{i}.{k}": (_places(t), [repr(p) for p in sharding.placements(
        mesh, specs[i][k])]) for i, entry in enumerate(cache)
        for k, t in entry.items() if k in STATES}


def _serve(arch, cfg, jstate, prompts, mesh, pol):
    from repro_torch.convert import params_from_jax
    from repro_torch.core import tsmm
    from repro_torch.distributed import sharding
    from repro_torch.ft import abft, inject
    from repro_torch.models import model
    from repro_torch.serve import engine

    out, meta = {}, {}
    params = params_from_jax(cfg, jstate["params"], device="cpu")
    plain = params_from_jax(cfg, jstate["params"], device="cpu")
    specs = sharding.make_param_specs(cfg, params, mesh)
    sharding.named(mesh, specs, params)

    toks = torch.from_numpy(prompts).long()
    out["tokens"] = engine.generate(params, cfg, toks, NEW, policy=pol,
                                    device="cpu", sharded_projections=True)
    prefill, decode = engine.make_serve_fns(cfg, policy=pol,
                                            sharded_projections=True)
    cache = model.init_cache(cfg, B, S + NEW, device="cpu", mesh=mesh)
    batch = sharding.named(mesh, sharding.batch_specs(
        cfg, mesh, {"tokens": toks}), {"tokens": toks})
    with tsmm.record_dispatches() as log:
        logits, cache = prefill(params, batch, cache)
    meta["prefill_events"] = sorted(set(harness.port_events(log)))
    meta["cache_prefill"] = _cache_places(cfg, mesh, cache)
    steps = [_full(logits)]
    for i in range(1, NEW):
        logits, cache = decode(params, out["tokens"][:, i - 1:i], S + i - 1,
                               cache)
        steps.append(_full(logits))
        if i == 1:
            meta["cache_decode"] = _cache_places(cfg, mesh, cache)
    out["step_logits"] = torch.stack(steps)
    named = dict(params.named_parameters())
    meta["watched"] = {n: (_places(named[n]), [repr(p) for p in
                                               sharding.placements(
                                                   mesh, specs[n])])
                       for n in WATCHED[arch]}

    # -- the port alone: sampling, the ABFT tree check ----------------------
    out["sampled"] = engine.generate(
        params, cfg, toks, NEW, policy=pol, device="cpu",
        sharded_projections=True, temperature=1.0,
        generator=torch.Generator().manual_seed(7))
    out["sampled_plain"] = engine.generate(
        plain, cfg, toks, NEW, policy=pol, device="cpu", temperature=1.0,
        generator=torch.Generator().manual_seed(7))
    with mock.patch.object(abft, "MIN_LEAF", ABFT_MIN_LEAF):
        sums = abft.encode_tree(params)
        want = abft.encode_tree(plain)
        meta["checksum_kinds"] = sorted({type(c).__name__
                                         for c in sums.values()
                                         if c is not None})
        out["checksums"] = {n: _full(c) for n, c in sums.items()
                            if c is not None}
        out["checksums_plain"] = {n: c for n, c in want.items()
                                  if c is not None}
        clean, _ = abft.verify_tree(params, sums)
        inject.poison_tree(params)
        poisoned, _ = abft.verify_tree(params, sums)
    meta["verify"] = (bool(clean), bool(poisoned))
    return out, meta


def _train(arch, cfg, jstate, mesh, pol):
    from repro_torch import convert
    from repro_torch.core import tsmm
    from repro_torch.distributed import sharding
    from repro_torch.launch import train as launcher
    from repro_torch.optim import adamw, powersgd, schedule
    from repro_torch.train import train_step

    out, meta = {}, {}
    opt = adamw.AdamWConfig(lr=schedule.linear_warmup_cosine(1e-3, 2, 3),
                            eps=1e-6)
    ps = powersgd.PowerSGDConfig(rank=4, min_size=MIN_SIZE[arch])
    state = convert.state_from_jax(cfg, jstate, device="cpu")
    specs = sharding.make_param_specs(cfg, state["params"], mesh)
    sharding.named(mesh, {"params": specs,
                          "opt": sharding.make_opt_specs(specs)}, state)
    sharding.named(mesh, launcher._powersgd_specs(state["extra"], specs),
                   state["extra"])
    meta["compressed"] = sorted(state["extra"])
    step = train_step.make_train_step(
        cfg, opt, n_micro=N_MICRO,
        grad_transform=lambda g, st: powersgd.compress_tree(ps, g, st),
        acc_shardings=sharding.named(mesh, specs), mesh=mesh)
    losses, moments, lrs = [], [], []
    for b in _batches():
        tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
        tb = sharding.named(mesh, sharding.batch_specs(cfg, mesh, tb), tb)
        with tsmm.policy(pol):
            state, metrics = step(state, tb)
        losses.append(metrics["loss"])
        lrs.append(float(metrics["lr"]))
        moments.append({n: _full(mv["m"]).clone()
                        for n, mv in state["opt"]["moments"].items()})
    named = dict(state["params"].named_parameters())
    out["losses"] = torch.stack(losses)
    out["moments"] = moments
    out["lr"] = lrs
    out["params"] = {n: _full(p).detach().clone() for n, p in named.items()}
    meta["watched"] = {n: (_places(named[n]), [repr(p) for p in
                                               sharding.placements(
                                                   mesh, specs[n])])
                       for n in WATCHED[arch]}
    meta["all_placed"] = all(
        list(p.placements) == sharding.placements(mesh, specs[n])
        for n, p in named.items())
    return out, meta


def port_rank(arch, rank, work):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import registry
    from repro_torch.core import tsmm

    cfg = registry.get_config(arch, smoke=True)
    with open(work / "state.pkl", "rb") as f:
        jstate = pickle.load(f)
    prompts = np.load(work / "inputs.npz")["prompts"]
    pol = tsmm.GemmPolicy(**THRESH)
    res = {}
    for shape in SHAPES:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data",
                                                              "model"))
        tag = "x".join(map(str, shape))
        serve, serve_meta = _serve(arch, cfg, jstate, prompts, mesh, pol)
        train, train_meta = _train(arch, cfg, jstate, mesh, pol)
        res[tag] = ({**serve, **train},
                    {"serve": serve_meta, "train": train_meta})
    return res


# ---------------------------------------------------------------------------
# The JAX package's side, on two host devices
# ---------------------------------------------------------------------------

JAX_SCRIPT = harness.JAX_PRELUDE + r"""
import pickle

from repro.configs import registry
from repro.data import pipeline
from repro.distributed import sharding
from repro.models import model
from repro.optim import adamw, powersgd, schedule
from repro.serve import engine
from repro.train import train_step as ts

ARCH, B, S, NEW, STEPS, N_MICRO, MIN_SIZE = %r, %d, %d, %d, %d, %d, %d
THRESH = %r
DATA = %r
cfg = registry.get_config(ARCH, smoke=True)
with open(WORK + "/state.pkl", "rb") as f:
    jstate = pickle.load(f)
pol = tsmm.GemmPolicy(**THRESH)
prompts = INP["prompts"]


def key_of(path):
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


for shape in ((1, 2), (2, 1)):
    tag = "x".join(map(str, shape))
    m = Mesh(np.array(devs).reshape(shape), ("data", "model"))
    p_named = sharding.named(m, sharding.make_param_specs(
        cfg, jstate["params"], m))
    params = jax.device_put(jax.tree.map(jnp.asarray, jstate["params"]),
                            p_named)
    with m:
        toks = engine.generate(params, cfg, prompts, NEW, policy=pol,
                               sharded_projections=True)
        OUT[tag + "/tokens"] = toks
        prefill, decode = engine.make_serve_fns(cfg, policy=pol,
                                                sharded_projections=True)
        with tsmm.record_dispatches() as log:
            logits, cache = jax.jit(prefill)(
                params, {"tokens": prompts},
                model.init_cache(cfg, B, S + NEW))
        REC[tag] = events(log)
        steps = [logits]
        jdecode = jax.jit(decode, static_argnums=(2,))
        for i in range(1, NEW):
            logits, cache = jdecode(params, toks[:, i - 1:i], S + i - 1,
                                    cache)
            steps.append(logits)
        OUT[tag + "/step_logits"] = jnp.stack(steps)
    opt = adamw.AdamWConfig(lr=schedule.linear_warmup_cosine(1e-3, 2, 3),
                            eps=1e-6)
    ps = powersgd.PowerSGDConfig(rank=4, min_size=MIN_SIZE)
    state = {"params": params,
             "opt": jax.tree.map(jnp.asarray, jstate["opt"]),
             "extra": jax.tree.map(jnp.asarray, jstate["extra"])}
    step = jax.jit(ts.make_train_step(
        cfg, opt, n_micro=N_MICRO,
        grad_transform=lambda g, st: powersgd.compress_tree(ps, g, st),
        acc_shardings=p_named, mesh=m))
    losses = []
    for i in range(STEPS):
        b = pipeline.batch_for_step(pipeline.DataConfig(**DATA), i)
        with m, tsmm.policy(pol):
            state, met = step(state, {k: jnp.asarray(v)
                                      for k, v in b.items()})
        losses.append(met["loss"])
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                state["opt"]["moments"])[0]:
            OUT[f"{tag}/m{i}/{key_of(path)}"] = leaf
    OUT[tag + "/losses"] = jnp.stack(losses)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            state["params"])[0]:
        OUT[tag + "/params/" + key_of(path)] = leaf
save()
"""


def jax_script(arch):
    return JAX_SCRIPT % (arch, B, S, NEW, STEPS, N_MICRO, MIN_SIZE[arch],
                         THRESH, DATA)


# ---------------------------------------------------------------------------
# The fixture and the tests (each test file imports them with its ARCH)
# ---------------------------------------------------------------------------

def _path_hash(s: str) -> int:
    import zlib
    return zlib.crc32(s.encode())


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    import jax

    import test_torch_serve_rwkv
    import test_torch_serve_zamba
    from repro.configs import registry as jregistry
    from repro.optim import adamw as jadamw
    from repro.optim import powersgd as jpowersgd
    from repro.optim import schedule as jschedule
    from repro.train import train_step as jtrain

    arch = request.module.ARCH
    perturb = {"rwkv6-1.6b": test_torch_serve_rwkv.perturb,
               "zamba2-1.2b": test_torch_serve_zamba.perturb}[arch]
    work = tmp_path_factory.mktemp("mesh_ssm")
    jcfg = jregistry.get_config(arch, smoke=True)
    jopt = jadamw.AdamWConfig(
        lr=jschedule.linear_warmup_cosine(1e-3, 2, 3), eps=1e-6)
    jstate = jax.tree.map(np.asarray, jtrain.init_train_state(
        jax.random.PRNGKey(0), jcfg, jopt))
    rng = np.random.default_rng(0)
    jstate["params"] = perturb(jstate["params"], rng)
    with mock.patch.object(jpowersgd, "hash", _path_hash, create=True):
        extra = jpowersgd.init(
            jpowersgd.PowerSGDConfig(rank=4, min_size=MIN_SIZE[arch]),
            jstate["params"], jax.random.PRNGKey(17))
    jstate["extra"] = jax.tree.map(np.asarray, extra)
    with open(work / "state.pkl", "wb") as f:
        pickle.dump(jstate, f)
    prompts = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    ranks, arrays, record = harness.run_both(
        functools.partial(port_rank, arch), jax_script(arch),
        {"prompts": prompts}, work, timeout=500)
    return types.SimpleNamespace(arch=arch, ranks=ranks, jax=arrays,
                                 rec=record)


@pytest.mark.parametrize("tag", _tags())
def test_serve_tokens_and_logits_as_jax(runs, tag):
    for out, _ in (r[tag] for r in runs.ranks):
        np.testing.assert_array_equal(out["tokens"].numpy(),
                                      runs.jax[tag + "/tokens"])
        np.testing.assert_allclose(out["step_logits"].numpy(),
                                   runs.jax[tag + "/step_logits"], **TOL)


@pytest.mark.parametrize("tag", _tags())
def test_prefill_routes_as_jax(runs, tag):
    want = sorted(set(harness.jax_events(runs.rec[tag])))
    for _, meta in (r[tag] for r in runs.ranks):
        assert meta["serve"]["prefill_events"] == want
    # the LoRAs' down projections reach tsm2r on every mesh
    assert {e[1] for e in want} >= {"tsm2r"}


@pytest.mark.parametrize("tag", _tags())
def test_caches_and_parameters_where_the_specs_put_them(runs, tag):
    for _, meta in (r[tag] for r in runs.ranks):
        for when in ("cache_prefill", "cache_decode"):
            places = meta["serve"][when]
            assert places and all(got == want
                                  for got, want in places.values()), when
        for part in ("serve", "train"):
            for name, (got, want) in meta[part]["watched"].items():
                assert got == want, (part, name)
                assert "Shard(dim=1)" in got or "Shard(dim=0)" in got
        assert meta["train"]["all_placed"]


@pytest.mark.parametrize("tag", _tags())
def test_sampling_draws_as_one_process(runs, tag):
    a, b = (r[tag][0] for r in runs.ranks)
    assert torch.equal(a["sampled"], b["sampled"])
    assert torch.equal(a["sampled"], a["sampled_plain"])


@pytest.mark.parametrize("tag", _tags())
def test_abft_tree_check_on_dtensor_leaves(runs, tag):
    for out, meta in (r[tag] for r in runs.ranks):
        assert meta["serve"]["checksum_kinds"] == ["DTensor"]
        assert sorted(out["checksums"]) == sorted(out["checksums_plain"])
        assert len(out["checksums"]) >= 4
        for n, c in out["checksums"].items():
            # a block's partial sums add in another order: 1e-5 of the
            # leaf's largest checksum (a column summing near zero has no
            # relative precision to keep)
            want = out["checksums_plain"][n]
            torch.testing.assert_close(c, want, rtol=1e-5,
                                       atol=1e-5 * float(want.abs().max()),
                                       msg=n)
        assert meta["serve"]["verify"] == (True, False)


@pytest.mark.parametrize("tag", _tags())
def test_train_losses_as_jax(runs, tag):
    want = runs.jax[tag + "/losses"]
    for out, meta in (r[tag] for r in runs.ranks):
        np.testing.assert_allclose(out["losses"].numpy(), want, **TOL)
        assert meta["train"]["compressed"]


def _jax_leaf(runs, key, name, field=""):
    from repro_torch import layout
    path, idx = layout.jax_path(name)
    arr = runs.jax[f"{key}/{path}{field}"]
    return arr[idx] if idx else arr


def _noise(runs, tag, out, name):
    """The entries of parameter ``name`` whose gradient was f32 rounding
    noise in both packages at some step: under ``NOISE`` of the leaf's
    largest, each step's gradient read back from the first moments,
    ``g = (m_j - b1 m_{j-1}) / (1 - b1)``."""
    from repro_torch.optim import adamw
    b1 = adamw.AdamWConfig().b1
    hit = False
    for j in range(STEPS):
        got = out["moments"][j][name].numpy()
        want = _jax_leaf(runs, f"{tag}/m{j}", name, ".m")
        if j:
            got = got - b1 * out["moments"][j - 1][name].numpy()
            want = want - b1 * _jax_leaf(runs, f"{tag}/m{j - 1}", name,
                                         ".m")
        scale = NOISE * max(np.abs(want).max(), 1e-30)
        hit = hit | ((np.abs(got) <= scale) & (np.abs(want) <= scale))
    return hit


@pytest.mark.parametrize("tag", _tags())
def test_train_parameters_as_jax(runs, tag):
    """Every parameter at rtol = atol = 1e-4, except an entry whose
    gradient was f32 rounding noise in both packages: AdamW's ``m /
    sqrt(v)`` turns it into a step of up to ``lr`` either way, so there
    the parameter may differ by at most twice the learning rates so far,
    and at most 0.1% of a leaf's entries may be such."""
    for out, _ in (r[tag] for r in runs.ranks):
        lr_sum = sum(out["lr"])
        for name, p in out["params"].items():
            p, w = p.numpy(), _jax_leaf(runs, f"{tag}/params", name)
            close = np.abs(p - w) <= TOL["atol"] + TOL["rtol"] * np.abs(w)
            if close.all():
                continue
            noise = _noise(runs, tag, out, name)
            assert (close | noise).all(), name
            assert np.abs(p - w)[noise].max(initial=0) <= 2 * lr_sum, name
            assert (~close).sum() <= max(1, p.size // 1000), name
