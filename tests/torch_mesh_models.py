"""The rwkv6, zamba2, mixtral, deepseek-v3, llama-3.2-vision and hubert
smoke models on DTensor parameters: the port's serve and train step on
two-rank meshes against the JAX package's two-device run. The tests live
in ``tests/test_torch_mesh_{rwkv,zamba,mixtral,deepseek,vision,hubert}.
py``, which
name the arch (``ARCH``) and import them from here (with
``pytest_generate_tests``, which gives each test the arch's cases); each
file runs one world.

As ``tests/test_torch_mesh.py`` does for chatglm3, with its sizes,
thresholds, tolerance and batches: one two-rank gloo world
(``tests/torch_dist_harness.py``) runs the port on each of the arch's
cases (``CASES``: a ``("data", "model")`` mesh of shape (1, 2) or (2, 1),
changes to the smoke config, ``make_param_specs``'s ``fsdp``); a
subprocess with two host devices runs the JAX package on the same cases.
rwkv6 and zamba2 take the two meshes. The MoE models take expert
parallelism on (1, 2), one dispatch group spanning both dp ranks on
(2, 1) and two groups there, 3 experts on (1, 2) (the experts then split
their d_ff over "model"), and FSDP with two groups on (2, 1); deepseek
also its
non-absorbed MLA decode on (1, 2), where the latent cache's sequence is
split over "model". llama-3.2-vision takes the two meshes with seeded
f32 image embeddings beside its prompts (``generate(extras=)``, the
prefill's batch) and the pipeline's in training, each placed by
``batch_specs`` like the tokens; its cross caches lie where
``cache_specs`` puts them. hubert, an encoder (``ENCODERS``), takes the two
meshes at 4 layers (its stacked ``ffn.b_up`` then has PowerSGD's rank of
rows) and an encoder arm in place of ``generate``: ``forward`` and
``prefill`` of seeded f32 frames, and the pipeline's frame batches in
training. Both packages start from the JAX package's
train state for the case's config (the leaves that start constant
perturbed as ``tests/test_torch_serve_rwkv.py`` /
``test_torch_serve_zamba.py`` / ``test_torch_serve_moe.py`` do;
PowerSGD's Q drawn with the crc32 hash of ``tests/test_torch_train_zamba.
py``, which every process agrees on), the port's through ``convert``,
each placed by its own package's ``make_param_specs``, both under a
policy with lowered classifier thresholds, so the LoRAs' down projections
and the routers classify as tsm2r (the shard_map executor on the (1, 2)
mesh). f32. The tests read the two records:

* serving (``generate(sharded_projections=True)``, caches from
  ``cache_specs``): the greedy tokens equal; the prefill logits and every
  decode step's at rtol = atol = 1e-4, as the plain serve tests hold them;
  an encoder's ``forward`` logits (every frame's), and its
  ``make_serve_fns(sharded_projections=True)`` prefill's last-frame
  logits and K/V caches, at the same tolerance, and both equal to the
  one-process port's within it;
* training (``make_train_step(acc_shardings=, mesh=)``, PowerSGD rank 4
  on ``embed`` / ``lm_head`` (and zamba2's shared block), 2 microbatches,
  2 steps, AdamW's eps 1e-6 as ``tests/test_torch_mesh.py``): each step's
  loss (and an MoE model's three metrics) and every parameter after the
  second at rtol = atol = 1e-4, except an entry whose gradient was f32
  rounding noise in both packages, where AdamW's normalised step is
  bounded instead (``test_torch_train_zamba.py``'s exception); an MoE
  model's ``router_bias`` gradient zero and in the bias's placements;
* the placements: the ``WATCHED`` parameters (``wr``; ``in_proj`` and
  ``conv_w``; the expert stacks) where ``make_param_specs`` puts them
  before and after the steps, and the ``CACHES`` entries (the ``wkv`` /
  ``ssm`` / ``conv`` states, mixtral's ring ``k`` / ``v``, deepseek's
  latent ``c`` / ``kpe``) where ``cache_specs`` puts them after a prefill
  and a decode step;
* the prefill's dispatch events: the same executors as the JAX run's;
* on the port alone: sampling at temperature 1 draws the same tokens on
  both ranks, equal to the one-process port's from the same seed;
  ``abft.encode_tree`` of the DTensor leaves equals that of the full
  leaves (f32, within 1e-5 of each leaf's largest checksum; ``MIN_LEAF``
  lowered so the smoke leaves get checksums), and ``verify_tree``
  passes clean parameters and fails after ``ft.inject.poison_tree``.
  (An encoder has no sampling.)

The ranks import this module, so it imports no JAX.
"""

import dataclasses
import functools
import pickle
import types
from unittest import mock

import numpy as np
import pytest
import torch

import torch_dist_harness as harness
from test_torch_mesh import (B, DATA, N_MICRO, NEW, STEPS, THRESH, TOL, S,
                             _full, _places)

MIXTRAL, DEEPSEEK, HUBERT = "mixtral-8x7b", "deepseek-v3-671b", "hubert-xlarge"
VISION = "llama-3.2-vision-11b"
# Encoders: served by forward and prefill of frames, trained on frames.
ENCODERS = (HUBERT,)
FRAME_DATA = {**DATA, "vocab_size": 64, "mode": "frames", "frame_dim": 32}
# The vision smoke config's image embeddings: 24 tokens of width 48.
IMAGE_DATA = {**DATA, "vision_seq": 24, "vision_dim": 48}
# Each arch's cases: tag -> (mesh shape, changes to the smoke config,
# changes to its MoEConfig, make_param_specs's fsdp).
MESHES = {"1x2": ((1, 2), {}, {}, None), "2x1": ((2, 1), {}, {}, None)}
MOE_CASES = {**MESHES,
             "2x1-g2": ((2, 1), {}, {"dispatch_groups": 2}, None),
             "1x2-e3": ((1, 2), {}, {"n_experts": 3}, None),
             "2x1-fsdp": ((2, 1), {}, {"dispatch_groups": 2}, True)}
CASES = {"rwkv6-1.6b": MESHES, "zamba2-1.2b": MESHES, MIXTRAL: MOE_CASES,
         VISION: MESHES,
         DEEPSEEK: {**MOE_CASES, "1x2-plain": ((1, 2), {"mla_absorb": False},
                                               {}, None)},
         HUBERT: {tag: (shape, {"n_layers": 4}, {}, None)
                  for tag, (shape, *_) in MESHES.items()}}
# PowerSGD's leaves at the smoke width: embed and lm_head (rwkv6 and the
# MoE models, whose expert stacks are 3-D), and the shared block's seven
# matrices too (zamba2), and frame_proj and the stacked b_up (hubert), as
# at full width.
MIN_SIZE = {"rwkv6-1.6b": 1024, "zamba2-1.2b": 4096, MIXTRAL: 4096,
            DEEPSEEK: 4096, HUBERT: 512, VISION: 1024}
# The parameters whose placements the tests read, and the cache entries.
WATCHED = {"rwkv6-1.6b": ("layers.0.time_mix.wr",),
           "zamba2-1.2b": ("groups.0.mamba.0.mixer.in_proj",
                           "groups.0.mamba.0.mixer.conv_w"),
           MIXTRAL: ("layers.0.ffn.experts.w_gate",
                     "layers.0.ffn.experts.w_down"),
           DEEPSEEK: ("tail.0.ffn.experts.w_gate",
                      "tail.0.ffn.experts.w_down", "layers.0.attn.wukv"),
           HUBERT: ("frame_proj.w", "layers.0.ffn.w_up", "layers.0.ffn.b_up"),
           VISION: ("groups.0.cross.kv_proj_k", "groups.0.cross.attn.wq",
                    "groups.0.self.0.attn.wk")}
STATES = ("wkv", "ssm", "conv")
CACHES = {"rwkv6-1.6b": STATES, "zamba2-1.2b": STATES, MIXTRAL: ("k", "v"),
          DEEPSEEK: ("c", "kpe"), HUBERT: ("k", "v"), VISION: ("k", "v")}
MOE_METRICS = ("moe_balance_loss", "moe_dropped_frac", "moe_max_load")
ABFT_MIN_LEAF = 1024
NOISE = 1e-6


# ---------------------------------------------------------------------------
# The port's side: run on each rank of the world
# ---------------------------------------------------------------------------

def pytest_generate_tests(metafunc):
    """Each test of a file runs on its arch's cases (``tag``)."""
    if "tag" in metafunc.fixturenames:
        metafunc.parametrize("tag", list(CASES[metafunc.module.ARCH]))


def case_config(cfg, case):
    """The smoke config ``cfg`` with a case's changes."""
    _, change, moe, _ = case
    if moe:
        change = {**change, "moe": dataclasses.replace(cfg.moe, **moe)}
    return dataclasses.replace(cfg, **change)


def data(arch) -> dict:
    """The arch's ``DataConfig`` fields: frames for an encoder, image
    embeddings for the vision model."""
    return (FRAME_DATA if arch in ENCODERS else IMAGE_DATA if arch == VISION
            else DATA)


def batches(arch) -> list:
    """Each train step's pipeline batch."""
    from repro_torch.data import pipeline
    cfg = pipeline.DataConfig(**data(arch))
    return [pipeline.batch_for_step(cfg, i) for i in range(STEPS)]


def _cache_places(arch, cfg, mesh, cache):
    """(placements, the spec's placements) of every ``CACHES[arch]``
    entry of ``cache``, by ``layer.name``."""
    from repro_torch.distributed import sharding
    specs = sharding.cache_specs(cfg, mesh, cache)
    return {f"{i}.{k}": (_places(t), [repr(p) for p in sharding.placements(
        mesh, specs[i][k])]) for i, entry in enumerate(cache)
        for k, t in entry.items() if k in CACHES[arch]}


def _encode(arch, cfg, params, plain, frames, mesh, pol):
    """An encoder's serve: ``forward`` (every frame's logits) and a
    ``make_serve_fns`` prefill (the last frame's, and the K/V caches) of
    ``frames`` placed by ``batch_specs``; the one-process port's forward
    beside them."""
    from repro_torch.core import tsmm
    from repro_torch.distributed import sharding
    from repro_torch.models import model
    from repro_torch.serve import engine

    out, meta = {}, {}
    fr = torch.from_numpy(frames)
    batch = sharding.named(mesh, sharding.batch_specs(
        cfg, mesh, {"frames": fr}), {"frames": fr})
    with tsmm.policy(pol):
        logits, _ = model.forward(params, cfg, batch)
        out["forward_logits"] = _full(logits)
        out["forward_plain"], _ = model.forward(plain, cfg, {"frames": fr})
    prefill, _ = engine.make_serve_fns(cfg, policy=pol,
                                       sharded_projections=True)
    cache = model.init_cache(cfg, B, S, device="cpu", mesh=mesh)
    with tsmm.record_dispatches() as log:
        logits, cache = prefill(params, batch, cache)
    meta["prefill_events"] = sorted(set(harness.port_events(log)))
    meta["cache_prefill"] = _cache_places(arch, cfg, mesh, cache)
    out["prefill_logits"] = _full(logits)
    out["caches"] = {f"{i}.{k}": _full(t) for i, entry in enumerate(cache)
                     for k, t in entry.items()}
    return out, meta


def _serve(arch, cfg, jstate, inputs, mesh, pol, fsdp):
    from repro_torch.convert import params_from_jax
    from repro_torch.distributed import sharding
    from repro_torch.ft import abft, inject

    params = params_from_jax(cfg, jstate["params"], device="cpu")
    plain = params_from_jax(cfg, jstate["params"], device="cpu")
    specs = sharding.make_param_specs(cfg, params, mesh, fsdp)
    sharding.named(mesh, specs, params)
    if arch in ENCODERS:
        out, meta = _encode(arch, cfg, params, plain, inputs["frames"],
                            mesh, pol)
    else:
        out, meta = _generate(arch, cfg, params, plain, specs,
                              inputs["prompts"], mesh, pol,
                              inputs.get("image_embeds"))
    named = dict(params.named_parameters())
    meta["watched"] = {n: (_places(named[n]), [repr(p) for p in
                                               sharding.placements(
                                                   mesh, specs[n])])
                       for n in WATCHED[arch]}

    # -- the port alone: the ABFT tree check --------------------------------
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


def _generate(arch, cfg, params, plain, specs, prompts, mesh, pol,
              images=None):
    from repro_torch.core import tsmm
    from repro_torch.distributed import sharding
    from repro_torch.models import model
    from repro_torch.serve import engine

    out, meta = {}, {}
    toks = torch.from_numpy(prompts).long()
    extras = ({} if images is None
              else {"image_embeds": torch.from_numpy(images)})
    out["tokens"] = engine.generate(params, cfg, toks, NEW, policy=pol,
                                    extras=extras, device="cpu",
                                    sharded_projections=True)
    prefill, decode = engine.make_serve_fns(cfg, policy=pol,
                                            sharded_projections=True)
    cache = model.init_cache(cfg, B, S + NEW, device="cpu", mesh=mesh)
    host = {"tokens": toks, **extras}
    batch = sharding.named(mesh, sharding.batch_specs(cfg, mesh, host),
                           dict(host))
    with tsmm.record_dispatches() as log:
        logits, cache = prefill(params, batch, cache)
    meta["prefill_events"] = sorted(set(harness.port_events(log)))
    meta["cache_prefill"] = _cache_places(arch, cfg, mesh, cache)
    steps = [_full(logits)]
    for i in range(1, NEW):
        logits, cache = decode(params, out["tokens"][:, i - 1:i], S + i - 1,
                               cache)
        steps.append(_full(logits))
        if i == 1:
            meta["cache_decode"] = _cache_places(arch, cfg, mesh, cache)
    out["step_logits"] = torch.stack(steps)

    # -- the port alone: sampling, the bias update --------------------------
    out["sampled"] = engine.generate(
        params, cfg, toks, NEW, policy=pol, extras=extras, device="cpu",
        sharded_projections=True, temperature=1.0,
        generator=torch.Generator().manual_seed(7))
    out["sampled_plain"] = engine.generate(
        plain, cfg, toks, NEW, policy=pol, extras=extras, device="cpu",
        temperature=1.0, generator=torch.Generator().manual_seed(7))
    if cfg.moe is not None:
        # DeepSeek's bias step from whole counts, on the DTensor layer and
        # on the plain one
        from repro_torch.models import moe
        name = next(n for n, m in params.named_modules()
                    if isinstance(m, moe.MoE))
        layer, plain_layer = (tree.get_submodule(name)
                              for tree in (params, plain))
        out["bias_before"] = plain_layer.router_bias.detach().clone()
        counts = torch.arange(cfg.moe.n_experts) % 3
        moe.update_router_bias(layer, counts)
        moe.update_router_bias(plain_layer, counts)
        out["bias_after"] = _full(layer.router_bias).detach().clone()
        out["bias_after_plain"] = plain_layer.router_bias.detach().clone()
        meta["bias_places"] = (_places(layer.router_bias), [
            repr(p) for p in sharding.placements(
                mesh, specs[f"{name}.router_bias"])])
    return out, meta


def _train(arch, cfg, jstate, mesh, pol, fsdp):
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
    specs = sharding.make_param_specs(cfg, state["params"], mesh, fsdp)
    sharding.named(mesh, {"params": specs,
                          "opt": sharding.make_opt_specs(specs)}, state)
    sharding.named(mesh, launcher._powersgd_specs(state["extra"], specs),
                   state["extra"])
    meta["compressed"] = sorted(state["extra"])
    acc = sharding.named(mesh, specs)
    step = train_step.make_train_step(
        cfg, opt, n_micro=N_MICRO,
        grad_transform=lambda g, st: powersgd.compress_tree(ps, g, st),
        acc_shardings=acc, mesh=mesh)
    losses, moments, lrs, moe_metrics = [], [], [], []
    for i, b in enumerate(batches(arch)):
        tb = launcher.to_tensors(b, "cpu")
        tb = sharding.named(mesh, sharding.batch_specs(cfg, mesh, tb), tb)
        if i == 0 and cfg.moe is not None:
            # router_bias reaches the loss only through the selection
            with tsmm.policy(pol):
                _, grads, _ = train_step._grads(train_step.make_loss_fn(cfg),
                                                state["params"], tb, acc)
            meta["bias_grads"] = {
                n: (_places(g), [repr(p) for p in acc[n]],
                    float(g.full_tensor().abs().max()))
                for n, g in grads.items() if n.endswith("router_bias")}
            del grads
        with tsmm.policy(pol):
            state, metrics = step(state, tb)
        losses.append(metrics["loss"])
        moe_metrics.append({k: float(metrics[k]) for k in MOE_METRICS
                            if k in metrics})
        lrs.append(float(metrics["lr"]))
        moments.append({n: _full(mv["m"]).clone()
                        for n, mv in state["opt"]["moments"].items()})
    named = dict(state["params"].named_parameters())
    out["losses"] = torch.stack(losses)
    out["moe_metrics"] = moe_metrics
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

    smoke = registry.get_config(arch, smoke=True)
    with open(work / "state.pkl", "rb") as f:
        jstates = pickle.load(f)
    inputs = dict(np.load(work / "inputs.npz"))
    pol = tsmm.GemmPolicy(**THRESH)
    res = {}
    for tag, case in CASES[arch].items():
        cfg = case_config(smoke, case)
        mesh = init_device_mesh("cpu", case[0], mesh_dim_names=("data",
                                                                "model"))
        serve, serve_meta = _serve(arch, cfg, jstates[tag], inputs, mesh,
                                   pol, case[3])
        train, train_meta = _train(arch, cfg, jstates[tag], mesh, pol,
                                   case[3])
        res[tag] = ({**serve, **train},
                    {"serve": serve_meta, "train": train_meta})
    return res


# ---------------------------------------------------------------------------
# The JAX package's side, on two host devices
# ---------------------------------------------------------------------------

JAX_SCRIPT = harness.JAX_PRELUDE + r"""
import dataclasses
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
CASES = %r
METRICS = %r
ENCODER = %r
smoke = registry.get_config(ARCH, smoke=True)
with open(WORK + "/state.pkl", "rb") as f:
    jstates = pickle.load(f)
pol = tsmm.GemmPolicy(**THRESH)


def encode(tag, cfg, params):
    batch = {"frames": INP["frames"]}
    with tsmm.policy(pol):
        OUT[tag + "/forward_logits"] = jax.jit(
            lambda p, b: model.forward(p, cfg, b)[0])(params, batch)
    prefill, _ = engine.make_serve_fns(cfg, policy=pol,
                                       sharded_projections=True)
    with tsmm.record_dispatches() as log:
        logits, cache = jax.jit(prefill)(params, batch,
                                         model.init_cache(cfg, B, S))
    REC[tag] = events(log)
    OUT[tag + "/prefill_logits"] = logits
    for k in ("k", "v"):
        OUT[f"{tag}/cache/{k}"] = cache[0][k]


def generate(tag, cfg, params):
    prompts = INP["prompts"]
    extras = ({"image_embeds": INP["image_embeds"]}
              if "image_embeds" in INP else None)
    toks = engine.generate(params, cfg, prompts, NEW, policy=pol,
                           extras=extras, sharded_projections=True)
    OUT[tag + "/tokens"] = toks
    prefill, decode = engine.make_serve_fns(cfg, policy=pol,
                                            sharded_projections=True)
    with tsmm.record_dispatches() as log:
        logits, cache = jax.jit(prefill)(
            params, {"tokens": prompts, **(extras or {})},
            model.init_cache(cfg, B, S + NEW))
    REC[tag] = events(log)
    steps = [logits]
    jdecode = jax.jit(decode, static_argnums=(2,))
    for i in range(1, NEW):
        logits, cache = jdecode(params, toks[:, i - 1:i], S + i - 1, cache)
        steps.append(logits)
    OUT[tag + "/step_logits"] = jnp.stack(steps)



def key_of(path):
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


for tag, (shape, change, moe, fsdp) in CASES.items():
    cfg = dataclasses.replace(smoke, **change, **(
        {"moe": dataclasses.replace(smoke.moe, **moe)} if moe else {}))
    jstate = jstates[tag]
    m = Mesh(np.array(devs).reshape(shape), ("data", "model"))
    p_named = sharding.named(m, sharding.make_param_specs(
        cfg, jstate["params"], m, fsdp))
    params = jax.device_put(jax.tree.map(jnp.asarray, jstate["params"]),
                            p_named)
    with m:
        (encode if ENCODER else generate)(tag, cfg, params)
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
        for k in METRICS:
            if k in met:
                OUT[f"{tag}/metrics{i}/{k}"] = met[k]
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
                         THRESH, data(arch), CASES[arch], MOE_METRICS,
                         arch in ENCODERS)


# ---------------------------------------------------------------------------
# The fixture and the tests (each test file imports them with its ARCH)
# ---------------------------------------------------------------------------

def _path_hash(s: str) -> int:
    import zlib
    return zlib.crc32(s.encode())


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    import jax

    import test_torch_hubert
    import test_torch_serve_moe
    import test_torch_serve_rwkv
    import test_torch_serve_zamba
    import test_torch_vision
    from repro.configs import registry as jregistry
    from repro.optim import adamw as jadamw
    from repro.optim import powersgd as jpowersgd
    from repro.optim import schedule as jschedule
    from repro.train import train_step as jtrain

    arch = request.module.ARCH
    perturb = {"rwkv6-1.6b": test_torch_serve_rwkv.perturb,
               "zamba2-1.2b": test_torch_serve_zamba.perturb,
               MIXTRAL: test_torch_serve_moe.perturb,
               DEEPSEEK: test_torch_serve_moe.perturb,
               HUBERT: test_torch_hubert.perturb,
               VISION: test_torch_vision.perturb}[arch]
    work = tmp_path_factory.mktemp("mesh_models")
    smoke = jregistry.get_config(arch, smoke=True)
    jopt = jadamw.AdamWConfig(
        lr=jschedule.linear_warmup_cosine(1e-3, 2, 3), eps=1e-6)
    jstates = {}
    for tag, case in CASES[arch].items():
        # each case's state from the same seeds (its config's shapes)
        jstate = jax.tree.map(np.asarray, jtrain.init_train_state(
            jax.random.PRNGKey(0), case_config(smoke, case), jopt))
        rng = np.random.default_rng(0)
        jstate["params"] = perturb(jstate["params"], rng)
        with mock.patch.object(jpowersgd, "hash", _path_hash, create=True):
            extra = jpowersgd.init(
                jpowersgd.PowerSGDConfig(rank=4, min_size=MIN_SIZE[arch]),
                jstate["params"], jax.random.PRNGKey(17))
        jstate["extra"] = jax.tree.map(np.asarray, extra)
        jstates[tag] = jstate
    with open(work / "state.pkl", "wb") as f:
        pickle.dump(jstates, f)
    if arch in ENCODERS:
        inputs = {"frames": test_torch_hubert.frames(smoke, rng, B, S)}
    else:
        inputs = {"prompts": rng.integers(0, smoke.vocab_size, (B, S)
                                          ).astype(np.int32)}
        if arch == VISION:
            inputs["image_embeds"] = test_torch_vision.images(smoke, rng, B)
    ranks, arrays, record = harness.run_both(
        functools.partial(port_rank, arch), jax_script(arch), inputs, work,
        timeout=500)
    return types.SimpleNamespace(arch=arch, ranks=ranks, jax=arrays,
                                 rec=record)


def test_serve_tokens_and_logits_as_jax(runs, tag):
    for out, _ in (r[tag] for r in runs.ranks):
        np.testing.assert_array_equal(out["tokens"].numpy(),
                                      runs.jax[tag + "/tokens"])
        np.testing.assert_allclose(out["step_logits"].numpy(),
                                   runs.jax[tag + "/step_logits"], **TOL)


def test_prefill_routes_as_jax(runs, tag):
    want = sorted(set(harness.jax_events(runs.rec[tag])))
    for _, meta in (r[tag] for r in runs.ranks):
        assert meta["serve"]["prefill_events"] == want
    # the LoRAs' down projections and the routers reach tsm2r on every
    # mesh
    assert {e[1] for e in want} >= {"tsm2r"}


def test_caches_and_parameters_where_the_specs_put_them(runs, tag):
    whens = (("cache_prefill",) if runs.arch in ENCODERS
             else ("cache_prefill", "cache_decode"))
    for _, meta in (r[tag] for r in runs.ranks):
        for when in whens:
            places = meta["serve"][when]
            assert places and all(got == want
                                  for got, want in places.values()), when
        for part in ("serve", "train"):
            for name, (got, want) in meta[part]["watched"].items():
                assert got == want, (part, name)
                assert any(f"Shard(dim={d})" in got for d in range(3))
        assert meta["train"]["all_placed"]


def test_encoder_logits_and_caches_as_jax(runs, tag):
    """(An encoder.) ``forward``'s every frame and the prefill's last
    frame as the JAX run's and as the one-process port's, and the
    prefill's K/V caches as JAX's."""
    for out, _ in (r[tag] for r in runs.ranks):
        want = runs.jax[tag + "/forward_logits"]
        np.testing.assert_allclose(out["forward_logits"].numpy(), want,
                                   **TOL)
        np.testing.assert_allclose(out["forward_plain"].numpy(), want,
                                   **TOL)
        np.testing.assert_allclose(out["prefill_logits"].numpy(),
                                   runs.jax[tag + "/prefill_logits"], **TOL)
        np.testing.assert_allclose(out["prefill_logits"].numpy(),
                                   want[:, -1], **TOL)
        n = len(out["caches"]) // 2
        for k in ("k", "v"):
            got = np.stack([out["caches"][f"{i}.{k}"].numpy()
                            for i in range(n)])
            np.testing.assert_allclose(got, runs.jax[f"{tag}/cache/{k}"],
                                       **TOL, err_msg=k)


def test_encoder_prefill_routes_as_jax(runs, tag):
    """(An encoder.) The prefill's dispatch events as the JAX run's: at
    the smoke width every projection is dense in both packages."""
    want = sorted(set(harness.jax_events(runs.rec[tag])))
    for _, meta in (r[tag] for r in runs.ranks):
        assert meta["serve"]["prefill_events"] == want
    assert want and {e[1] for e in want} == {"dense"}


def test_sampling_draws_as_one_process(runs, tag):
    a, b = (r[tag][0] for r in runs.ranks)
    assert torch.equal(a["sampled"], b["sampled"])
    assert torch.equal(a["sampled"], a["sampled_plain"])


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


def test_train_losses_as_jax(runs, tag):
    want = runs.jax[tag + "/losses"]
    for out, meta in (r[tag] for r in runs.ranks):
        np.testing.assert_allclose(out["losses"].numpy(), want, **TOL)
        assert meta["train"]["compressed"]


def test_router_bias_update_on_dtensor_leaves(runs, tag):
    """(The MoE models.) ``update_router_bias`` steps a DTensor bias in
    place from the whole counts as it steps the plain bias, and leaves
    it in its placements."""
    for out, meta in (r[tag] for r in runs.ranks):
        assert torch.equal(out["bias_after"], out["bias_after_plain"])
        assert not torch.equal(out["bias_after"], out["bias_before"])
        got, want = meta["serve"]["bias_places"]
        assert got == want


def test_moe_metrics_and_router_bias_gradient_as_jax(runs, tag):
    """(The MoE models.) Each step's three MoE metrics as the JAX run's,
    and every MoE layer's ``router_bias`` gradient zero, in the bias's
    placements."""
    for out, meta in (r[tag] for r in runs.ranks):
        for i, got in enumerate(out["moe_metrics"]):
            assert sorted(got) == sorted(MOE_METRICS)
            for k, v in got.items():
                np.testing.assert_allclose(
                    v, runs.jax[f"{tag}/metrics{i}/{k}"], **TOL, err_msg=k)
        bias = meta["train"]["bias_grads"]
        assert len(bias) == 2          # both smoke models: two MoE layers
        for name, (got, want, largest) in bias.items():
            assert got == want and largest == 0.0, name


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
