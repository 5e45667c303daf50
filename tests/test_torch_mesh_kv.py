"""chatglm3's smoke model with kv heads that do not split over the model
axis of a (1, 2) mesh, against the JAX package's two-device run.

Two cases: one kv head under 4 query heads ("kv1"), whose 2 query heads
a rank attend over their one kv head (``heads.local_heads``); and 3 kv
heads under 6 query heads ("kv3"), whose feature dim splits over "model"
across a head, which DTensor cannot unflatten (GSPMD reshards it; the
parent tree failed there): the port gathers it first
(``attention.split_heads``) and every rank attends over every head. In
both the caches shard their sequence (``cache_specs``). One two-rank
gloo world
(``tests/torch_dist_harness.py``) beside one JAX subprocess on two host
devices, both from the JAX package's initial parameters (biases and norm
scales perturbed), under lowered classifier thresholds as
``tests/test_torch_mesh.py``: the prefill logits at rtol = atol = 1e-4,
the greedy tokens equal, and one train step's loss and parameters at
1e-4. The ranks import this module, so it imports no JAX. ~35 s.
"""

import dataclasses
import pickle
import types

import numpy as np
import pytest
import torch

import torch_dist_harness as harness

B, S, NEW, N_MICRO = 4, 24, 6, 2
CASES = {"kv1": dict(n_kv_heads=1), "kv3": dict(n_heads=6, n_kv_heads=3)}
THRESH = dict(min_tall=32, max_skinny=32, skinny_ratio=2)
TOL = dict(rtol=1e-4, atol=1e-4)
DATA = dict(seed=0, seq_len=32, global_batch=4, vocab_size=256)


def port_rank(rank, work):
    return {tag: _port_case(tag, work) for tag in CASES}


def _port_case(tag, work):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import registry
    from repro_torch.convert import params_from_jax
    from repro_torch.core import tsmm
    from repro_torch.data import pipeline
    from repro_torch.distributed import sharding
    from repro_torch.models import model
    from repro_torch.optim import adamw, schedule
    from repro_torch.serve import engine
    from repro_torch.train import train_step

    cfg = dataclasses.replace(registry.get_config("chatglm3-6b", smoke=True),
                              **CASES[tag])
    with open(work / f"params_{tag}.pkl", "rb") as f:
        tree = pickle.load(f)
    prompts = torch.from_numpy(np.load(work / "inputs.npz")["prompts"]).long()
    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    pol = tsmm.GemmPolicy(**THRESH)
    params = params_from_jax(cfg, tree, device="cpu")
    specs = sharding.make_param_specs(cfg, params, mesh)
    sharding.named(mesh, specs, params)
    out = {"wk": [repr(p) for p in params.layers[0].attn.wk.placements]}
    out["tokens"] = engine.generate(params, cfg, prompts, NEW, policy=pol,
                                    device="cpu")
    prefill, _ = engine.make_serve_fns(cfg, policy=pol)
    cache = model.init_cache(cfg, B, S + NEW, device="cpu", mesh=mesh)
    out["cache_k"] = [repr(p) for p in cache[0]["k"].placements]
    batch = sharding.named(mesh, sharding.batch_specs(
        cfg, mesh, {"tokens": prompts}), {"tokens": prompts})
    logits, _ = prefill(params, batch, cache)
    out["logits"] = logits.full_tensor()

    opt = adamw.AdamWConfig(lr=schedule.linear_warmup_cosine(1e-3, 2, 3),
                            eps=1e-6)
    params.requires_grad_(True)
    state = {"params": params, "opt": adamw.init(opt, params)}
    step = train_step.make_train_step(
        cfg, opt, n_micro=N_MICRO, acc_shardings=sharding.named(mesh, specs),
        mesh=mesh)
    b = pipeline.batch_for_step(pipeline.DataConfig(**DATA), 0)
    tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
    tb = sharding.named(mesh, sharding.batch_specs(cfg, mesh, tb), tb)
    with tsmm.policy(pol):
        state, metrics = step(state, tb)
    out["loss"] = metrics["loss"]
    out["params"] = {n: p.full_tensor().detach().clone()
                     for n, p in params.named_parameters()}
    return out


JAX_SCRIPT = harness.JAX_PRELUDE + r"""
import dataclasses, pickle

from repro.configs import registry
from repro.data import pipeline
from repro.distributed import sharding
from repro.models import model
from repro.optim import adamw, schedule
from repro.serve import engine
from repro.train import train_step as ts

B, S, NEW, N_MICRO = %d, %d, %d, %d
THRESH = %r
DATA = %r
CASES = %r
for tag, case in CASES.items():
    cfg = dataclasses.replace(registry.get_config("chatglm3-6b", smoke=True),
                              **case)
    with open(WORK + f"/params_{tag}.pkl", "rb") as f:
        tree = pickle.load(f)
    pol = tsmm.GemmPolicy(**THRESH)
    prompts = INP["prompts"]
    m = Mesh(np.array(devs).reshape(1, 2), ("data", "model"))
    p_named = sharding.named(m, sharding.make_param_specs(cfg, tree, m))
    params = jax.device_put(jax.tree.map(jnp.asarray, tree), p_named)
    with m:
        OUT[tag + "/tokens"] = engine.generate(params, cfg, prompts, NEW,
                                               policy=pol)
        prefill, _ = engine.make_serve_fns(cfg, policy=pol)
        OUT[tag + "/logits"], _ = jax.jit(prefill)(
            params, {"tokens": prompts}, model.init_cache(cfg, B, S + NEW))
    opt = adamw.AdamWConfig(lr=schedule.linear_warmup_cosine(1e-3, 2, 3),
                            eps=1e-6)
    state = {"params": params, "opt": adamw.init(opt, params)}
    step = jax.jit(ts.make_train_step(cfg, opt, n_micro=N_MICRO,
                                      acc_shardings=p_named, mesh=m))
    b = pipeline.batch_for_step(pipeline.DataConfig(**DATA), 0)
    with m, tsmm.policy(pol):
        state, met = step(state, {k: jnp.asarray(v) for k, v in b.items()})
    OUT[tag + "/loss"] = met["loss"]
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            state["params"])[0]:
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        OUT[tag + "/params/" + key] = leaf
save()
""" % (B, S, NEW, N_MICRO, THRESH, DATA, CASES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from repro.configs import registry as jregistry
    from repro.models import model as jmodel

    work = tmp_path_factory.mktemp("mesh_kv")
    rng = np.random.default_rng(0)
    for tag, case in CASES.items():
        jcfg = dataclasses.replace(
            jregistry.get_config("chatglm3-6b", smoke=True), **case)
        tree = jax.tree.map(np.asarray,
                            jmodel.init(jax.random.PRNGKey(0), jcfg))
        seg = tree["segments"][0]
        for key in ("bq", "bk", "bv"):
            seg["attn"][key] = rng.normal(0, 0.1, seg["attn"][key].shape
                                          ).astype(np.float32)
        for norm in (seg["norm1"], seg["norm2"], tree["final_norm"]):
            norm["scale"] = (1 + rng.normal(0, 0.1, norm["scale"].shape)
                             ).astype(np.float32)
        with open(work / f"params_{tag}.pkl", "wb") as f:
            pickle.dump(tree, f)
    prompts = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    ranks, arrays, _ = harness.run_both(port_rank, JAX_SCRIPT,
                                        {"prompts": prompts}, work,
                                        timeout=300)
    return types.SimpleNamespace(ranks=ranks, jax=arrays)


@pytest.mark.parametrize("tag", list(CASES))
def test_placements(runs, tag):
    for r in runs.ranks:
        # the kv heads' features split over "model"; the cache shards its
        # sequence
        assert r[tag]["wk"] == ["Replicate()", "Shard(dim=1)"]
        assert r[tag]["cache_k"] == ["Shard(dim=0)", "Shard(dim=1)"]


@pytest.mark.parametrize("tag", list(CASES))
def test_prefill_logits_and_greedy_tokens_as_jax(runs, tag):
    for r in runs.ranks:
        np.testing.assert_allclose(r[tag]["logits"].numpy(),
                                   runs.jax[tag + "/logits"], **TOL)
        np.testing.assert_array_equal(r[tag]["tokens"].numpy(),
                                      runs.jax[tag + "/tokens"])


@pytest.mark.parametrize("tag", list(CASES))
def test_train_step_as_jax(runs, tag):
    from repro_torch import layout
    for r in runs.ranks:
        np.testing.assert_allclose(float(r[tag]["loss"]),
                                   float(runs.jax[tag + "/loss"]), **TOL)
        for name, p in r[tag]["params"].items():
            path, idx = layout.jax_path(name)
            want = runs.jax[f"{tag}/params/{path}"]
            np.testing.assert_allclose(p.numpy(), want[idx] if idx else want,
                                       err_msg=name, **TOL)
