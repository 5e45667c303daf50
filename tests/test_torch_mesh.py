"""chatglm3's smoke model on DTensor parameters: the port's serve and train
step on a two-rank mesh against the JAX package's two-device run.

One two-rank gloo world (``tests/torch_dist_harness.py``) runs the port on
``("data", "model")`` meshes of shape (1, 2) and (2, 1); a subprocess with
two host devices runs the JAX package on the same meshes. Both start from
the JAX package's initial parameters (biases and norm scales perturbed),
the port's through ``convert.params_from_jax``, each placed by its own
package's ``make_param_specs``, and both run under a policy with lowered
classifier thresholds, so the smoke model's ``wk`` / ``wv`` projections
classify as tsm2r (the shard_map executor on a mesh of two ranks). The
tests read the two records:

* serving (``generate(sharded_projections=True)``, caches from
  ``cache_specs``): the greedy tokens equal, the prefill logits at
  ``tests/test_torch_serve.py``'s rtol = atol = 1e-4;
* training (``make_train_step(acc_shardings=, mesh=)``, 2 microbatches,
  2 steps, AdamW's eps 1e-6 as ``tests/test_torch_train.py``): each
  step's loss and every parameter after the second at rtol = atol = 1e-4;
  the microbatches are rows of the *global* batch (the loss is the last
  microbatch's, so a wrong grouping shows);
* the placements: parameters, moments, gradients' accumulator and caches
  where the specs put them;
* on the port alone: ``poison_tree`` writes the global element 0 once,
  a snapshot round trip is exact, and a checkpoint of DTensor leaves
  holds full leaves that ``elastic.restore_state`` places back.

The ranks import this module, so it imports no JAX.
"""

import pickle
import types

import numpy as np
import pytest
import torch

import torch_dist_harness as harness
from repro_torch.configs import registry

B, S, NEW = 4, 24, 6
STEPS, N_MICRO = 2, 2
THRESH = dict(min_tall=32, max_skinny=32, skinny_ratio=2)
TOL = dict(rtol=1e-4, atol=1e-4)
SHAPES = ((1, 2), (2, 1))
DATA = dict(seed=0, seq_len=32, global_batch=4, vocab_size=256)


def _batches():
    from repro_torch.data import pipeline
    cfg = pipeline.DataConfig(**DATA)
    return [pipeline.batch_for_step(cfg, i) for i in range(STEPS)]


# ---------------------------------------------------------------------------
# The port's side: run on each rank of the world
# ---------------------------------------------------------------------------

def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _places(t):
    return [repr(p) for p in t.placements]


def _port_mesh(cfg, tree, prompts, mesh, work, tag):
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.convert import params_from_jax
    from repro_torch.core import tsmm
    from repro_torch.distributed import sharding
    from repro_torch.ft import elastic, inject
    from repro_torch.models import model
    from repro_torch.optim import adamw, schedule
    from repro_torch.serve import engine
    from repro_torch.train import train_step

    out, meta = {}, {}
    pol = tsmm.GemmPolicy(**THRESH)
    params = params_from_jax(cfg, tree, device="cpu")
    specs = sharding.make_param_specs(cfg, params, mesh)
    sharding.named(mesh, specs, params)
    meta["wk"] = _places(params.layers[0].attn.wk)
    meta["embed"] = _places(params.embed.table)

    # -- serving -------------------------------------------------------------
    toks = torch.from_numpy(prompts).long()
    out["tokens"] = engine.generate(params, cfg, toks, NEW, policy=pol,
                                    device="cpu", sharded_projections=True)
    prefill, _ = engine.make_serve_fns(cfg, policy=pol)
    cache = model.init_cache(cfg, B, S + NEW, device="cpu", mesh=mesh)
    batch = sharding.named(mesh, sharding.batch_specs(
        cfg, mesh, {"tokens": toks}), {"tokens": toks})
    with tsmm.record_dispatches() as log:
        logits, cache = prefill(params, batch, cache)
    meta["prefill_events"] = sorted(set(harness.port_events(log)))
    out["logits"] = _full(logits)
    meta["cache_k"] = _places(cache[0]["k"])
    meta["batch"] = _places(batch["tokens"])

    # -- training ------------------------------------------------------------
    opt = adamw.AdamWConfig(lr=schedule.linear_warmup_cosine(1e-3, 2, 3),
                            eps=1e-6)
    params.requires_grad_(True)
    state = {"params": params, "opt": adamw.init(opt, params)}
    meta["moment"] = _places(state["opt"]["moments"]["layers.0.attn.wk"]
                             ["m"])
    acc = sharding.named(mesh, specs)
    step = train_step.make_train_step(cfg, opt, n_micro=N_MICRO,
                                      acc_shardings=acc, mesh=mesh)
    losses = []
    for b in _batches():
        tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
        tb = sharding.named(mesh, sharding.batch_specs(cfg, mesh, tb), tb)
        with tsmm.policy(pol):
            state, metrics = step(state, tb)
        losses.append(metrics["loss"])
        meta["metric_kinds"] = sorted({type(v).__name__
                                       for v in metrics.values()})
    out["losses"] = torch.stack(losses)
    out["params"] = {n: _full(p).detach().clone()
                     for n, p in params.named_parameters()}
    meta["wk_after"] = _places(params.layers[0].attn.wk)
    if tag == "1x2":
        out["zero1"], meta["zero1"] = _zero1(cfg, tree, mesh, opt, pol)

    # -- snapshot, checkpoint, restore, poison ---------------------------------
    snap = train_step.host_snapshot(state)
    meta["snap_wk"] = tuple(snap["params.layers.0.attn.wk"].shape)
    ckpt = Checkpointer(str(work / f"ckpt_{tag}"), keep_n=2)
    ckpt.save(7, state)
    ckpt.wait()
    full, saved_step = ckpt.restore()
    meta["ckpt"] = (saved_step, tuple(full["params.layers.0.attn.wk"].shape))
    meta["ckpt_equal"] = torch.equal(full["params.layers.0.attn.wk"],
                                     out["params"]["layers.0.attn.wk"])
    with torch.no_grad():
        for p in params.parameters():
            p.to_local().zero_()
    plan = elastic.rescale_plan(devices=["cpu"] * mesh.size(),
                                model_axis=mesh.shape[1])
    meta["plan"] = (tuple(plan.mesh.shape), plan.mesh.mesh_dim_names)
    state, rstep = elastic.restore_state(ckpt, cfg, plan, state)
    meta["restored_equal"] = all(
        torch.equal(_full(p), out["params"][n])
        for n, p in params.named_parameters())
    for p in params.parameters():
        with torch.no_grad():
            p.to_local().fill_(1.0)
    train_step.restore_snapshot(snap, state)
    meta["snapshot_equal"] = all(
        torch.equal(_full(p), out["params"][n])
        for n, p in params.named_parameters())
    inject.poison_tree(params)
    first = sorted(n for n, _ in params.named_parameters())[0]
    poisoned = _full(dict(params.named_parameters())[first]).detach()
    meta["poison"] = (first, int(torch.isnan(poisoned).sum()),
                      bool(torch.isnan(poisoned.view(-1)[0])))
    return out, meta


def _zero1(cfg, tree, mesh, opt, pol):
    """The same two steps under strategy "dp" with ZeRO-1: parameters
    replicated, moments sharded over the whole mesh (``make_opt_specs(
    zero1=True)``), the update pinned there (``opt_update_specs``)."""
    from repro_torch.convert import params_from_jax
    from repro_torch.core import tsmm
    from repro_torch.distributed import sharding
    from repro_torch.optim import adamw
    from repro_torch.train import train_step

    params = params_from_jax(cfg, tree, device="cpu")
    params.requires_grad_(True)
    specs = sharding.make_param_specs(cfg, params, mesh, strategy="dp")
    opt_specs = sharding.make_opt_specs(specs, mesh=mesh,
                                        params_shape=params, zero1=True)
    sharding.named(mesh, specs, params)
    state = {"params": params, "opt": adamw.init(opt, params)}
    sharding.named(mesh, {"moments": opt_specs["moments"]}, state["opt"])
    update = {n: mv["m"] for n, mv in opt_specs["moments"].items()}
    step = train_step.make_train_step(
        cfg, opt, n_micro=N_MICRO, acc_shardings=sharding.named(mesh, specs),
        mesh=mesh, opt_update_specs=update)
    losses = []
    for b in _batches():
        tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
        tb = sharding.named(mesh, sharding.batch_specs(
            cfg, mesh, tb, strategy="dp"), tb)
        with tsmm.policy(pol):
            state, metrics = step(state, tb)
        losses.append(metrics["loss"])
    moment = state["opt"]["moments"]["layers.0.attn.wk"]["m"]
    return ({"losses": torch.stack(losses),
             "params": {n: _full(p).detach().clone()
                        for n, p in params.named_parameters()}},
            {"moment": _places(moment),
             "param": _places(params.layers[0].attn.wk)})


def port_rank(rank, work):
    from torch.distributed.device_mesh import init_device_mesh

    cfg = registry.get_config("chatglm3-6b", smoke=True)
    with open(work / "params.pkl", "rb") as f:
        tree = pickle.load(f)
    prompts = np.load(work / "inputs.npz")["prompts"]
    from repro_torch.launch import mesh as launch_mesh

    res = {"host_meshes": [
        (tuple(m.shape), m.mesh_dim_names, m.device_type)
        for m in (launch_mesh.make_host_mesh(), launch_mesh.make_host_mesh(
            model=2))]}
    for bad in (lambda: launch_mesh.make_host_mesh(model=3),
                lambda: launch_mesh.make_production_mesh(),
                lambda: launch_mesh.make_production_mesh(multi_pod=True)):
        try:
            bad()
        except ValueError as e:
            res.setdefault("mesh_errors", []).append(str(e))
    for shape in SHAPES:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data",
                                                              "model"))
        tag = "x".join(map(str, shape))
        res[tag] = _port_mesh(cfg, tree, prompts, mesh, work, tag)
    res["sequence_parallel"] = _sequence_parallel(cfg, prompts)
    return res


def _sequence_parallel(cfg, prompts):
    """One kv head on a (1, 2) mesh: the heads cannot split, so the caches
    shard their sequence over "model" (``cache_specs``) and attention
    runs on whole heads. Greedy generation against the same model on
    plain tensors."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import sharding
    from repro_torch.models import model
    from repro_torch.serve import engine

    cfg = dataclasses.replace(cfg, n_kv_heads=1)
    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    plain = model.init(cfg, 3, device="cpu")
    params = model.init(cfg, 3, device="cpu")
    sharding.named(mesh, sharding.make_param_specs(cfg, params, mesh),
                   params)
    toks = torch.from_numpy(prompts).long()
    cache = model.init_cache(cfg, B, S + NEW, device="cpu", mesh=mesh)
    return {"cache_k": _places(cache[0]["k"]),
            "tokens": engine.generate(params, cfg, toks, NEW, device="cpu"),
            "want": engine.generate(plain, cfg, toks, NEW, device="cpu")}


# ---------------------------------------------------------------------------
# The JAX package's side, on two host devices
# ---------------------------------------------------------------------------

JAX_SCRIPT = harness.JAX_PRELUDE + r"""
import pickle

from repro.configs import registry
from repro.data import pipeline
from repro.distributed import sharding
from repro.models import model
from repro.optim import adamw, schedule
from repro.serve import engine
from repro.train import train_step as ts

B, S, NEW, STEPS, N_MICRO = %d, %d, %d, %d, %d
THRESH = %r
DATA = %r
cfg = registry.get_config("chatglm3-6b", smoke=True)
with open(WORK + "/params.pkl", "rb") as f:
    tree = pickle.load(f)
pol = tsmm.GemmPolicy(**THRESH)
prompts = INP["prompts"]
for shape in ((1, 2), (2, 1)):
    tag = "x".join(map(str, shape))
    m = Mesh(np.array(devs).reshape(shape), ("data", "model"))
    p_named = sharding.named(m, sharding.make_param_specs(cfg, tree, m))
    params = jax.device_put(jax.tree.map(jnp.asarray, tree), p_named)
    with m:
        OUT[tag + "/tokens"] = engine.generate(
            params, cfg, prompts, NEW, policy=pol, sharded_projections=True)
        prefill, _ = engine.make_serve_fns(cfg, policy=pol)
        with tsmm.record_dispatches() as log:
            OUT[tag + "/logits"], _ = jax.jit(prefill)(
                params, {"tokens": prompts},
                model.init_cache(cfg, B, S + NEW))
        REC[tag] = events(log)
    opt = adamw.AdamWConfig(lr=schedule.linear_warmup_cosine(1e-3, 2, 3),
                            eps=1e-6)
    state = {"params": params, "opt": adamw.init(opt, params)}
    step = jax.jit(ts.make_train_step(cfg, opt, n_micro=N_MICRO,
                                      acc_shardings=p_named, mesh=m))
    losses = []
    for i in range(STEPS):
        b = pipeline.batch_for_step(pipeline.DataConfig(**DATA), i)
        with m, tsmm.policy(pol):
            state, met = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(met["loss"])
    OUT[tag + "/losses"] = jnp.stack(losses)
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            state["params"])[0]:
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        OUT[tag + "/params/" + key] = leaf
save()
""" % (B, S, NEW, STEPS, N_MICRO, THRESH, DATA)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from repro.configs import registry as jregistry
    from repro.models import model as jmodel

    work = tmp_path_factory.mktemp("mesh")
    jcfg = jregistry.get_config("chatglm3-6b", smoke=True)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    seg = tree["segments"][0]
    for key in ("bq", "bk", "bv"):
        seg["attn"][key] = rng.normal(0, 0.1, seg["attn"][key].shape
                                      ).astype(np.float32)
    for norm in (seg["norm1"], seg["norm2"], tree["final_norm"]):
        norm["scale"] = (1 + rng.normal(0, 0.1, norm["scale"].shape)
                         ).astype(np.float32)
    with open(work / "params.pkl", "wb") as f:
        pickle.dump(tree, f)
    prompts = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    ranks, arrays, record = harness.run_both(port_rank, JAX_SCRIPT,
                                             {"prompts": prompts}, work,
                                             timeout=400)
    return types.SimpleNamespace(ranks=ranks, jax=arrays, rec=record)


def _tags():
    return ["x".join(map(str, s)) for s in SHAPES]


def test_host_and_production_meshes(runs):
    for r in runs.ranks:
        assert r["host_meshes"] == [((2, 1), ("data", "model"), "cpu"),
                                    ((1, 2), ("data", "model"), "cpu")]
        errs = r["mesh_errors"]
        assert len(errs) == 3 and "model axis of 3" in errs[0]
        assert "does not fill 1 pod(s) of 8-GPU nodes" in errs[1]
        assert "does not fill 2 pod(s)" in errs[2]


def test_meshes_need_a_process_group():
    from repro_torch.launch import mesh as launch_mesh
    with pytest.raises(RuntimeError, match=r"\[mesh\] no process group"):
        launch_mesh.make_host_mesh()
    with pytest.raises(RuntimeError, match=r"\[mesh\] no process group"):
        launch_mesh.make_production_mesh(multi_pod=True)


def test_zero1_steps_equal_tensor_parallel_ones(runs):
    """ZeRO-1 changes where the update runs, not what it computes."""
    for r in runs.ranks:
        out, meta = r["1x2"]
        z, zmeta = out["zero1"], meta["zero1"]
        assert zmeta["param"] == ["Replicate()", "Replicate()"]
        assert zmeta["moment"] in (["Shard(dim=0)", "Shard(dim=0)"],
                                   ["Shard(dim=1)", "Shard(dim=1)"])
        torch.testing.assert_close(z["losses"], out["losses"], **TOL)
        for name, p in z["params"].items():
            torch.testing.assert_close(p, out["params"][name], **TOL)


def test_sequence_parallel_cache_serves_as_plain(runs):
    for r in runs.ranks:
        sp = r["sequence_parallel"]
        assert sp["cache_k"] == ["Shard(dim=0)", "Shard(dim=1)"]
        assert torch.equal(sp["tokens"], sp["want"])


@pytest.mark.parametrize("tag", _tags())
def test_serve_tokens_and_logits_as_jax(runs, tag):
    for out, _ in (r[tag] for r in runs.ranks):
        np.testing.assert_array_equal(out["tokens"].numpy(),
                                      runs.jax[tag + "/tokens"])
        np.testing.assert_allclose(out["logits"].numpy(),
                                   runs.jax[tag + "/logits"], **TOL)


@pytest.mark.parametrize("tag,executors", [
    ("1x2", {"shard_map", "pallas-tpu"}),     # wk / wv per shard
    ("2x1", {"dense-xla"})])    # a shard's [48,64]x[64,32] is not skinny
def test_prefill_routes_as_jax(runs, tag, executors):
    want = sorted(set(harness.jax_events(runs.rec[tag])))
    for _, meta in (r[tag] for r in runs.ranks):
        assert meta["prefill_events"] == want
    assert {e[2] for e in want if e[1] == "tsm2r"} == executors


@pytest.mark.parametrize("tag", _tags())
def test_train_losses_as_jax(runs, tag):
    want = runs.jax[tag + "/losses"]
    for out, _ in (r[tag] for r in runs.ranks):
        np.testing.assert_allclose(out["losses"].numpy(), want, **TOL)
    # the two meshes group the microbatches alike
    other = [t for t in _tags() if t != tag][0]
    np.testing.assert_allclose(want, runs.jax[other + "/losses"], **TOL)


def _jax_leaf(runs, tag, name):
    from repro_torch import layout
    path, idx = layout.jax_path(name)
    arr = runs.jax[f"{tag}/params/{path}"]
    return arr[idx] if idx else arr


@pytest.mark.parametrize("tag", _tags())
def test_train_parameters_as_jax(runs, tag):
    for out, _ in (r[tag] for r in runs.ranks):
        for name, p in out["params"].items():
            np.testing.assert_allclose(p.numpy(), _jax_leaf(runs, tag, name),
                                       err_msg=name, **TOL)


@pytest.mark.parametrize("tag,wk,embed,cache,batch", [
    ("1x2", ["Replicate()", "Shard(dim=1)"], ["Replicate()", "Shard(dim=0)"],
     ["Shard(dim=0)", "Shard(dim=2)"], ["Shard(dim=0)", "Replicate()"]),
    ("2x1", ["Replicate()", "Shard(dim=1)"], ["Replicate()", "Shard(dim=0)"],
     ["Shard(dim=0)", "Shard(dim=2)"], ["Shard(dim=0)", "Replicate()"])])
def test_placements_follow_the_specs(runs, tag, wk, embed, cache, batch):
    for _, meta in (r[tag] for r in runs.ranks):
        assert meta["wk"] == meta["wk_after"] == meta["moment"] == wk
        assert meta["embed"] == embed
        assert meta["cache_k"] == cache
        assert meta["batch"] == batch
        assert meta["metric_kinds"] in (["Tensor"], ["Tensor", "float"])


@pytest.mark.parametrize("tag", _tags())
def test_snapshot_checkpoint_restore_and_poison(runs, tag):
    cfg = registry.get_config("chatglm3-6b", smoke=True)
    kv = cfg.n_kv_heads * cfg.resolved_head_dim
    shape = tuple(int(x) for x in tag.split("x"))
    for _, meta in (r[tag] for r in runs.ranks):
        # a snapshot holds the rank's shard; a checkpoint the full leaf
        assert meta["snap_wk"] == (cfg.d_model, kv // shape[1])
        assert meta["ckpt"] == (7, (cfg.d_model, kv))
        assert meta["ckpt_equal"] and meta["restored_equal"]
        assert meta["snapshot_equal"]
        assert meta["plan"] == (shape, ("data", "model"))
        name, nans, origin = meta["poison"]
        assert name == "embed.table" and nans == 1 and origin
