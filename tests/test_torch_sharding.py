"""The port's partition rules against the JAX package's, on the CPU.

Spec logic runs on device-free meshes of the reference's production sizes
(16 x 16 and 2 x 16 x 16): ``sharding.abstract_mesh`` here, the JAX
package's ``AbstractMesh`` there. Every comparison is entry for entry:
a JAX leaf of a segment is stacked on leading layer axes, and the port's
spec of one layer's tensor must equal the JAX spec without them (which
must be replicated).

* parameters: for each ported config at full size (the port's ``LM`` on
  the meta device against ``jax.eval_shape``), ``make_param_specs`` under
  "tp" (qwen2-72b, mixtral-8x7b and deepseek-v3-671b past
  ``FSDP_THRESHOLD``: FSDP over "data") and "dp";
* optimizer state: ``make_opt_specs`` with and without ``zero1``;
* ``batch_specs`` (tokens, hubert's frames, llama-3.2-vision's image
  embeddings) and ``cache_specs`` (the caches on the meta device; the
  vision model's cross caches beside its self-attention ones);
* the reference's six ``tests/test_sharding_rules.py`` cases, as cases of
  one parametrised test, on the JAX configs' shapes (their leaves named
  as the port names a layer, ``layers.0.<leaf>`` and ``tail.0.<leaf>``),
  the divisibility guard (hubert's vocab of 504 on a 16-wide "model") on
  the port's own hubert ``LM``;
* DTensor placements of specs, and the identities off a mesh.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import registry as jregistry
from repro.distributed import sharding as jsharding
from repro.models import model as jmodel
from repro_torch.configs import registry
from repro_torch.distributed import sharding
from repro_torch.models import model

PORTED = ["zamba2-1.2b", "chatglm3-6b", "llama3.2-3b", "mistral-nemo-12b",
          "qwen2-72b", "deepseek-v3-671b", "mixtral-8x7b", "rwkv6-1.6b",
          "llama-3.2-vision-11b", "hubert-xlarge"]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    sizes, names = MESHES[name]
    return (sharding.abstract_mesh(sizes, names),
            jsharding.abstract_mesh(sizes, names))


def _full(spec, ndim) -> tuple:
    """A JAX PartitionSpec as a tuple of ``ndim`` entries."""
    t = tuple(spec)
    return t + (None,) * (ndim - len(t))


def _jax_flat(tree):
    return {jsharding.path_str(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))[0]}


def _jax_shapes(arch):
    jcfg = jregistry.get_config(arch)
    return jcfg, jax.eval_shape(lambda k: jmodel.init(k, jcfg),
                                jax.random.PRNGKey(0))


def _strip(jspec, jshape, shape) -> tuple:
    """The JAX spec of a stacked leaf without its stacked axes, which must
    be replicated."""
    full = _full(jspec, len(jshape))
    k = len(jshape) - len(shape)
    assert full[:k] == (None,) * k, (jspec, jshape, shape)
    return full[k:]


def _compare(port_specs, port_shapes, jspecs, jshapes):
    """Every port leaf's spec equals its JAX leaf's, stacked axes
    stripped; every JAX leaf has a port leaf."""
    seen = set()
    for name, spec in port_specs.items():
        path = sharding.path_str(name)
        seen.add(path)
        assert spec == _strip(jspecs[path], jshapes[path].shape,
                              port_shapes[name]), name
    assert seen == set(jspecs)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("strategy", ["tp", "dp"])
@pytest.mark.parametrize("arch", PORTED)
def test_param_specs_equal_jax(arch, strategy, mesh_name):
    mesh, jmesh = _meshes(mesh_name)
    cfg = registry.get_config(arch)
    lm = model.LM(cfg, device="meta")
    jcfg, jshapes = _jax_shapes(arch)
    specs = sharding.make_param_specs(cfg, lm, mesh, strategy=strategy)
    jspecs = _jax_flat(jsharding.make_param_specs(jcfg, jshapes, jmesh,
                                                  strategy=strategy))
    shapes = {n: tuple(p.shape) for n, p in lm.named_parameters()}
    _compare(specs, shapes, jspecs, _jax_flat(jshapes))
    used = {a for s in specs.values() for a in s if a is not None}
    if strategy == "dp":
        assert not used
    elif cfg.param_count() > sharding.FSDP_THRESHOLD:   # qwen2-72b,
        # mixtral's 46.7B and deepseek's 671B: FSDP over "data"
        assert used == {"data", "model"}
    else:
        assert used == {"model"}


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("zero1", [False, True])
@pytest.mark.parametrize("arch", PORTED)
def test_opt_specs_equal_jax(arch, zero1, mesh_name):
    mesh, jmesh = _meshes(mesh_name)
    cfg = registry.get_config(arch)
    lm = model.LM(cfg, device="meta")
    jcfg, jshapes = _jax_shapes(arch)
    strategy = "dp" if zero1 else "tp"
    p_specs = sharding.make_param_specs(cfg, lm, mesh, strategy=strategy)
    jp = jsharding.make_param_specs(jcfg, jshapes, jmesh, strategy=strategy)
    opt = sharding.make_opt_specs(p_specs, mesh=mesh, params_shape=lm,
                                  zero1=zero1)
    jopt = jsharding.make_opt_specs(jp, mesh=jmesh, params_shape=jshapes,
                                    zero1=zero1)
    assert opt["step"] == () and tuple(jopt["step"]) == ()
    jflat = _jax_flat(jopt["moments"])
    jsh = _jax_flat(jshapes)
    shapes = {n: tuple(p.shape) for n, p in lm.named_parameters()}
    for field in ("m", "v"):
        _compare({n: mv[field] for n, mv in opt["moments"].items()}, shapes,
                 {k[:-2]: v for k, v in jflat.items()
                  if k.endswith("/" + field)}, jsh)
    if zero1:
        all_axes = MESHES[mesh_name][1]
        assert any(all_axes in mv["m"] for mv in opt["moments"].values())


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", PORTED)
def test_cache_specs_equal_jax(arch, mesh_name):
    mesh, jmesh = _meshes(mesh_name)
    cfg = registry.get_config(arch)
    jcfg = jregistry.get_config(arch)
    b, s = 128, 1024
    cache = model.init_cache(cfg, b, s, device="meta")
    specs = sharding.cache_specs(cfg, mesh, cache)
    jshape = jax.eval_shape(lambda: jmodel.init_cache(jcfg, b, s))
    jspecs = _jax_flat(jsharding.cache_specs(jcfg, jmesh, jshape))
    want = {}
    for path, leaf in _jax_flat(jshape).items():
        name = path.rsplit("/", 1)[-1]
        per_layer = 3 if name in ("conv", "tm_prev", "cm_prev", "c",
                                  "kpe") else 4
        shape = tuple(leaf.shape[len(leaf.shape) - per_layer:])
        want[(name, shape)] = _strip(jspecs[path], leaf.shape, shape)
    got = {(name, tuple(t.shape)): spec[name]
           for entry, spec in zip(cache, specs) for name, t in entry.items()}
    assert got == want


@pytest.mark.parametrize("strategy", ["tp", "dp"])
@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("batch", [256, 32, 1])
def test_batch_specs_equal_jax(batch, mesh_name, strategy):
    mesh, jmesh = _meshes(mesh_name)
    cfg = registry.get_config("llama3.2-3b")
    jcfg = jregistry.get_config("llama3.2-3b")
    shapes = {"tokens": torch.empty((batch, 128), device="meta"),
              "targets": torch.empty((batch, 128), device="meta")}
    jb = {k: jax.ShapeDtypeStruct((batch, 128), jnp.int32) for k in shapes}
    got = sharding.batch_specs(cfg, mesh, shapes, strategy=strategy)
    want = jsharding.batch_specs(jcfg, jmesh, jb, strategy=strategy)
    assert got == {k: _full(v, 2) for k, v in want.items()}


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("batch", [256, 32, 1])
def test_frame_batch_specs_equal_jax(batch, mesh_name):
    """hubert's batch: (B, S, frame_dim) f32 frames beside int targets."""
    mesh, jmesh = _meshes(mesh_name)
    cfg = registry.get_config("hubert-xlarge")
    jcfg = jregistry.get_config("hubert-xlarge")
    shapes = {"frames": torch.empty((batch, 128, 512), device="meta"),
              "targets": torch.empty((batch, 128), device="meta")}
    jb = {"frames": jax.ShapeDtypeStruct((batch, 128, 512), jnp.float32),
          "targets": jax.ShapeDtypeStruct((batch, 128), jnp.int32)}
    got = sharding.batch_specs(cfg, mesh, shapes)
    want = jsharding.batch_specs(jcfg, jmesh, jb)
    assert got == {k: _full(v, len(shapes[k].shape))
                   for k, v in want.items()}


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("batch", [256, 32, 1])
def test_image_batch_specs_equal_jax(batch, mesh_name):
    """llama-3.2-vision's batch: (B, 1601, 4096) f32 image embeddings
    beside int tokens and targets."""
    mesh, jmesh = _meshes(mesh_name)
    cfg = registry.get_config("llama-3.2-vision-11b")
    jcfg = jregistry.get_config("llama-3.2-vision-11b")
    img = (batch, cfg.vision_seq, cfg.vision_dim)
    shapes = {"tokens": torch.empty((batch, 128), device="meta"),
              "targets": torch.empty((batch, 128), device="meta"),
              "image_embeds": torch.empty(img, device="meta")}
    jb = {"tokens": jax.ShapeDtypeStruct((batch, 128), jnp.int32),
          "targets": jax.ShapeDtypeStruct((batch, 128), jnp.int32),
          "image_embeds": jax.ShapeDtypeStruct(img, jnp.float32)}
    got = sharding.batch_specs(cfg, mesh, shapes)
    want = jsharding.batch_specs(jcfg, jmesh, jb)
    assert got == {k: _full(v, len(shapes[k].shape))
                   for k, v in want.items()}


# ---------------------------------------------------------------------------
# The reference's six rule cases, on the JAX configs' shapes
# ---------------------------------------------------------------------------

def _port_named(jshapes) -> dict:
    """The JAX leaves of a dense or MoE arch as the port names one layer's
    tensors: ``segments/0/x`` -> ``layers.0.x``, ``segments/1/x`` ->
    ``tail.0.x`` (one stacked axis dropped)."""
    out = {}
    for path, leaf in _jax_flat(jshapes).items():
        parts = path.split("/")
        if parts[0] == "segments":
            head = "layers" if parts[1] == "0" else "tail"
            out[".".join([head, "0", *parts[2:]])] = tuple(leaf.shape[1:])
        else:
            out[".".join(parts)] = tuple(leaf.shape)
    return out


def _rule_specs(arch, mesh_name="16x16", **kw):
    """Port and JAX specs for one arch, compared entry for entry; returns
    the port's by JAX path."""
    mesh, jmesh = _meshes(mesh_name)
    jcfg, jshapes = _jax_shapes(arch)
    shapes = _port_named(jshapes)
    # The rules read only param_count() of the config.
    specs = sharding.make_param_specs(jcfg, shapes, mesh, **kw)
    jspecs = _jax_flat(jsharding.make_param_specs(jcfg, jshapes, jmesh,
                                                  **kw))
    _compare(specs, shapes, jspecs, _jax_flat(jshapes))
    return {sharding.path_str(n): s for n, s in specs.items()}, shapes


def _case_dense_tp():
    flat, _ = _rule_specs("llama3.2-3b")
    assert flat["segments/0/attn/wq"][-1] == "model"
    assert flat["segments/0/attn/wo"][-2] == "model"
    assert flat["embed/table"][0] == "model"
    assert all(a is None for a in flat["segments/0/norm1/scale"])


def _case_divisibility_guard():
    mesh, jmesh = _meshes("16x16")
    cfg = registry.get_config("hubert-xlarge")
    lm = model.LM(cfg, device="meta")
    jcfg, jshapes = _jax_shapes("hubert-xlarge")
    specs = sharding.make_param_specs(cfg, lm, mesh)
    _compare(specs, {n: tuple(p.shape) for n, p in lm.named_parameters()},
             _jax_flat(jsharding.make_param_specs(jcfg, jshapes, jmesh)),
             _jax_flat(jshapes))
    flat = {sharding.path_str(n): s for n, s in specs.items()}
    assert flat["embed/table"][0] is None      # vocab 504 % 16 != 0
    assert flat["lm_head/table"][0] is None
    assert flat["segments/0/ffn/w_up"][-1] == "model"
    assert flat["frame_proj/w"] == (None, "model")
    assert flat["segments/0/ffn/b_up"] == ("model",)
    assert flat["segments/0/ffn/b_down"] == (None,)


def _case_moe_ep_vs_tp_fallback():
    flat, _ = _rule_specs("deepseek-v3-671b")   # 256 experts: EP
    k = [p for p in flat if p.endswith("experts/w_gate")][0]
    assert flat[k][-3] == "model" and flat[k][-2] == "data"   # + FSDP
    flat2, _ = _rule_specs("mixtral-8x7b")      # 8 experts < 16: TP
    k2 = [p for p in flat2 if p.endswith("experts/w_gate")][0]
    assert flat2[k2][-3] is None and flat2[k2][-1] == "model"


def _case_dp_strategy_zero1():
    mesh, jmesh = _meshes("16x16")
    cfg = registry.get_config("llama3.2-3b")
    lm = model.LM(cfg, device="meta")
    specs = sharding.make_param_specs(cfg, lm, mesh, strategy="dp")
    assert all(all(a is None for a in s) for s in specs.values())
    opt = sharding.make_opt_specs(specs, mesh=mesh, params_shape=lm,
                                  zero1=True)
    mk = [n for n in opt["moments"] if n.endswith("attn.wq")][0]
    assert ("data", "model") in opt["moments"][mk]["m"]


def _case_cache_sequence_parallel():
    mesh, _ = _meshes("16x16")
    cfg = registry.get_config("qwen2-72b")      # kv 8 < 16: SP on seq
    specs = sharding.cache_specs(cfg, mesh, model.init_cache(
        cfg, 128, 1024, device="meta"))
    assert specs[0]["k"][-3] == "model" and specs[0]["k"][-2] is None


def _case_batch_multi_pod():
    mesh, _ = _meshes("2x16x16")
    cfg = registry.get_config("llama3.2-3b")
    spec = sharding.batch_specs(
        cfg, mesh, {"tokens": torch.empty((256, 128), device="meta")})
    assert spec["tokens"][0] == ("pod", "data")
    spec1 = sharding.batch_specs(
        cfg, mesh, {"tokens": torch.empty((1, 1), device="meta")})
    assert spec1["tokens"][0] is None


@pytest.mark.parametrize("case", [
    _case_dense_tp, _case_divisibility_guard, _case_moe_ep_vs_tp_fallback,
    _case_dp_strategy_zero1, _case_cache_sequence_parallel,
    _case_batch_multi_pod], ids=lambda f: f.__name__[6:])
def test_reference_rule_cases(case):
    case()


def test_fsdp_forced_either_way_equals_jax():
    for fsdp in (True, False):
        flat, _ = _rule_specs("llama3.2-3b", fsdp=fsdp)
        assert (flat["segments/0/attn/wq"][-2] == "data") is fsdp


# ---------------------------------------------------------------------------
# Placements and the identities off a mesh
# ---------------------------------------------------------------------------

def test_dp_axes_equal_jax():
    for name in MESHES:
        mesh, jmesh = _meshes(name)
        assert sharding.dp_axes(mesh) == tuple(jsharding.dp_axes(jmesh))


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    mesh, _ = _meshes("2x16x16")
    assert sharding.placements(mesh, (None, "model")) == [
        Replicate(), Replicate(), Shard(1)]
    assert sharding.placements(mesh, (("pod", "data"), None)) == [
        Shard(0), Shard(0), Replicate()]
    assert sharding.placements(mesh, ("model", "data")) == [
        Replicate(), Shard(1), Shard(0)]
    with pytest.raises(ValueError, match="mesh order"):
        sharding.placements(mesh, (("data", "pod"),))
    with pytest.raises(ValueError, match="twice"):
        sharding.placements(mesh, ("model", "model"))
    with pytest.raises(ValueError, match="mesh has"):
        sharding.placements(_meshes("16x16")[0], ("pod",))


def test_named_spec_tree_gives_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh, _ = _meshes("16x16")
    tree = {"a": ("data", None), "b": [(None, "model"), ()]}
    assert sharding.named(mesh, tree) == {
        "a": [Shard(0), Replicate()],
        "b": [[Replicate(), Shard(1)], [Replicate(), Replicate()]]}


def test_plain_tensors_pass_through():
    x = torch.ones(4, 8)
    assert sharding.maybe_wsc(x, "data", "model") is x
    assert sharding.maybe_wsc_spec(x, ("data",)) is x
    assert sharding.replicate_dim(x, -1) is x
    assert not sharding.on_mesh(x)
    with sharding.replicate_constants(x):     # no DTensor: no-op
        assert torch.equal(x + 1, torch.full((4, 8), 2.0))
