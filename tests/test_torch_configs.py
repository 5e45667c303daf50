"""The port's configs against the JAX package's, on the CPU.

* Full size, allocating nothing: for each ported config the JAX parameter
  tree comes from ``jax.eval_shape`` of ``model.init``, the port's ``LM``
  is built on the meta device, and every JAX leaf must have its port
  counterpart with the same stacked shape and dtype (``params_from_jax``
  casts each leaf to the port's dtype, so only this test would see a
  dtype that differs). ``param_count`` / ``active_param_count`` and the
  cell skip matrix must equal the reference's, and PowerSGD's default
  ``min_size`` must pick the reference's leaves (for rwkv6 ``embed`` and
  ``lm_head`` only; for zamba2 those and the shared block's seven
  matrices). zamba2's leaves stacked twice (``(6, 6, ...)``) are held
  with the rest, and its dtypes leaf by leaf (bf16 mixer norm, f32
  ``A_log`` / ``D`` / ``dt_bias`` and block norms).
* Smoke size: llama3.2-3b (tied embeddings), mistral-nemo-12b (head_dim
  != d_model / n_heads) and qwen2-72b (QKV bias) forward and greedy
  generate against JAX from the JAX parameters (biases and norm scales
  perturbed), f32, rtol = atol = 1e-4 as ``tests/test_torch_serve.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import model as jmodel
from repro.optim import powersgd as jpowersgd
from repro.serve import engine as jengine
from repro_torch import layout
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.convert import params_from_jax
from repro_torch.models import model
from repro_torch.optim import powersgd
from repro_torch.serve import engine

PORTED = ["zamba2-1.2b", "chatglm3-6b", "llama3.2-3b", "mistral-nemo-12b",
          "qwen2-72b", "deepseek-v3-671b", "mixtral-8x7b", "rwkv6-1.6b"]
DENSE_NEW = ["llama3.2-3b", "mistral-nemo-12b", "qwen2-72b"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _jax_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = leaf
    return out


def test_registry_lists_the_ported_archs_in_reference_order():
    assert registry.ARCH_NAMES == PORTED
    assert [a for a in jregistry.ARCH_NAMES if a in PORTED] == PORTED
    with pytest.raises(KeyError, match="not ported yet"):
        registry.get_config("hubert-xlarge")


@pytest.mark.parametrize("arch", PORTED)
def test_full_size_layout_shapes_and_dtypes(arch):
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    shapes = jax.eval_shape(lambda k: jmodel.init(k, jcfg),
                            jax.random.PRNGKey(0))
    want = _jax_leaves(shapes)
    lm = model.LM(cfg, device="meta")
    named = dict(lm.named_parameters())
    groups = layout.jax_leaves(named)
    assert sorted(groups) == sorted(want)
    for path, names in groups.items():
        assert layout.jax_shape(named, names) == tuple(want[path].shape), path
        dtypes = {str(named[n].dtype)[6:] for n in names}
        assert dtypes == {str(want[path].dtype)}, path
    n = sum(p.numel() for p in lm.parameters())
    assert n == sum(int(np.prod(s.shape)) for s in want.values())


@pytest.mark.parametrize("arch", PORTED)
def test_param_counts_are_the_references(arch):
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    small, jsmall = (registry.get_config(arch, smoke=True),
                     jregistry.get_config(arch, smoke=True))
    assert small.param_count() == jsmall.param_count()


def test_rwkv6_param_count_value():
    # 1.58 B by the reference's formula, which leaves out the per-channel
    # leaves (mu, w0, u, the norms: 15 x 2048 a layer, and the final
    # norm's 2 x 2048), all of which the model holds.
    cfg = registry.get_config("rwkv6-1.6b")
    assert cfg.param_count() == 1_583_349_760
    lm = model.LM(cfg, device="meta")
    assert sum(p.numel() for p in lm.parameters()) == (
        1_583_349_760 + 24 * 15 * 2048 + 2 * 2048)


def test_cells_are_the_references():
    for arch in PORTED:
        for shape in SHAPES:
            assert (registry.cell_supported(arch, shape)
                    == jregistry.cell_supported(arch, shape))
    want = [c for c in jregistry.all_cells(include_skipped=True)
            if c[0] in PORTED]
    assert list(registry.all_cells(include_skipped=True)) == want
    assert list(registry.all_cells()) == [c for c in want if c[2]]
    assert registry.cell_supported("rwkv6-1.6b", "long_500k") == (True, "")
    assert not registry.cell_supported("qwen2-72b", "long_500k")[0]


def test_zamba2_param_count_value_and_leaves():
    """1,169,424,384 by the reference's formula, which leaves out the conv
    and the per-channel leaves (``conv_w``, the norms, ``conv_b``,
    ``A_log``, ``D``, ``dt_bias``: 27,456 a Mamba2 layer; the shared
    block's two norms and the final norm) and the per-group LoRAs (6 x 2
    x 2 x 2048 x 128), all of which the model holds; and the stacked
    shapes and dtypes of the leaves that differ by kind."""
    cfg = registry.get_config("zamba2-1.2b")
    assert cfg.param_count() == 1_169_424_384
    lm = model.LM(cfg, device="meta")
    named = dict(lm.named_parameters())
    per_layer = 2048 + 4224 + 3 * 64 + 4096 + 4 * 4224
    assert sum(p.numel() for p in lm.parameters()) == (
        1_169_424_384 + 38 * per_layer + 3 * 2048 + 6 * 2 * 2 * 2048 * 128)
    groups = layout.jax_leaves(named)

    def leaf(path):
        names = groups[path]
        return layout.jax_shape(named, names), named[names[0]].dtype

    bf16, f32 = torch.bfloat16, torch.float32
    assert leaf("segments.0.mamba.mixer.in_proj") == ((6, 6, 2048, 8384),
                                                       bf16)
    assert leaf("segments.0.mamba.mixer.norm.scale") == ((6, 6, 4096), bf16)
    for key in ("A_log", "D", "dt_bias"):
        assert leaf(f"segments.0.mamba.mixer.{key}") == ((6, 6, 64), f32)
        assert leaf(f"segments.1.mixer.{key}") == ((2, 64), f32)
    assert leaf("segments.0.mamba.norm1.scale") == ((6, 6, 2048), f32)
    assert leaf("segments.0.lora_attn.a") == ((6, 2048, 128), bf16)
    assert leaf("shared_block.norm2.scale") == ((2048,), f32)
    assert leaf("shared_block.ffn.w_down") == ((8192, 2048), bf16)


@pytest.mark.parametrize("arch", PORTED)
def test_powersgd_default_compresses_the_references_leaves(arch):
    """At full width and the default ``min_size`` the port picks the JAX
    package's leaves (``jax.eval_shape`` of its ``powersgd.init``). For
    rwkv6 that is ``embed`` and ``lm_head`` alone: its stacked per-layer
    vectors, ``(24, 2048)`` = 49,152 in the JAX layout, stay under 65,536,
    and the 3-D leaves never compress; the dense configs' 28 to 80 layers
    put their stacked norm scales and biases over it."""
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    shapes = jax.eval_shape(lambda k: jmodel.init(k, jcfg),
                            jax.random.PRNGKey(0))
    jstate = jax.eval_shape(lambda: jpowersgd.init(
        jpowersgd.PowerSGDConfig(rank=4), shapes, jax.random.PRNGKey(0)))
    want = sorted({k.rsplit(".", 1)[0] for k in _jax_leaves(jstate)})
    lm = model.LM(cfg, device="meta")
    got = powersgd.compressible(powersgd.PowerSGDConfig(rank=4), lm)
    assert sorted(got) == want
    if arch == "rwkv6-1.6b":
        assert want == ["embed.table", "lm_head.table"]
    if arch == "zamba2-1.2b":
        assert want == ["embed.table", "lm_head.table", *(
            f"shared_block.{k}" for k in ("attn.wk", "attn.wo", "attn.wq",
                                          "attn.wv", "ffn.w_down",
                                          "ffn.w_gate", "ffn.w_up"))]


@pytest.fixture(scope="module", params=DENSE_NEW)
def dense_setup(request):
    arch = request.param
    cfg = registry.get_config(arch, smoke=True)
    jcfg = jregistry.get_config(arch, smoke=True)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1), jcfg))
    rng = np.random.default_rng(1)
    seg = tree["segments"][0]
    if cfg.qkv_bias:
        for key in ("bq", "bk", "bv"):
            seg["attn"][key] = rng.normal(0, 0.1, seg["attn"][key].shape
                                          ).astype(np.float32)
    for norm in (seg["norm1"], seg["norm2"], tree["final_norm"]):
        norm["scale"] = (1 + rng.normal(0, 0.1, norm["scale"].shape)
                         ).astype(np.float32)
    prompts = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    return (cfg, jcfg, jax.tree.map(jnp.asarray, tree),
            params_from_jax(cfg, tree, device="cpu"), prompts)


def test_dense_config_forward_matches_jax(dense_setup):
    cfg, jcfg, jparams, params, prompts = dense_setup
    jlogits, _ = jmodel.forward(jparams, jcfg,
                                {"tokens": jnp.asarray(prompts)})
    logits, _ = model.forward(params, cfg,
                              {"tokens": torch.from_numpy(prompts).long()})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert hasattr(params, "lm_head") != cfg.tie_embeddings


def test_dense_config_generate_matches_jax(dense_setup):
    cfg, jcfg, jparams, params, prompts = dense_setup
    jout = jengine.generate(jparams, jcfg, jnp.asarray(prompts), 4)
    out = engine.generate(params, cfg, torch.from_numpy(prompts).long(), 4,
                          device="cpu")
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
