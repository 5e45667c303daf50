"""hubert-xlarge's smoke config served by the PyTorch port against the JAX
package, on the CPU.

Both sides start from the JAX package's initial parameters, carried
across by ``repro_torch.convert.params_from_jax``, with every leaf that
starts constant perturbed first (the GELU MLP's ``b_up`` / ``b_down`` and
the block and final LayerNorms' scales and biases), so a dropped term
shows. The frames are seeded f32 numpy arrays of a length that is not a
multiple of ``q_chunk`` (the last query and key chunks are short). f32
throughout, at rtol = atol = 1e-4 (``tests/test_torch_serve.py``'s
tolerance):

* ``forward`` logits (every frame's: the reference's encode step),
  ``forward_hidden`` and ``prefill``'s last-frame logits and K/V caches
  against the JAX package's; the encoder is bidirectional (a change to
  the last frame moves the first frame's logits), and every projection of
  a forward routes dense in both packages;
* ``gelu_mlp`` against the reference's, which takes ``jax.nn.gelu``'s
  tanh form; the erf form misses it;
* non-causal ``chunked_attention`` at head_dim 80 (hubert's) against
  JAX's;
* a bf16 model fed f32 frames runs f32 activations in both packages;
* ``param_count`` is the reference's 945,008,640, and the model holds
  946,219,520 parameters (the formula leaves out ``frame_proj``, the
  biases and the norms);
* on the full-size shapes, allocating nothing, the classifier under the
  default policy sends the 289 projections of a 4 x 2,048-frame forward
  dense, and the offline ABFT tree check's checksum products of each
  ``ffn.w_down`` leaf to tsmt at S = 1 (every other leaf dense): what
  ``chip_smoke.py``'s hubert phases hold the card to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import registry as jregistry
from repro.core import tsmm as jtsmm
from repro.models import attention as jattention
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.core import tsmm
from repro_torch.ft import abft, named_leaves
from repro_torch.kernels import ops
from repro_torch.models import attention, layers, model

ARCH = "hubert-xlarge"
B, S = 3, 40           # 40 frames: q_chunk = kv_chunk = 16 leave 8 over
TOL = dict(rtol=1e-4, atol=1e-4)


def perturb(tree, rng):
    """Every leaf of the hubert tree that starts constant, from ``rng``."""
    seg = tree["segments"][0]
    for key in ("b_up", "b_down"):
        seg["ffn"][key] = rng.normal(0, 0.1, seg["ffn"][key].shape
                                     ).astype(seg["ffn"][key].dtype)
    for norm in (seg["norm1"], seg["norm2"], tree["final_norm"]):
        norm["scale"] = (1 + rng.normal(0, 0.1, norm["scale"].shape)
                         ).astype(np.float32)
        norm["bias"] = rng.normal(0, 0.1, norm["bias"].shape
                                  ).astype(np.float32)
    return tree


def frames(cfg, rng, b=B, s=S):
    return rng.standard_normal((b, s, cfg.frame_dim)).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    cfg = registry.get_config(ARCH, smoke=True)
    jcfg = jregistry.get_config(ARCH, smoke=True)
    rng = np.random.default_rng(0)
    tree = perturb(jax.tree.map(np.asarray,
                                jmodel.init(jax.random.PRNGKey(0), jcfg)), rng)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_jax(cfg, tree, device="cpu")
    return cfg, jcfg, jparams, params, frames(cfg, rng)


def _both(setup, fn, jfn):
    """``fn`` on the port and ``jfn`` on JAX, each under a dispatch log."""
    cfg, jcfg, jparams, params, fr = setup
    with jtsmm.record_dispatches() as jlog:
        want = jfn(jparams, jcfg, {"frames": jnp.asarray(fr)})
    with tsmm.record_dispatches() as log:
        got = fn(params, cfg, {"frames": torch.from_numpy(fr)})
    return got, want, log, jlog


def test_forward_logits_match_and_route_dense(setup):
    cfg = setup[0]
    (logits, _), (jlogits, _), log, jlog = _both(setup, model.forward,
                                                 jmodel.forward)
    assert logits.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    # frame_proj and the six projections of each layer; JAX traces one
    # scanned layer body, the port walks every layer
    assert len(log) == 1 + 6 * cfg.n_layers
    assert all(e.kind == "dense" for e in log)
    assert ({(e.kind, e.shape) for e in log}
            == {(e.kind, e.shape) for e in jlog})
    assert (B * S, cfg.frame_dim, cfg.d_model) in {e.shape for e in log}


def test_forward_hidden_matches(setup):
    (hidden, metrics), (jhidden, _), _, _ = _both(
        setup, model.forward_hidden, jmodel.forward_hidden)
    assert metrics == {}
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jhidden), **TOL)


def test_prefill_logits_and_caches_match(setup):
    cfg = setup[0]
    (logits, cache), (jlogits, jcache), _, _ = _both(
        setup,
        lambda p, c, b: model.prefill(p, c, b, model.init_cache(
            c, B, S, device="cpu")),
        lambda p, c, b: jmodel.prefill(p, c, b,
                                       jmodel.init_cache(c, B, S)))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert len(cache) == cfg.n_layers
    for i, entry in enumerate(cache):
        assert sorted(entry) == ["k", "v"]
        for key, t in entry.items():
            np.testing.assert_allclose(t.numpy(),
                                       np.asarray(jcache[0][key][i]),
                                       **TOL, err_msg=f"{i}.{key}")


def test_prefill_is_the_forwards_last_frame_and_attention_is_bidirectional(
        setup):
    cfg, _, _, params, fr = setup
    batch = {"frames": torch.from_numpy(fr)}
    logits, _ = model.forward(params, cfg, batch)
    last, _ = model.prefill(params, cfg, batch,
                            model.init_cache(cfg, B, S, device="cpu"))
    torch.testing.assert_close(last, logits[:, -1], rtol=0, atol=1e-5)
    moved = fr.copy()
    moved[:, -1] += 1.0
    other, _ = model.forward(params, cfg, {"frames": torch.from_numpy(moved)})
    assert float((other[:, 0] - logits[:, 0]).abs().max()) > 1e-3


def test_gelu_mlp_matches_jax_and_the_erf_form_misses(setup):
    cfg, _, jparams, params, _ = setup
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32) * 2
    jp = jax.tree.map(lambda a: a[0], jparams["segments"][0]["ffn"])
    want = np.asarray(jlayers.gelu_mlp(jp, jnp.asarray(x)))
    p = params.layers[0].ffn
    assert isinstance(p, layers.GeluMLP)
    got = layers.gelu_mlp(p, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    h = layers.dense(p.w_up, torch.from_numpy(x)) + p.b_up
    erf = layers.dense(p.w_down, F.gelu(h)) + p.b_down
    # the two forms part by up to ~5e-4 of a unit input
    assert float(np.abs(erf.numpy() - want).max()) > 5 * TOL["atol"]


def test_noncausal_chunked_attention_at_head_dim_80():
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 37, 4, 80)).astype(np.float32)
               for _ in range(3))
    kw = dict(causal=False, q_chunk=16, kv_chunk=16)
    want = np.asarray(jattention.chunked_attention(
        *(jnp.asarray(t) for t in (q, k, v)), **kw))
    got = attention.chunked_attention(*(torch.from_numpy(t)
                                        for t in (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    causal = attention.chunked_attention(
        *(torch.from_numpy(t) for t in (q, k, v)), causal=True,
        q_chunk=16, kv_chunk=16)
    assert float(np.abs(causal.numpy() - want).max()) > 1e-2


def test_bf16_model_fed_f32_frames_runs_f32_activations():
    """The reference's train step feeds the pipeline's f32 frames to a
    bf16 model (``layers.dense`` returns x's dtype): the hidden states
    come out f32 in both packages."""
    import dataclasses
    cfg = dataclasses.replace(registry.get_config(ARCH, smoke=True),
                              dtype="bfloat16")
    jcfg = dataclasses.replace(jregistry.get_config(ARCH, smoke=True),
                               dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jcfg))
    params = params_from_jax(cfg, tree, device="cpu")
    fr = frames(cfg, np.random.default_rng(5), 2, 24)
    jhidden, _ = jmodel.forward_hidden(jax.tree.map(jnp.asarray, tree), jcfg,
                                       {"frames": jnp.asarray(fr)})
    hidden, _ = model.forward_hidden(params, cfg,
                                     {"frames": torch.from_numpy(fr)})
    assert params.layers[0].ffn.w_up.dtype == torch.bfloat16
    assert jhidden.dtype == jnp.float32 and hidden.dtype == torch.float32
    half, _ = model.forward_hidden(
        params, cfg, {"frames": torch.from_numpy(fr).bfloat16()})
    assert half.dtype == torch.bfloat16


def test_param_count_is_the_references():
    cfg = registry.get_config(ARCH)
    assert cfg.param_count() == jregistry.get_config(ARCH).param_count() \
        == 945_008_640
    lm = model.LM(cfg, device="meta")
    held = sum(p.numel() for p in lm.parameters())
    # frame_proj, the MLP's two biases, two LayerNorms a layer, final norm
    assert held == 945_008_640 + 512 * 1280 + 48 * (5120 + 1280) \
        + 48 * 4 * 1280 + 2 * 1280 == 946_219_520


def test_full_size_routes_dense_and_the_tree_check_reaches_tsmt():
    cfg = registry.get_config(ARCH)
    pol = tsmm.GemmPolicy()
    rows = 4 * 2048
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    qkv = cfg.n_heads * hd
    shapes = [(rows, cfg.frame_dim, d)] + cfg.n_layers * [
        (rows, d, qkv), (rows, d, qkv), (rows, d, qkv), (rows, qkv, d),
        (rows, d, f), (rows, f, d)]
    assert len(shapes) == 289
    assert {tsmm.classify_gemm(*s, pol) for s in shapes} == {"dense"}
    lm = model.LM(cfg, device="meta")
    routed, dense = [], 0
    for name, x in named_leaves(lm):
        if x.dim() < 1 or x.numel() < abft.MIN_LEAF:
            continue
        shape = (x.shape[0], x.numel() // x.shape[0], 2)
        if tsmm.classify_gemm_t(*shape, pol) == "dense":
            dense += 1
            continue
        routed.append((name, shape, tsmm.classify_gemm_t(*shape, pol),
                       ops.resolve_params("tsmt", *shape, torch.float32,
                                          pol)["splits"]))
    assert sorted(r[0] for r in routed) == sorted(
        f"layers.{i}.ffn.w_down" for i in range(48))
    assert {r[1:] for r in routed} == {((5120, 1280, 2), "tsmt", 1)}
    # frame_proj, embed, lm_head, 4 attention and 1 w_up a layer
    assert dense == 3 + 5 * 48
