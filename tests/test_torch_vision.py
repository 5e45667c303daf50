"""llama-3.2-vision-11b's smoke config served by the PyTorch port against
the JAX package, on the CPU.

Both sides start from the JAX package's initial parameters, carried
across by ``repro_torch.convert.params_from_jax``, with every leaf that
starts constant perturbed first: both gates of every cross layer (at
zero, ``tanh(0)`` multiplies the whole image path away) and every norm
scale. The smoke config has 2 groups of 1 self-attention layer and 1
gated cross-attention layer over 24 image tokens of width 48 (not
d_model); its chunks of 16 leave a short last key tile over the image
(the reference pads and masks it). The prompts and the image embeddings
are seeded numpy arrays; the embeddings go in as f32 (the pipeline's)
and as bf16. f32 model, rtol = atol = 1e-4 (``tests/test_torch_serve.
py``'s tolerance), the decode tolerance of ``test_torch_serve_zamba.py``
against the teacher-forced forward:

* ``cross_kv`` and each cross layer's forward, prefill and decode step
  against ``repro.models.blocks``;
* ``forward``, ``prefill`` (logits and every cache entry), cached decode
  and greedy ``generate(extras=)`` against the JAX package's;
* the cross cache after a prefill holds the embeddings' dtype (the
  reference's scan returns the projected K/V, uncast) and a decode step
  leaves it as it was;
* the cross layers' own ``attn.wk`` / ``attn.wv`` are never read: their
  gradients are zero, as ``jax.grad``'s are;
* the image reaches the logits: with the gates drawn, another request's
  image moves them; with both gates of every cross layer at zero, they
  stay bit for bit;
* ``segments`` takes whole groups only (a 4-layer cut of the full config
  has none), and the full config's ``param_count`` is the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import blocks as jblocks
from repro.models import model as jmodel
from repro.serve import engine as jengine
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.models import blocks, model
from repro_torch.serve import engine

ARCH = "llama-3.2-vision-11b"
B, S, NEW = 3, 20, 5
TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-4)
DTYPES = ["float32", "bfloat16"]


def perturb(tree, rng):
    """Every leaf of the vision tree that starts constant, from ``rng``:
    both gates of every cross layer and every norm scale."""
    seg = tree["segments"][0]
    for key in ("gate_attn", "gate_ffn"):
        seg["cross"][key] = rng.normal(0, 1, seg["cross"][key].shape
                                       ).astype(np.float32)
    for norm in (seg["self"]["norm1"], seg["self"]["norm2"],
                 seg["cross"]["norm1"], seg["cross"]["norm2"],
                 tree["final_norm"]):
        norm["scale"] = (1 + rng.normal(0, 0.1, norm["scale"].shape)
                         ).astype(np.float32)
    return tree


def images(cfg, rng, b=B):
    """Seeded f32 image embeddings (b, vision_seq, vision_dim)."""
    return rng.standard_normal((b, cfg.vision_seq, cfg.vision_dim)
                               ).astype(np.float32)


def _as(img, dtype):
    """The embeddings for each package in ``dtype`` (the same values)."""
    return (jnp.asarray(img, dtype=getattr(jnp, dtype)),
            torch.from_numpy(img).to(getattr(torch, dtype)))


@pytest.fixture(scope="module")
def setup():
    cfg = registry.get_config(ARCH, smoke=True)
    jcfg = jregistry.get_config(ARCH, smoke=True)
    rng = np.random.default_rng(0)
    tree = perturb(jax.tree.map(np.asarray,
                                jmodel.init(jax.random.PRNGKey(0), jcfg)), rng)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_jax(cfg, tree, device="cpu")
    prompts = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, jcfg, jparams, params, prompts, images(cfg, rng)


def _batches(setup, dtype, tokens=None):
    """(JAX batch, port batch) of the prompts (or ``tokens``) and the
    image embeddings in ``dtype``."""
    prompts, img = setup[4], setup[5]
    toks = prompts if tokens is None else tokens
    jimg, timg = _as(img, dtype)
    return ({"tokens": jnp.asarray(toks), "image_embeds": jimg},
            {"tokens": torch.from_numpy(toks).long(), "image_embeds": timg})


def _cross(setup, g):
    """Group ``g``'s cross layer in both packages."""
    jparams, params = setup[2], setup[3]
    jp = jax.tree.map(lambda a: a[g], jparams["segments"][0]["cross"])
    return jp, params.groups[g].cross


def test_model_holds_vision_groups(setup):
    cfg, _, _, params, _, _ = setup
    assert [s.kind for s in model.segments(cfg)] == ["vlm_group"]
    assert [len(g.self) for g in params.groups] == [1, 1]
    assert not hasattr(params, "layers") and not hasattr(params, "tail")
    cross = params.groups[0].cross
    assert cross.gate_attn.shape == () and cross.gate_attn.dtype == (
        torch.float32)
    assert tuple(cross.kv_proj_k.shape) == (cfg.vision_dim, cfg.n_kv_heads
                                            * cfg.resolved_head_dim)
    # the port's own init: zero gates, as the reference's
    fresh = model.init(cfg, seed=0, device="cpu")
    assert all(float(g.cross.gate_attn) == float(g.cross.gate_ffn) == 0.0
               for g in fresh.groups)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_kv_matches(setup, dtype):
    cfg, jcfg = setup[0], setup[1]
    jimg, timg = _as(setup[5], dtype)
    for g in range(len(setup[3].groups)):
        jp, p = _cross(setup, g)
        jk, jv = jblocks.cross_kv(jp, jcfg, jimg)
        k, v = blocks.cross_kv(p, cfg, timg)
        for got, want in ((k, jk), (v, jv)):
            assert str(got.dtype)[6:] == str(want.dtype) == dtype
            np.testing.assert_allclose(got.float().detach().numpy(),
                                       np.asarray(want, np.float32), **TOL)


@pytest.mark.parametrize("g", [0, 1])
def test_cross_layer_forward_prefill_and_decode_match(setup, g):
    """One cross layer alone: ``block_fwd``, ``block_prefill`` (the
    output and the K/V it caches) and a ``block_decode`` step over that
    cache, on the same hidden states in both packages."""
    cfg, jcfg = setup[0], setup[1]
    jp, p = _cross(setup, g)
    rng = np.random.default_rng(10 + g)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    jimg, timg = _as(setup[5], "float32")
    jx = {"image_embeds": jimg}
    tx = {"image_embeds": timg}
    with torch.no_grad():
        got, _ = blocks.block_fwd(p, torch.from_numpy(x), cfg, "cross_mlp",
                                  tx)
        pre, cache = blocks.block_prefill(
            p, torch.from_numpy(x), cfg, "cross_mlp",
            blocks.cache_init(cfg, "cross_mlp", B, S, "cpu"), tx)
        dec, cache2 = blocks.block_decode(p, torch.from_numpy(x1), cfg,
                                          "cross_mlp", cache, S)
    want, _ = jblocks.block_fwd(jp, jnp.asarray(x), jcfg, "cross_mlp", jx)
    jpre, jcache = jblocks.block_prefill(
        jp, jnp.asarray(x), jcfg, "cross_mlp",
        jblocks.cache_init(jcfg, "cross_mlp", B, S), jx)
    jdec, _ = jblocks.block_decode(jp, jnp.asarray(x1), jcfg, "cross_mlp",
                                   jcache, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(pre.numpy(), np.asarray(jpre), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), **TOL)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), **TOL)
    assert cache2 is cache
    # the cross layer moved the stream
    assert float((got - torch.from_numpy(x)).abs().max()) > 1e-2


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_logits_match(setup, dtype):
    cfg, jcfg, jparams, params = setup[:4]
    jb, tb = _batches(setup, dtype)
    jlogits, _ = jmodel.forward(jparams, jcfg, jb)
    with torch.no_grad():
        logits, metrics = model.forward(params, cfg, tb)
    assert metrics == {} and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


def _prefill(setup, dtype, extra=0):
    cfg, jcfg, jparams, params = setup[:4]
    jb, tb = _batches(setup, dtype)
    jlogits, jcache = jmodel.prefill(jparams, jcfg, jb, jmodel.init_cache(
        jcfg, B, S + extra))
    logits, cache = model.prefill(params, cfg, tb, model.init_cache(
        cfg, B, S + extra, device="cpu"))
    return (jlogits, jcache), (logits, cache)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_logits_and_caches_match(setup, dtype):
    """The flat cache in execution order against JAX's stacks: each
    group's self-attention K/V, then its cross layer's image K/V, in the
    embeddings' dtype."""
    cfg = setup[0]
    (jlogits, jcache), (logits, cache) = _prefill(setup, dtype)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    period = cfg.cross_attn_period
    n_groups = cfg.n_layers // period
    want = []
    for g in range(n_groups):
        want += [({k: v[g, i] for k, v in jcache[0]["self"].items()},
                  "float32") for i in range(period - 1)]
        want.append(({k: v[g] for k, v in jcache[0]["cross"].items()},
                     dtype))
    assert len(cache) == len(want) == cfg.n_layers
    for i, (got, (exp, dt)) in enumerate(zip(cache, want)):
        assert sorted(got) == sorted(exp) == ["k", "v"]
        for key, t in got.items():
            assert str(t.dtype)[6:] == str(exp[key].dtype) == dt, (i, key)
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(exp[key], np.float32),
                                       **TOL, err_msg=f"{i}.{key}")
        if dt != "float32" or i % period == period - 1:
            assert got["k"].shape[1] == cfg.vision_seq


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_matches_jax_and_the_forward(setup, dtype):
    """Cached decode of given tokens: each step's logits against JAX's
    decode and against the teacher-forced forward at that position; the
    cross caches keep their dtype and values through every step."""
    cfg, jcfg, jparams, params, prompts, _ = setup
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, NEW)
                                             ).astype(np.int32)
    _, tb_full = _batches(setup, dtype, np.concatenate([prompts, toks], 1))
    with torch.no_grad():
        forced, _ = model.forward(params, cfg, tb_full)
    (_, jcache), (_, cache) = _prefill(setup, dtype, NEW)
    cross = [i for i in range(cfg.n_layers)
             if i % cfg.cross_attn_period == cfg.cross_attn_period - 1]
    before = {i: {k: t.clone() for k, t in cache[i].items()} for i in cross}
    for i in range(NEW):
        logits, cache = model.decode_step(
            params, cfg, torch.from_numpy(toks[:, i:i + 1]).long(), S + i,
            cache)
        jlogits, jcache = jmodel.decode_step(
            jparams, jcfg, jnp.asarray(toks[:, i:i + 1]), S + i, jcache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        np.testing.assert_allclose(logits.numpy(), forced[:, S + i].numpy(),
                                   **DECODE_TOL)
    for i in cross:
        for k, t in cache[i].items():
            assert str(t.dtype)[6:] == dtype
            assert torch.equal(t, before[i][k])


@pytest.mark.parametrize("dtype", DTYPES)
def test_greedy_generate_matches(setup, dtype):
    cfg, jcfg, jparams, params, prompts, img = setup
    jimg, timg = _as(img, dtype)
    jout = jengine.generate(jparams, jcfg, jnp.asarray(prompts), NEW,
                            extras={"image_embeds": jimg})
    out = engine.generate(params, cfg, torch.from_numpy(prompts).long(), NEW,
                          extras={"image_embeds": timg}, device="cpu")
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_generate_refuses_extras_off_its_device(setup):
    cfg, _, _, params, prompts, img = setup
    with pytest.raises(ValueError, match="image_embeds lie on meta"):
        engine.generate(params, cfg, torch.from_numpy(prompts).long(), NEW,
                        extras={"image_embeds": torch.empty(
                            img.shape, device="meta")}, device="cpu")


def test_unread_cross_wk_wv_get_zero_gradients(setup):
    """The cross layers' own ``attn.wk`` / ``attn.wv`` are never read (the
    image K/V come from ``kv_proj_*``): zero gradients in both packages,
    and a nonzero one for every other cross leaf."""
    cfg, jcfg, jparams, params = setup[:4]
    jb, tb = _batches(setup, "float32")

    def jloss(p):
        return jmodel.forward(p, jcfg, jb)[0].sum()

    jgrads = jax.grad(jloss)(jparams)["segments"][0]["cross"]
    params.requires_grad_(True)
    try:
        named = dict(params.named_parameters())
        logits, _ = model.forward(params, cfg, tb)
        grads = dict(zip(named, torch.autograd.grad(
            logits.sum(), list(named.values()), allow_unused=True,
            materialize_grads=True)))
    finally:
        params.requires_grad_(False)
    for g in range(len(params.groups)):
        for key in ("wk", "wv"):
            assert not np.asarray(jgrads["attn"][key][g]).any()
            assert not grads[f"groups.{g}.cross.attn.{key}"].any()
        for name in ("attn.wq", "attn.wo", "kv_proj_k", "kv_proj_v",
                     "gate_attn", "gate_ffn", "ffn.w_up"):
            got = grads[f"groups.{g}.cross.{name}"]
            assert float(got.abs().max()) > 0, name
            want = jgrads
            for part in name.split("."):
                want = want[part]
            np.testing.assert_allclose(got.numpy(), np.asarray(want)[g],
                                       rtol=1e-3, atol=1e-3, err_msg=name)


def test_the_image_reaches_the_logits_both_ways(setup):
    """With the gates drawn, each request given another request's image
    moves its logits; with both gates of every cross layer at zero, the
    swap leaves them bit for bit."""
    cfg, _, _, params, prompts, img = setup
    toks = torch.from_numpy(prompts).long()
    rolled = np.roll(img, 1, axis=0)

    def last(embeds):
        with torch.no_grad():
            return model.prefill(params, cfg, {
                "tokens": toks, "image_embeds": torch.from_numpy(embeds)},
                model.init_cache(cfg, B, S, device="cpu"))[0]

    assert float((last(rolled) - last(img)).abs().max()) > 1e-2
    gates = [t for g in params.groups
             for t in (g.cross.gate_attn, g.cross.gate_ffn)]
    saved = [t.clone() for t in gates]
    try:
        for t in gates:
            t.data.zero_()
        assert torch.equal(last(rolled), last(img))
    finally:
        for t, v in zip(gates, saved):
            t.data.copy_(v)


def test_segments_take_whole_groups():
    cfg = registry.get_config(ARCH)
    jcfg = jregistry.get_config(ARCH)
    for layers, groups in ((40, 8), (10, 2), (5, 1), (4, 0)):
        segs = model.segments(dataclasses.replace(cfg, n_layers=layers))
        jsegs = jmodel.segments(dataclasses.replace(jcfg, n_layers=layers))
        assert [(s.kind, s.n, s.inner) for s in segs] == [
            (s.kind, s.n, s.inner) for s in jsegs] == [
            ("vlm_group", groups, 4)]


def test_param_count_value():
    """9,774,825,472 by the reference's formula, which counts 40 dense
    layers: it leaves out the cross layers' ``kv_proj_k`` / ``kv_proj_v``
    (2 x 4096 x 1024 each) and the norms and gates; the model holds them
    all (9,842,266,128)."""
    cfg = registry.get_config(ARCH)
    assert cfg.param_count() == jregistry.get_config(ARCH).param_count()
    assert cfg.param_count() == 9_774_825_472
    lm = model.LM(cfg, device="meta")
    n = sum(p.numel() for p in lm.parameters())
    assert n == (9_774_825_472 + 8 * 2 * 4096 * 1024
                 + (40 * 2 + 1) * 4096 + 8 * 2)
    assert n == 9_842_266_128


def test_every_layer_is_checkpointed_under_remat(setup, monkeypatch):
    """The reference checkpoints each vision group and each self layer in
    it (``_maybe_remat`` of both bodies): under autograd with
    ``cfg.remat`` the port checkpoints every self layer and every cross
    layer (the same values), and the forward's logits are the ones
    without remat."""
    from repro_torch.models import attention, layers
    cfg, _, _, params = setup[:4]
    _, tb = _batches(setup, "float32")
    real, calls = layers.remat, []

    def counting(fn, *args):
        if fn is not attention._kv_step:
            calls.append((fn.__name__, args[3]))
        return real(fn, *args)

    monkeypatch.setattr(layers, "remat", counting)
    params.requires_grad_(True)
    try:
        hidden, _ = model.forward_hidden(params, cfg, tb)
        hidden.sum().backward()
    finally:
        params.requires_grad_(False)
        params.zero_grad(set_to_none=True)
    period = cfg.cross_attn_period
    assert calls == ([("block_fwd", "attn_mlp")] * (period - 1)
                     + [("block_fwd", "cross_mlp")]) * (cfg.n_layers // period)
    with torch.no_grad():
        plain, _ = model.forward_hidden(params, cfg, tb)
    torch.testing.assert_close(hidden.detach(), plain, rtol=0, atol=0)
