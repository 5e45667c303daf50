"""Sliding windows, ring caches and MLA in the port's attention
(``repro_torch.models.attention`` / ``blocks``) against the JAX package,
on the CPU.

* ``chunked_attention`` with ``window``, ``q_offset`` and
  ``kv_valid_len`` (an int and a (B,) array) against the JAX function at
  4-wide tiles, so that tiles behind every query's window, above the
  diagonal and past the valid length are skipped; and the skip is exact:
  bit-equal to the same online softmax run over every tile;
* the windowed ``decode_attention``;
* ring decode (a cache of ``window`` slots) against decode over a full
  cache under the window mask and against the windowed forward (the
  reference's ``tests/test_attention.py`` ring test), and against JAX's
  ring decode;
* ``block_prefill``'s ring layout (slot p % w) at S >= w against JAX's
  ``roll``, and the plain layout below it, on mixtral's smoke block;
* ``mla_fwd`` and ``mla_decode`` with ``absorb`` True and False against
  JAX, and against the forward.

Parameters are the JAX initialisers' draws carried into the port's
modules; inputs from seeded numpy. f32; rtol = atol = 1e-4 against JAX,
the reference's rtol 2e-3 / atol 1e-4 for decode against the forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro_torch.configs import registry
from repro_torch.models import attention, blocks, layers

TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=2e-3, atol=1e-4)


def _load(module, tree):
    """Copy a JAX params dict into ``module``, leaf by leaf."""
    for name, t in module.named_parameters():
        node = tree
        for key in name.split("."):
            node = node[key]
        assert tuple(node.shape) == tuple(t.shape), name
        t.data.copy_(torch.from_numpy(np.array(node)))
    return module


def _np(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


CASES = [  # (window, q_offset, kv_valid_len)
    (None, 0, None), (5, 0, None), (8, 0, None), (3, 6, None),
    (None, 6, None), (None, 0, 13), (6, 4, 17), (None, 0, "array"),
    (7, 2, "array")]


@pytest.mark.parametrize("window,q_offset,kv_valid", CASES)
def test_chunked_attention_matches_jax(window, q_offset, kv_valid):
    b, sq, h, hk, d = 2, 18, 4, 2, 8
    skv = sq + q_offset
    q, k, v = (_np((b, sq, h, d), 0), _np((b, skv, hk, d), 1),
               _np((b, skv, hk, d), 2))
    valid = (np.array([skv - 3, 9], np.int32) if kv_valid == "array"
             else kv_valid)
    kw = dict(window=window, q_offset=q_offset, q_chunk=4, kv_chunk=4)
    want = jattn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_valid_len=None if valid is None else jnp.asarray(valid), **kw)
    got = attention.chunked_attention(
        _t(q), _t(k), _t(v),
        kv_valid_len=_t(valid) if kv_valid == "array" else valid, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _every_tile(q, k, v, *, window, q_offset, kv_valid_len, qc, kc):
    """``chunked_attention``'s online softmax with no tile skipped."""
    b, sq, h, dk = q.shape
    skv, hk = k.shape[1], k.shape[2]
    g = h // hk
    qg = q.reshape(b, sq, hk, g, dk)
    valid = (None if kv_valid_len is None
             else torch.as_tensor(kv_valid_len).expand(b))
    outs = []
    for q0 in range(0, sq, qc):
        q1 = min(q0 + qc, sq)
        m = torch.full((b, hk, g, q1 - q0), attention._NEG)
        l = torch.zeros((b, hk, g, q1 - q0))
        acc = torch.zeros((b, hk, g, q1 - q0, v.shape[-1]))
        for k0 in range(0, skv, kc):
            m, l, acc = attention._kv_step(
                qg[:, q0:q1].float(), k[:, k0:k0 + kc], v[:, k0:k0 + kc],
                q_offset + q0, k0, True, dk ** -0.5, m, l, acc, window,
                valid)
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, q1 - q0, h, -1))
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("window,q_offset,kv_valid", [
    (4, 0, None), (5, 8, None), (3, 2, 15), (None, 5, 11)])
def test_tile_skips_are_exact(window, q_offset, kv_valid):
    b, sq, h, hk, d = 2, 20, 4, 2, 8
    skv = sq + q_offset
    q, k, v = (_t(_np((b, sq, h, d), 3)), _t(_np((b, skv, hk, d), 4)),
               _t(_np((b, skv, hk, d), 5)))
    kw = dict(window=window, q_offset=q_offset, kv_valid_len=kv_valid)
    got = attention.chunked_attention(q, k, v, q_chunk=4, kv_chunk=4, **kw)
    want = _every_tile(q, k, v, qc=4, kc=4, **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("window", [None, 1, 5])
def test_decode_attention_window_matches_jax(window):
    b, s, h, hk, d = 2, 12, 4, 2, 8
    q, kc, vc = (_np((b, 1, h, d), 6), _np((b, s, hk, d), 7),
                 _np((b, s, hk, d), 8))
    lens = np.array([12, 7], np.int32)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(lens),
                                  window=window)
    got = attention.decode_attention(_t(q), _t(kc), _t(vc), _t(lens),
                                     window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def gqa():
    d_model, h, hk, hd = 32, 4, 2, 8
    tree = jax.tree.map(np.asarray, jattn.gqa_init(
        jax.random.PRNGKey(8), d_model, h, hk, hd, dtype=jnp.float32))
    p = _load(attention.GQA(d_model, h, hk, hd, device="cpu"), tree)
    return tree, p, dict(n_heads=h, n_kv=hk, head_dim=hd)


def test_ring_decode_matches_window_and_jax(gqa):
    """A ring of w slots equals a full cache under the window mask, the
    windowed forward, and JAX's ring decode, at every step past w."""
    tree, p, kw = gqa
    jp = jax.tree.map(jnp.asarray, tree)
    w, s = 8, 24
    x = _np((1, s, 32), 9)
    full, _ = attention.gqa_fwd(p, _t(x), window=w, q_chunk=8, kv_chunk=8,
                                **kw)
    shape = (1, w, kw["n_kv"], kw["head_dim"])
    ring_k, ring_v = torch.zeros(shape), torch.zeros(shape)
    big = (1, s, kw["n_kv"], kw["head_dim"])
    big_k, big_v = torch.zeros(big), torch.zeros(big)
    jk, jv = jnp.zeros(shape), jnp.zeros(shape)
    for t in range(s):
        xt = _t(x[:, t:t + 1])
        out_r, ring_k, ring_v = attention.gqa_decode(
            p, xt, ring_k, ring_v, t, ring_window=w, **kw)
        out_f, big_k, big_v = attention.gqa_decode(
            p, xt, big_k, big_v, t, window=w, **kw)
        jout, jk, jv = jattn.gqa_decode(jp, jnp.asarray(x[:, t:t + 1]), jk,
                                        jv, t, ring_window=w, **kw)
        np.testing.assert_allclose(out_r.numpy(), out_f.numpy(),
                                   **DECODE_TOL)
        np.testing.assert_allclose(out_r[:, 0].numpy(), full[:, t].numpy(),
                                   **DECODE_TOL)
        np.testing.assert_allclose(out_r.numpy(), np.asarray(jout), **TOL)
        np.testing.assert_allclose(ring_k.numpy(), np.asarray(jk), **TOL)


def test_windowed_gqa_fwd_matches_jax(gqa):
    tree, p, kw = gqa
    x = _np((2, 21, 32), 10)
    want, (jk, _) = jattn.gqa_fwd(jax.tree.map(jnp.asarray, tree),
                                  jnp.asarray(x), window=6, q_chunk=4,
                                  kv_chunk=4, **kw)
    got, (k, _) = attention.gqa_fwd(p, _t(x), window=6, q_chunk=4,
                                    kv_chunk=4, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)


@pytest.fixture(scope="module")
def mixtral_block():
    cfg = registry.get_config("mixtral-8x7b", smoke=True)
    jcfg = jregistry.get_config("mixtral-8x7b", smoke=True)
    tree = jax.tree.map(np.asarray, jblocks.block_init(
        jax.random.PRNGKey(3), jcfg, "attn_moe"))
    p = _load(blocks.Block(cfg, "attn_moe", device="cpu"), tree)
    return cfg, jcfg, tree, p


@pytest.mark.parametrize("s,max_len", [(16, 20), (21, 30), (40, 44),
                                       (10, 20), (10, 12)])
def test_block_prefill_ring_layout_matches_jax(mixtral_block, s, max_len):
    """Window 16: a cache of min(max_len, 16) slots; at S >= 16 the last 16
    positions land in slot p % 16 (JAX's roll), below it the first S
    slots; then a decode step into the ring."""
    cfg, jcfg, tree, p = mixtral_block
    jp = jax.tree.map(jnp.asarray, tree)
    x = _np((2, s, cfg.d_model), s)
    jout, jcache = jblocks.block_prefill(
        jp, jnp.asarray(x), jcfg, "attn_moe",
        jblocks.cache_init(jcfg, "attn_moe", 2, max_len))
    cache = blocks.cache_init(cfg, "attn_moe", 2, max_len, "cpu")
    assert cache["k"].shape[1] == min(max_len, cfg.attn_window)
    with torch.inference_mode():
        out, cache = blocks.block_prefill(p, _t(x), cfg, "attn_moe", cache)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), **TOL)
    xd = _np((2, 1, cfg.d_model), 99)
    jd, jcache = jblocks.block_decode(jp, jnp.asarray(xd), jcfg, "attn_moe",
                                      jcache, s)
    with torch.inference_mode():
        d, cache = blocks.block_decode(p, _t(xd), cfg, "attn_moe", cache, s)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), **TOL)
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jcache["k"]),
                               **TOL)


@pytest.fixture(scope="module")
def mla():
    d_model, h = 32, 4
    kw = dict(nope_dim=8, rope_dim=4, v_dim=8)
    tree = jax.tree.map(np.asarray, jattn.mla_init(
        jax.random.PRNGKey(10), d_model, h, q_lora=16, kv_lora=8,
        dtype=jnp.float32, **kw))
    rng = np.random.default_rng(10)
    for norm in ("q_norm", "kv_norm"):
        tree[norm]["scale"] = (1 + rng.normal(0, 0.1, tree[norm]["scale"]
                                              .shape)).astype(np.float32)
    p = _load(attention.MLA(d_model, h, q_lora=16, kv_lora=8, device="cpu",
                            **kw), tree)
    return tree, p, dict(n_heads=h, **kw)


def test_mla_fwd_matches_jax(mla):
    tree, p, kw = mla
    x = _np((2, 12, 32), 11)
    want, (jc, jkpe) = jattn.mla_fwd(jax.tree.map(jnp.asarray, tree),
                                     jnp.asarray(x), q_chunk=4, kv_chunk=4,
                                     **kw)
    got, (c, kpe) = attention.mla_fwd(p, _t(x), q_chunk=4, kv_chunk=4, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(kpe.numpy(), np.asarray(jkpe), **TOL)


@pytest.mark.parametrize("absorb", [True, False])
def test_mla_decode_matches_jax_and_forward(mla, absorb):
    tree, p, kw = mla
    jp = jax.tree.map(jnp.asarray, tree)
    s = 12
    x = _np((2, s, 32), 12)
    full, _ = attention.mla_fwd(p, _t(x), q_chunk=4, kv_chunk=4, **kw)
    s0 = s - 4
    _, (c0, kpe0) = attention.mla_fwd(p, _t(x[:, :s0]), q_chunk=4,
                                      kv_chunk=4, **kw)
    cc, ckpe = torch.zeros((2, s, 8)), torch.zeros((2, s, 4))
    cc[:, :s0], ckpe[:, :s0] = c0, kpe0
    jcc, jckpe = jnp.asarray(cc.numpy()), jnp.asarray(ckpe.numpy())
    for t in range(s0, s):
        out, cc, ckpe = attention.mla_decode(p, _t(x[:, t:t + 1]), cc, ckpe,
                                             t, absorb=absorb, **kw)
        jout, jcc, jckpe = jattn.mla_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                            jcc, jckpe, t, absorb=absorb,
                                            **kw)
        np.testing.assert_allclose(out[:, 0].numpy(), full[:, t].numpy(),
                                   **DECODE_TOL)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
        np.testing.assert_allclose(cc.numpy(), np.asarray(jcc), **TOL)
        np.testing.assert_allclose(ckpe.numpy(), np.asarray(jckpe), **TOL)


def test_mla_rope_key_is_shared_by_every_head(mla):
    """The latent cache holds one rope key a position: the forward's
    per-head keys end in that key for every head."""
    _, p, kw = mla
    x = _t(_np((1, 6, 32), 13))
    pos = torch.arange(6)[None, :]
    _, k_pe = attention._mla_latent(p, x, pos, rope_theta=10000.0)
    assert k_pe.shape == (1, 6, 1, kw["rope_dim"])
    wide = k_pe.expand(1, 6, kw["n_heads"], kw["rope_dim"])
    assert wide.stride(2) == 0
    want = layers.apply_rope(layers.dense(p.wkr, x)[:, :, None, :], pos)
    assert torch.equal(k_pe, want)
