"""The Mamba2 layer of the PyTorch port against the JAX package, on the CPU.

Weights come from the JAX package's ``mamba2_init`` with every leaf that
starts constant (``conv_b``, ``A_log``, ``D``, ``dt_bias``, the gated
norm's ``scale``) perturbed from a numpy seed, so each is wired; inputs
are numpy draws from a seed. Both sides run f32 under the default policy,
where every projection of these widths is dense. Two groups of two heads,
as the JAX tests' ``CFG_M`` (``tests/test_ssm_moe.py:19``), so the
broadcast over a group's heads is exercised. Tolerances are the JAX tests'
own (``tests/test_ssm_moe.py:31, :41, :53``): rtol = atol = 2e-4 for the
chunked and per-step forms, rtol 2e-3 / atol 2e-4 for decode against the
full sequence; gradients against ``jax.grad`` at 2e-4 as well.

The last two tests record the reference's overflow: at chunk 128 from its
own init its gradient is non-finite, and the port's (masked before the
exponential) is finite and equals the reference's finite chunk-32
gradient within 1e-4 of each leaf's largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as jmamba2
from repro_torch.models import mamba2

TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-4)
D = 16
CFG = mamba2.Mamba2Config(d_inner=32, n_heads=4, state_dim=8, n_groups=2,
                          chunk=8)
JCFG = jmamba2.Mamba2Config(d_inner=32, n_heads=4, state_dim=8, n_groups=2,
                            chunk=8)


def _node(tree, name):
    for key in name.split("."):
        tree = tree[key]
    return tree


def carry(module, tree):
    """Copy a JAX params dict (numpy leaves) into ``module`` by name."""
    for name, p in module.named_parameters():
        src = np.asarray(_node(tree, name))
        assert src.shape == tuple(p.shape), name
        p.data.copy_(torch.from_numpy(src.copy()))
    return module


def params(seed, cfg=CFG, jcfg=JCFG, d=D, perturb=True):
    tree = jax.tree.map(np.asarray, jmamba2.mamba2_init(
        jax.random.PRNGKey(seed), d, jcfg, jnp.float32))
    if perturb:
        rng = np.random.default_rng(seed)
        for key, mean, sd in (("conv_b", 0, 0.1), ("A_log", 0, 0.5),
                              ("D", 1, 0.3), ("dt_bias", 0, 0.5)):
            tree[key] = (mean + rng.normal(0, sd, tree[key].shape)
                         ).astype(np.float32)
        tree["norm"]["scale"] = (1 + rng.normal(0, 0.1, cfg.d_inner)
                                 ).astype(np.float32)
    port = carry(mamba2.Mamba2(d, cfg, torch.float32, "cpu"), tree)
    return jax.tree.map(jnp.asarray, tree), port


def inputs(seed, shape, scale=1.0):
    x = (scale * np.random.default_rng(100 + seed).normal(size=shape)
         ).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def test_chunked_matches_jax_and_the_per_step_oracle():
    jp, p = params(0)
    jx, x = inputs(1, (2, 24, D))
    got = mamba2.mamba2_fwd(p, x, CFG)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jmamba2.mamba2_fwd(jp, jx, JCFG)),
                               **TOL)
    ref = mamba2.mamba2_ref_recurrent(p, x, CFG)
    np.testing.assert_allclose(
        ref.numpy(), np.asarray(jmamba2.mamba2_ref_recurrent(jp, jx, JCFG)),
        **TOL)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_return_state_matches_jax():
    jp, p = params(1)
    jx, x = inputs(2, (2, 20, D))
    rng = np.random.default_rng(3)
    st0 = rng.normal(0, 0.1, (2, 4, 8, 8)).astype(np.float32)
    conv0 = rng.normal(0, 0.5, (2, 3, 32 + 2 * 2 * 8)).astype(np.float32)
    jout, (jst, jconv) = jmamba2.mamba2_fwd(
        jp, jx, JCFG, initial_state=jnp.asarray(st0),
        conv_state=jnp.asarray(conv0), return_state=True)
    out, (st, conv) = mamba2.mamba2_fwd(
        p, x, CFG, initial_state=torch.from_numpy(st0),
        conv_state=torch.from_numpy(conv0), return_state=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(jconv))
    assert st.dtype == torch.float32 and st.shape == (2, 4, 8, 8)


@pytest.mark.parametrize("chunk", [4, 6, 12, 24])
def test_chunk_invariance(chunk):
    jp, p = params(2)
    jx, x = inputs(3, (1, 24, D))
    cfg = mamba2.Mamba2Config(d_inner=32, n_heads=4, state_dim=8,
                              n_groups=2, chunk=chunk)
    got = mamba2.mamba2_fwd(p, x, cfg)
    np.testing.assert_allclose(got.numpy(),
                               mamba2.mamba2_fwd(p, x, CFG).numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jmamba2.mamba2_fwd(jp, jx, JCFG)),
                               **TOL)


def test_chunk_rule_takes_the_largest_divisor():
    """S = 22 with chunk 8: the reference steps down to 2 chunks of 11."""
    jp, p = params(4)
    jx, x = inputs(5, (1, 22, D))
    np.testing.assert_allclose(mamba2.mamba2_fwd(p, x, CFG).numpy(),
                               np.asarray(jmamba2.mamba2_fwd(jp, jx, JCFG)),
                               **TOL)


def test_prefill_state_seeds_decode():
    """fwd(S0, return_state) then decode(t) == fwd(S) at tail positions,
    and each step equals JAX's decode."""
    jp, p = params(4)
    jx, x = inputs(5, (2, 19, D))
    full = mamba2.mamba2_fwd(p, x, CFG)
    s0 = 16
    _, (st, conv) = mamba2.mamba2_fwd(p, x[:, :s0], CFG, return_state=True)
    _, (jst, jconv) = jmamba2.mamba2_fwd(jp, jx[:, :s0], JCFG,
                                         return_state=True)
    for t in range(s0, 19):
        out, st, conv = mamba2.mamba2_decode(p, x[:, t:t + 1], st, conv, CFG)
        jout, jst, jconv = jmamba2.mamba2_decode(jp, jx[:, t:t + 1], jst,
                                                 jconv, JCFG)
        np.testing.assert_allclose(out[:, 0].numpy(), full[:, t].numpy(),
                                   **DECODE_TOL)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)
        np.testing.assert_allclose(conv.numpy(), np.asarray(jconv), **TOL)


def test_no_nans_long_decay():
    """Extreme dt must not overflow the chunked log-decay path (the JAX
    test's ``dt_bias = 6`` and 3x inputs); the output is JAX's."""
    jp, p = params(6, perturb=False)
    jp = dict(jp, dt_bias=jnp.full_like(jp["dt_bias"], 6.0))
    p.dt_bias.data.fill_(6.0)
    jx, x = inputs(7, (1, 32, D), scale=3.0)
    got = mamba2.mamba2_fwd(p, x, CFG)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jmamba2.mamba2_fwd(jp, jx, JCFG)),
                               **TOL)


def _grads(p, x, cfg, cot):
    p.requires_grad_(True)
    x = x.clone().requires_grad_(True)
    loss = (mamba2.mamba2_fwd(p, x, cfg) * cot).sum()
    loss.backward()
    return x.grad, {n: t.grad for n, t in p.named_parameters()}


def test_gradients_match_jax_grad():
    jp, p = params(8)
    jx, x = inputs(9, (2, 16, D))
    cot = np.random.default_rng(10).normal(size=(2, 16, D)).astype(
        np.float32)

    def jloss(prm, xx):
        return jnp.sum(jmamba2.mamba2_fwd(prm, xx, JCFG) * jnp.asarray(cot))

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    gx, gp = _grads(p, x, CFG, torch.from_numpy(cot))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **TOL)
    jg = jax.tree.map(np.asarray, jgp)
    for name, g in gp.items():
        np.testing.assert_allclose(g.numpy(), _node(jg, name), **TOL,
                                   err_msg=name)


def test_init_values_and_dtypes_are_the_references():
    cfg = mamba2.Mamba2Config(d_inner=128, n_heads=4, state_dim=8)
    jcfg = jmamba2.Mamba2Config(d_inner=128, n_heads=4, state_dim=8)
    gen = torch.Generator().manual_seed(0)
    m = mamba2.mamba2_init(gen, 64, cfg, torch.bfloat16, "cpu")
    jm = jmamba2.mamba2_init(jax.random.PRNGKey(0), 64, jcfg, jnp.bfloat16)
    for name, t in m.named_parameters():
        want = _node(jm, name)
        assert tuple(t.shape) == want.shape, name
        assert str(t.dtype)[6:] == str(want.dtype), name
    assert not m.A_log.any() and not m.dt_bias.any() and not m.conv_b.any()
    assert bool((m.D == 1).all()) and bool((m.norm.scale == 1).all())
    # conv_w is the reference's W^-1/2 draw; in_proj and out_proj fan-in
    for t, fan in ((m.conv_w, 4), (m.in_proj, 64), (m.out_proj, 128)):
        assert abs(float(t.float().std()) * fan ** 0.5 - 1) < 0.1


# The reference's overflow: chunk 128, s = 128, the reference's own init.
OV_D = 64
OV_SHAPE = (2, 128, OV_D)


def _ov_cfgs(chunk):
    kw = dict(d_inner=128, n_heads=8, state_dim=16, chunk=chunk)
    return mamba2.Mamba2Config(**kw), jmamba2.Mamba2Config(**kw)


def _ov_jgrad(jp, jx, jcfg):
    return jax.tree.map(np.asarray, jax.grad(
        lambda prm: jnp.sum(jmamba2.mamba2_fwd(prm, jx, jcfg) ** 2))(jp))


def test_reference_gradient_overflows_at_chunk_128():
    """The reference's ``where(tri, exp(seg), 0)`` (``mamba2.py:114``):
    ``seg`` on the masked upper triangle sums up to 127 steps of about
    0.8 at init, ``exp`` is ``inf`` and its backward ``0 * inf = NaN``.
    Its forward stays finite."""
    cfg, jcfg = _ov_cfgs(128)
    jp, _ = params(11, cfg, jcfg, OV_D, perturb=False)
    jx, _ = inputs(12, OV_SHAPE)
    assert np.isfinite(np.asarray(jmamba2.mamba2_fwd(jp, jx, jcfg))).all()
    jg = _ov_jgrad(jp, jx, jcfg)
    bad = sorted(k for k in ("in_proj", "A_log", "dt_bias")
                 if not np.isfinite(jg[k]).all())
    assert bad == ["A_log", "dt_bias", "in_proj"]


def test_port_gradient_is_finite_at_chunk_128_and_the_references():
    """The port masks before the exponential: its chunk-128 gradient is
    finite and equals the reference's at chunk 32 (finite there; the SSD
    is chunk invariant) within 1e-4 of each leaf's largest entry; its
    forward equals the reference's chunk-128 forward at the JAX tests'
    2e-4."""
    cfg, jcfg = _ov_cfgs(128)
    _, jcfg32 = _ov_cfgs(32)
    jp, p = params(11, cfg, jcfg, OV_D, perturb=False)
    jx, x = inputs(12, OV_SHAPE)
    np.testing.assert_allclose(mamba2.mamba2_fwd(p, x, cfg).detach().numpy(),
                               np.asarray(jmamba2.mamba2_fwd(jp, jx, jcfg)),
                               **TOL)
    want = _ov_jgrad(jp, jx, jcfg32)
    p.requires_grad_(True)
    (mamba2.mamba2_fwd(p, x, cfg) ** 2).sum().backward()
    for name, t in p.named_parameters():
        g, w = t.grad.numpy(), _node(want, name)
        assert np.isfinite(g).all(), name
        assert np.isfinite(w).all(), name
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= 1e-4, (name, err)
