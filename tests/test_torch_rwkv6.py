"""The RWKV6 layer of the PyTorch port against the JAX package, on the CPU.

Weights come from the JAX package's ``rwkv6_time_mix_init`` /
``rwkv6_channel_mix_init`` with every leaf that starts constant (``w0``,
``u``, the LoRA's ``b``, ``ln_x``) perturbed from a numpy seed, so each is
wired; inputs are numpy draws from a seed. Both sides run f32 under the
default policy, where every projection of these widths is dense.
Tolerances are the JAX tests' own (``tests/test_ssm_moe.py``): 2e-4 for
the chunked and per-step forms (rtol and atol), rtol 2e-3 / atol 2e-4 for
decode against the full sequence, rtol 1e-4 / atol 1e-5 for the channel
mix; gradients against ``jax.grad`` at 2e-4 as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv6 as jrwkv6
from repro_torch.models import rwkv6

TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-4)
CM_TOL = dict(rtol=1e-4, atol=1e-5)
D = 32
CFG = rwkv6.RWKV6Config(n_heads=4, head_dim=8, decay_lora_rank=4, chunk=8)
JCFG = jrwkv6.RWKV6Config(n_heads=4, head_dim=8, decay_lora_rank=4, chunk=8)


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


def time_mix_params(seed):
    tree = jax.tree.map(np.asarray, jrwkv6.rwkv6_time_mix_init(
        jax.random.PRNGKey(seed), D, JCFG, jnp.float32))
    rng = np.random.default_rng(seed)
    tree["w0"] = (tree["w0"] + rng.normal(0, 1, D)).astype(np.float32)
    tree["u"] = rng.normal(0, 0.5, tree["u"].shape).astype(np.float32)
    tree["w_lora"]["b"] = rng.normal(0, 0.5, tree["w_lora"]["b"].shape
                                     ).astype(np.float32)
    tree["ln_x"] = {"scale": (1 + rng.normal(0, 0.1, D)).astype(np.float32),
                    "bias": rng.normal(0, 0.1, D).astype(np.float32)}
    port = carry(rwkv6.TimeMix(D, CFG, torch.float32, "cpu"), tree)
    return jax.tree.map(jnp.asarray, tree), port


def inputs(seed, shape):
    x = np.random.default_rng(100 + seed).normal(size=shape).astype(
        np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def test_time_mix_chunked_matches_jax():
    jp, p = time_mix_params(0)
    jx, x = inputs(1, (2, 24, D))
    want = jrwkv6.rwkv6_time_mix(jp, jx, JCFG)
    got = rwkv6.rwkv6_time_mix(p, x, CFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_time_mix_return_state_matches_jax():
    jp, p = time_mix_params(0)
    jx, x = inputs(2, (2, 20, D))
    jst0 = np.random.default_rng(3).normal(0, 0.1, (2, 4, 8, 8)).astype(
        np.float32)
    jout, (jst, jlast) = jrwkv6.rwkv6_time_mix(
        jp, jx, JCFG, state=jnp.asarray(jst0), x_prev=jx[:, :1] * 0.5,
        return_state=True)
    out, (st, last) = rwkv6.rwkv6_time_mix(
        p, x, CFG, state=torch.from_numpy(jst0), x_prev=x[:, :1] * 0.5,
        return_state=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)
    np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))
    assert st.dtype == torch.float32 and st.shape == (2, 4, 8, 8)


def test_per_step_oracle_matches_jax_and_the_chunked_form():
    jp, p = time_mix_params(0)
    jx, x = inputs(1, (2, 24, D))
    got = rwkv6.rwkv6_time_mix_ref(p, x, CFG)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jrwkv6.rwkv6_time_mix_ref(jp, jx, JCFG)),
        **TOL)
    np.testing.assert_allclose(rwkv6.rwkv6_time_mix(p, x, CFG).numpy(),
                               got.numpy(), **TOL)


@pytest.mark.parametrize("chunk", [4, 6, 24])
def test_chunk_invariance(chunk):
    jp, p = time_mix_params(2)
    jx, x = inputs(3, (1, 24, D))
    cfg = rwkv6.RWKV6Config(n_heads=4, head_dim=8, decay_lora_rank=4,
                            chunk=chunk)
    got = rwkv6.rwkv6_time_mix(p, x, cfg)
    np.testing.assert_allclose(got.numpy(),
                               rwkv6.rwkv6_time_mix(p, x, CFG).numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jrwkv6.rwkv6_time_mix(jp, jx, JCFG)),
                               **TOL)


def test_chunk_rule_takes_the_largest_divisor():
    """S = 22 with chunk 8: the reference steps down to 2 chunks of 11."""
    jp, p = time_mix_params(4)
    jx, x = inputs(5, (1, 22, D))
    np.testing.assert_allclose(rwkv6.rwkv6_time_mix(p, x, CFG).numpy(),
                               np.asarray(jrwkv6.rwkv6_time_mix(jp, jx, JCFG)),
                               **TOL)


def test_prefill_then_decode():
    jp, p = time_mix_params(4)
    jx, x = inputs(5, (2, 16, D))
    full = rwkv6.rwkv6_time_mix(p, x, CFG)
    s0 = 13
    _, (st, xprev) = rwkv6.rwkv6_time_mix(p, x[:, :s0], CFG,
                                          return_state=True)
    _, (jst, jxprev) = jrwkv6.rwkv6_time_mix(jp, jx[:, :s0], JCFG,
                                             return_state=True)
    for t in range(s0, 16):
        out, st, xprev = rwkv6.rwkv6_time_mix_decode(p, x[:, t:t + 1], st,
                                                     xprev, CFG)
        jout, jst, jxprev = jrwkv6.rwkv6_time_mix_decode(
            jp, jx[:, t:t + 1], jst, jxprev, JCFG)
        np.testing.assert_allclose(out[:, 0].numpy(), full[:, t].numpy(),
                                   **DECODE_TOL)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)


def channel_mix_params(seed):
    tree = jax.tree.map(np.asarray, jrwkv6.rwkv6_channel_mix_init(
        jax.random.PRNGKey(seed), D, 64, jnp.float32))
    port = carry(rwkv6.ChannelMix(D, 64, torch.float32, "cpu"), tree)
    return jax.tree.map(jnp.asarray, tree), port


def test_channel_mix_matches_jax_and_its_shift():
    jp, p = channel_mix_params(6)
    jx, x = inputs(7, (1, 8, D))
    full, last = rwkv6.rwkv6_channel_mix(p, x, return_state=True)
    jfull = jrwkv6.rwkv6_channel_mix(jp, jx)
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), **CM_TOL)
    np.testing.assert_array_equal(last.numpy(), x[:, -1:].numpy())
    # per token with the carried x_prev
    prev = torch.zeros((1, 1, D))
    for t in range(8):
        out = rwkv6.rwkv6_channel_mix(p, x[:, t:t + 1], x_prev=prev)
        np.testing.assert_allclose(out[:, 0].numpy(), full[:, t].numpy(),
                                   **CM_TOL)
        prev = x[:, t:t + 1]


def test_time_mix_gradients_match_jax_grad():
    jp, p = time_mix_params(8)
    jx, x = inputs(9, (2, 16, D))
    cot = np.random.default_rng(10).normal(size=(2, 16, D)).astype(
        np.float32)

    def jloss(params, xx):
        return jnp.sum(jrwkv6.rwkv6_time_mix(params, xx, JCFG)
                       * jnp.asarray(cot))

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    p.requires_grad_(True)
    x = x.clone().requires_grad_(True)
    loss = (rwkv6.rwkv6_time_mix(p, x, CFG) * torch.from_numpy(cot)).sum()
    loss.backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgx), **TOL)
    jg = jax.tree.map(np.asarray, jgp)
    for name, t in p.named_parameters():
        np.testing.assert_allclose(t.grad.numpy(), _node(jg, name), **TOL,
                                   err_msg=name)


def test_init_values_and_dtypes_are_the_references():
    gen = torch.Generator().manual_seed(0)
    tm = rwkv6.rwkv6_time_mix_init(
        gen, 64, rwkv6.RWKV6Config(n_heads=4, head_dim=16,
                                   decay_lora_rank=8), torch.bfloat16, "cpu")
    jtm = jrwkv6.rwkv6_time_mix_init(
        jax.random.PRNGKey(0), 64,
        jrwkv6.RWKV6Config(n_heads=4, head_dim=16, decay_lora_rank=8),
        jnp.bfloat16)
    for name, t in tm.named_parameters():
        assert str(t.dtype)[6:] == str(_node(jtm, name).dtype), name
    assert bool(((tm.mu >= 0) & (tm.mu < 1)).all()) and tm.mu.std() > 0.2
    assert bool((tm.w0 == -6).all()) and not tm.u.any()
    assert not tm.w_lora.b.any() and tm.w_lora.a.float().std() > 0
    assert bool((tm.ln_x.scale == 1).all()) and not tm.ln_x.bias.any()
    cm = rwkv6.rwkv6_channel_mix_init(gen, 64, 96, torch.bfloat16, "cpu")
    assert cm.mu.dtype == torch.bfloat16
    assert bool(((cm.mu >= 0) & (cm.mu < 1)).all()) and cm.mu.std() > 0.2
