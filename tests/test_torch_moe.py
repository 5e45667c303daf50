"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``, on the CPU.

The same parameters (the JAX ``moe_init`` draw, carried into the port's
``MoE`` leaf by leaf, with a nonzero ``router_bias`` drawn from a seeded
numpy generator) and the same inputs go through both:

* ``route`` for the softmax router and for the sigmoid router with a
  selection-only bias: weights, expert ids and probabilities;
* ``_dispatch_indices`` on one group's sorted entries, with and without
  drops: token and weight buffers and the kept mask;
* ``moe_fwd`` output and its three metrics, at a drop-free capacity and
  at ``capacity_factor`` 0.5 (where ``moe_dropped_frac`` must be > 0, so
  the stable sort must drop the same tokens), with ``dispatch_groups`` 1
  and 2, and with shared experts and ``routed_scale`` (the sigmoid
  cases);
* gradients of ``router_w``, the experts and ``shared`` against
  ``jax.grad`` (``router_bias`` reaches no output: zero in both);
* ``update_router_bias``;
* the reference's all-experts dense oracle (``tests/test_ssm_moe.py``).

f32 throughout; rtol = atol = 1e-4 (the packages sum in different
orders; the port combines a token's slots in top-k order, JAX scatters).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe
from test_ssm_moe import dense_moe_oracle

TOL = dict(rtol=1e-4, atol=1e-4)
D = 16


def _cfg(router: str, capacity: float = 8.0, groups: int = 1):
    sig = router == "sigmoid"
    return moe.MoEConfig(n_experts=4, top_k=2, d_ff_expert=32,
                         n_shared=1 if sig else 0, d_ff_shared=32,
                         router=router, capacity_factor=capacity,
                         routed_scale=2.5 if sig else 1.0,
                         dispatch_groups=groups)


def _jcfg(cfg):
    return jmoe.MoEConfig(**dataclasses.asdict(cfg))


def _params(cfg, seed=0):
    """The JAX parameters (numpy leaves, a drawn router bias) and the
    port's ``MoE`` holding the same values."""
    tree = jax.tree.map(np.asarray, jmoe.moe_init(
        jax.random.PRNGKey(seed), D, _jcfg(cfg), jnp.float32))
    rng = np.random.default_rng(seed)
    tree["router_bias"] = rng.normal(0, 0.3, tree["router_bias"].shape
                                     ).astype(np.float32)
    p = moe.MoE(D, cfg, torch.float32, device="cpu")
    for name, t in p.named_parameters():
        node = tree
        for key in name.split("."):
            node = node[key]
        assert tuple(node.shape) == tuple(t.shape), name
        t.data.copy_(torch.from_numpy(np.array(node)))
    return tree, p


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_route_matches_jax(router):
    cfg = _cfg(router)
    tree, p = _params(cfg)
    xt = _x((40, D))
    jw, jidx, jprobs = jmoe.route(jax.tree.map(jnp.asarray, tree),
                                  jnp.asarray(xt), _jcfg(cfg))
    w, idx, probs = moe.route(p, torch.from_numpy(xt), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), **TOL)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-5)


def test_sigmoid_bias_acts_on_selection_only():
    cfg = _cfg("sigmoid")
    _, p = _params(cfg)
    xt = torch.from_numpy(_x((64, D)))
    w, idx, probs = moe.route(p, xt, cfg)
    with torch.no_grad():
        p.router_bias.zero_()
    w0, idx0, probs0 = moe.route(p, xt, cfg)
    assert not torch.equal(idx, idx0)
    torch.testing.assert_close(probs, probs0)
    same = (idx == idx0).all(-1)
    torch.testing.assert_close(w[same], w0[same])


@pytest.mark.parametrize("cap", [4, 100])
def test_dispatch_indices_match_jax(cap):
    rng = np.random.default_rng(cap)
    e, tk = 4, 24
    se = np.sort(rng.integers(0, e, tk)).astype(np.int32)
    stok = rng.permutation(tk).astype(np.int32) // 2
    sw = rng.uniform(0.1, 1.0, tk).astype(np.float32)
    jtok, jw, jkeep = jmoe._dispatch_indices(
        jnp.asarray(se), jnp.asarray(stok), jnp.asarray(sw), e, cap)
    tok, w, keep, dest = moe._dispatch_indices(
        torch.from_numpy(se).long(), torch.from_numpy(stok).long(),
        torch.from_numpy(sw), e, cap)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert bool((dest[~keep] == e * cap).all())
    assert (not keep.all()) == (cap == 4)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("capacity", [8.0, 0.5])
@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_moe_fwd_matches_jax(router, capacity, groups):
    cfg = _cfg(router, capacity, groups)
    tree, p = _params(cfg)
    x = _x((2, 16, D))
    jout, jmet = jmoe.moe_fwd(jax.tree.map(jnp.asarray, tree),
                              jnp.asarray(x), _jcfg(cfg))
    out, met = moe.moe_fwd(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    assert sorted(met) == sorted(jmet)
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), **TOL,
                                   err_msg=k)
    dropped = float(met["moe_dropped_frac"])
    assert (dropped > 0) if capacity < 1 else (dropped == 0)


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_moe_grads_match_jax(router):
    """d/dparams of sum(out * r) + the balance metric, at a capacity that
    drops."""
    cfg = _cfg(router, 0.5)
    tree, p = _params(cfg)
    x = _x((2, 16, D))
    r = _x((2, 16, D), seed=2)

    def jloss(params):
        out, met = jmoe.moe_fwd(params, jnp.asarray(x), _jcfg(cfg))
        return jnp.sum(out * r) + met["moe_balance_loss"]

    jg = jax.grad(jloss)(jax.tree.map(jnp.asarray, tree))
    p.requires_grad_(True)
    out, met = moe.moe_fwd(p, torch.from_numpy(x), cfg)
    loss = (out * torch.from_numpy(r)).sum() + met["moe_balance_loss"]
    names, leaves = zip(*p.named_parameters())
    gs = torch.autograd.grad(loss, leaves, allow_unused=True,
                             materialize_grads=True)
    for name, g in zip(names, gs):
        want = jg
        for key in name.split("."):
            want = want[key]
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **TOL,
                                   err_msg=name)
    assert not gs[names.index("router_bias")].any()
    assert gs[names.index("router_w")].abs().max() > 0


def test_update_router_bias_matches_jax():
    cfg = _cfg("sigmoid")
    tree, p = _params(cfg)
    counts = np.array([100.0, 10.0, 30.0, 10.0], np.float32)
    want = jmoe.update_router_bias(jax.tree.map(jnp.asarray, tree),
                                   jnp.asarray(counts), rate=0.1)
    before = p.router_bias.clone()
    assert moe.update_router_bias(p, torch.from_numpy(counts), 0.1) is p
    np.testing.assert_allclose(p.router_bias.numpy(),
                               np.asarray(want["router_bias"]), **TOL)
    assert p.router_bias[0] < before[0] and p.router_bias[1] > before[1]


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_moe_matches_dense_oracle(router):
    """Drop-free, the dispatched layer equals every expert run on every
    token and combined by the router weights (the reference's oracle)."""
    cfg = _cfg(router)
    tree, p = _params(cfg)
    x = _x((2, 16, D))
    want = dense_moe_oracle(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                            _jcfg(cfg))
    got, met = moe.moe_fwd(p, torch.from_numpy(x), cfg)
    assert float(met["moe_dropped_frac"]) == 0.0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_expert_stacks_are_drawn_per_expert():
    """``init_random_`` draws an (E, d, f) stack one expert at a time with
    the in-dim's fan: every expert's slab differs, each with the scale
    ``d^-1/2`` (``f^-1/2`` for ``w_down``)."""
    cfg = moe.MoEConfig(n_experts=4, top_k=2, d_ff_expert=256)
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(gen, 128, cfg, torch.float32)
    for w, fan in ((p.experts.w_gate, 128), (p.experts.w_up, 128),
                   (p.experts.w_down, 256)):
        stds = w.std(dim=(1, 2))
        assert torch.allclose(stds, torch.full_like(stds, fan ** -0.5),
                              rtol=0.05)
        assert not torch.equal(w[0], w[1])
    assert p.router_w.dtype == torch.float32
    assert not p.router_bias.any()
