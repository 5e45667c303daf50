"""The mixtral and deepseek-v3 smoke configs served by the port against the
JAX package, on the CPU.

Both sides start from the JAX package's initial parameters, carried
across by ``repro_torch.convert.params_from_jax``, with the leaves that
start constant perturbed first: every norm scale (MLA's ``q_norm`` and
``kv_norm`` too) and deepseek's ``router_bias``, so the selection-only
bias changes which experts run. mixtral's smoke window is 16 and the
prompt is 24 tokens, so its caches are 16-slot rings and every decode
step wraps; deepseek's are MLA's latent caches, one dense MLA layer and
two MoE layers. Both run under a policy with lowered classifier
thresholds, under which the router's ``[B*S, 64]·[64, 4]`` routes to
tsm2r as the full-width routers do under the defaults. f32; rtol = atol =
1e-4 against JAX, and the JAX decode tests' rtol 2e-3 / atol 2e-4 for
cached decode against the teacher-forced forward. The smoke configs'
capacity is drop-free, so decode and forward route alike.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import tsmm as jtsmm
from repro.models import model as jmodel
from repro.serve import engine as jengine
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.core import tsmm
from repro_torch.models import model
from repro_torch.serve import engine

B, S, NEW = 2, 24, 6
TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-4)
THRESH = dict(min_tall=32, max_skinny=32, skinny_ratio=2)
ARCHS = ["mixtral-8x7b", "deepseek-v3-671b"]


def perturb(tree, rng):
    """Every norm scale of the tree, and every router bias, from ``rng``."""
    def walk(node):
        if isinstance(node, dict):
            for key, sub in node.items():
                if key == "scale" or key == "router_bias":
                    mean = 1.0 if key == "scale" else 0.0
                    node[key] = (mean + rng.normal(0, 0.1 if key == "scale"
                                                   else 0.3, sub.shape)
                                 ).astype(sub.dtype)
                else:
                    walk(sub)
        elif isinstance(node, (list, tuple)):
            for sub in node:
                walk(sub)
    walk(tree)
    return tree


def _setup(arch, **replace):
    cfg = dataclasses.replace(registry.get_config(arch, smoke=True),
                              **replace)
    jcfg = dataclasses.replace(jregistry.get_config(arch, smoke=True),
                               **replace)
    rng = np.random.default_rng(0)
    tree = perturb(jax.tree.map(np.asarray,
                                jmodel.init(jax.random.PRNGKey(0), jcfg)), rng)
    params = params_from_jax(cfg, tree, device="cpu")
    prompts = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, jcfg, jax.tree.map(jnp.asarray, tree), params, prompts


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    return _setup(request.param)


def _policies():
    return tsmm.GemmPolicy(**THRESH), jtsmm.GemmPolicy(**THRESH)


def test_layers_and_segments(setup):
    cfg, _, _, params, _ = setup
    kinds = [s.kind for s in model.segments(cfg)]
    if cfg.mla is None:
        assert kinds == ["attn_moe"] and not hasattr(params, "tail")
        assert len(params.layers) == cfg.n_layers
    else:
        assert kinds == ["mla_mlp", "mla_moe"]
        assert len(params.layers) == cfg.first_k_dense
        assert len(params.tail) == cfg.n_layers - cfg.first_k_dense
        assert params.tail[0].ffn.shared.w_gate.shape == (64, 32)
    moe_layer = (params.tail if cfg.mla else params.layers)[0].ffn
    assert moe_layer.router_w.dtype == torch.float32
    assert moe_layer.experts.w_gate.shape == (
        cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert)


def test_forward_logits_and_metrics_match(setup):
    cfg, jcfg, jparams, params, prompts = setup
    jlogits, jmet = jmodel.forward(jparams, jcfg,
                                   {"tokens": jnp.asarray(prompts)})
    with torch.no_grad():
        logits, met = model.forward(
            params, cfg, {"tokens": torch.from_numpy(prompts).long()})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert sorted(met) == sorted(jmet) == [
        "moe_balance_loss", "moe_dropped_frac", "moe_max_load"]
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), **TOL,
                                   err_msg=k)


def _prefill(setup):
    cfg, jcfg, jparams, params, prompts = setup
    pol, jpol = _policies()
    with jtsmm.policy(jpol), jtsmm.record_dispatches() as jlog:
        jlogits, jcache = jmodel.prefill(jparams, jcfg,
                                         {"tokens": jnp.asarray(prompts)},
                                         jmodel.init_cache(jcfg, B, S + NEW))
    with tsmm.policy(pol), tsmm.record_dispatches() as log:
        logits, cache = model.prefill(
            params, cfg, {"tokens": torch.from_numpy(prompts).long()},
            model.init_cache(cfg, B, S + NEW, device="cpu"))
    return (jlogits, jcache, jlog), (logits, cache, log)


def test_prefill_logits_routes_and_cache_match(setup):
    cfg = setup[0]
    (jlogits, jcache, jlog), (logits, cache, log) = _prefill(setup)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert ({(e.kind, e.shape) for e in log}
            == {(e.kind, e.shape) for e in jlog})
    router = (B * S, cfg.d_model, cfg.moe.n_experts)
    n_moe = cfg.n_layers - cfg.first_k_dense
    assert [e.kind for e in log if e.shape == router] == ["tsm2r"] * n_moe
    want = [{k: v[i] for k, v in seg.items()}
            for seg in jcache for i in range(next(iter(seg.values()))
                                             .shape[0])]
    assert len(cache) == len(want) == cfg.n_layers
    for i, (got, exp) in enumerate(zip(cache, want)):
        assert sorted(got) == sorted(exp)
        for key, t in got.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(exp[key]),
                                       **TOL, err_msg=f"{i}.{key}")


def test_cache_shapes(setup):
    cfg = setup[0]
    cache = model.init_cache(cfg, B, S + NEW, device="cpu")
    if cfg.mla is None:
        ring = (B, cfg.attn_window, cfg.n_kv_heads, cfg.resolved_head_dim)
        assert all(c["k"].shape == c["v"].shape == ring for c in cache)
        short = model.init_cache(cfg, B, 10, device="cpu")
        assert short[0]["k"].shape[1] == 10
    else:
        assert all(c["c"].shape == (B, S + NEW, cfg.mla.kv_lora)
                   and c["kpe"].shape == (B, S + NEW, cfg.mla.rope_dim)
                   for c in cache)


def _decode_both(setup, steps):
    cfg, jcfg, jparams, params, prompts = setup
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, steps)).astype(np.int32)
    jcache = jmodel.init_cache(jcfg, B, S + steps)
    _, jcache = jmodel.prefill(jparams, jcfg, {"tokens": jnp.asarray(prompts)},
                               jcache)
    cache = model.init_cache(cfg, B, S + steps, device="cpu")
    _, cache = model.prefill(params, cfg,
                             {"tokens": torch.from_numpy(prompts).long()},
                             cache)
    out = []
    for i in range(steps):
        tok = tokens[:, i:i + 1]
        jl, jcache = jmodel.decode_step(jparams, jcfg, jnp.asarray(tok),
                                        S + i, jcache)
        lg, cache = model.decode_step(params, cfg, torch.from_numpy(tok)
                                      .long(), S + i, cache)
        out.append((np.asarray(jl), lg.numpy()))
    return tokens, out


def test_decode_steps_match_jax_and_forward(setup):
    cfg, _, _, params, prompts = setup
    tokens, out = _decode_both(setup, NEW)
    for i, (jl, lg) in enumerate(out):
        np.testing.assert_allclose(lg, jl, **TOL, err_msg=f"step {i}")
    with torch.no_grad():
        forced, _ = model.forward(params, cfg, {"tokens": torch.from_numpy(
            np.concatenate([prompts, tokens], 1)).long()})
    for i, (_, lg) in enumerate(out):
        np.testing.assert_allclose(lg, forced[:, S + i].numpy(),
                                   **DECODE_TOL, err_msg=f"step {i}")


def test_generate_matches_jax(setup):
    cfg, jcfg, jparams, params, prompts = setup
    want = jengine.generate(jparams, jcfg, jnp.asarray(prompts), NEW)
    got = engine.generate(params, cfg, torch.from_numpy(prompts).long(), NEW,
                          device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mla_decode_without_absorption_matches_jax():
    """deepseek with ``mla_absorb=False``: the latent cache re-expanded
    through W_ukv every step, against JAX's and the absorbed arm."""
    setup = _setup("deepseek-v3-671b", mla_absorb=False)
    _, out = _decode_both(setup, 3)
    absorbed = _decode_both(_setup("deepseek-v3-671b"), 3)[1]
    for (jl, lg), (_, la) in zip(out, absorbed):
        np.testing.assert_allclose(lg, jl, **TOL)
        np.testing.assert_allclose(lg, la, **DECODE_TOL)


def test_router_bias_moves_deepseek_logits():
    """The selection-only bias reaches the logits: zeroing it changes
    which experts run."""
    cfg, _, _, params, prompts = _setup("deepseek-v3-671b")
    toks = {"tokens": torch.from_numpy(prompts).long()}
    with torch.no_grad():
        before, _ = model.forward(params, cfg, toks)
        for lp in params.tail:
            lp.ffn.router_bias.zero_()
        after, _ = model.forward(params, cfg, toks)
    assert (before - after).abs().max() > 1e-3
