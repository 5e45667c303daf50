"""rwkv6 smoke config served by the PyTorch port against the JAX package.

Both sides start from the JAX package's initial parameters, carried across
by ``repro_torch.convert.params_from_jax``, with every leaf that starts
constant perturbed first (the decay LoRA's ``b`` starts at zero, so
without it the LoRA's output would not reach the logits; ``w0``, ``u``,
``ln_x`` and the block and final LayerNorms too). Both run under a policy
with lowered classifier thresholds, under which the decay LoRA's down
projection ``[B*S, 64]·[64, 8]`` routes to tsm2r as rwkv6-1.6b's
``[B*S, 2048]·[2048, 64]`` does at full width under the defaults, and
every other projection stays dense. f32 throughout; tolerance rtol = atol
= 1e-4 (the packages sum in different orders), and the decode tolerance of
the JAX RWKV6 tests (rtol 2e-3, atol 2e-4) for cached decode against the
teacher-forced forward.
"""

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

B, S, NEW = 4, 24, 6
TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-4)
THRESH = dict(min_tall=32, max_skinny=32, skinny_ratio=2)


def perturb(tree, rng):
    """Every leaf of the rwkv6 tree that starts constant, from ``rng``."""
    seg = tree["segments"][0]
    tm = seg["time_mix"]
    tm["w0"] = (tm["w0"] + rng.normal(0, 1, tm["w0"].shape)
                ).astype(np.float32)
    for key, leaf in (("u", tm), ("b", tm["w_lora"])):
        leaf[key] = rng.normal(0, 0.3, leaf[key].shape).astype(np.float32)
    for norm in (seg["norm1"], seg["norm2"], tm["ln_x"], tree["final_norm"]):
        norm["scale"] = (1 + rng.normal(0, 0.1, norm["scale"].shape)
                         ).astype(np.float32)
        norm["bias"] = rng.normal(0, 0.1, norm["bias"].shape
                                  ).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def setup():
    cfg = registry.get_config("rwkv6-1.6b", smoke=True)
    jcfg = jregistry.get_config("rwkv6-1.6b", smoke=True)
    rng = np.random.default_rng(0)
    tree = perturb(jax.tree.map(np.asarray,
                                jmodel.init(jax.random.PRNGKey(0), jcfg)), rng)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_jax(cfg, tree, device="cpu")
    prompts = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, jcfg, jparams, params, prompts


def _policies():
    return tsmm.GemmPolicy(**THRESH), jtsmm.GemmPolicy(**THRESH)


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


def test_prefill_logits_and_route_match(setup):
    cfg = setup[0]
    (jlogits, _, jlog), (logits, _, log) = _prefill(setup)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    # JAX traces one scanned layer body; the port walks every layer.
    assert ({(e.kind, e.shape) for e in log}
            == {(e.kind, e.shape) for e in jlog})
    rank = cfg.rwkv.decay_lora_rank
    routed = [e for e in log if e.kind != "dense"]
    assert len(routed) == cfg.n_layers
    assert all(e.kind == "tsm2r" and e.shape == (B * S, cfg.d_model, rank)
               and e.executor == "torch-ref" for e in routed)


def test_prefill_cache_matches_jax(setup):
    cfg = setup[0]
    (_, jcache, _), (_, cache, _) = _prefill(setup)
    assert len(cache) == cfg.n_layers
    for i, entry in enumerate(cache):
        assert sorted(entry) == ["cm_prev", "tm_prev", "wkv"]
        for key, t in entry.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jcache[0][key][i]),
                                       **TOL, err_msg=f"{i}.{key}")
        assert entry["wkv"].dtype == torch.float32


def test_forward_logits_match(setup):
    cfg, jcfg, jparams, params, prompts = setup
    pol, jpol = _policies()
    with jtsmm.policy(jpol):
        jlogits, _ = jmodel.forward(jparams, jcfg,
                                    {"tokens": jnp.asarray(prompts)})
    with tsmm.policy(pol):
        logits, _ = model.forward(
            params, cfg, {"tokens": torch.from_numpy(prompts).long()})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


def test_decode_matches_jax_and_the_forward(setup):
    """Cached decode of the given tokens: each step's logits against JAX's
    decode and against the teacher-forced forward at that position."""
    cfg, jcfg, jparams, params, prompts = setup
    pol, jpol = _policies()
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, NEW)
                                             ).astype(np.int32)
    full = np.concatenate([prompts, toks], axis=1)
    with tsmm.policy(pol):
        forced, _ = model.forward(params, cfg,
                                  {"tokens": torch.from_numpy(full).long()})
        _, cache = model.prefill(
            params, cfg, {"tokens": torch.from_numpy(prompts).long()},
            model.init_cache(cfg, B, S + NEW, device="cpu"))
    with jtsmm.policy(jpol):
        _, jcache = jmodel.prefill(jparams, jcfg,
                                   {"tokens": jnp.asarray(prompts)},
                                   jmodel.init_cache(jcfg, B, S + NEW))
    for i in range(NEW):
        with tsmm.policy(pol):
            logits, cache = model.decode_step(
                params, cfg, torch.from_numpy(toks[:, i:i + 1]).long(),
                S + i, cache)
        with jtsmm.policy(jpol):
            jlogits, jcache = jmodel.decode_step(
                jparams, jcfg, jnp.asarray(toks[:, i:i + 1]), S + i, jcache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        np.testing.assert_allclose(logits.numpy(),
                                   forced[:, S + i].numpy(), **DECODE_TOL)


def test_greedy_generate_matches(setup):
    cfg, jcfg, jparams, params, prompts = setup
    pol, jpol = _policies()
    jout = jengine.generate(jparams, jcfg, jnp.asarray(prompts), NEW,
                            policy=jpol)
    out = engine.generate(params, cfg, torch.from_numpy(prompts).long(), NEW,
                          policy=pol, device="cpu")
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_sampled_tokens_in_vocab(setup):
    cfg, _, _, params, prompts = setup
    gen = torch.Generator().manual_seed(3)
    out = engine.generate(params, cfg, torch.from_numpy(prompts).long(), NEW,
                          generator=gen, temperature=1.0, device="cpu")
    assert out.shape == (B, NEW)
    assert bool(((out >= 0) & (out < cfg.vocab_size)).all())


def test_lora_output_reaches_the_logits(setup):
    """With the LoRA's ``b`` zeroed the logits move: the kernel's output is
    on the path (at init ``b`` is zero and it would not be)."""
    cfg, _, _, params, prompts = setup
    tokens = {"tokens": torch.from_numpy(prompts).long()}
    logits, _ = model.forward(params, cfg, tokens)
    saved = [lp.time_mix.w_lora.b.clone() for lp in params.layers]
    try:
        for lp in params.layers:
            lp.time_mix.w_lora.b.data.zero_()
        zeroed, _ = model.forward(params, cfg, tokens)
    finally:
        for lp, b in zip(params.layers, saved):
            lp.time_mix.w_lora.b.data.copy_(b)
    assert float((zeroed - logits).abs().max()) > 1e-2
