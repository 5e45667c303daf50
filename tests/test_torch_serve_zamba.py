"""zamba2 smoke config served by the PyTorch port against the JAX package.

Both sides start from the JAX package's initial parameters, carried across
by ``repro_torch.convert.params_from_jax``, with every leaf that starts
constant perturbed first: the shared LoRAs' ``b`` start at zero, so
without it their output would not reach the logits; the Mamba2 mixers'
``conv_b``, ``A_log``, ``D`` and ``dt_bias`` and every norm scale too.
The smoke config has 2 groups of 2 Mamba2 layers and a tail of 1, so the
leaves stacked twice (``segments.0.mamba.*``), once (the LoRAs,
``segments.1.*``) and not at all (``shared_block.*``) are all carried.
Both run under a policy with lowered classifier thresholds, under which
the shared LoRAs' down projection ``[B*S, 64]·[64, 8]`` routes to tsm2r as
zamba2-1.2b's ``[B*S, 2048]·[2048, 128]`` does at full width under the
defaults, and every other projection stays dense. f32 throughout;
tolerance rtol = atol = 1e-4 (the packages sum in different orders), and
the decode tolerance of the JAX Mamba2 tests (rtol 2e-3, atol 2e-4) for
cached decode against the teacher-forced forward.
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
from repro_torch import layout
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.core import tsmm
from repro_torch.models import model
from repro_torch.serve import engine

B, S, NEW = 4, 24, 6
TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-4)
THRESH = dict(min_tall=32, max_skinny=32, skinny_ratio=2)
ARCH = "zamba2-1.2b"


def perturb(tree, rng):
    """Every leaf of the zamba2 tree that starts constant, from ``rng``."""
    group, tail = tree["segments"]
    mixers = (group["mamba"]["mixer"], tail["mixer"])
    for mx in mixers:
        for key, mean, sd in (("conv_b", 0, 0.1), ("A_log", 0, 0.5),
                              ("D", 1, 0.3), ("dt_bias", 0, 0.5)):
            mx[key] = (mean + rng.normal(0, sd, mx[key].shape)
                       ).astype(mx[key].dtype)
    for lora in (group["lora_attn"], group["lora_ffn"]):
        lora["b"] = rng.normal(0, 0.3, lora["b"].shape).astype(
            lora["b"].dtype)
    shared = tree["shared_block"]
    for norm in (group["mamba"]["norm1"], tail["norm1"], *(
            mx["norm"] for mx in mixers), shared["norm1"], shared["norm2"],
            tree["final_norm"]):
        norm["scale"] = (1 + rng.normal(0, 0.1, norm["scale"].shape)
                         ).astype(norm["scale"].dtype)
    return tree


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


def test_model_holds_groups_tail_and_shared_block(setup):
    cfg, _, _, params, _ = setup
    assert [len(g.mamba) for g in params.groups] == [2, 2]
    assert len(params.tail) == 1 and not hasattr(params, "layers")
    assert [s.kind for s in model.segments(cfg)] == ["zamba_group", "mamba"]
    named = dict(params.named_parameters())
    shapes = {p: layout.jax_shape(named, n)
              for p, n in layout.jax_leaves(named).items()}
    assert shapes["segments.0.mamba.mixer.in_proj"] == (2, 2, 64, 276)
    assert shapes["segments.0.lora_ffn.b"] == (2, 8, 64)
    assert shapes["segments.1.mixer.D"] == (1, 4)
    assert shapes["shared_block.attn.wq"] == (64, 64)


def test_prefill_logits_and_route_match(setup):
    cfg = setup[0]
    (jlogits, _, jlog), (logits, _, log) = _prefill(setup)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    # JAX traces one scanned group body; the port walks every group.
    assert ({(e.kind, e.shape) for e in log}
            == {(e.kind, e.shape) for e in jlog})
    routed = [e for e in log if e.kind != "dense"]
    n_groups = cfg.n_layers // cfg.hybrid_period
    assert len(routed) == 2 * n_groups
    assert all(e.kind == "tsm2r"
               and e.shape == (B * S, cfg.d_model, cfg.shared_lora_rank)
               and e.executor == "torch-ref" for e in routed)


def test_prefill_cache_matches_jax(setup):
    """The flat cache in execution order against JAX's per-segment
    stacks: each group's Mamba2 entries then its shared-block K/V, then
    the tail."""
    cfg = setup[0]
    (_, jcache, _), (_, cache, _) = _prefill(setup)
    period, n_groups = cfg.hybrid_period, cfg.n_layers // cfg.hybrid_period
    want = []
    for g in range(n_groups):
        want += [{k: v[g, i] for k, v in jcache[0]["mamba"].items()}
                 for i in range(period)]
        want.append({k: v[g] for k, v in jcache[0]["shared"].items()})
    want += [{k: v[i] for k, v in jcache[1].items()}
             for i in range(cfg.n_layers - n_groups * period)]
    assert len(cache) == len(want) == cfg.n_layers + n_groups
    for i, (got, exp) in enumerate(zip(cache, want)):
        assert sorted(got) == sorted(exp)
        for key, t in got.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(exp[key]),
                                       **TOL, err_msg=f"{i}.{key}")
        if "ssm" in got:
            assert got["ssm"].dtype == torch.float32


def test_forward_logits_match(setup):
    cfg, jcfg, jparams, params, prompts = setup
    pol, jpol = _policies()
    with jtsmm.policy(jpol):
        jlogits, _ = jmodel.forward(jparams, jcfg,
                                    {"tokens": jnp.asarray(prompts)})
    with tsmm.policy(pol):
        logits, _ = model.forward(
            params, cfg, {"tokens": torch.from_numpy(prompts).long()})
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **TOL)


def test_decode_matches_jax_and_the_forward(setup):
    """Cached decode of the given tokens: each step's logits against JAX's
    decode and against the teacher-forced forward at that position."""
    cfg, jcfg, jparams, params, prompts = setup
    pol, jpol = _policies()
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, NEW)
                                             ).astype(np.int32)
    full = np.concatenate([prompts, toks], axis=1)
    with tsmm.policy(pol), torch.no_grad():
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


@pytest.mark.parametrize("lora", ["lora_attn", "lora_ffn"])
def test_lora_output_reaches_the_logits(setup, lora):
    """With either shared LoRA's ``b`` zeroed the logits move: its
    kernel's output is on the path (at init ``b`` is zero and it would not
    be)."""
    cfg, _, _, params, prompts = setup
    tokens = {"tokens": torch.from_numpy(prompts).long()}
    with torch.no_grad():
        logits, _ = model.forward(params, cfg, tokens)
    saved = [getattr(g, lora).b.clone() for g in params.groups]
    try:
        for g in params.groups:
            getattr(g, lora).b.data.zero_()
        with torch.no_grad():
            zeroed, _ = model.forward(params, cfg, tokens)
    finally:
        for g, b in zip(params.groups, saved):
            getattr(g, lora).b.data.copy_(b)
    assert float((zeroed - logits).abs().max()) > 1e-2
