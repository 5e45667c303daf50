"""chatglm3 smoke config served by the PyTorch port against the JAX package.

Both sides start from the JAX package's initial parameters, carried across
by ``repro_torch.convert.params_from_jax`` (biases and norm scales are
perturbed first so their wiring is tested too). Both run under a policy
with lowered classifier thresholds, so the smoke model's ``wk``/``wv``
projections route to tsm2r exactly as chatglm3-6b's do at full width and
>= 4096 prefill tokens. f32 throughout; tolerance rtol = atol = 1e-4
(the two packages sum attention and projections in different orders).
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
THRESH = dict(min_tall=32, max_skinny=32, skinny_ratio=2)


@pytest.fixture(scope="module")
def setup():
    cfg = registry.get_config("chatglm3-6b", smoke=True)
    jcfg = jregistry.get_config("chatglm3-6b", smoke=True)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    seg = tree["segments"][0]
    for key in ("bq", "bk", "bv"):
        seg["attn"][key] = rng.normal(0, 0.1, seg["attn"][key].shape
                                      ).astype(np.float32)
    for norm in (seg["norm1"], seg["norm2"], tree["final_norm"]):
        norm["scale"] = (1 + rng.normal(0, 0.1, norm["scale"].shape)
                         ).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = params_from_jax(cfg, tree, device="cpu")
    prompts = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, jcfg, jparams, params, prompts


def _policies():
    return tsmm.GemmPolicy(**THRESH), jtsmm.GemmPolicy(**THRESH)


def test_prefill_logits_and_route_match(setup):
    cfg, jcfg, jparams, params, prompts = setup
    pol, jpol = _policies()
    with jtsmm.policy(jpol), jtsmm.record_dispatches() as jlog:
        jlogits, _ = jmodel.prefill(jparams, jcfg,
                                    {"tokens": jnp.asarray(prompts)},
                                    jmodel.init_cache(jcfg, B, S + NEW))
    with tsmm.policy(pol), tsmm.record_dispatches() as log:
        logits, _ = model.prefill(
            params, cfg, {"tokens": torch.from_numpy(prompts).long()},
            model.init_cache(cfg, B, S + NEW, device="cpu"))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    # JAX traces one scanned layer body; the port walks every layer.
    assert ({(e.kind, e.shape) for e in log}
            == {(e.kind, e.shape) for e in jlog})
    kv = cfg.n_kv_heads * cfg.resolved_head_dim
    routed = [e for e in log if e.kind == "tsm2r"]
    assert len(routed) == 2 * cfg.n_layers
    assert all(e.shape == (B * S, cfg.d_model, kv) and
               e.executor == "torch-ref" for e in routed)


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


def test_sample_token_greedy_and_low_temperature():
    logits = torch.tensor([[1.0, 5.0, 2.0]])
    gen = torch.Generator().manual_seed(0)
    assert int(engine.sample_token(gen, logits, 0.0)[0]) == 1
    assert int(engine.sample_token(gen, logits, 0.01)[0]) == 1
