"""zamba2 in bfloat16: the PyTorch port against the JAX package on the CPU.

Both packages start from the JAX package's initial parameters of the
zamba2 smoke config in bf16, every leaf that starts constant perturbed
(``test_torch_serve_zamba.perturb``), carried across by
``params_from_jax``; the f32 arms use the same values cast to f32.

* The Mamba2 layer in bf16 gives the reference's bf16 outputs and conv
  states bit for bit: the port rounds where the reference rounds
  (``_causal_conv`` summed in the activation dtype, the SSD in f32, ``y``
  cast back before the gated norm), forward and decode. Its f32 SSM
  state is summed in another order, so it is held at the JAX Mamba2
  tests' f32 tolerance, rtol = atol = 2e-4.
* The whole model in bf16 sums in other orders than the reference (its
  SwiGLU rounds ``silu(g)`` before the product, XLA fuses it), so two
  correct bf16 models differ by about their own rounding. The port's
  bf16 logits may sit at most ``X`` = 2 times as far from the reference's
  f32 logits as the reference's bf16 logits do, at 5, 11, 23 and 37
  layers (readings 1.04-1.34 times). The reference's own bf16 distance
  from f32 stays under 0.1 of the largest logit at every depth (readings
  0.039-0.047): at this width depth does not amplify bf16 rounding.
* Cached decode in bf16 against the teacher-forced forward, by the
  relations zamba-serve holds on the card (``chip_smoke.py``'s
  ``ZAMBA_FLOOR_X``): each step's logits no further from the f32 forward
  than ``FLOOR_X`` = 1.25 times the bf16 forward is (readings 0.98-1.00
  in both packages at 5 and 11 layers, 0.97-1.02 on the card), and no
  further from the bf16 forward than the bf16 forward is from f32
  (readings 0-0.24 of it); the same relations hold for the reference,
  and the port's distance from f32 is at most ``X`` times the
  reference's (readings 0.83-1.50).

Run as a script, the file prints these readings.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import mamba2 as jmamba2
from repro.models import model as jmodel
from repro_torch.configs import registry
from repro_torch.convert import params_from_jax
from repro_torch.models import mamba2, model
from test_torch_mamba2 import CFG, D, JCFG, _node
from test_torch_mamba2 import params as mamba2_params
from test_torch_serve_zamba import perturb

ARCH = "zamba2-1.2b"
B, S, NEW = 2, 32, 4
X = 2.0
REF_GAP = 0.1
FLOOR_X = 1.25
F32_LEAVES = ("A_log", "D", "dt_bias")
STATE_TOL = dict(rtol=2e-4, atol=2e-4)


def nerr(got, want) -> float:
    """Largest absolute difference over the largest magnitude of ``want``."""
    got, want = (np.asarray(t, np.float32) for t in (got, want))
    return float(np.abs(got - want).max() / np.abs(want).max())


def _mamba2_bf16(seed):
    """The JAX layer's f32 and bf16 params (A_log, D, dt_bias stay f32, as
    ``mamba2_init`` makes them) and the port's bf16 layer."""
    jp, _ = mamba2_params(seed)
    jp16 = {k: v if k in F32_LEAVES else jax.tree.map(
        lambda t: t.astype(jnp.bfloat16), v) for k, v in jp.items()}
    port = mamba2.Mamba2(D, CFG, torch.bfloat16, "cpu")
    for name, p in port.named_parameters():
        src = np.asarray(_node(jp16, name), np.float32)
        p.data.copy_(torch.from_numpy(src).to(p.dtype))
    return jp, jp16, port


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mamba2_layer_bf16_rounds_as_the_reference(seed):
    jp, jp16, port = _mamba2_bf16(seed)
    x = np.random.default_rng(seed).normal(size=(2, 24, D))
    jx = jnp.asarray(x, jnp.bfloat16)
    jy, (jstate, jconv) = jmamba2.mamba2_fwd(jp16, jx, JCFG,
                                             return_state=True)
    y, (state, conv) = mamba2.mamba2_fwd(port, _t(x), CFG,
                                         return_state=True)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    for got, want in ((y, jy), (conv, jconv)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **STATE_TOL)
    # and it is a bf16 result: not the f32 layer's
    assert nerr(y.float(), jmamba2.mamba2_fwd(jp, jnp.asarray(x, jnp.float32),
                                              JCFG)) > 1e-3
    step = np.random.default_rng(10 + seed).normal(size=(2, 1, D))
    jd, jstate2, jconv2 = jmamba2.mamba2_decode(
        jp16, jnp.asarray(step, jnp.bfloat16), jstate, jconv, JCFG)
    d, state2, conv2 = mamba2.mamba2_decode(port, _t(step), state, conv, CFG)
    for got, want in ((d, jd), (conv2, jconv2)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    np.testing.assert_allclose(state2.numpy(), np.asarray(jstate2),
                               **STATE_TOL)


def _models(n_layers):
    """(port bf16, port f32, JAX bf16 params, JAX f32 params, configs) of
    the smoke config at ``n_layers`` (odd: the tail keeps one layer)."""
    cfg16 = dataclasses.replace(registry.get_config(ARCH, smoke=True),
                                dtype="bfloat16", n_layers=n_layers)
    jcfg16 = dataclasses.replace(jregistry.get_config(ARCH, smoke=True),
                                 dtype="bfloat16", n_layers=n_layers)
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    jcfg32 = dataclasses.replace(jcfg16, dtype="float32")
    rng = np.random.default_rng(0)
    tree = perturb(jax.tree.map(
        np.asarray, jmodel.init(jax.random.PRNGKey(0), jcfg16)), rng)
    tree32 = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    return ((params_from_jax(cfg16, tree, device="cpu"), cfg16),
            (params_from_jax(cfg32, tree32, device="cpu"), cfg32),
            (jax.tree.map(jnp.asarray, tree), jcfg16),
            (jax.tree.map(jnp.asarray, tree32), jcfg32), rng)


@pytest.mark.parametrize("n_layers", [5, 11, 23, 37])
def test_bf16_forward_is_as_close_to_f32_as_the_references(n_layers):
    (p16, cfg16), (p32, cfg32), (j16, jcfg16), (j32, jcfg32), rng = (
        _models(n_layers))
    tokens = rng.integers(0, cfg16.vocab_size, (B, S)).astype(np.int32)
    jlog16, _ = jmodel.forward(j16, jcfg16, {"tokens": jnp.asarray(tokens)})
    jlog32, _ = jmodel.forward(j32, jcfg32, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        log16, _ = model.forward(p16, cfg16,
                                 {"tokens": torch.from_numpy(tokens).long()})
        log32, _ = model.forward(p32, cfg32,
                                 {"tokens": torch.from_numpy(tokens).long()})
    ref_gap = nerr(jlog16, jlog32)
    assert nerr(log32, jlog32) < 1e-4          # the f32 arms agree
    assert 1e-3 < ref_gap <= REF_GAP
    assert nerr(log16, jlog32) <= X * ref_gap


def _decode_distances(n_layers) -> list:
    """Each cached bf16 decode step of the port and of the reference:
    {package: (decode vs the f32 forward, the bf16 forward vs the f32
    forward, decode vs the bf16 forward)}."""
    (p16, cfg16), _, (j16, jcfg16), (j32, jcfg32), rng = _models(n_layers)
    prompts = rng.integers(0, cfg16.vocab_size, (B, S)).astype(np.int32)
    toks = rng.integers(0, cfg16.vocab_size, (B, NEW)).astype(np.int32)
    full = np.concatenate([prompts, toks], axis=1)
    exact, _ = jmodel.forward(j32, jcfg32, {"tokens": jnp.asarray(full)})
    jforced, _ = jmodel.forward(j16, jcfg16, {"tokens": jnp.asarray(full)})
    _, jcache = jmodel.prefill(j16, jcfg16, {"tokens": jnp.asarray(prompts)},
                               jmodel.init_cache(jcfg16, B, S + NEW))
    with torch.no_grad():
        forced, _ = model.forward(p16, cfg16,
                                  {"tokens": torch.from_numpy(full).long()})
        _, cache = model.prefill(
            p16, cfg16, {"tokens": torch.from_numpy(prompts).long()},
            model.init_cache(cfg16, B, S + NEW, device="cpu"))
    steps = []
    for i in range(NEW):
        logits, cache = model.decode_step(
            p16, cfg16, torch.from_numpy(toks[:, i:i + 1]).long(), S + i,
            cache)
        jlogits, jcache = jmodel.decode_step(
            j16, jcfg16, jnp.asarray(toks[:, i:i + 1]), S + i, jcache)
        assert logits.dtype == torch.float32
        want = exact[:, S + i]
        steps.append({name: (nerr(dec, want), nerr(fwd, want),
                             nerr(dec, fwd))
                      for name, dec, fwd in (
                          ("port", logits, forced[:, S + i]),
                          ("reference", jlogits, jforced[:, S + i]))})
    return steps


@pytest.mark.parametrize("n_layers", [5, 11])
def test_bf16_decode_matches_the_forward_as_the_references(n_layers):
    for step in _decode_distances(n_layers):
        for to_f32, floor, to_forward in step.values():
            assert 1e-3 < floor <= REF_GAP
            assert to_f32 <= FLOOR_X * floor
            assert to_forward <= floor
        assert step["port"][0] <= X * step["reference"][0]


def _readings(n_layers) -> dict:
    """The distances the tests above bound, at ``n_layers``."""
    (p16, cfg16), (p32, cfg32), (j16, jcfg16), (j32, jcfg32), rng = (
        _models(n_layers))
    tokens = rng.integers(0, cfg16.vocab_size, (B, S)).astype(np.int32)
    jlog16, _ = jmodel.forward(j16, jcfg16, {"tokens": jnp.asarray(tokens)})
    jlog32, _ = jmodel.forward(j32, jcfg32, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        log16, _ = model.forward(p16, cfg16,
                                 {"tokens": torch.from_numpy(tokens).long()})
    return {"layers": n_layers, "reference_bf16_vs_f32": nerr(jlog16, jlog32),
            "port_bf16_vs_f32": nerr(log16, jlog32),
            "port_bf16_vs_reference_bf16": nerr(log16, jlog16)}


if __name__ == "__main__":
    # Prints the readings: python tests/test_torch_bf16_zamba.py
    # (with src and tests on PYTHONPATH, JAX on the CPU).
    import json

    for n in (5, 11, 23, 37):
        print(json.dumps(_readings(n)), flush=True)
    for n in (5, 11):
        steps = _decode_distances(n)
        print(json.dumps({"layers": n, **{
            f"{name}_decode_to_f32_over_forward_to_f32": [
                st[name][0] / st[name][1] for st in steps]
            for name in ("port", "reference")}, "port_over_reference": [
                st["port"][0] / st["reference"][0] for st in steps]}),
            flush=True)
    for seed in (0, 1, 2):
        jp, jp16, port = _mamba2_bf16(seed)
        x = np.random.default_rng(seed).normal(size=(2, 24, D))
        jy, (jstate, _) = jmamba2.mamba2_fwd(
            jp16, jnp.asarray(x, jnp.bfloat16), JCFG, return_state=True)
        y, (state, _) = mamba2.mamba2_fwd(port, _t(x), CFG,
                                          return_state=True)
        print(json.dumps({"mamba2_seed": seed,
                          "bf16_out_vs_reference": nerr(y.float(), jy),
                          "f32_state_vs_reference": nerr(state, jstate)}))
