"""Checkpointed training backward of the port, on the CPU.

The JAX package checkpoints every kv tile step of its chunked attention
(``jax.checkpoint(kv_step)``) and, with ``ModelConfig.remat`` (default
True), every layer. The port does the same with ``torch.utils.checkpoint``
(``models.layers.remat``). Here the checkpointed arms are held against a
plain arm, in which ``layers.remat`` calls its function straight, on the
chatglm3 smoke config in f32: the loss and every gradient must be equal
(rtol 1e-6, atol 1e-7: the recompute repeats the forward's arithmetic, so
only the order in which autograd adds a tensor's gradient contributions
may differ). The recompute must also route as the forward did, and
serving under ``inference_mode`` must not checkpoint at all.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro_torch.configs import base, registry
from repro_torch.core import tsmm
from repro_torch.data import pipeline
from repro_torch.models import attention, layers, model
from repro_torch.train import train_step

EQUAL = dict(rtol=1e-6, atol=1e-7)
# Lowered thresholds route the smoke model's wk/wv to tsm2r, as
# chatglm3-6b's route at full width (tests/test_torch_train.py).
POLICY = tsmm.GemmPolicy(min_tall=32, max_skinny=32, skinny_ratio=2)
DATA = dict(seed=0, seq_len=32, global_batch=2, vocab_size=256)


def _plain(fn, *args):
    return fn(*args)


def _cfg(remat):
    return dataclasses.replace(registry.get_config("chatglm3-6b", smoke=True),
                               remat=remat)


def _params(cfg):
    params = model.init(cfg, seed=0, device="cpu")
    params.requires_grad_(True)
    return params


def _loss_and_grads(cfg, params, batch):
    named = dict(params.named_parameters())
    with tsmm.policy(POLICY), tsmm.record_dispatches() as log:
        loss, _ = train_step.make_loss_fn(cfg)(params, batch)
        grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), dict(zip(named, grads)), log


def _batch():
    b = pipeline.batch_for_step(pipeline.DataConfig(**DATA), 0)
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def test_remat_defaults_to_the_jax_packages():
    fields = {f.name: f.default for f in dataclasses.fields(base.ModelConfig)}
    jfields = {f.name: f.default
               for f in dataclasses.fields(jbase.ModelConfig)}
    assert fields["remat"] is True and jfields["remat"] is True
    assert registry.get_config("chatglm3-6b").remat


def test_checkpointed_kv_step_gives_the_plain_gradients(monkeypatch):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 40, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16)))
    ct = torch.from_numpy(rng.standard_normal((2, 40, 4, 16))
                          .astype(np.float32))
    calls = []

    def counting(fn, *args):
        calls.append(fn.__name__)
        return real(fn, *args)

    real = layers.remat
    arms = []
    for wrap in (counting, _plain):
        monkeypatch.setattr(layers, "remat", wrap)
        xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = attention.chunked_attention(*xs, q_chunk=16, kv_chunk=16)
        out.backward(ct)
        arms.append((out.detach(), *(t.grad for t in xs)))
    # Causal tiles of 16 over 40 positions: 1 + 2 + 3 kv steps.
    assert calls == ["_kv_step"] * 6
    for got, want in zip(*arms):
        torch.testing.assert_close(got, want, **EQUAL)


@pytest.mark.parametrize("remat_layers,kv_step", [
    (True, True), (False, True), (True, False)])
def test_checkpointed_arms_give_the_plain_loss_and_gradients(
        monkeypatch, remat_layers, kv_step):
    batch = _batch()
    plain_cfg = _cfg(False)
    monkeypatch.setattr(layers, "remat", _plain)
    want_loss, want, _ = _loss_and_grads(plain_cfg, _params(plain_cfg), batch)
    monkeypatch.undo()
    if not kv_step:     # only the layers are checkpointed
        real = layers.remat
        monkeypatch.setattr(layers, "remat", lambda fn, *a: (
            fn(*a) if fn is attention._kv_step else real(fn, *a)))
    cfg = _cfg(remat_layers)
    loss, grads, _ = _loss_and_grads(cfg, _params(cfg), batch)
    torch.testing.assert_close(loss, want_loss, **EQUAL)
    assert grads.keys() == want.keys()
    for name in want:
        torch.testing.assert_close(grads[name], want[name], **EQUAL,
                                   msg=name)


@pytest.mark.parametrize("remat", [True, False])
def test_layer_recompute_launches_the_wk_wv_forward_again(remat):
    """Each checkpointed layer runs its forward twice, the second time in
    the backward: the tsm2r launches a layer's wk/wv make double. This is
    where the train path's per-step count of tsm2r launches comes from."""
    cfg = _cfg(remat)
    tokens = DATA["global_batch"] * DATA["seq_len"]
    kv = cfg.n_kv_heads * cfg.resolved_head_dim
    _, _, log = _loss_and_grads(cfg, _params(cfg), _batch())
    fwd = [e for e in log if (e.entry, e.shape) == ("mm", (tokens, cfg.d_model,
                                                          kv))]
    assert all(e.kind == "tsm2r" for e in fwd)
    assert len(fwd) == 2 * cfg.n_layers * (2 if remat else 1)


def test_recompute_routes_under_the_forwards_policy():
    """The backward may run where the caller's policy scope is not set
    (autograd's device thread): the recompute must still route as the
    forward did. Here the backward runs outside the scope on purpose."""
    cfg = _cfg(True)
    params = _params(cfg)
    batch = _batch()
    tokens = DATA["global_batch"] * DATA["seq_len"]
    kv = cfg.n_kv_heads * cfg.resolved_head_dim
    with tsmm.record_dispatches() as log:
        with tsmm.policy(POLICY):
            loss, _ = train_step.make_loss_fn(cfg)(params, batch)
        loss.backward()
    fwd = [e.kind for e in log
           if (e.entry, e.shape) == ("mm", (tokens, cfg.d_model, kv))]
    assert fwd == ["tsm2r"] * (4 * cfg.n_layers)


def test_prefill_under_inference_mode_does_not_checkpoint(monkeypatch):
    cfg = _cfg(True)
    params = model.init(cfg, seed=0, device="cpu")
    tokens = _batch()["tokens"]
    b, s = tokens.shape
    want, _ = model.prefill(params, cfg, {"tokens": tokens},
                            model.init_cache(cfg, b, s + 1, device="cpu"))

    def refuse(fn, *args):
        raise AssertionError(f"checkpointed {fn.__name__} under inference")

    monkeypatch.setattr(layers, "remat", refuse)
    got, _ = model.prefill(params, cfg, {"tokens": tokens},
                           model.init_cache(cfg, b, s + 1, device="cpu"))
    assert torch.equal(got, want)
    with torch.inference_mode():
        out, _ = model.forward(params, cfg, {"tokens": tokens})
    assert out.shape == (b, s, cfg.vocab_size)


def test_zamba2_checkpoints_each_mamba_layer_and_not_the_shared_block(
        monkeypatch):
    """The reference's hybrid remat: each Mamba2 layer of a group on its
    own (``_maybe_remat(cfg, mamba_body)``), each tail layer (a plain
    segment at ``remat_group`` 1), and the shared block not at all (its
    group body has no ``jax.checkpoint``); the attention's kv steps are
    checkpointed as everywhere."""
    cfg = registry.get_config("zamba2-1.2b", smoke=True)
    real, calls = layers.remat, []

    def counting(fn, *args):
        if fn is not attention._kv_step:
            calls.append((fn.__name__, args[-1]))
        return real(fn, *args)

    monkeypatch.setattr(layers, "remat", counting)
    _loss_and_grads(cfg, _params(cfg), _batch())
    n_groups = cfg.n_layers // cfg.hybrid_period
    assert n_groups * cfg.hybrid_period < cfg.n_layers   # a tail
    assert calls == [("block_fwd", "mamba")] * cfg.n_layers
