"""Serving engine: batched prefill + decode with KV caches.

Counterpart of ``src/repro/serve/engine.py`` (``make_serve_fns`` :29,
``sample_token`` :79, ``generate`` :85). PyTorch runs eagerly, so the two
step functions are plain callables (the JAX package jits them) and the
policy scope is entered on every call. Caches are allocated once at
``max_len = prompt + max_new`` (a sliding window's K/V at
``min(max_len, window)`` slots, a ring once the prompt reaches the
window) and updated in place. An MoE layer's metrics are dropped on this
path, as the reference drops them.

``params`` is a model (``models.model.LM``) or a model whose large leaves
are held as int8 records (``kernels.quant.quantize_weights``, or
``convert.params_from_jax`` of a JAX tree holding records): each step
dequantizes the records at its entry, into the dtype the model holds
them in, and frees the dense tensors after it (the JAX engine dequantizes
at step entry inside its jit, ``engine.py:66-74``).
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch import resolve_device
from repro_torch.core import tsmm
from repro_torch.distributed import sharding
from repro_torch.ft import is_dtensor
from repro_torch.kernels import quant
from repro_torch.models import model


def make_serve_fns(cfg, policy: "tsmm.GemmPolicy | None" = None, *,
                   sharded_projections: bool = False):
    """Build (prefill_step, decode_step).

    ``policy`` pins a GemmPolicy scope around both steps (e.g.
    ``GemmPolicy(mode="dense")`` for an A/B arm).

    ``sharded_projections=True`` scopes ``reduce="psum_scatter"`` on top:
    on a mesh, ``tsmm_t`` products inside the steps (ABFT checksum
    projections, the weight-side backward paths) come back row-sharded
    over the dp dims instead of replicated -- the right layout when the
    consumer re-shards at once, and a no-op everywhere else (off a mesh,
    or for shapes that cannot scatter, dispatch is the default path's).
    """
    def _scope():
        base = policy
        if sharded_projections:
            base = ((base if base is not None else tsmm.current_policy())
                    .with_(reduce="psum_scatter"))
        return (tsmm.policy(base) if base is not None
                else contextlib.nullcontext())

    def prefill_step(params, batch, cache):
        with _scope(), quant.dequantized(params) as p:
            return model.prefill(p, cfg, batch, cache)

    def decode_step(params, tokens, pos, cache):
        with _scope(), quant.dequantized(params) as p:
            return model.decode_step(p, cfg, tokens, pos, cache)

    return prefill_step, decode_step


def sample_token(generator, logits, temperature: float = 0.0):
    """Greedy at ``temperature <= 0``, else a draw from softmax(logits / T)
    with ``generator`` (on the logits' device). Returns (B,) int64.

    DTensor logits (vocab-sharded, the batch over the dp dims) are drawn
    from whole: ``torch.multinomial`` has no DTensor rule, and every rank
    must draw the same tokens from its copy of the seeded generator, as
    the one process draws them, so each gathers every row and the whole
    vocabulary, draws them all, and keeps the tokens in the batch's
    placements."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    if is_dtensor(logits):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        mesh = logits.device_mesh
        tok = sample_token(generator, logits.full_tensor(), temperature)
        places = [Shard(0) if isinstance(p, Shard) and p.dim == 0
                  else Replicate() for p in logits.placements]
        return DTensor.from_local(tok, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False).redistribute(mesh, places)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate(params, cfg, prompts, max_new: int, *, generator=None,
             temperature: float = 0.0, policy=None, device=None,
             sharded_projections: bool = False):
    """prompts: (B, S) int. Returns (B, max_new) generated tokens.

    Runs on ``device`` (the card unless the caller passes one), where
    ``params`` and ``prompts`` must already lie. ``generator`` drives
    sampling (default: one seeded with 0 on that device).
    ``sharded_projections`` is forwarded to :func:`make_serve_fns`.
    DTensor parameters serve on their mesh (the caches and the prompts'
    batch placed there); the tokens come back whole, a plain tensor.
    """
    dev = resolve_device(device)
    lm = params.model if isinstance(params, quant.QuantizedWeights) else params
    for name, t in (("params", next(lm.parameters())),
                    ("prompts", prompts)):
        if t.device != dev:
            raise ValueError(f"generate runs on {dev} but {name} lie on "
                             f"{t.device}")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    prefill_step, decode_step = make_serve_fns(
        cfg, policy=policy, sharded_projections=sharded_projections)

    b, s0 = prompts.shape
    mesh = next(lm.parameters()).device_mesh if sharding.on_mesh(lm) \
        else None
    cache = model.init_cache(cfg, b, s0 + max_new, device=dev, mesh=mesh)
    batch = {"tokens": prompts}
    if mesh is not None:
        batch = sharding.named(mesh, sharding.batch_specs(cfg, mesh, batch),
                               dict(batch))
    logits, cache = prefill_step(params, batch, cache)
    tok = sample_token(generator, logits, temperature)[:, None]
    toks = [tok]
    for i in range(1, max_new):
        logits, cache = decode_step(params, tok, s0 + i - 1, cache)
        tok = sample_token(generator, logits, temperature)[:, None]
        toks.append(tok)
    out = torch.cat(toks, dim=1)
    return out.full_tensor() if mesh is not None else out
