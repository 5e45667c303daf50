"""Shared model layers: dense projection, RMSNorm, RoPE, SwiGLU, embeddings.

Counterpart of ``src/repro/models/layers.py``. Parameters live in small
``nn.Module``s whose attribute names are the JAX pytree's keys; the
functions take tensors (or such a module) as the JAX functions take their
params dicts. Weight layout is ``w[in_dim, out_dim]`` as in the JAX
package. Norms run in f32 whatever the activation dtype. Parameters are
made without ``requires_grad`` (serving); the training state turns it on
(``train.train_step.init_train_state``, ``convert.state_from_jax``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint

from repro_torch.core import tsmm


def remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (the JAX package's
    ``jax.checkpoint``): the backward keeps only ``args`` and recomputes
    the rest. The recompute runs under the ``tsmm.policy`` of the forward,
    because autograd may run it on its device thread, where the caller's
    scope is not set; nothing inside draws random numbers, so no RNG state
    is kept."""
    pol = tsmm.current_policy()
    return checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), tsmm.policy(pol)))


def param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of ``module`` as the JAX package's initialisers
    do: RMSNorm ``scale`` ones, biases zeros, embedding ``table`` rows
    N(0, 1) * d_model^-0.5, ``w[in, out]`` weights N(0, 1) * in^-0.5.
    Draws are f32 from ``generator`` (on the parameters' device), in
    parameter registration order, then cast to the parameter dtype."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            p.data.fill_(1.0)
        elif p.dim() == 1:
            p.data.zero_()
        else:
            fan = p.shape[1] if leaf == "table" else p.shape[0]
            w = torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=torch.float32)
            p.data.copy_(w.mul_(fan ** -0.5))
    return module


def dense(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x @ w over the trailing dim of x.

    Every model projection lands here, so this is where the tall-and-skinny
    dispatcher hooks into serving: ``tsmm`` takes the (..., S, d_in)
    activations as they are (it owns the leading-dim collapse) and routes to
    a TSM2X kernel when the shape qualifies, to ``torch.matmul`` otherwise,
    following the active ``tsmm.policy(...)`` scope.
    """
    return tsmm.tsmm(x, w)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = param(torch.ones((d,), dtype=torch.float32,
                                      device=device))


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, fraction: float, theta: float, device=None):
    """Inverse frequencies for the rotated sub-dimension."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps), rot


def apply_rope(x, positions, *, theta: float = 10000.0, fraction: float = 1.0):
    """x: (..., S, H, D); positions: broadcastable to (..., S).

    ``fraction < 1`` rotates only the leading slice of D (ChatGLM-style
    partial / '2d' RoPE); the remainder passes through unrotated.
    """
    d = x.shape[-1]
    inv_freq, rot = rope_freqs(d, fraction, theta, x.device)
    if rot == 0:
        return x
    ang = positions[..., None].float() * inv_freq          # (..., S, rot/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., : rot // 2].float(), x_rot[..., rot // 2:].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.cat([r1.to(x.dtype), r2.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.w_gate = param(torch.empty((d_model, d_ff), **kw))
        self.w_up = param(torch.empty((d_model, d_ff), **kw))
        self.w_down = param(torch.empty((d_ff, d_model), **kw))


def swiglu(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    g = dense(p.w_gate, x)
    u = dense(p.w_up, x)
    return dense(p.w_down, F.silu(g) * u)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    def __init__(self, vocab: int, d_model: int, dtype, device=None):
        super().__init__()
        self.table = param(torch.empty((vocab, d_model), dtype=dtype,
                                       device=device))


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits in f32. A plain product outside any kernel: vocab-sized
    outputs never classify tall-and-skinny, and the JAX package leaves this
    dot to XLA as well."""
    return torch.matmul(x.float(), table.float().transpose(0, 1))
