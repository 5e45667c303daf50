"""Shared model layers: dense projection, RMSNorm, LayerNorm, RoPE, SwiGLU,
the GELU MLP, embeddings, LoRA.

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
from repro_torch.ft import inject, is_dtensor


def remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (the JAX package's
    ``jax.checkpoint``): the backward keeps only ``args`` and recomputes
    the rest. The recompute runs under the ``tsmm.policy`` of the forward,
    because autograd may run it on its device thread, where the caller's
    scope is not set, and replays the forward's GEMM fault sites from the
    counter at segment entry (``ft.inject.replay``), as the reference
    evaluates its checkpointed trace twice with the same faults in it;
    nothing inside draws random numbers, so no RNG state is kept."""
    pol = tsmm.current_policy()
    scope = inject.current_scope()
    start = scope.sites_seen if scope is not None else 0

    @contextlib.contextmanager
    def recompute_context():
        with tsmm.policy(pol), inject.replay(scope, start):
            yield

    return checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), recompute_context()))


def param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter of ``module`` as the JAX package's initialisers
    do: norm ``scale`` ones, biases zeros, embedding ``table`` rows
    N(0, 1) * d_model^-0.5, ``w[in, out]`` weights N(0, 1) * in^-0.5 (a
    stack ``w[E, in, out]`` too, drawn weight by weight).
    A module overrides those rules for its own leaves with an ``INIT``
    dict of leaf name to "zeros", "uniform" (U[0, 1)) or a constant (the
    RWKV6 mixers' ``mu``, ``w0`` and ``u``, the LoRA's ``b`` and the
    Mamba2 mixer's ``D``). Draws are f32 from ``generator`` (on the
    parameters' device), in parameter registration order, then cast to
    the parameter dtype."""
    for mod in module.modules():
        rules = getattr(mod, "INIT", {})
        for leaf, p in mod.named_parameters(recurse=False):
            rule = rules.get(leaf)
            if rule == "zeros":
                p.data.zero_()
            elif rule == "uniform":
                p.data.copy_(torch.rand(p.shape, generator=generator,
                                        device=p.device, dtype=torch.float32))
            elif rule is not None:
                p.data.fill_(rule)
            elif leaf == "scale":
                p.data.fill_(1.0)
            elif p.dim() == 1:
                p.data.zero_()
            else:
                fan = p.shape[1] if leaf == "table" else p.shape[-2]
                # A stack of weights (an MoE layer's experts) is drawn one
                # weight at a time: the f32 draw of a whole deepseek-v3
                # stack would be 15 GB.
                for slab in (p.data.unbind(0) if p.dim() > 2 else [p.data]):
                    w = torch.randn(slab.shape, generator=generator,
                                    device=p.device, dtype=torch.float32)
                    slab.copy_(w.mul_(fan ** -0.5))
    return module


def _dense_raw(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` summed in f32 and cast to ``x``'s dtype: the dense
    primitive a 1-D ``x`` takes (the JAX package's ``_dense_raw``)."""
    # repro: allow-raw-param-matmul (this IS the dense primitive dense()
    # routes non-tsmm shapes to -- 1-D inputs and the mode="dense" arm;
    # wrapping it in tsmm would recurse)
    return torch.matmul(x.float(), w.float()).to(x.dtype)


class _DensePG(torch.autograd.Function):
    """``tsmm(x, w)`` whose backward re-dispatches through its own pair,
    inside ``backward_scope`` of the forward's policy: ``dw = tsmm_t(x,
    dy)`` and ``dx = tsmm(dy, w^T)``, each rounded to its operand's dtype
    as soon as it leaves the dispatcher (the JAX package's
    ``_dense_pg``)."""

    @staticmethod
    def forward(ctx, w, x, policy):
        ctx.save_for_backward(w, x)
        ctx.policy = policy
        return tsmm.tsmm(x, w, policy=policy)

    @staticmethod
    def backward(ctx, dy):
        w, x = ctx.saved_tensors
        with tsmm.backward_scope(ctx.policy) as bp:
            dw = tsmm.tsmm_t(x, dy, policy=bp).to(w.dtype)
            dx = tsmm.tsmm(dy, w.transpose(0, 1), policy=bp).to(x.dtype)
        return dw, dx, None


def dense(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x @ w over the trailing dim of x.

    Every model projection lands here, so this is where the tall-and-skinny
    dispatcher hooks into the model: ``tsmm`` takes the (..., S, d_in)
    activations as they are (it owns the leading-dim collapse) and routes to
    a TSM2X kernel when the shape qualifies, to ``torch.matmul`` otherwise,
    following the active ``tsmm.policy(...)`` scope. A 1-D ``x`` takes the
    dense primitive, as in the JAX package.

    Under ``param_dtype_grads`` the backward is ``_DensePG``'s. In JAX the
    knob makes parameter gradients come out in the parameter's dtype
    instead of f32; in PyTorch a parameter's gradient always has the
    parameter's dtype, so what the knob changes here is the backward's
    routes (``tsmm_t(x, dy)`` then ``tsmm(dy, w^T)``, for every route of
    the forward, the dense one included) and where the rounding happens
    (each gradient rounded once, as it leaves its GEMM). No path of the
    port sets the knob; it is kept for the JAX package's API.

    On DTensors over more than one rank the pending sum a projection's
    output holds, and one in its gradient, is reduced here
    (:func:`_settled`); the pending sum in the gradient of its input, once
    autograd has added up the projections that read it, where the input
    fans out to them (:func:`sums_whole`): the tensor-parallel layer's
    reductions, which GSPMD places in the reference.
    """
    if x.dim() < 2:
        return _dense_raw(w, x)
    p = tsmm.current_policy()
    if p.param_dtype_grads:
        return _DensePG.apply(w, x, p)
    return _settled(tsmm.tsmm(x, w), x)


def sums_whole(t):
    """``t`` with a pending sum (``Partial``) in it or in its gradient
    all-reduced, where it feeds projections that shard their output dim
    (``wq``, ``wk`` and ``wv``; ``w_gate`` and ``w_up`` over "model"):
    each gives its gradient a pending sum, which autograd adds up first,
    so one all-reduce at the fan-out settles them all: a block's normed
    input (``blocks.norm_apply``) and MLA's two latent norms. Left
    pending, DTensor carries a sum on through the residual stream into
    the next projection, whose weight it then gathers whole on every
    rank."""
    return _SumsWhole.apply(t, None) if _shared(t) else t


def _shared(t) -> bool:
    """Whether ``t`` is a DTensor over more than one rank (on one rank a
    pending sum is already whole, and the reductions are skipped)."""
    return is_dtensor(t) and t.device_mesh.size() > 1


def _settled(y, x):
    """A projection's output ``y`` of the input ``x``, settled: a pending sum
    (``wo``, ``w_down`` over "model") all-reduced, or reduce-scattered
    back to the batch's layout on a mesh dim where ``x`` shards its
    batch, and a pending sum in its gradient (the vocab head's, through
    the residual stream) all-reduced. A product whose weight is sharded
    over the batch's dims (FSDP) may be run by DTensor on the whole batch
    (at decode, cheaper than gathering the weight); its output goes back
    to the batch's layout, so attention does not gather the caches of
    every sequence."""
    if not _shared(y):
        return y
    from torch.distributed.tensor import Partial, Replicate, Shard
    want = []
    for px, py in zip(x.placements, y.placements):
        if (isinstance(px, Shard) and px.dim == 0
                and isinstance(py, (Partial, Replicate))):
            want.append(Shard(0))
        else:
            want.append(Replicate() if isinstance(py, Partial) else py)
    return _SumsWhole.apply(y, want)


def _reduce_partial(t, want=None):
    from torch.distributed.tensor import Partial, Replicate
    if want is None:
        want = [Replicate() if isinstance(p, Partial) else p
                for p in t.placements]
    return (t.view_as(t) if list(want) == list(t.placements)
            else t.redistribute(t.device_mesh, want))


class _SumsWhole(torch.autograd.Function):
    """:func:`sums_whole` / :func:`_settled`: the forward redistributes to
    ``want`` (default: each pending sum all-reduced); the backward
    all-reduces a pending sum in the cotangent and passes it on otherwise
    (its global value is the gradient of every term of the sum)."""

    @staticmethod
    def forward(ctx, t, want):
        return _reduce_partial(t, want)

    @staticmethod
    def backward(ctx, g):
        return _reduce_partial(g), None


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    """``scale`` ones, f32 unless ``dtype`` says (the Mamba2 mixer's gated
    norm keeps the model dtype, as in JAX)."""

    def __init__(self, d: int, dtype=torch.float32, device=None):
        super().__init__()
        self.scale = param(torch.ones((d,), dtype=dtype, device=device))


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


class LayerNorm(nn.Module):
    """``scale`` ones and ``bias`` zeros, f32 unless ``dtype`` says (the
    RWKV6 time mix's ``ln_x`` keeps the model dtype, as in JAX)."""

    def __init__(self, d: int, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.scale = param(torch.ones((d,), **kw))
        self.bias = param(torch.zeros((d,), **kw))


def layernorm(p: LayerNorm, x: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * p.scale.float() + p.bias.float()
    return out.to(x.dtype)


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


class GeluMLP(nn.Module):
    """hubert's MLP: ``w_up`` / ``w_down`` drawn as weights, the biases
    ``b_up`` / ``b_down`` zero (the reference's ``gelu_mlp_init``,
    ``src/repro/models/layers.py:167``), all in the model's dtype."""

    INIT = {"b_up": "zeros", "b_down": "zeros"}

    def __init__(self, d_model: int, d_ff: int, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.w_up = param(torch.empty((d_model, d_ff), **kw))
        self.b_up = param(torch.empty((d_ff,), **kw))
        self.w_down = param(torch.empty((d_ff, d_model), **kw))
        self.b_down = param(torch.empty((d_model,), **kw))


def gelu_mlp(p: GeluMLP, x: torch.Tensor) -> torch.Tensor:
    """``dense(w_down, gelu(dense(w_up, x) + b_up)) + b_down``. The GELU is
    ``jax.nn.gelu``'s default, the tanh form (torch's default is the erf
    form), computed in f32 and cast to ``x``'s dtype."""
    h = dense(p.w_up, x) + p.b_up
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return dense(p.w_down, h) + p.b_down


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    def __init__(self, vocab: int, d_model: int, dtype, device=None):
        super().__init__()
        self.table = param(torch.empty((vocab, d_model), dtype=dtype,
                                       device=device))


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``. A DTensor table is gathered whole (a vocab shard
    holds only its own rows) and looked up on local tensors, the output
    placed as the tokens are (their batch over the dp dims, or
    replicated): DTensor's own rule for the lookup's backward
    (``index_put``) fails on torch 2.11. The table's local gradient is
    this rank's batch's, so it is marked a pending sum over the dims the
    tokens are sharded on."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    places = (list(tokens.placements) if is_dtensor(tokens)
              else [Replicate()] * mesh.ndim)
    whole = table.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if isinstance(p, Shard) else Replicate()
                         for p in places])
    ids = tokens.to_local() if is_dtensor(tokens) else tokens
    return DTensor.from_local(whole[ids], mesh, places, run_check=False)


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits in f32. A plain product outside any kernel: vocab-sized
    outputs never classify tall-and-skinny, and the JAX package leaves this
    dot to XLA as well."""
    # repro: allow-raw-param-matmul (logits must stay f32 -- tsmm returns
    # the operand dtype -- and vocab-sized outputs never classify
    # tall-skinny)
    return torch.matmul(x.float(), table.float().transpose(0, 1))


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------

class LoRA(nn.Module):
    """Low-rank adapter: a tall-and-skinny GEMM pair (TSM2X shapes).
    ``a[d_in, rank]`` is drawn as a weight, ``b[rank, d_out]`` starts at
    zero (the reference's ``lora_init``)."""

    INIT = {"b": "zeros"}

    def __init__(self, d_in: int, d_out: int, rank: int, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.a = param(torch.empty((d_in, rank), **kw))
        self.b = param(torch.empty((rank, d_out), **kw))


def lora_init(generator, d_in: int, d_out: int, rank: int, dtype,
              device=None) -> LoRA:
    return init_random_(LoRA(d_in, d_out, rank, dtype, device), generator)


def lora_apply(p: LoRA, x: torch.Tensor) -> torch.Tensor:
    """``x @ a @ b``, both projections through ``dense`` (so ``tsmm``):
    the down projection ``[T, d_in]·[d_in, rank]`` is TSM2R's shape. (The
    reference's ``base_out`` argument has no caller in either package.)"""
    return dense(p.b, dense(p.a, x))
