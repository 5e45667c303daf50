"""Mixture-of-Experts: top-k routing with sort-based capacity dispatch.

Counterpart of ``src/repro/models/moe.py`` (``MoEConfig`` :31,
``moe_init`` :48, ``route`` :71, ``_dispatch_indices`` :88, ``moe_fwd``
:108, ``update_router_bias`` :201). The (token, expert) assignments are
sorted by expert (a stable sort, so the same tokens drop as in JAX),
ranked within their expert, clipped to the capacity, and addressed by
int index buffers into a dense (G, E, C, d) expert batch: O(T*k)
bookkeeping and O(E*C*d) compute, the GShard-style dropping formulation
(tokens past capacity fall through on the residual).

Routers:
* ``softmax`` (Mixtral): softmax over E, top-k, renormalize selected.
* ``sigmoid`` (DeepSeek-V3): sigmoid scores; selection adds the
  aux-loss-free balancing bias (bias affects *selection only*, not the
  combine weights); selected weights renormalized to sum 1.

The router's projection goes through ``layers.dense`` (so ``tsmm``) in
the activations' dtype: ``[T, d]·[d, E]`` is TSM2R's shape (mixtral's
n = 8 on the skinny body, deepseek's n = 256 on the wgmma body). The
grouped expert products have no 2-D ``tsmm`` form; the reference leaves
them to ``jnp.einsum`` outside any Pallas kernel, and so they stay
library products here (``_expert_mm``).

Where the port differs from the reference's ops, not its values:
* JAX's ``.at[dest].set(..., mode="drop")`` discards out-of-range writes
  and its gather clamps an out-of-range index; torch's ``scatter`` and
  indexing raise on both. The buffers get a sentinel slot ``E*C`` that
  is sliced off, and a dropped slot's token index (the reference's
  ``T*k``) reads the zero pad row ``T``, where JAX's clamp lands.
* The combine sums each token's k slots in top-k order (gathered by the
  inverse of the dispatch index) instead of a scatter-add, whose order
  on CUDA (atomics) would change a bf16 sum's bits from run to run.

``maybe_wsc`` pins stand at the reference's points; on plain tensors
they are the identity.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import sharding
from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0          # defaults to d_ff_expert * n_shared
    router: str = "softmax"        # 'softmax' | 'sigmoid'
    capacity_factor: float = 1.25
    routed_scale: float = 1.0      # DeepSeek scales routed output by 2.5
    # Dispatch groups: tokens route within their group only (the DP shard
    # count, so sort and scatter stay shard-local).
    dispatch_groups: int = 1


class Experts(nn.Module):
    """The routed experts' SwiGLU weights stacked on a leading expert axis:
    ``w_gate`` / ``w_up`` (E, d, f), ``w_down`` (E, f, d)."""

    def __init__(self, e: int, d_model: int, f: int, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.w_gate = layers.param(torch.empty((e, d_model, f), **kw))
        self.w_up = layers.param(torch.empty((e, d_model, f), **kw))
        self.w_down = layers.param(torch.empty((e, f, d_model), **kw))


class MoE(nn.Module):
    """``router_w`` (d, E) and ``router_bias`` (E,) in f32 whatever the
    model dtype, ``experts``, and ``shared`` (a ``layers.SwiGLU``) when
    the config has shared experts."""

    def __init__(self, d_model: int, cfg: MoEConfig, dtype, device=None):
        super().__init__()
        e = cfg.n_experts
        f32 = dict(dtype=torch.float32, device=device)
        self.router_w = layers.param(torch.empty((d_model, e), **f32))
        self.router_bias = layers.param(torch.zeros((e,), **f32))
        self.experts = Experts(e, d_model, cfg.d_ff_expert, dtype, device)
        if cfg.n_shared:
            d_sh = cfg.d_ff_shared or cfg.d_ff_expert * cfg.n_shared
            self.shared = layers.SwiGLU(d_model, d_sh, dtype, device)


def moe_init(generator, d_model: int, cfg: MoEConfig, dtype,
             device=None) -> MoE:
    return layers.init_random_(MoE(d_model, cfg, dtype, device), generator)


def route(p: MoE, xt, cfg: MoEConfig):
    """xt: (T, d) -> (weights (T,k) f32, expert_ids (T,k), probs (T,E))."""
    logits = layers.dense(p.router_w.to(xt.dtype), xt).float()
    if cfg.router == "sigmoid":
        scores = torch.sigmoid(logits)
        sel = scores + p.router_bias[None, :]       # bias: selection only
        idx = torch.topk(sel, cfg.top_k, dim=-1).indices
        w = torch.gather(scores, 1, idx)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        probs = scores / torch.clamp(scores.sum(-1, keepdim=True), min=1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        w, idx = torch.topk(probs, cfg.top_k, dim=-1)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, idx, probs


def _dispatch_indices(se, stok, sw, e: int, cap: int):
    """Sorted entries -> (tok_buf (..., E*C), w_buf (..., E*C), keep,
    dest). ``se`` / ``stok`` / ``sw``: one group's (tk,) or G groups'
    (G, tk) expert ids (sorted), token ids and weights. ``dest`` is each
    entry's slot, ``E*C`` where it dropped.

    Index-based: only int indices and f32 weights are scattered; the
    activation gather happens later at (E, C, d) granularity. An empty
    slot holds the reference's sentinel token ``tk``.
    """
    one = se.dim() == 1
    if one:
        se, stok, sw = se[None], stok[None], sw[None]
    g, tk = se.shape
    dev = se.device
    starts = torch.searchsorted(
        se, torch.arange(e, device=dev, dtype=se.dtype).repeat(g, 1))
    rank = torch.arange(tk, device=dev) - torch.gather(starts, 1, se)
    keep = rank < cap
    dest = torch.where(keep, se * cap + rank, e * cap)   # E*C: drops
    tok_buf = torch.full((g, e * cap + 1), tk, dtype=torch.int64,
                         device=dev).scatter(1, dest, stok.long())
    w_buf = torch.zeros((g, e * cap + 1), dtype=torch.float32,
                        device=dev).scatter(1, dest, sw * keep)
    out = tok_buf[:, :e * cap], w_buf[:, :e * cap], keep, dest
    return tuple(t[0] for t in out) if one else out


class _ExpertMM(torch.autograd.Function):
    """``torch.bmm(a, w)`` (E batches) summed in f32 and returned in
    ``out_dtype``, the reference's ``preferred_element_type=f32`` (then
    ``astype``): on CUDA ``aten::bmm.dtype`` for an f32 output (the
    products of bf16 operands summed and kept in f32, no f32 copy of the
    weights) and cuBLAS's own f32 sum, rounded once, for an output in the
    operands' dtype; elsewhere the product of the operands in f32. That
    overload has no derivative, so the backward is written out: the
    cotangent in the operands' dtype through two bmm, the gradients in
    that dtype."""

    @staticmethod
    def forward(ctx, a, w, out_dtype):
        ctx.save_for_backward(a, w)
        if a.dtype == torch.float32:
            return torch.bmm(a, w.float()).to(out_dtype)
        if a.is_cuda:
            return (torch.bmm(a, w, out_dtype=torch.float32)
                    if out_dtype == torch.float32 else torch.bmm(a, w))
        return torch.bmm(a.float(), w.float()).to(out_dtype)

    @staticmethod
    def backward(ctx, dy):
        a, w = ctx.saved_tensors
        dy = dy.to(a.dtype)
        da = torch.bmm(dy, w.transpose(1, 2).to(a.dtype))
        dw = torch.bmm(a.transpose(1, 2), dy).to(w.dtype)
        return da, dw, None


def _expert_mm(buf, w, out_dtype=torch.float32):
    """``einsum("gecd,edf->gecf", buf, w, preferred_element_type=f32)``
    cast to ``out_dtype``: the G groups ride along the rows of each
    expert's product."""
    g, e, c, d = buf.shape
    rows = buf.transpose(0, 1).reshape(e, g * c, d)
    out = _ExpertMM.apply(rows, w, out_dtype)
    return out.reshape(e, g, c, -1).transpose(0, 1)


def moe_fwd(p: MoE, x, cfg: MoEConfig):
    """x: (B, S, d). Returns (out, metrics dict).

    Dispatch is group-local (``cfg.dispatch_groups``): within each group,
    entries sort by expert, ranks clip to capacity, and index buffers
    address a (G, E, C, d) gather.
    """
    b, s, d = x.shape
    t = b * s
    ng = cfg.dispatch_groups if t % cfg.dispatch_groups == 0 else 1
    tl = t // ng                                     # tokens per group
    xt = x.reshape(t, d)
    w, idx, probs = route(p, xt, cfg)
    dev = x.device

    k = cfg.top_k
    e = cfg.n_experts
    cap = max(8, int(cfg.capacity_factor * tl * k / e))

    # Per-group flatten + stable sort by expert.
    ge = idx.reshape(ng, tl * k)
    gtok = torch.arange(tl, device=dev).repeat_interleave(k).expand(
        ng, tl * k)
    gw = w.reshape(ng, tl * k)
    ge = sharding.maybe_wsc(ge, ("pod", "data"), None)
    order = torch.argsort(ge, dim=-1, stable=True)
    se = torch.gather(ge, 1, order)
    stok = torch.gather(gtok, 1, order)
    sw = torch.gather(gw, 1, order)
    tok_buf, w_buf, keep, dest = _dispatch_indices(se, stok, sw, e, cap)

    # Gather activations at (G, E, C, d); a dropped slot's sentinel reads
    # the zero pad row tl.
    dp = ("pod", "data")
    xg = sharding.maybe_wsc(xt.reshape(ng, tl, d), dp, None, None)
    xg_pad = torch.cat([xg, xg.new_zeros((ng, 1, d))], dim=1)
    rows = torch.arange(ng, device=dev)[:, None]
    buf = xg_pad[rows, tok_buf.clamp(max=tl)].reshape(ng, e, cap, d)
    buf = sharding.maybe_wsc(buf, dp, "model", None, None)

    # Expert SwiGLU (f32 products, h rounded to the activations' dtype).
    ew = p.experts
    g = sharding.maybe_wsc(_expert_mm(buf, ew.w_gate),
                           dp, "model", None, None)
    u = sharding.maybe_wsc(_expert_mm(buf, ew.w_up), dp, "model", None, None)
    h = (F.silu(g) * u).to(x.dtype)
    del g, u    # serving frees the f32 products here (autograd keeps them)
    h = sharding.maybe_wsc(h, dp, "model", None, None)
    y = _expert_mm(h, ew.w_down, x.dtype)
    y = sharding.maybe_wsc(y, dp, "model", None, None)

    # Combine: each token's k slots times their weights (the reference's
    # y * w_buf, in the activations' dtype), gathered by the inverse of the
    # dispatch index (a dropped entry's weight is zero) and summed in
    # top-k order. Gathering (T*k, d) rows leaves out the (E*C, d)
    # weighted copy of y.
    slot_of = torch.empty_like(dest).scatter_(1, order, dest)
    safe = slot_of.clamp(max=e * cap - 1)
    wt = torch.gather(w_buf, 1, safe) * (slot_of < e * cap)
    picked = (y.reshape(ng, e * cap, d)[rows, safe]
              * wt[..., None].to(x.dtype)).reshape(ng, tl, k, d)
    out = picked[:, :, 0]
    for j in range(1, k):
        out = out + picked[:, :, j]
    out = sharding.maybe_wsc(out, dp, None, None)
    out = out.reshape(t, d) * cfg.routed_scale

    if cfg.n_shared:
        out = out + layers.swiglu(p.shared, xt)

    # Switch-style load-balance diagnostics (metric; DeepSeek uses the
    # aux-loss-free router-bias update instead -- see update_router_bias).
    counts = (w_buf.reshape(ng, e, cap) > 0).sum(dim=(0, 2))   # per E
    frac_tokens = counts / torch.clamp(counts.sum(), min=1)
    mean_prob = probs.mean(dim=0)
    metrics = {
        "moe_balance_loss": e * torch.sum(frac_tokens * mean_prob),
        "moe_dropped_frac": 1.0 - keep.float().mean(),
        "moe_max_load": frac_tokens.max() * e,
    }
    return out.reshape(b, s, d), metrics


@torch.no_grad()
def update_router_bias(p: MoE, metrics_counts, rate: float = 1e-3) -> MoE:
    """DeepSeek aux-loss-free balancing: nudge under-loaded experts up, in
    place (the reference returns a new params dict)."""
    counts = metrics_counts.float()
    target = counts.mean()
    p.router_bias.add_(torch.sign(target - counts) * rate)
    return p
