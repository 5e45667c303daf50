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

On DTensors (parameters placed by ``distributed.sharding``) the layer
runs PyTorch's tensor-parallel idiom, as ``models/heads.py`` does for the
attention and scan cores: the router's product stays a DTensor one
(the executor and kernel the dispatcher picks for it, as on plain
tensors), and everything after it runs on each rank's local tensors
(:func:`_moe_mesh`). DTensor takes neither the dispatch nor the expert
products: torch refuses ``searchsorted`` ("Operator
aten.searchsorted.Tensor does not have a sharding strategy registered"),
the flatten of a one-group (E, G, C, d) batch whose G and E carry
placements ("This operation would remove or reshape sharded dimension
1"), and ``aten::bmm.dtype`` ("does not have a sharding strategy
registered"). So each rank routes, sorts and clips the whole dispatch
groups of its dp ranks (a group that spans dp ranks is gathered whole
over them first, as GSPMD gathers it for the reference's sort), gathers
its share of the (G, E, C, d) batch -- its E/tp experts where "model"
splits the expert dim (expert parallelism), every expert where the
experts fall back to splitting d_ff -- runs the expert products on its
own slice of the stacks, and sums its own slots' weighted outputs; the
other ranks' slots add zero. The output leaves as a pending sum over
"model" (``Partial``), all-reduced at the reference's ``out`` pin: the
collective GSPMD would choose (all-to-alls) is not reproduced. The
routing and the activations are read whole on every model rank while the
expert work splits, so their local gradients leave ``to_local`` marked
``Partial`` there; the metrics are each rank's counts summed over its dp
ranks, equal on every rank, and ``router_bias`` keeps its zero gradient
(it reaches the loss only through the selection). On plain tensors the
layer runs the same code on all its tokens and experts (the pins are
the identity there).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import sharding
from repro_torch.ft import is_dtensor
from repro_torch.models import heads, layers


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


def _route(logits, bias, cfg: MoEConfig):
    """The router's selection from its f32 logits (T, E) and ``bias``."""
    if cfg.router == "sigmoid":
        scores = torch.sigmoid(logits)
        sel = scores + bias[None, :]                # bias: selection only
        idx = torch.topk(sel, cfg.top_k, dim=-1).indices
        w = torch.gather(scores, 1, idx)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        probs = scores / torch.clamp(scores.sum(-1, keepdim=True), min=1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        w, idx = torch.topk(probs, cfg.top_k, dim=-1)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, idx, probs


def route(p: MoE, xt, cfg: MoEConfig):
    """xt: (T, d) -> (weights (T,k) f32, expert_ids (T,k), probs (T,E)).

    On a DTensor ``xt`` the product stays a DTensor one (the executor the
    dispatcher picks for it), and the selection runs on each rank's
    tokens (those of its dp ranks, whole over the other mesh dims); the
    three come back DTensors in that layout."""
    logits = layers.dense(p.router_w.to(xt.dtype), xt).float()
    if not is_dtensor(logits):
        return _route(logits, p.router_bias, cfg)
    from torch.distributed.tensor import DTensor
    hd = _tokens(xt)
    places = heads.placements(hd, 0, None)
    out = _route(logits.redistribute(hd.mesh, places).to_local(),
                 p.router_bias.full_tensor(), cfg)
    return tuple(DTensor.from_local(t, hd.mesh, places, run_check=False)
                 for t in out)


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


def _experts_fwd(xt, w, idx, w_gate, w_up, w_down, tl: int, cap: int,
                 cfg: MoEConfig, lo: int = 0):
    """The dispatch, the expert SwiGLU and the combine over ``xt``'s
    groups of ``tl`` tokens (plain tensors: all the layer's tokens, or a
    rank's). ``w_gate`` / ``w_up`` / ``w_down`` hold experts ``lo ..``
    (all E, or a rank's E/tp), or every expert's slice of d_ff; the other
    experts' slots add nothing. Returns (out (G, tl, d), w_buf, keep)."""
    t, d = xt.shape
    ng = t // tl
    dev = xt.device
    k = cfg.top_k
    e = cfg.n_experts
    e_loc = w_gate.shape[0]

    # Per-group flatten + stable sort by expert.
    ge = idx.reshape(ng, tl * k)
    gtok = torch.arange(tl, device=dev).repeat_interleave(k).expand(
        ng, tl * k)
    gw = w.reshape(ng, tl * k)
    order = torch.argsort(ge, dim=-1, stable=True)
    se = torch.gather(ge, 1, order)
    stok = torch.gather(gtok, 1, order)
    sw = torch.gather(gw, 1, order)
    tok_buf, w_buf, keep, dest = _dispatch_indices(se, stok, sw, e, cap)

    # Gather activations at (G, E, C, d) (this rank's experts' slots); a
    # dropped slot's sentinel reads the zero pad row tl.
    xg = xt.reshape(ng, tl, d)
    xg_pad = torch.cat([xg, xg.new_zeros((ng, 1, d))], dim=1)
    rows = torch.arange(ng, device=dev)[:, None]
    mine = tok_buf[:, lo * cap:(lo + e_loc) * cap]
    buf = xg_pad[rows, mine.clamp(max=tl)].reshape(ng, e_loc, cap, d)

    # Expert SwiGLU (f32 products, h rounded to the activations' dtype).
    g = _expert_mm(buf, w_gate)
    u = _expert_mm(buf, w_up)
    h = (F.silu(g) * u).to(xt.dtype)
    del g, u    # serving frees the f32 products here (autograd keeps them)
    y = _expert_mm(h, w_down, xt.dtype)

    # Combine: each token's k slots times their weights (the reference's
    # y * w_buf, in the activations' dtype), gathered by the inverse of the
    # dispatch index (a dropped entry's weight is zero, and so is that of
    # another rank's slot) and summed in top-k order. Gathering (T*k, d)
    # rows leaves out the (E*C, d) weighted copy of y.
    slot_of = torch.empty_like(dest).scatter_(1, order, dest)
    safe = slot_of.clamp(max=e * cap - 1)
    wt = torch.gather(w_buf, 1, safe) * (slot_of < e * cap)
    if e_loc < e:
        wt = wt * ((safe >= lo * cap) & (safe < (lo + e_loc) * cap))
        safe = (safe - lo * cap).clamp(0, e_loc * cap - 1)
    picked = (y.reshape(ng, e_loc * cap, d)[rows, safe]
              * wt[..., None].to(xt.dtype)).reshape(ng, tl, k, d)
    out = picked[:, :, 0]
    for j in range(1, k):
        out = out + picked[:, :, j]
    return out, w_buf, keep


def _metrics(counts, kept, mean_prob, e: int) -> dict:
    """Switch-style load-balance diagnostics from the honoured slots per
    expert, the kept share of the entries and the mean router
    probabilities (a metric; DeepSeek uses the aux-loss-free router-bias
    update instead -- see update_router_bias)."""
    frac_tokens = counts / torch.clamp(counts.sum(), min=1)
    return {
        "moe_balance_loss": e * torch.sum(frac_tokens * mean_prob),
        "moe_dropped_frac": 1.0 - kept,
        "moe_max_load": frac_tokens.max() * e,
    }


def _tokens(xt) -> heads.Heads:
    """The layout of a DTensor ``xt``'s (T, d) tokens: its rows on the
    mesh dims where it shards them (its dp dims), whole elsewhere."""
    from torch.distributed.tensor import Shard
    return heads.Heads(xt.device_mesh, tuple(
        "batch" if isinstance(pl, Shard) and pl.dim == 0 else None
        for pl in xt.placements), 0, 0)


def _moe_mesh(p: MoE, xt, w, idx, probs, tl: int, cap: int,
              cfg: MoEConfig):
    """:func:`_experts_fwd` on each rank's local tensors, for a DTensor
    ``xt`` (T, d) and its routing. Each rank takes the whole groups of its
    dp ranks (a group that spans dp ranks is gathered whole over them
    first) and, where "model" splits the expert stacks, its E/tp experts
    or every expert's d_ff slice; its output is its share of the sum over
    "model" (``Partial``), all-reduced at the reference's ``out`` pin
    (its tokens' rows over dp). Returns (out (T, d) DTensor, metrics:
    Replicate DTensors)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    hd = _tokens(xt)
    mesh, names = hd.mesh, hd.mesh.mesh_dim_names
    dp_n = 1
    for i, role in enumerate(hd.roles):
        dp_n *= mesh.size(i) if role else 1
    if (xt.shape[0] // tl) % dp_n:
        hd = hd._replace(roles=(None,) * len(names))   # groups span dp
        dp_n = 1
    ew = p.experts
    split = None       # the tensor dim "model" splits w_gate on: 0 or 2
    if "model" in names:
        pl = ew.w_gate.placements[names.index("model")]
        split = pl.dim if isinstance(pl, Shard) else None
    if split is not None:
        hd = hd._replace(roles=tuple("heads" if n == "model" else r
                                     for n, r in zip(names, hd.roles)))
    ff = split == 2
    wg, wu = (heads.local(hd, t, None, split) for t in (ew.w_gate, ew.w_up))
    wd = heads.local(hd, ew.w_down, None, 1 if ff else split)
    lo = 0
    if split == 0:
        lo = mesh.get_coordinate()[names.index("model")] * wg.shape[0]

    xl = heads.local(hd, xt, 0, None)
    out, w_buf, keep = _experts_fwd(
        xl, heads.local(hd, w, 0, None),
        idx.redistribute(mesh, heads.placements(hd, 0, None)).to_local(),
        wg, wu, wd, tl, cap, cfg, lo)
    places = [Partial() if r == "heads" else pl for r, pl in
              zip(hd.roles, heads.placements(hd, 0, None))]
    out = DTensor.from_local(out.reshape(-1, out.shape[-1]), mesh, places,
                             run_check=False)

    # The metrics from the whole counts: each rank's dp share summed.
    def whole(t):
        return DTensor.from_local(
            t, mesh, [Partial() if r == "batch" else Replicate()
                      for r in hd.roles], run_check=False).redistribute(
            mesh, [Replicate()] * len(names)).to_local()

    pr = probs.redistribute(mesh, heads.placements(hd, 0, None)).to_local()
    counts = whole((w_buf.reshape(-1, cfg.n_experts, cap) > 0).sum(
        dim=(0, 2)))
    metrics = _metrics(counts, whole(keep.float().mean() / dp_n),
                       whole(pr.mean(dim=0) / dp_n), cfg.n_experts)
    return out, {k: DTensor.from_local(v, mesh, [Replicate()] * len(names),
                                       run_check=False)
                 for k, v in metrics.items()}


def moe_fwd(p: MoE, x, cfg: MoEConfig):
    """x: (B, S, d). Returns (out, metrics dict).

    Dispatch is group-local (``cfg.dispatch_groups``): within each group,
    entries sort by expert, ranks clip to capacity, and index buffers
    address a (G, E, C, d) gather. A DTensor ``x`` runs it on each rank's
    local tensors (:func:`_moe_mesh`).
    """
    b, s, d = x.shape
    t = b * s
    ng = cfg.dispatch_groups if t % cfg.dispatch_groups == 0 else 1
    tl = t // ng                                     # tokens per group
    cap = max(8, int(cfg.capacity_factor * tl * cfg.top_k / cfg.n_experts))
    xt = x.reshape(t, d)
    w, idx, probs = route(p, xt, cfg)
    if is_dtensor(xt):
        out, metrics = _moe_mesh(p, xt, w, idx, probs, tl, cap, cfg)
        # The rows over the dp dims, as the reference pins them, and whole
        # where they cut across the b sequences (32 over 64 dp ranks).
        out = sharding.whole_if_uneven(
            sharding.maybe_wsc(out, ("pod", "data"), None), 0, b)
    else:
        ew = p.experts
        out, w_buf, keep = _experts_fwd(xt, w, idx, ew.w_gate, ew.w_up,
                                        ew.w_down, tl, cap, cfg)
        counts = (w_buf.reshape(ng, cfg.n_experts, cap) > 0).sum(dim=(0, 2))
        metrics = _metrics(counts, keep.float().mean(), probs.mean(dim=0),
                           cfg.n_experts)
        out = out.reshape(t, d)
    out = out * cfg.routed_scale

    if cfg.n_shared:
        out = out + layers.swiglu(p.shared, xt)
    return out.reshape(b, s, d), metrics


@torch.no_grad()
def update_router_bias(p: MoE, metrics_counts, rate: float = 1e-3) -> MoE:
    """DeepSeek aux-loss-free balancing: nudge under-loaded experts up, in
    place (the reference returns a new params dict). ``metrics_counts``
    are the whole counts (a DTensor's full value); a DTensor bias takes
    its own part of the step."""
    counts = (metrics_counts.full_tensor() if is_dtensor(metrics_counts)
              else metrics_counts).float()
    target = counts.mean()
    delta = torch.sign(target - counts) * rate
    b = p.router_bias
    if is_dtensor(b):       # each rank's part of the bias, from the whole
        b.to_local().add_(sharding.local_part(delta, b.device_mesh,
                                              b.placements))
    else:
        b.add_(delta)
    return p
