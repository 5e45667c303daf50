"""Mamba2 (SSD) layer: chunked matmul-form scan for training and prefill,
O(1) recurrent step for decode. Zamba2's backbone.

Counterpart of ``src/repro/models/mamba2.py`` (``Mamba2Config`` :30,
``mamba2_init`` :40, ``_split_proj`` :58, ``_causal_conv`` :65,
``mamba2_fwd`` :76, ``mamba2_decode`` :157, ``mamba2_ref_recurrent``
:186).

State-space recurrence per head h (state size N, head dim P):
    S_t = a_t * S_{t-1} + dt_t * B_t x_t^T          (S: (N, P))
    y_t = C_t @ S_t + D * x_t
with a_t = exp(dt_t * A) (scalar per head per step, A < 0).

``in_proj`` and ``out_proj`` go through ``layers.dense`` (so ``tsmm``);
the SSD contractions and the inter-chunk scan stay plain torch, as the
reference keeps them in ``jnp.einsum`` and ``lax.scan``, with its chunk
rule. The reference's ``jnp.repeat`` of C·B, B and C over the heads of a
group is a broadcast here (the same values).

On DTensor parameters the layer between its projections
(``_ssd_chunked``, ``_ssd_step``) runs on each rank's heads
(``models.heads``): ``in_proj``'s output and ``conv_w``'s channels shard
over "model" at boundaries that do not fall on the ``[x, z, B, C, dt]``
split points, so each rank takes the projection and the conv's weights
whole and keeps its heads' columns (``_cut``); B and C (one group) are
shared by every head; ``dt_bias``, ``A_log``, ``D`` and the SSM state are
cut to the rank's heads; the gated RMSNorm runs on the head-sharded
output over the whole ``d_inner``.

One deliberate difference: the intra-chunk decay masks before the
exponential (``_segsum_decay``). The reference evaluates ``exp(seg)`` on
the masked upper triangle too (``src/repro/models/mamba2.py:114``), where
``seg`` is a sum of up to chunk - 1 positive steps: at zamba2's chunk 128
from its own init that is ~100, ``exp`` gives ``inf`` and the backward of
the ``where`` gives ``0 * inf = NaN``. The forward is the same function
either way, and the gradient equals the reference's wherever the
reference's is finite.

Parameters live in ``Mamba2``, whose attribute names are the JAX keys;
``D`` starts at one (``INIT``), ``A_log``, ``dt_bias`` and ``conv_b`` at
zero and ``conv_w`` as a ``W^-1/2`` draw, by ``layers.init_random_``'s
rules. ``A_log``, ``D`` and ``dt_bias`` are f32, the rest (``norm.scale``
included) the model dtype.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.ft import is_dtensor
from repro_torch.models import heads, layers


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_inner: int           # expansion * d_model
    n_heads: int           # d_inner / head_dim
    state_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 128


class Mamba2(nn.Module):
    INIT = {"D": 1.0}

    def __init__(self, d_model: int, cfg: Mamba2Config, dtype, device=None):
        super().__init__()
        di, h, n, g = cfg.d_inner, cfg.n_heads, cfg.state_dim, cfg.n_groups
        conv_dim = di + 2 * g * n
        proj_out = 2 * di + 2 * g * n + h   # x, z, B, C, dt
        kw = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.in_proj = layers.param(torch.empty((d_model, proj_out), **kw))
        self.conv_w = layers.param(torch.empty((cfg.conv_width, conv_dim),
                                               **kw))
        self.conv_b = layers.param(torch.empty((conv_dim,), **kw))
        self.A_log = layers.param(torch.empty((h,), **f32))
        self.D = layers.param(torch.empty((h,), **f32))
        self.dt_bias = layers.param(torch.empty((h,), **f32))
        self.norm = layers.RMSNorm(di, dtype, device)
        self.out_proj = layers.param(torch.empty((di, d_model), **kw))


def mamba2_init(generator, d_model: int, cfg: Mamba2Config, dtype,
                device=None) -> Mamba2:
    return layers.init_random_(Mamba2(d_model, cfg, dtype, device),
                               generator)


@functools.lru_cache(maxsize=None)
def _cut(cfg: Mamba2Config, heads_: tuple[int, int]) -> dict:
    """Column ranges of heads ``[h0, h1)`` and their groups: of the
    projection's x, z, B, C and dt (its output concatenates ``[x, z, B,
    C, dt]``) and of the conv's channels (``[x, B, C]``). The whole
    ranges at ``(0, n_heads)`` (``"whole"``: every column in order). One
    dict a config and range, shared: not to be changed."""
    di, g, n, h = cfg.d_inner, cfg.n_groups, cfg.state_dim, cfg.n_heads
    pd, hg = di // h, h // g
    h0, h1 = heads_
    g0, g1 = h0 // hg, -(-h1 // hg)
    xs, gs = slice(h0 * pd, h1 * pd), slice(g0 * n, g1 * n)
    return {"x": xs, "z": slice(di + xs.start, di + xs.stop),
            "B": slice(2 * di + gs.start, 2 * di + gs.stop),
            "C": slice(2 * di + g * n + gs.start, 2 * di + g * n + gs.stop),
            "dt": slice(2 * di + 2 * g * n + h0, 2 * di + 2 * g * n + h1),
            "conv": (xs, slice(di + gs.start, di + gs.stop),
                     slice(di + g * n + gs.start, di + g * n + gs.stop)),
            "heads": h1 - h0, "groups": g1 - g0,
            "whole": (h0, h1) == (0, h)}


def _split_proj(proj, cut: dict):
    """x, z, B, C, dt of the projection: ``cut``'s columns (views; one
    ``torch.split`` for the whole cut)."""
    cols = [cut[k] for k in ("x", "z", "B", "C", "dt")]
    if cut["whole"]:
        return torch.split(proj, [c.stop - c.start for c in cols], dim=-1)
    return tuple(proj[..., c] for c in cols)


def _conv_channels(t, cut: dict):
    """``t``'s conv channels (last dim) of ``cut``: ``t`` itself for the
    whole cut."""
    if cut["whole"]:
        return t
    return torch.cat([t[..., c] for c in cut["conv"]], dim=-1)


def _causal_conv(seq, w, b, prev=None):
    """Depthwise causal conv. seq: (B, S, C); w: (W, C); prev: (B, W-1, C).
    The W shifted products are summed in ``seq``'s dtype, as the
    reference's Python ``sum``; then the bias, and SiLU in f32."""
    width = w.shape[0]
    if prev is None:
        prev = seq.new_zeros((seq.shape[0], width - 1, seq.shape[-1]))
    padded = torch.cat([prev, seq], dim=1)
    out = sum(padded[:, i:i + seq.shape[1]] * w[i] for i in range(width))
    new_prev = padded[:, -(width - 1):] if width > 1 else prev
    return F.silu((out + b).float()).to(seq.dtype), new_prev


def _segsum_decay(cum, lc: int):
    """``exp(cum_t - cum_s')`` for s' <= t, and 0 above the diagonal:
    (B, nc, L, L, H) from the inclusive cumulative log decay (B, nc, L, H).
    The mask goes in before the exponential (the ``segsum`` of the Mamba-2
    paper's minimal SSD listing, arXiv:2405.21060), so no masked entry is
    ``exp`` of a positive sum: see the module docstring."""
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    tri = torch.tril(torch.ones((lc, lc), dtype=torch.bool,
                                device=cum.device))
    return torch.exp(seg.masked_fill_(~tri[None, None, :, :, None],
                                      float("-inf")))


def _on_heads(core, p: Mamba2, proj, cfg: Mamba2Config, state,
              conv_state):
    """``core(proj, conv_w, conv_b, dt_bias, A_log, D, cfg, cut, state,
    conv_state)`` over the heads: for plain tensors straight (``cut`` of
    every head), for DTensors on each rank's heads (``heads``). The
    projection's shard boundaries do not fall on its split points (nor the
    conv's on its channel groups), so the rank takes the projection, the
    conv's weights and the conv state whole and keeps its heads' columns
    of x, z, dt and its groups' B and C; ``dt_bias``, ``A_log``, ``D``
    and the SSM state (B, H, N, P) are cut to its heads. Returns (y, z
    (B, S, H*P) in the projection's dtype, SSM state, conv state: the
    whole (B, W-1, C), its x channels gathered from the ranks)."""
    if not is_dtensor(proj):
        return core(proj, p.conv_w, p.conv_b, p.dt_bias, p.A_log, p.D, cfg,
                    _cut(cfg, (0, cfg.n_heads)), state, conv_state)
    hd = heads.layout(proj, cfg.n_heads, cfg.n_groups)
    cut = _cut(cfg, (hd.lo, hd.lo + hd.n))
    whole = [heads.local(hd, t, None) for t in (p.conv_w, p.conv_b)]
    per_head = [heads.local(hd, t, None, 0)
                for t in (p.dt_bias, p.A_log, p.D)]
    y, z, st, cs = core(
        heads.local(hd, proj, 0), *whole, *per_head, cfg, cut,
        None if state is None else heads.local(hd, state, 0, 1),
        None if conv_state is None else heads.local(hd, conv_state, 0))
    # The rank's conv channels to the whole state: its x channels (and its
    # B and C, where the groups split too) gathered in rank order.
    parts = torch.split(cs, [c.stop - c.start for c in cut["conv"]], dim=-1)
    split = cut["groups"] < cfg.n_groups
    parts = [heads.local(hd, heads.wrap(hd, t, 0, 2), 0) if i == 0 or split
             else t for i, t in enumerate(parts)]
    cs = heads.wrap(hd, torch.cat(parts, dim=-1), 0)
    return (heads.wrap(hd, y, 0, 2), heads.wrap(hd, z, 0, 2),
            heads.wrap(hd, st, 0, 1), cs)


def _ssd_chunked(proj, conv_w, conv_b, dt_bias, A_log, D, cfg: Mamba2Config,
                 cut, initial_state, conv_state):
    """The layer between its projections, on plain tensors, over ``cut``'s
    heads: split, causal conv, the chunked SSD scan, the skip term.
    Returns (y, z, SSM state, conv state)."""
    b, s, _ = proj.shape
    h, g = cut["heads"], cut["groups"]
    n, pd = cfg.state_dim, cfg.d_inner // cfg.n_heads
    hg = h // g
    di = h * pd

    x, z, bb, cc, dt = _split_proj(proj, cut)
    conv_in = torch.cat([x, bb, cc], dim=-1)
    conv_out, conv_state_new = _causal_conv(
        conv_in, _conv_channels(conv_w, cut), _conv_channels(conv_b, cut),
        _conv_channels(conv_state, cut) if conv_state is not None else None)
    x, bb, cc = torch.split(conv_out, [di, g * n, g * n], dim=-1)

    dt = F.softplus(dt.float() + dt_bias)                       # (B,S,H)
    a_neg = -torch.exp(A_log)                                   # (H,)
    loga = dt * a_neg                                           # log decay

    lc = min(cfg.chunk, s)
    while s % lc:
        lc -= 1
    nc = s // lc
    xh = x.reshape(b, nc, lc, h, pd).float()
    bh = bb.reshape(b, nc, lc, g, n).float()
    ch = cc.reshape(b, nc, lc, g, n).float()
    dtc = dt.reshape(b, nc, lc, h)
    logac = loga.reshape(b, nc, lc, h)

    cum = torch.cumsum(logac, dim=2)                            # (B,nc,L,H)

    # Intra-chunk: scores[t, s'] = (C_t . B_s') * exp(cum_t - cum_s') * dt_s'
    decay = _segsum_decay(cum, lc)                              # (B,nc,L,L,H)
    cb = torch.einsum("bclgn,bcsgn->bclsg", ch, bh)             # (B,nc,L,L,G)
    grouped = (b, nc, lc, lc, g, hg)
    # decay first, so the product takes its contiguous layout (x * y is
    # y * x bit for bit: the reference's (cb * decay) * dt)
    scores = (decay.view(grouped) * cb[..., None]
              * dtc.view(b, nc, 1, lc, g, hg)).view(b, nc, lc, lc, h)
    # Each (B,nc,L,L,H) f32 tensor is 268 MB in zamba2-1.2b's 4 x 2048
    # prefill: free it once used (autograd keeps what the backward needs).
    del decay, cb
    y_intra = torch.einsum("bclsh,bcshp->bclhp", scores, xh)
    del scores

    # Chunk-end states: S_c = sum_t exp(cum_L - cum_t) dt_t B_t x_t^T
    dec_to_end = torch.exp(cum[:, :, -1:, :] - cum)             # (B,nc,L,H)
    xw = (xh * (dtc * dec_to_end)[..., None]).view(b, nc, lc, g, hg, pd)
    s_chunk = torch.einsum("bclgn,bclghp->bcghnp", bh, xw).reshape(
        b, nc, h, n, pd)

    # Inter-chunk scan: carry the state, keep the state at each chunk start.
    chunk_decay = torch.exp(cum[:, :, -1, :])                   # (B,nc,H)
    st = (proj.new_zeros((b, h, n, pd), dtype=torch.float32)
          if initial_state is None else initial_state.float())
    s_starts = []
    for c in range(nc):
        s_starts.append(st)
        st = st * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    s_starts = torch.stack(s_starts, dim=1)                     # (B,nc,H,N,P)

    c_rep = ch[:, :, :, :, None, :].expand(b, nc, lc, g, hg, n).reshape(
        b, nc, lc, h, n)
    y_inter = torch.einsum("bclhn,bchnp->bclhp",
                           c_rep * torch.exp(cum)[..., None], s_starts)

    y = (y_intra + y_inter).reshape(b, s, di)
    y = y + (x.float().reshape(b, s, h, pd)
             * D[None, None, :, None]).reshape(b, s, di)
    return y.to(proj.dtype), z, st, conv_state_new


def _gate_out(p: Mamba2, y, z):
    """The gated RMSNorm over the whole ``d_inner`` and ``out_proj``."""
    y = layers.rmsnorm(p.norm.scale, y) * F.silu(z.float()).to(y.dtype)
    return layers.dense(p.out_proj, y)


def mamba2_fwd(p: Mamba2, x_in, cfg: Mamba2Config, *, initial_state=None,
               conv_state=None, return_state: bool = False):
    """x_in: (B, S, d_model). Chunked SSD scan.

    Returns out, or (out, (ssm_state, conv_state)) when ``return_state``
    (prefill needs the states to seed decode).
    """
    proj = layers.dense(p.in_proj, x_in)
    y, z, st, conv_state_new = _on_heads(_ssd_chunked, p, proj, cfg,
                                         initial_state, conv_state)
    out = _gate_out(p, y, z)
    if return_state:
        return out, (st, conv_state_new)
    return out


def _ssd_step(proj, conv_w, conv_b, dt_bias, A_log, D, cfg: Mamba2Config,
              cut, state, conv_state):
    """One token of the layer between its projections, on plain tensors,
    over ``cut``'s heads. Returns (y, z, SSM state, conv state)."""
    b = proj.shape[0]
    h, g = cut["heads"], cut["groups"]
    n, pd = cfg.state_dim, cfg.d_inner // cfg.n_heads
    hg = h // g
    di = h * pd

    x, z, bb, cc, dt = _split_proj(proj, cut)
    conv_in = torch.cat([x, bb, cc], dim=-1)
    conv_out, conv_state = _causal_conv(
        conv_in, _conv_channels(conv_w, cut), _conv_channels(conv_b, cut),
        _conv_channels(conv_state, cut))
    x, bb, cc = torch.split(conv_out, [di, g * n, g * n], dim=-1)

    dt = F.softplus(dt.float() + dt_bias)[:, 0]                # (B,H)
    a = torch.exp(dt * -torch.exp(A_log))                       # (B,H)
    xh = x.reshape(b, h, pd).float()
    b_rep = bb.reshape(b, g, n).float().repeat_interleave(hg, dim=1)
    c_rep = cc.reshape(b, g, n).float().repeat_interleave(hg, dim=1)

    state = state * a[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", b_rep, xh * dt[..., None])
    y = torch.einsum("bhn,bhnp->bhp", c_rep, state)
    y = y + xh * D[None, :, None]
    return y.reshape(b, 1, di).to(proj.dtype), z, state, conv_state


def mamba2_decode(p: Mamba2, x_in, state, conv_state, cfg: Mamba2Config):
    """One token. x_in: (B, 1, d_model); state: (B, H, N, P) f32.
    Returns (out, state, conv_state)."""
    proj = layers.dense(p.in_proj, x_in)
    y, z, state, conv_state = _on_heads(_ssd_step, p, proj, cfg, state,
                                        conv_state)
    return _gate_out(p, y, z), state, conv_state


def mamba2_ref_recurrent(p: Mamba2, x_in, cfg: Mamba2Config):
    """Step-by-step oracle for testing the chunked path."""
    b, s, _ = x_in.shape
    h, n, pd = cfg.n_heads, cfg.state_dim, cfg.d_inner // cfg.n_heads
    state = x_in.new_zeros((b, h, n, pd), dtype=torch.float32)
    conv_state = x_in.new_zeros(
        (b, cfg.conv_width - 1,
         cfg.d_inner + 2 * cfg.n_groups * cfg.state_dim))
    outs = []
    for t in range(s):
        o, state, conv_state = mamba2_decode(p, x_in[:, t:t + 1], state,
                                             conv_state, cfg)
        outs.append(o)
    return torch.cat(outs, dim=1)
