"""RWKV6 ("Finch") block: time-mix with data-dependent decay + channel-mix.

Counterpart of ``src/repro/models/rwkv6.py`` (``RWKV6Config`` :38,
``rwkv6_time_mix_init`` :46, ``_projections`` :66, ``_out_stage`` :85,
``rwkv6_time_mix`` :93, ``rwkv6_time_mix_ref`` :156,
``rwkv6_time_mix_decode`` :182, the channel mix :203-226).

Recurrence per head (head dim D, matrix state S: (D, D)):
    wkv_t = S_{t-1} + diag(u) k_t v_t^T
    y_t   = r_t @ wkv_t
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T
with w_t = exp(-exp(w0 + lora_w(x'_t))) -- the *data-dependent* decay that
distinguishes RWKV6; the decay LoRA (rank 64) is a tall-and-skinny GEMM
pair: its down projection ``[B*S, d]·[d, 64]`` classifies TSM2R.

Every projection goes through ``layers.dense`` (so ``tsmm``); the WKV
contractions and the chunk scan stay plain torch, as the reference keeps
them in ``jnp.einsum`` and ``lax.scan``, with its chunk rule and its
``where``-masked pairwise-difference decay. On DTensor parameters the
scan (``_wkv_chunked``, ``_wkv_step``) runs on each rank's heads
(``models.heads``): r, k, v and g come out of ``wr``/``wk``/``wv``/``wg``
split by heads, the decay (from the replicated LoRA) and the bonus ``u``
are cut to the rank's heads, the head reshapes run on local tensors, and
``ln_x`` normalises the head-sharded output over the whole ``H * D``.
The masked decay evaluates ``exp(diff)`` on the masked upper triangle
too: past ``chunk * |logw|`` of ~88 it overflows, and the backward of
the mask gives ``inf * 0 = NaN``, in both packages alike.

Parameters live in ``TimeMix`` and ``ChannelMix``, whose attribute names
are the JAX keys; their ``INIT`` gives the reference's initial values
(``mu`` U[0, 1), ``w0`` -6, ``u`` zeros; the LoRA's ``b`` zeros) to
``layers.init_random_``. ``w0`` and ``u`` are f32, the rest the model
dtype, ``ln_x`` included.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.ft import is_dtensor
from repro_torch.models import heads, layers


@dataclasses.dataclass(frozen=True)
class RWKV6Config:
    n_heads: int
    head_dim: int = 64
    decay_lora_rank: int = 64
    chunk: int = 64


class TimeMix(nn.Module):
    INIT = {"mu": "uniform", "w0": -6.0, "u": "zeros"}

    def __init__(self, d_model: int, cfg: RWKV6Config, dtype, device=None):
        super().__init__()
        h, dh = cfg.n_heads, cfg.head_dim
        if h * dh != d_model:
            raise ValueError(f"rwkv6: {h} heads x {dh} != d_model {d_model}")
        kw = dict(dtype=dtype, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.mu = layers.param(torch.empty((5, d_model), **kw))
        self.w0 = layers.param(torch.empty((d_model,), **f32))
        self.w_lora = layers.LoRA(d_model, d_model, cfg.decay_lora_rank,
                                  dtype, device)
        self.u = layers.param(torch.empty((h, dh), **f32))
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name,
                    layers.param(torch.empty((d_model, d_model), **kw)))
        self.ln_x = layers.LayerNorm(d_model, dtype, device)


class ChannelMix(nn.Module):
    INIT = {"mu": "uniform"}

    def __init__(self, d_model: int, d_ff: int, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.mu = layers.param(torch.empty((2, d_model), **kw))
        self.wk = layers.param(torch.empty((d_model, d_ff), **kw))
        self.wv = layers.param(torch.empty((d_ff, d_model), **kw))
        self.wr = layers.param(torch.empty((d_model, d_model), **kw))


def rwkv6_time_mix_init(generator, d_model: int, cfg: RWKV6Config, dtype,
                        device=None) -> TimeMix:
    return layers.init_random_(TimeMix(d_model, cfg, dtype, device),
                               generator)


def _token_shift(x, prev):
    """x: (B,S,d); prev: (B,1,d) last token of previous segment (or zeros)."""
    return torch.cat([prev, x[:, :-1]], dim=1)


def _projections(p: TimeMix, x, x_prev):
    xx = _token_shift(x, x_prev)
    mu = p.mu.to(x.dtype)
    xr, xk, xv, xw, xg = [x + (xx - x) * mu[i] for i in range(5)]
    r = layers.dense(p.wr, xr)
    k = layers.dense(p.wk, xk)
    v = layers.dense(p.wv, xv)
    g = layers.dense(p.wg, xg)
    logw = -torch.exp(p.w0 + layers.lora_apply(p.w_lora, xw).float())
    return r, k, v, g, logw                               # logw <= 0


def _headed(x, h, dh):
    return x.reshape(*x.shape[:-1], h, dh)


def _out_stage(p: TimeMix, y, g):
    """y: (B, S, H*D) -> ln_x, the SiLU gate and ``wo``."""
    y = layers.layernorm(p.ln_x, y.to(g.dtype))
    return layers.dense(p.wo, y * F.silu(g.float()).to(g.dtype))


def _on_heads(core, p: TimeMix, r, k, v, logw, state, cfg: RWKV6Config):
    """``core(r, k, v, logw, u, state, h, dh, chunk)`` over the heads:
    for plain tensors straight, for DTensors on each rank's heads
    (``heads``: r, k, v and logw (B, S, H*D) split on dim 2, ``u`` (H, D)
    on dim 0, the state (B, H, D, D) on dim 1; the head reshapes run on
    the local tensors). Returns (y (B, S, H*D) f32, state)."""
    h, dh = cfg.n_heads, cfg.head_dim
    if not is_dtensor(r):
        y, st = core(r, k, v, logw, p.u, state, h, dh, cfg.chunk)
        return y.reshape(*y.shape[:2], h * dh), st
    hd = heads.layout(r, h)
    ops = [heads.local(hd, t, 0, 2) for t in (r, k, v, logw)]
    st = None if state is None else heads.local(hd, state, 0, 1)
    y, st = core(*ops, heads.local(hd, p.u, None, 0), st, hd.n, dh,
                 cfg.chunk)
    return (heads.wrap(hd, y.reshape(*y.shape[:2], hd.n * dh), 0, 2),
            heads.wrap(hd, st, 0, 1))


def _wkv_chunked(r, k, v, logw, u, state, h: int, dh: int, chunk: int):
    """The chunked WKV scan over ``h`` heads, on plain tensors: r, k, v,
    logw (B, S, h*dh); u (h, dh); state (B, h, dh, dh) f32 or None.
    Returns (y (B, S, h, dh) f32, final state)."""
    b, s = r.shape[0], r.shape[1]
    rh = _headed(r, h, dh).float()
    kh = _headed(k, h, dh).float()
    vh = _headed(v, h, dh).float()
    lw = _headed(logw, h, dh)                              # (B,S,H,D)

    lc = min(chunk, s)
    while s % lc:
        lc -= 1
    nc = s // lc
    rc = rh.reshape(b, nc, lc, h, dh)
    kc = kh.reshape(b, nc, lc, h, dh)
    vc = vh.reshape(b, nc, lc, h, dh)
    lwc = lw.reshape(b, nc, lc, h, dh)
    cum = torch.cumsum(lwc, dim=2)                         # inclusive

    # Intra-chunk: for s' < t: A[t,s'] = sum_d r_t[d] k_s'[d]
    # exp(cum_{t-1} - cum_{s'})[d] (decay on steps s'+1 .. t-1; y_t reads
    # S_{t-1}), by the pairwise difference (L is small).
    cum_tm1 = cum - lwc                                    # cum_{t-1}
    diff = cum_tm1[:, :, :, None] - cum[:, :, None]        # (B,nc,L,L,H,D)
    strict = torch.tril(torch.ones((lc, lc), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    dec = torch.where(strict[None, None, :, :, None, None], torch.exp(diff),
                      0.0)
    # Each (B,nc,L,L,H,D) tensor is 2.1 GB at rwkv6-1.6b's 4 x 2048-token
    # prefill: free it once used (autograd keeps what the backward needs).
    del diff
    scores = (rc[:, :, :, None] * kc[:, :, None] * dec).sum(-1)  # (B,nc,L,L,H)
    del dec
    y_intra = torch.einsum("bctsh,bcshd->bcthd", scores, vc)
    # Diagonal (current token) via bonus u:
    y_diag = (rc * kc * u).sum(-1, keepdim=True) * vc
    y_intra = y_intra + y_diag

    # Chunk-end state contributions: sum_t exp(cum_L - cum_t) k_t v_t^T
    dec_end = torch.exp(cum[:, :, -1:] - cum)              # (B,nc,L,H,D)
    s_chunk = torch.einsum("bcthd,bcthe->bchde", kc * dec_end, vc)
    chunk_decay = torch.exp(cum[:, :, -1])                 # (B,nc,H,D)

    st = (r.new_zeros((b, h, dh, dh), dtype=torch.float32) if state is None
          else state)
    s_starts = []
    for c in range(nc):
        s_starts.append(st)
        st = st * chunk_decay[:, c, ..., None] + s_chunk[:, c]
    s_starts = torch.stack(s_starts, dim=1)                # (B,nc,H,D,D)

    # Inter-chunk: y_t += r_t (exp(cum_{t-1}) .) S_in
    r_dec = rc * torch.exp(cum_tm1)
    y_inter = torch.einsum("bcthd,bchde->bcthe", r_dec, s_starts)
    return (y_intra + y_inter).reshape(b, s, h, dh), st


def rwkv6_time_mix(p: TimeMix, x, cfg: RWKV6Config, *, state=None,
                   x_prev=None, return_state: bool = False):
    """Chunked evaluation. x: (B,S,d). state: (B,H,D,D) f32.
    ``return_state``: also (final state, x's last token (B,1,d))."""
    b, s, d = x.shape
    if x_prev is None:
        x_prev = x.new_zeros((b, 1, d))
    r, k, v, g, logw = _projections(p, x, x_prev)
    y, st = _on_heads(_wkv_chunked, p, r, k, v, logw, state, cfg)
    out = _out_stage(p, y, g)
    if return_state:
        return out, (st, x[:, -1:])
    return out


def rwkv6_time_mix_ref(p: TimeMix, x, cfg: RWKV6Config):
    """Per-step oracle (also the latency-bound perf baseline)."""
    b, s, d = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    r, k, v, g, logw = _projections(p, x, x.new_zeros((b, 1, d)))
    rh = _headed(r, h, dh).float()
    kh = _headed(k, h, dh).float()
    vh = _headed(v, h, dh).float()
    wh = torch.exp(_headed(logw, h, dh))
    st = x.new_zeros((b, h, dh, dh), dtype=torch.float32)
    ys = []
    for t in range(s):
        kv = torch.einsum("bhd,bhe->bhde", kh[:, t], vh[:, t])
        wkv = st + p.u[None, :, :, None] * kv
        # repro: allow-raw-param-matmul (wkv is the recurrent attention
        # STATE, not a parameter -- the name trips the weight heuristic)
        ys.append(torch.einsum("bhd,bhde->bhe", rh[:, t], wkv))
        st = st * wh[:, t, ..., None] + kv
    y = torch.stack(ys, dim=1)                              # (B,S,H,D)
    return _out_stage(p, y.reshape(b, s, h * dh), g)


def _wkv_step(r, k, v, logw, u, state, h: int, dh: int, chunk: int):
    """One token of the WKV recurrence over ``h`` heads, on plain
    tensors: r, k, v, logw (B, 1, h*dh); state (B, h, dh, dh). Returns
    (y (B, 1, h, dh) f32, new state)."""
    del chunk
    rt = _headed(r, h, dh)[:, 0].float()
    kt = _headed(k, h, dh)[:, 0].float()
    vt = _headed(v, h, dh)[:, 0].float()
    wt = torch.exp(_headed(logw, h, dh)[:, 0])
    kv = torch.einsum("bhd,bhe->bhde", kt, vt)
    wkv = state + u[None, :, :, None] * kv
    # repro: allow-raw-param-matmul (wkv is recurrent state; see the
    # chunked time mix)
    yt = torch.einsum("bhd,bhde->bhe", rt, wkv)[:, None]   # (B,1,H,D)
    return yt, state * wt[..., None] + kv


def rwkv6_time_mix_decode(p: TimeMix, x, state, x_prev, cfg: RWKV6Config):
    """One token. x: (B,1,d); state: (B,H,D,D); x_prev: (B,1,d).
    Returns (out, new state, x)."""
    r, k, v, g, logw = _projections(p, x, x_prev)
    yt, new_state = _on_heads(_wkv_step, p, r, k, v, logw, state, cfg)
    return _out_stage(p, yt, g), new_state, x


# ---------------------------------------------------------------------------
# Channel mix (RWKV's FFN)
# ---------------------------------------------------------------------------

def rwkv6_channel_mix_init(generator, d_model: int, d_ff: int, dtype,
                           device=None) -> ChannelMix:
    return layers.init_random_(ChannelMix(d_model, d_ff, dtype, device),
                               generator)


def rwkv6_channel_mix(p: ChannelMix, x, *, x_prev=None,
                      return_state: bool = False):
    b, s, d = x.shape
    if x_prev is None:
        x_prev = x.new_zeros((b, 1, d))
    xx = _token_shift(x, x_prev)
    mu = p.mu.to(x.dtype)
    xk = x + (xx - x) * mu[0]
    xr = x + (xx - x) * mu[1]
    k = torch.square(F.relu(layers.dense(p.wk, xk).float()))
    r = torch.sigmoid(layers.dense(p.wr, xr).float())
    out = (r * layers.dense(p.wv, k.to(x.dtype)).float()).to(x.dtype)
    if return_state:
        return out, x[:, -1:]
    return out
