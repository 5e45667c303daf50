"""Per-layer blocks: init / forward / prefill / decode.

Counterpart of ``src/repro/models/blocks.py`` for three kinds:

  attn_mlp   dense transformer layer (GQA + SwiGLU)   [llama/qwen/chatglm/
                                                       mistral; zamba2's
                                                       shared block]
  mamba      Mamba2 layer                             [zamba2 backbone]
  rwkv       RWKV6 time-mix + channel-mix             [rwkv6]

Residual/pre-norm convention: x = x + f(norm(x)) everywhere; the norm is
LayerNorm where ``cfg.norm == "ln"`` (rwkv6), RMSNorm otherwise, f32
parameters either way (the reference's ``_norm_init``, :27-37). The
other kinds arrive with their models.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention, layers, mamba2, rwkv6

KINDS = ("attn_mlp", "mamba", "rwkv")


def _check(cfg, kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"block kind {kind!r} is not ported yet "
                         f"(ported: {', '.join(KINDS)})")
    if cfg.norm not in ("rms", "ln"):
        raise ValueError(f"{cfg.name}: unknown norm {cfg.norm!r}")
    if kind == "attn_mlp" and (cfg.mlp_type != "swiglu" or cfg.attn_window):
        raise ValueError(f"{cfg.name}: only SwiGLU and full attention are "
                         "ported so far")
    if kind == "rwkv" and cfg.rwkv is None:
        raise ValueError(f"{cfg.name}: the rwkv kind needs cfg.rwkv")
    if kind == "mamba" and cfg.ssm is None:
        raise ValueError(f"{cfg.name}: the mamba kind needs cfg.ssm")


def norm_init(cfg, device=None) -> nn.Module:
    return (layers.LayerNorm(cfg.d_model, device=device) if cfg.norm == "ln"
            else layers.RMSNorm(cfg.d_model, device=device))


def norm_apply(cfg, p, x):
    return (layers.layernorm(p, x, cfg.norm_eps) if cfg.norm == "ln"
            else layers.rmsnorm(p.scale, x, cfg.norm_eps))


def _mlp_fwd(cfg, p: layers.SwiGLU, x):
    return layers.swiglu(p, x)


def _attn_kwargs(cfg):
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                rope_fraction=cfg.rope_fraction)


class Block(nn.Module):
    """One layer of ``kind``; attribute names are the JAX pytree keys."""

    def __init__(self, cfg, kind: str = "attn_mlp", device=None):
        super().__init__()
        _check(cfg, kind)
        dt = getattr(torch, cfg.dtype)
        self.norm1 = norm_init(cfg, device)
        if kind == "mamba":
            self.mixer = mamba2.Mamba2(cfg.d_model, cfg.ssm, dt, device)
            return
        if kind == "rwkv":
            self.time_mix = rwkv6.TimeMix(cfg.d_model, cfg.rwkv, dt, device)
            self.norm2 = norm_init(cfg, device)
            self.channel_mix = rwkv6.ChannelMix(cfg.d_model, cfg.d_ff, dt,
                                                device)
            return
        self.attn = attention.GQA(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.resolved_head_dim,
                                  qkv_bias=cfg.qkv_bias, dtype=dt,
                                  device=device)
        self.norm2 = norm_init(cfg, device)
        self.ffn = layers.SwiGLU(cfg.d_model, cfg.d_ff, dt, device)


def block_init(generator, cfg, kind: str = "attn_mlp", device=None) -> Block:
    return layers.init_random_(Block(cfg, kind, device), generator)


def _layer(p: Block, x, cfg):
    """Full-sequence layer. Returns (x, (k, v))."""
    h, kv = attention.gqa_fwd(p.attn, norm_apply(cfg, p.norm1, x),
                              causal=cfg.causal, q_chunk=cfg.q_chunk,
                              kv_chunk=cfg.kv_chunk, **_attn_kwargs(cfg))
    x = x + h
    return x + _mlp_fwd(cfg, p.ffn, norm_apply(cfg, p.norm2, x)), kv


def block_fwd(p: Block, x, cfg, kind: str = "attn_mlp"):
    """Full-sequence forward without a cache. Returns (x, metrics)."""
    if kind == "mamba":
        return x + mamba2.mamba2_fwd(p.mixer, norm_apply(cfg, p.norm1, x),
                                     cfg.ssm), {}
    if kind == "rwkv":
        x = x + rwkv6.rwkv6_time_mix(p.time_mix,
                                     norm_apply(cfg, p.norm1, x), cfg.rwkv)
        return x + rwkv6.rwkv6_channel_mix(
            p.channel_mix, norm_apply(cfg, p.norm2, x)), {}
    return _layer(p, x, cfg)[0], {}


def cache_init(cfg, kind: str, batch: int, max_len: int, device) -> dict:
    """Zero cache entry for one layer of this kind: attention's K/V for
    ``max_len`` positions, Mamba2's f32 SSM state and the conv's last W - 1
    inputs, RWKV6's f32 WKV state and the last normed inputs of its two
    mixers."""
    _check(cfg, kind)
    dt = getattr(torch, cfg.dtype)
    if kind == "mamba":
        s = cfg.ssm
        return {"ssm": torch.zeros((batch, s.n_heads, s.state_dim,
                                    s.d_inner // s.n_heads),
                                   dtype=torch.float32, device=device),
                "conv": torch.zeros((batch, s.conv_width - 1,
                                     s.d_inner + 2 * s.n_groups * s.state_dim),
                                    dtype=dt, device=device)}
    if kind == "rwkv":
        r = cfg.rwkv
        return {"wkv": torch.zeros((batch, r.n_heads, r.head_dim,
                                    r.head_dim), dtype=torch.float32,
                                   device=device),
                "tm_prev": torch.zeros((batch, 1, cfg.d_model), dtype=dt,
                                       device=device),
                "cm_prev": torch.zeros((batch, 1, cfg.d_model), dtype=dt,
                                       device=device)}
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def block_prefill(p: Block, x, cfg, kind: str, cache: dict):
    """Full-sequence forward that also fills the cache. Attention writes
    the first S slots of its K/V in place; Mamba2 and RWKV6 return a new
    entry. Returns (x, cache)."""
    if kind == "mamba":
        h, (ssm, conv) = mamba2.mamba2_fwd(
            p.mixer, norm_apply(cfg, p.norm1, x), cfg.ssm, return_state=True)
        return x + h, {"ssm": ssm, "conv": conv}
    if kind == "rwkv":
        n1 = norm_apply(cfg, p.norm1, x)
        h, (wkv, tm_prev) = rwkv6.rwkv6_time_mix(p.time_mix, n1, cfg.rwkv,
                                                 return_state=True)
        x = x + h
        n2 = norm_apply(cfg, p.norm2, x)
        h2, cm_prev = rwkv6.rwkv6_channel_mix(p.channel_mix, n2,
                                              return_state=True)
        # Cache the *normed* last inputs: decode re-normalizes the new
        # token, so store what the mixers actually consumed.
        return x + h2, {"wkv": wkv, "tm_prev": tm_prev, "cm_prev": cm_prev}
    x, (k, v) = _layer(p, x, cfg)
    attention.write_cache(cache["k"], k, 0)
    attention.write_cache(cache["v"], v, 0)
    return x, cache


def block_decode(p: Block, x, cfg, kind: str, cache: dict, pos: int):
    """One-token step. x: (B, 1, d). Returns (x, cache)."""
    if kind == "mamba":
        h, ssm, conv = mamba2.mamba2_decode(
            p.mixer, norm_apply(cfg, p.norm1, x), cache["ssm"],
            cache["conv"], cfg.ssm)
        return x + h, {"ssm": ssm, "conv": conv}
    if kind == "rwkv":
        n1 = norm_apply(cfg, p.norm1, x)
        h, wkv, tm_prev = rwkv6.rwkv6_time_mix_decode(
            p.time_mix, n1, cache["wkv"], cache["tm_prev"], cfg.rwkv)
        x = x + h
        n2 = norm_apply(cfg, p.norm2, x)
        h2 = rwkv6.rwkv6_channel_mix(p.channel_mix, n2,
                                     x_prev=cache["cm_prev"])
        return x + h2, {"wkv": wkv, "tm_prev": tm_prev, "cm_prev": n2}
    h, ck, cv = attention.gqa_decode(
        p.attn, norm_apply(cfg, p.norm1, x), cache["k"], cache["v"], pos,
        **_attn_kwargs(cfg))
    x = x + h
    x = x + _mlp_fwd(cfg, p.ffn, norm_apply(cfg, p.norm2, x))
    return x, {"k": ck, "v": cv}
