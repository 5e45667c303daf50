"""Per-layer blocks: init / forward / prefill / decode.

Counterpart of ``src/repro/models/blocks.py`` for six kinds:

  attn_mlp   dense transformer layer (GQA + SwiGLU)   [llama/qwen/chatglm/
                                                       mistral; zamba2's
                                                       shared block]
  attn_moe   GQA + routed MoE                         [mixtral]
  mla_mlp    DeepSeek MLA + dense MLP                 [deepseek first-3]
  mla_moe    DeepSeek MLA + MoE (shared+routed)       [deepseek]
  mamba      Mamba2 layer                             [zamba2 backbone]
  rwkv       RWKV6 time-mix + channel-mix             [rwkv6]

Residual/pre-norm convention: x = x + f(norm(x)) everywhere; the norm is
LayerNorm where ``cfg.norm == "ln"`` (rwkv6), RMSNorm otherwise, f32
parameters either way (the reference's ``_norm_init``, :27-37). The
cross-attention kind arrives with its model.

Sliding-window attention (``cfg.attn_window``, mixtral) attends within
the window in every path. Its cache holds ``min(max_len, window)``
slots; a cache of exactly ``window`` slots is a ring (position p in slot
p % window), as in the reference (:196-203, :230-242, :291-297), written
in place like every cache of the port. MoE layers return their metrics
from ``block_fwd``; prefill and decode drop them, as the reference's
``moe_fwd(...)[0]`` does.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.ft import is_dtensor
from repro_torch.models import attention, layers, mamba2, moe, rwkv6

KINDS = ("attn_mlp", "attn_moe", "mla_mlp", "mla_moe", "mamba", "rwkv")


def _check(cfg, kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"block kind {kind!r} is not ported yet "
                         f"(ported: {', '.join(KINDS)})")
    if cfg.norm not in ("rms", "ln"):
        raise ValueError(f"{cfg.name}: unknown norm {cfg.norm!r}")
    if kind in ("attn_mlp", "attn_moe", "mla_mlp", "mla_moe") \
            and cfg.mlp_type != "swiglu":
        raise ValueError(f"{cfg.name}: only the SwiGLU MLP is ported so "
                         "far")
    if kind.endswith("_moe") and cfg.moe is None:
        raise ValueError(f"{cfg.name}: the {kind} kind needs cfg.moe")
    if kind.startswith("mla") and cfg.mla is None:
        raise ValueError(f"{cfg.name}: the {kind} kind needs cfg.mla")
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


def _mla_kwargs(cfg):
    m = cfg.mla
    return dict(n_heads=cfg.n_heads, nope_dim=m.nope_dim, rope_dim=m.rope_dim,
                v_dim=m.v_dim, rope_theta=cfg.rope_theta)


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
        if kind.startswith("mla"):
            m = cfg.mla
            self.attn = attention.MLA(
                cfg.d_model, cfg.n_heads, q_lora=m.q_lora, kv_lora=m.kv_lora,
                nope_dim=m.nope_dim, rope_dim=m.rope_dim, v_dim=m.v_dim,
                dtype=dt, device=device)
        else:
            self.attn = attention.GQA(cfg.d_model, cfg.n_heads,
                                      cfg.n_kv_heads, cfg.resolved_head_dim,
                                      qkv_bias=cfg.qkv_bias, dtype=dt,
                                      device=device)
        self.norm2 = norm_init(cfg, device)
        self.ffn = (moe.MoE(cfg.d_model, cfg.moe, dt, device)
                    if kind.endswith("_moe")
                    else layers.SwiGLU(cfg.d_model, cfg.d_ff, dt, device))


def block_init(generator, cfg, kind: str = "attn_mlp", device=None) -> Block:
    return layers.init_random_(Block(cfg, kind, device), generator)


def _ffn(p: Block, x, cfg, kind: str):
    """The second half of an attention layer: x + ffn(norm2(x)). Returns
    (x, metrics): an MoE layer's metrics, none for a dense MLP."""
    h2in = norm_apply(cfg, p.norm2, x)
    if kind.endswith("_moe"):
        h2, metrics = moe.moe_fwd(p.ffn, h2in, cfg.moe)
        return x + h2, metrics
    return x + _mlp_fwd(cfg, p.ffn, h2in), {}


def _layer(p: Block, x, cfg, kind: str = "attn_mlp"):
    """Full-sequence attention layer. Returns (x, kv, metrics): GQA's
    (k, v) or MLA's latent (c, k_pe)."""
    n1 = norm_apply(cfg, p.norm1, x)
    if kind.startswith("mla"):
        h, kv = attention.mla_fwd(p.attn, n1, causal=cfg.causal,
                                  q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                                  **_mla_kwargs(cfg))
    else:
        h, kv = attention.gqa_fwd(p.attn, n1, causal=cfg.causal,
                                  window=cfg.attn_window,
                                  q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
                                  **_attn_kwargs(cfg))
    x, metrics = _ffn(p, x + h, cfg, kind)
    return x, kv, metrics


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
    x, _, metrics = _layer(p, x, cfg, kind)
    return x, metrics


def _ring(cfg, cache: dict) -> int | None:
    """The window when ``cache``'s K/V is a ring of exactly that many
    slots, else None."""
    w = cfg.attn_window
    return w if w and cache["k"].shape[1] == w else None


def cache_init(cfg, kind: str, batch: int, max_len: int, device) -> dict:
    """Zero cache entry for one layer of this kind: attention's K/V for
    ``max_len`` positions (``min(max_len, window)`` under a sliding
    window), MLA's latent ``c`` and rope key ``kpe``, Mamba2's f32 SSM
    state and the conv's last W - 1 inputs, RWKV6's f32 WKV state and the
    last normed inputs of its two mixers."""
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
    if kind.startswith("mla"):
        m = cfg.mla
        return {"c": torch.zeros((batch, max_len, m.kv_lora), dtype=dt,
                                 device=device),
                "kpe": torch.zeros((batch, max_len, m.rope_dim), dtype=dt,
                                   device=device)}
    s = min(max_len, cfg.attn_window) if cfg.attn_window else max_len
    shape = (batch, s, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _write_ring(cache, t, w: int) -> None:
    """The last ``w`` of ``t``'s S >= w positions into the ring ``cache``
    of ``w`` slots, position p in slot p % w: the reference's
    ``roll(t[:, -w:], S % w)``, written in place."""
    shift = t.shape[1] % w
    last = t[:, -w:]
    attention.write_cache(cache, last[:, :w - shift], shift)
    attention.write_cache(cache, last[:, w - shift:], 0)


def _placed(new: dict, old: dict) -> dict:
    """A Mamba2 or RWKV6 cache entry that replaces ``old``, each state in
    ``old``'s placements (a DTensor cache keeps ``sharding.cache_specs``'s
    layout step after step)."""
    return {k: v.redistribute(old[k].device_mesh, old[k].placements)
            if is_dtensor(v) and list(v.placements) != list(old[k].placements)
            else v for k, v in new.items()}


def block_prefill(p: Block, x, cfg, kind: str, cache: dict):
    """Full-sequence forward that also fills the cache. Attention writes
    its K/V (MLA its latent) in place: the first S slots, or under a ring
    the last ``window`` positions; Mamba2 and RWKV6 return a new entry.
    Returns (x, cache)."""
    if kind == "mamba":
        h, (ssm, conv) = mamba2.mamba2_fwd(
            p.mixer, norm_apply(cfg, p.norm1, x), cfg.ssm, return_state=True)
        return x + h, _placed({"ssm": ssm, "conv": conv}, cache)
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
        return x + h2, _placed({"wkv": wkv, "tm_prev": tm_prev,
                                "cm_prev": cm_prev}, cache)
    x, (a, b), _ = _layer(p, x, cfg, kind)
    names = ("c", "kpe") if kind.startswith("mla") else ("k", "v")
    ring = None if kind.startswith("mla") else _ring(cfg, cache)
    for name, t in zip(names, (a, b)):
        if ring is not None and t.shape[1] >= ring:
            _write_ring(cache[name], t, ring)
        else:
            attention.write_cache(cache[name], t, 0)
    return x, cache


def block_decode(p: Block, x, cfg, kind: str, cache: dict, pos: int):
    """One-token step. x: (B, 1, d). Returns (x, cache)."""
    if kind == "mamba":
        h, ssm, conv = mamba2.mamba2_decode(
            p.mixer, norm_apply(cfg, p.norm1, x), cache["ssm"],
            cache["conv"], cfg.ssm)
        return x + h, _placed({"ssm": ssm, "conv": conv}, cache)
    if kind == "rwkv":
        n1 = norm_apply(cfg, p.norm1, x)
        h, wkv, tm_prev = rwkv6.rwkv6_time_mix_decode(
            p.time_mix, n1, cache["wkv"], cache["tm_prev"], cfg.rwkv)
        x = x + h
        n2 = norm_apply(cfg, p.norm2, x)
        h2 = rwkv6.rwkv6_channel_mix(p.channel_mix, n2,
                                     x_prev=cache["cm_prev"])
        return x + h2, _placed({"wkv": wkv, "tm_prev": tm_prev,
                                "cm_prev": n2}, cache)
    n1 = norm_apply(cfg, p.norm1, x)
    if kind.startswith("mla"):
        h, cc, ckpe = attention.mla_decode(
            p.attn, n1, cache["c"], cache["kpe"], pos, absorb=cfg.mla_absorb,
            **_mla_kwargs(cfg))
        cache = {"c": cc, "kpe": ckpe}
    else:
        ring = _ring(cfg, cache)
        h, ck, cv = attention.gqa_decode(
            p.attn, n1, cache["k"], cache["v"], pos,
            window=None if ring else cfg.attn_window, ring_window=ring,
            **_attn_kwargs(cfg))
        cache = {"k": ck, "v": cv}
    x, _ = _ffn(p, x + h, cfg, kind)
    return x, cache
