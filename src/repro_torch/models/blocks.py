"""Per-layer blocks: init / forward / prefill / decode.

Counterpart of ``src/repro/models/blocks.py`` for the ``attn_mlp`` kind
(dense transformer layer: GQA + SwiGLU, pre-norm RMSNorm residuals), the
kind of llama, qwen, chatglm and mistral. The other kinds arrive with their
models.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention, layers

KINDS = ("attn_mlp",)


def _check(cfg, kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"block kind {kind!r} is not ported yet "
                         f"(ported: {', '.join(KINDS)})")
    if cfg.norm != "rms" or cfg.mlp_type != "swiglu" or cfg.attn_window:
        raise ValueError(f"{cfg.name}: only RMSNorm, SwiGLU and full "
                         "attention are ported so far")


def norm_apply(cfg, p: layers.RMSNorm, x):
    return layers.rmsnorm(p.scale, x, cfg.norm_eps)


def _mlp_fwd(cfg, p: layers.SwiGLU, x):
    return layers.swiglu(p, x)


def _attn_kwargs(cfg):
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                rope_fraction=cfg.rope_fraction)


class Block(nn.Module):
    """One ``attn_mlp`` layer; attribute names are the JAX pytree keys."""

    def __init__(self, cfg, kind: str = "attn_mlp", device=None):
        super().__init__()
        _check(cfg, kind)
        dt = getattr(torch, cfg.dtype)
        self.norm1 = layers.RMSNorm(cfg.d_model, device)
        self.attn = attention.GQA(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.resolved_head_dim,
                                  qkv_bias=cfg.qkv_bias, dtype=dt,
                                  device=device)
        self.norm2 = layers.RMSNorm(cfg.d_model, device)
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
    return _layer(p, x, cfg)[0], {}


def cache_init(cfg, kind: str, batch: int, max_len: int, device) -> dict:
    """Zero cache entry for one layer of this kind."""
    _check(cfg, kind)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    dt = getattr(torch, cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def block_prefill(p: Block, x, cfg, kind: str, cache: dict):
    """Full-sequence forward that also fills the cache's first S slots in
    place. Returns (x, cache)."""
    s = x.shape[1]
    x, (k, v) = _layer(p, x, cfg)
    cache["k"][:, :s] = k
    cache["v"][:, :s] = v
    return x, cache


def block_decode(p: Block, x, cfg, kind: str, cache: dict, pos: int):
    """One-token step. x: (B, 1, d). Returns (x, cache)."""
    h, ck, cv = attention.gqa_decode(
        p.attn, norm_apply(cfg, p.norm1, x), cache["k"], cache["v"], pos,
        **_attn_kwargs(cfg))
    x = x + h
    x = x + _mlp_fwd(cfg, p.ffn, norm_apply(cfg, p.norm2, x))
    return x, {"k": ck, "v": cv}
