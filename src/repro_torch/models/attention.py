"""Attention: chunked online-softmax prefill, cached decode, and the GQA
module.

Counterpart of ``src/repro/models/attention.py`` (``chunked_attention``
:28, ``decode_attention`` :113, GQA :142-222). The JAX package has no Pallas
attention, so neither has this one: plain torch, f32 scores and softmax
statistics, no ``scaled_dot_product_attention``. Sliding windows, MLA and
cross-attention arrive with the models that need them.

Layouts are the JAX package's: q (B, S, H, D), k/v (B, S, Hk, D).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers

_NEG = -1e30


def chunked_attention(q, k, v, *, causal: bool = True, q_chunk: int = 1024,
                      kv_chunk: int = 1024,
                      softmax_scale: float | None = None):
    """q: (B, Sq, H, D); k, v: (B, Skv, Hk, D); H % Hk == 0; q[i] and k[i]
    share position i.

    Exact online softmax over (q_chunk x kv_chunk) tiles, so the live score
    tile stays bounded at long prompts. Under ``causal``, tiles that lie
    wholly above the diagonal are skipped: their masked contribution is
    exactly zero (the JAX package computes and zeroes them).
    """
    b, sq, h, dk = q.shape
    skv, hk = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // hk
    scale = softmax_scale if softmax_scale is not None else dk ** -0.5
    dev = q.device
    qc, kc = min(q_chunk, sq), min(kv_chunk, skv)
    qg = q.reshape(b, sq, hk, g, dk)
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=dev)

    for q0 in range(0, sq, qc):
        q1 = min(q0 + qc, sq)
        qb = qg[:, q0:q1].float()
        q_pos = torch.arange(q0, q1, device=dev)
        m_run = torch.full((b, hk, g, q1 - q0), _NEG, device=dev)
        l_run = torch.zeros((b, hk, g, q1 - q0), device=dev)
        acc = torch.zeros((b, hk, g, q1 - q0, dv), device=dev)
        for k0 in range(0, skv, kc):
            if causal and k0 > q1 - 1:
                break
            k1 = min(k0 + kc, skv)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb,
                             k[:, k0:k1].float()) * scale
            kv_pos = torch.arange(k0, k1, device=dev)
            mask = (kv_pos[None, :] <= q_pos[:, None]) if causal else \
                torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=dev)
            s = torch.where(mask, s, _NEG)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None]) * mask
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, v[:, k0:k1].float())
            m_run = m_new
        o = acc / torch.clamp(l_run, min=1e-30)[..., None]   # (b,hk,g,q,dv)
        out[:, q0:q1] = o.permute(0, 3, 1, 2, 4).reshape(
            b, q1 - q0, h, dv).to(q.dtype)
    return out


def decode_attention(q, k_cache, v_cache, cur_len,
                     softmax_scale: float | None = None):
    """Single-step decode: q (B, 1, H, D) against a (B, S, Hk, D) cache.

    ``cur_len``: number of valid cache slots (the new token's own k/v must
    already be written at cur_len - 1).
    """
    b, _, h, dk = q.shape
    s, hk = k_cache.shape[1], k_cache.shape[2]
    g = h // hk
    scale = softmax_scale if softmax_scale is not None else dk ** -0.5
    qh = q.reshape(b, hk, g, dk).float()
    scores = torch.einsum("bhgd,bkhd->bhgk", qh, k_cache.float()) * scale
    pos = torch.arange(s, device=q.device)
    lens = torch.as_tensor(cur_len, device=q.device).expand(b)
    mask = pos[None, :] < lens[:, None]
    scores = torch.where(mask[:, None, None, :], scores, _NEG)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(b, 1, h, v_cache.shape[-1]).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA self-attention module
# ---------------------------------------------------------------------------

class GQA(nn.Module):
    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                 *, qkv_bias: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.wq = layers.param(torch.empty((d_model, n_heads * head_dim), **kw))
        self.wk = layers.param(torch.empty((d_model, n_kv * head_dim), **kw))
        self.wv = layers.param(torch.empty((d_model, n_kv * head_dim), **kw))
        self.wo = layers.param(torch.empty((n_heads * head_dim, d_model), **kw))
        if qkv_bias:
            self.bq = layers.param(torch.zeros((n_heads * head_dim,), **kw))
            self.bk = layers.param(torch.zeros((n_kv * head_dim,), **kw))
            self.bv = layers.param(torch.zeros((n_kv * head_dim,), **kw))


def gqa_init(generator, d_model: int, n_heads: int, n_kv: int, head_dim: int,
             *, qkv_bias: bool = False, dtype=torch.float32, device=None):
    return layers.init_random_(
        GQA(d_model, n_heads, n_kv, head_dim, qkv_bias=qkv_bias, dtype=dtype,
            device=device), generator)


def gqa_project_qkv(p: GQA, x, positions, *, n_heads, n_kv, head_dim,
                    rope_theta=10000.0, rope_fraction=1.0):
    b, s, _ = x.shape
    q = layers.dense(p.wq, x)
    k = layers.dense(p.wk, x)
    v = layers.dense(p.wv, x)
    if hasattr(p, "bq"):
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, n_heads, head_dim)
    k = k.reshape(b, s, n_kv, head_dim)
    v = v.reshape(b, s, n_kv, head_dim)
    if rope_fraction > 0:
        q = layers.apply_rope(q, positions, theta=rope_theta,
                              fraction=rope_fraction)
        k = layers.apply_rope(k, positions, theta=rope_theta,
                              fraction=rope_fraction)
    return q, k, v


def gqa_fwd(p: GQA, x, *, n_heads, n_kv, head_dim, causal=True,
            rope_theta=10000.0, rope_fraction=1.0, q_chunk=1024,
            kv_chunk=1024):
    """Full-sequence attention (prefill / teacher-forced forward) over
    positions 0..S-1. Returns (out, (k, v))."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = gqa_project_qkv(p, x, positions, n_heads=n_heads, n_kv=n_kv,
                              head_dim=head_dim, rope_theta=rope_theta,
                              rope_fraction=rope_fraction)
    ctx = chunked_attention(q, k, v, causal=causal, q_chunk=q_chunk,
                            kv_chunk=kv_chunk)
    out = layers.dense(p.wo, ctx.reshape(b, s, n_heads * head_dim))
    return out, (k, v)


def gqa_decode(p: GQA, x, cache_k, cache_v, pos: int, *, n_heads, n_kv,
               head_dim, rope_theta=10000.0, rope_fraction=1.0):
    """One-token decode. x: (B, 1, d). pos: the current position.

    Writes the new k/v into slot ``pos`` of the caches in place (the JAX
    version returns updated copies; in place saves a cache-sized copy per
    layer and step) and attends over the valid slots. Returns
    (out, cache_k, cache_v).
    """
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = gqa_project_qkv(p, x, positions, n_heads=n_heads, n_kv=n_kv,
                              head_dim=head_dim, rope_theta=rope_theta,
                              rope_fraction=rope_fraction)
    cache_k[:, pos] = k[:, 0]
    cache_v[:, pos] = v[:, 0]
    ctx = decode_attention(q, cache_k, cache_v, pos + 1)
    out = layers.dense(p.wo, ctx.reshape(b, 1, n_heads * head_dim))
    return out, cache_k, cache_v
