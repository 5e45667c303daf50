"""Attention: chunked online-softmax prefill, cached decode, and the GQA
module.

Counterpart of ``src/repro/models/attention.py`` (``chunked_attention``
:28, ``decode_attention`` :113, GQA :142-222). The JAX package has no Pallas
attention, so neither has this one: plain torch, f32 scores and softmax
statistics, no ``scaled_dot_product_attention``. Sliding windows, MLA and
cross-attention arrive with the models that need them.

Layouts are the JAX package's: q (B, S, H, D), k/v (B, S, Hk, D).

On DTensors (parameters placed by ``distributed.sharding``) the attention
core runs on local tensors, PyTorch's tensor-parallel idiom: q, k, v (and
a decode step's caches) are redistributed to one placement -- the batch
as the activations carry it over the dp dims, the heads over "model"
where the kv heads divide it, else whole -- and every rank attends over
its own heads (``_local_heads``). Cache writes go into the local shard
likewise (``write_cache``), a sequence-parallel cache's too.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.ft import is_dtensor
from repro_torch.models import layers

_NEG = -1e30


def _head_placements(q, n_kv: int) -> list:
    """Where attention runs on ``q``'s mesh: the batch dim as ``q`` shards
    it, the heads (dim 2) over "model" when the ``n_kv`` kv heads divide
    it, everything else whole."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    out = []
    for i, (name, p) in enumerate(zip(mesh.mesh_dim_names, q.placements)):
        if isinstance(p, Shard) and p.dim == 0:
            out.append(Shard(0))
        elif name == "model" and n_kv % mesh.size(i) == 0:
            out.append(Shard(2))
        else:
            out.append(Replicate())
    return out


def _local_heads(fn, q, *kv, n_kv: int, **kw):
    """``fn(q, *kv, **kw)`` per rank over its heads: DTensor operands are
    redistributed to ``_head_placements`` and taken local, the output
    (heads on dim 2) comes back a DTensor there. Plain tensors pass
    straight through."""
    if not is_dtensor(q):
        return fn(q, *kv, **kw)
    from torch.distributed.tensor import DTensor
    mesh, places = q.device_mesh, _head_placements(q, n_kv)
    local = [t.redistribute(mesh, places).to_local() for t in (q, *kv)]
    return DTensor.from_local(fn(*local, **kw), mesh, places,
                              run_check=False)


def write_cache(cache, t, start: int) -> None:
    """``cache[:, start:start + S] = t`` in place. A DTensor cache takes
    ``t`` in its own placements, whole along the sequence, and each rank
    writes the positions its shard holds (all of them, unless the cache
    shards its sequence: the sequence-parallel layout)."""
    n = t.shape[1]
    if not is_dtensor(cache):
        cache[:, start:start + n] = t
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache.device_mesh
    seq = [isinstance(p, Shard) and p.dim == 1 for p in cache.placements]
    src = t.redistribute(mesh, [Replicate() if s else p for s, p in
                                zip(seq, cache.placements)]).to_local()
    local = cache.to_local()
    lo, size = 0, cache.shape[1]
    for i, s in enumerate(seq):
        if s:
            size //= mesh.size(i)
            lo += mesh.get_coordinate()[i] * size
    a, b = max(start, lo), min(start + n, lo + size)
    if a < b:
        local[:, a - lo:b - lo] = src[:, a - start:b - start]


def _kv_step(qb, kb, vb, q0: int, k0: int, causal: bool, scale: float,
             m_run, l_run, acc):
    """One (q chunk x kv chunk) tile of the online softmax: the f32 q
    chunk ``qb`` (B, qc, Hk, G, D) starting at position ``q0`` against the
    k/v chunk ``kb``/``vb`` (B, kc, Hk, D) starting at ``k0``. Returns the
    updated (m_run, l_run, acc) carries."""
    dev = qb.device
    qn, kn = qb.shape[1], kb.shape[1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb.float()) * scale
    q_pos = torch.arange(q0, q0 + qn, device=dev)
    kv_pos = torch.arange(k0, k0 + kn, device=dev)
    mask = (kv_pos[None, :] <= q_pos[:, None]) if causal else \
        torch.ones((qn, kn), dtype=torch.bool, device=dev)
    s = torch.where(mask, s, _NEG)
    m_new = torch.maximum(m_run, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None]) * mask
    corr = torch.exp(m_run - m_new)
    l_run = l_run * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum(
        "bhgqk,bkhd->bhgqd", p, vb.float())
    return m_new, l_run, acc


def chunked_attention(q, k, v, *, causal: bool = True, q_chunk: int = 1024,
                      kv_chunk: int = 1024,
                      softmax_scale: float | None = None):
    """q: (B, Sq, H, D); k, v: (B, Skv, Hk, D); H % Hk == 0; q[i] and k[i]
    share position i.

    Exact online softmax over (q_chunk x kv_chunk) tiles, so the live score
    tile stays bounded at long prompts. Under ``causal``, tiles that lie
    wholly above the diagonal are skipped: their masked contribution is
    exactly zero (the JAX package computes and zeroes them). Under autograd
    each kv tile step is checkpointed, as the JAX package's
    ``jax.checkpoint(kv_step)``: the backward keeps only the (m, l, acc)
    carries and recomputes the f32 score tiles.
    """
    b, sq, h, dk = q.shape
    skv, hk = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // hk
    scale = softmax_scale if softmax_scale is not None else dk ** -0.5
    dev = q.device
    qc, kc = min(q_chunk, sq), min(kv_chunk, skv)
    qg = q.reshape(b, sq, hk, g, dk)
    outs = []
    grad = torch.is_grad_enabled()

    for q0 in range(0, sq, qc):
        q1 = min(q0 + qc, sq)
        qb = qg[:, q0:q1].float()
        m_run = torch.full((b, hk, g, q1 - q0), _NEG, device=dev)
        l_run = torch.zeros((b, hk, g, q1 - q0), device=dev)
        acc = torch.zeros((b, hk, g, q1 - q0, dv), device=dev)
        for k0 in range(0, skv, kc):
            if causal and k0 > q1 - 1:
                break
            k1 = min(k0 + kc, skv)
            args = (qb, k[:, k0:k1], v[:, k0:k1], q0, k0, causal, scale,
                    m_run, l_run, acc)
            m_run, l_run, acc = (layers.remat(_kv_step, *args) if grad
                                 else _kv_step(*args))
        o = acc / torch.clamp(l_run, min=1e-30)[..., None]   # (b,hk,g,q,dv)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(
            b, q1 - q0, h, dv).to(q.dtype))
    # One concatenation, not writes into a buffer: a DTensor q chunks into
    # DTensors, which a plain buffer cannot take.
    return torch.cat(outs, dim=1)


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
    ctx = _local_heads(chunked_attention, q, k, v, n_kv=n_kv, causal=causal,
                       q_chunk=q_chunk, kv_chunk=kv_chunk)
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
    write_cache(cache_k, k, pos)
    write_cache(cache_v, v, pos)
    ctx = _local_heads(decode_attention, q, cache_k, cache_v, n_kv=n_kv,
                       cur_len=pos + 1)
    out = layers.dense(p.wo, ctx.reshape(b, 1, n_heads * head_dim))
    return out, cache_k, cache_v
