"""Attention: chunked online-softmax prefill, cached decode, sliding
windows (ring caches), the GQA module and DeepSeek's MLA.

Counterpart of ``src/repro/models/attention.py`` (``chunked_attention``
:28, ``decode_attention`` :113, GQA :142-222, MLA :229-337). The JAX
package has no Pallas attention, so neither has this one: plain torch, f32
scores and softmax statistics, no ``scaled_dot_product_attention``.
Cross-attention (llama-3.2-vision) is ``gqa_fwd(kv_override=)``: the
queries attend over pre-projected image keys and values.

Layouts are the JAX package's: q (B, S, H, D), k/v (B, S, Hk, D).

On DTensors (parameters placed by ``distributed.sharding``) the attention
core runs on local tensors, PyTorch's tensor-parallel idiom: q, k, v (and
a decode step's caches) are redistributed to one placement -- the batch
as the activations carry it over the dp dims, the heads over "model"
where the kv heads divide it, else whole -- and every rank attends over
its own heads (``heads.local_heads``). Cache writes go into the local shard
likewise (``write_cache``), a sequence-parallel cache's too.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed import sharding
from repro_torch.ft import is_dtensor
from repro_torch.models import heads, layers

_NEG = -1e30


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
             m_run, l_run, acc, window=None, kv_valid=None):
    """One (q chunk x kv chunk) tile of the online softmax: the f32 q
    chunk ``qb`` (B, qc, Hk, G, D) at global positions ``q0``.. against
    the k/v chunk ``kb``/``vb`` (B, kc, Hk, D) at cache slots ``k0``..;
    ``window`` keeps a key only if it lies less than ``window`` positions
    back, ``kv_valid`` (B,) masks slots at or past it. Returns the
    updated (m_run, l_run, acc) carries."""
    dev = qb.device
    qn, kn = qb.shape[1], kb.shape[1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb.float()) * scale
    q_pos = torch.arange(q0, q0 + qn, device=dev)
    kv_pos = torch.arange(k0, k0 + kn, device=dev)
    mask = (kv_pos[None, :] <= q_pos[:, None]) if causal else \
        torch.ones((qn, kn), dtype=torch.bool, device=dev)
    if window is not None:
        mask = mask & (kv_pos[None, :] > q_pos[:, None] - window)
    if kv_valid is not None:
        mask = (mask[None] & (kv_pos[None, None, :]
                              < kv_valid[:, None, None]))[:, None, None]
    s = torch.where(mask, s, _NEG)
    m_new = torch.maximum(m_run, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None]) * mask
    corr = torch.exp(m_run - m_new)
    l_run = l_run * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum(
        "bhgqk,bkhd->bhgqd", p, vb.float())
    return m_new, l_run, acc


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: int | None = None, q_offset: int = 0,
                      kv_valid_len=None, q_chunk: int = 1024,
                      kv_chunk: int = 1024,
                      softmax_scale: float | None = None):
    """q: (B, Sq, H, Dk); k, v: (B, Skv, Hk, Dk/Dv); H % Hk == 0.

    ``q_offset``: global position of q[0] (prefill continuation / decode);
    k[j] sits at position j. ``window``: a query attends only to keys
    less than ``window`` positions back (sliding-window attention).
    ``kv_valid_len``: mask out cache slots >= this (an int or (B,)).
    Supports Dk != Dv (MLA attends with 192-dim keys, 128-dim values).

    Exact online softmax over (q_chunk x kv_chunk) tiles, so the live score
    tile stays bounded at long prompts. Tiles whose masked contribution is
    exactly zero are skipped (the JAX package computes and zeroes them):
    under ``causal`` those wholly above the diagonal, under ``window``
    those wholly behind every query's window, and those wholly at or past
    an int ``kv_valid_len``. Under autograd each kv tile step is
    checkpointed, as the JAX package's ``jax.checkpoint(kv_step)``: the
    backward keeps only the (m, l, acc) carries and recomputes the f32
    score tiles.
    """
    b, sq, h, dk = q.shape
    skv, hk = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // hk
    scale = softmax_scale if softmax_scale is not None else dk ** -0.5
    dev = q.device
    qc, kc = min(q_chunk, sq), min(kv_chunk, skv)
    qg = q.reshape(b, sq, hk, g, dk)
    kv_valid, kv_end = None, skv
    if isinstance(kv_valid_len, int):
        kv_end = min(skv, max(kv_valid_len, 0))
    if kv_valid_len is not None:
        kv_valid = torch.as_tensor(kv_valid_len, device=dev).expand(b)
    outs = []
    grad = torch.is_grad_enabled()

    for q0 in range(0, sq, qc):
        q1 = min(q0 + qc, sq)
        p0, p1 = q_offset + q0, q_offset + q1 - 1   # the chunk's positions
        qb = qg[:, q0:q1].float()
        m_run = torch.full((b, hk, g, q1 - q0), _NEG, device=dev)
        l_run = torch.zeros((b, hk, g, q1 - q0), device=dev)
        acc = torch.zeros((b, hk, g, q1 - q0, dv), device=dev)
        for k0 in range(0, kv_end, kc):
            if causal and k0 > p1:
                break
            k1 = min(k0 + kc, skv)
            if window is not None and k1 - 1 <= p0 - window:
                continue
            args = (qb, k[:, k0:k1], v[:, k0:k1], p0, k0, causal, scale,
                    m_run, l_run, acc, window, kv_valid)
            m_run, l_run, acc = (layers.remat(_kv_step, *args) if grad
                                 else _kv_step(*args))
        o = acc / torch.clamp(l_run, min=1e-30)[..., None]   # (b,hk,g,q,dv)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(
            b, q1 - q0, h, dv).to(q.dtype))
    # One concatenation, not writes into a buffer: a DTensor q chunks into
    # DTensors, which a plain buffer cannot take.
    return torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, cur_len, *,
                     window: int | None = None,
                     softmax_scale: float | None = None):
    """Single-step decode: q (B, 1, H, D) against a (B, S, Hk, D) cache.

    ``cur_len``: number of valid cache slots (the new token's own k/v must
    already be written at cur_len - 1); ``window`` keeps only the last
    ``window`` of them.
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
    if window is not None:
        mask = mask & (pos[None, :] >= lens[:, None] - window)
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


def split_heads(t, n: int, head_dim: int):
    """(B, S, n * head_dim) -> (B, S, n, head_dim), the feature dim gathered
    first where its shards do not divide the ``n`` heads (chatglm3's two
    kv heads over a "model" of 8, ``sharding.whole_if_uneven``). The
    attention core then takes each rank's kv head (``heads.local_heads``)."""
    t = sharding.whole_if_uneven(t, -1, n)
    return t.reshape(*t.shape[:2], n, head_dim)


def gqa_project_qkv(p: GQA, x, positions, *, n_heads, n_kv, head_dim,
                    rope_theta=10000.0, rope_fraction=1.0):
    b, s, _ = x.shape
    q = layers.dense(p.wq, x)
    k = layers.dense(p.wk, x)
    v = layers.dense(p.wv, x)
    if hasattr(p, "bq"):
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, n_heads, head_dim)
    k = split_heads(k, n_kv, head_dim)
    v = split_heads(v, n_kv, head_dim)
    if rope_fraction > 0:
        q = layers.apply_rope(q, positions, theta=rope_theta,
                              fraction=rope_fraction)
        k = layers.apply_rope(k, positions, theta=rope_theta,
                              fraction=rope_fraction)
    return q, k, v


def gqa_fwd(p: GQA, x, *, n_heads, n_kv, head_dim, causal=True,
            window=None, rope_theta=10000.0, rope_fraction=1.0,
            q_chunk=1024, kv_chunk=1024, kv_override=None):
    """Full-sequence attention (prefill / teacher-forced forward) over
    positions 0..S-1, within ``window`` positions back when given.
    Returns (out, (k, v)).

    ``kv_override``: (k, v) to attend over instead of self-projections
    (cross-attention passes pre-projected image keys and values). Only q
    is projected then: the reference projects ``wk`` / ``wv`` too and
    discards them (XLA drops that code), so those weights get a zero
    gradient in both packages."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    if kv_override is None:
        q, k, v = gqa_project_qkv(p, x, positions, n_heads=n_heads,
                                  n_kv=n_kv, head_dim=head_dim,
                                  rope_theta=rope_theta,
                                  rope_fraction=rope_fraction)
    else:
        k, v = kv_override
        q = layers.dense(p.wq, x)
        if hasattr(p, "bq"):
            q = q + p.bq
        q = q.reshape(b, s, n_heads, head_dim)
        if rope_fraction > 0:
            q = layers.apply_rope(q, positions, theta=rope_theta,
                                  fraction=rope_fraction)
    ctx = heads.local_heads(chunked_attention, q, k, v, n_kv=n_kv,
                            causal=causal, window=window, q_chunk=q_chunk,
                            kv_chunk=kv_chunk)
    out = layers.dense(p.wo, ctx.reshape(b, s, n_heads * head_dim))
    return out, (k, v)


def gqa_decode(p: GQA, x, cache_k, cache_v, pos: int, *, n_heads, n_kv,
               head_dim, window=None, rope_theta=10000.0, rope_fraction=1.0,
               ring_window: int | None = None):
    """One-token decode. x: (B, 1, d). pos: the current position.

    Writes the new k/v into slot ``pos`` (``pos % ring_window`` for a
    sliding window's ring cache) of the caches in place (the JAX version
    returns updated copies; in place saves a cache-sized copy per layer
    and step) and attends over the valid slots. Returns
    (out, cache_k, cache_v).
    """
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = gqa_project_qkv(p, x, positions, n_heads=n_heads, n_kv=n_kv,
                              head_dim=head_dim, rope_theta=rope_theta,
                              rope_fraction=rope_fraction)
    slot = pos if ring_window is None else pos % ring_window
    write_cache(cache_k, k, slot)
    write_cache(cache_v, v, slot)
    if ring_window is None:
        ctx = heads.local_heads(decode_attention, q, cache_k, cache_v,
                                n_kv=n_kv, cur_len=pos + 1, window=window)
    else:
        # Ring cache: the first min(pos + 1, ring) slots are valid; the
        # positions wrap, and softmax is permutation-invariant, so the
        # slot order does not matter.
        ctx = heads.local_heads(decode_attention, q, cache_k, cache_v,
                                n_kv=n_kv,
                                cur_len=min(pos + 1, ring_window))
    out = layers.dense(p.wo, ctx.reshape(b, 1, n_heads * head_dim))
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention)
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    """Latent attention's projections (the JAX keys): the query's down
    projection ``wdq``, its norm ``q_norm`` and up projection ``wuq``; the
    kv latent's ``wdkv``, ``kv_norm`` and ``wukv``; the shared rope key
    ``wkr`` (``[T, d]·[d, rope_dim]``: TSM2R's shape); the output ``wo``.
    The norms' scales keep the model dtype, as the reference's
    ``rmsnorm_init`` does inside ``mla_init``."""

    def __init__(self, d_model: int, n_heads: int, *, q_lora: int,
                 kv_lora: int, nope_dim: int, rope_dim: int, v_dim: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.wdq = layers.param(torch.empty((d_model, q_lora), **kw))
        self.q_norm = layers.RMSNorm(q_lora, dtype, device)
        self.wuq = layers.param(torch.empty(
            (q_lora, n_heads * (nope_dim + rope_dim)), **kw))
        self.wdkv = layers.param(torch.empty((d_model, kv_lora), **kw))
        self.kv_norm = layers.RMSNorm(kv_lora, dtype, device)
        self.wukv = layers.param(torch.empty(
            (kv_lora, n_heads * (nope_dim + v_dim)), **kw))
        self.wkr = layers.param(torch.empty((d_model, rope_dim), **kw))
        self.wo = layers.param(torch.empty((n_heads * v_dim, d_model), **kw))


def mla_init(generator, d_model: int, n_heads: int, *, q_lora: int,
             kv_lora: int, nope_dim: int, rope_dim: int, v_dim: int,
             dtype=torch.float32, device=None) -> MLA:
    return layers.init_random_(
        MLA(d_model, n_heads, q_lora=q_lora, kv_lora=kv_lora,
            nope_dim=nope_dim, rope_dim=rope_dim, v_dim=v_dim, dtype=dtype,
            device=device), generator)


def _mla_q(p: MLA, x, positions, *, n_heads, nope_dim, rope_dim,
           rope_theta):
    b, s, _ = x.shape
    cq = layers.sums_whole(layers.rmsnorm(p.q_norm.scale,
                                          layers.dense(p.wdq, x)))
    q = layers.dense(p.wuq, cq).reshape(b, s, n_heads, nope_dim + rope_dim)
    q_nope, q_pe = q[..., :nope_dim], q[..., nope_dim:]
    q_pe = layers.apply_rope(q_pe, positions, theta=rope_theta)
    return q_nope, q_pe


def _mla_latent(p: MLA, x, positions, *, rope_theta):
    c = layers.sums_whole(layers.rmsnorm(p.kv_norm.scale,
                                         layers.dense(p.wdkv, x)))
    k_pe = layers.dense(p.wkr, x)[:, :, None, :]      # (b,s,1,rope)
    k_pe = layers.apply_rope(k_pe, positions, theta=rope_theta)
    return c, k_pe


def mla_fwd(p: MLA, x, *, n_heads, nope_dim, rope_dim, v_dim,
            rope_theta=10000.0, causal=True, q_chunk=1024, kv_chunk=1024):
    """Full-sequence MLA over positions 0..S-1. Returns (out, (c_latent,
    k_pe)) -- the latent cache."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_pe = _mla_q(p, x, positions, n_heads=n_heads,
                          nope_dim=nope_dim, rope_dim=rope_dim,
                          rope_theta=rope_theta)
    c, k_pe = _mla_latent(p, x, positions, rope_theta=rope_theta)
    kv = layers.dense(p.wukv, c).reshape(b, s, n_heads, nope_dim + v_dim)
    k_nope, v = kv[..., :nope_dim], kv[..., nope_dim:]
    # The rope key is shared by every head: a broadcast view, no copy
    # until the concatenation.
    k = torch.cat([k_nope, k_pe.expand(b, s, n_heads, rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    scale = (nope_dim + rope_dim) ** -0.5
    ctx = heads.local_heads(chunked_attention, q, k, v, n_kv=n_heads,
                            causal=causal, q_chunk=q_chunk,
                            kv_chunk=kv_chunk, softmax_scale=scale)
    out = layers.dense(p.wo, ctx.reshape(b, s, n_heads * v_dim))
    return out, (c, k_pe[:, :, 0, :])


def _mla_decode_ctx(q_nope, q_pe, cache_c, cache_kpe, wukv, pos: int, *,
                    nope_dim, rope_dim, v_dim, absorb: bool):
    """The one-token query's context (B, H, v_dim) over the latent cache
    (plain tensors: every head, or a rank's heads with the whole cache
    and those heads' columns of ``wukv``)."""
    b, _, n_heads, _ = q_nope.shape
    kv_lora = cache_c.shape[-1]
    scale = (nope_dim + rope_dim) ** -0.5
    s_len = cache_c.shape[1]
    wukv = wukv.reshape(kv_lora, n_heads, nope_dim + v_dim)
    wuk, wuv = wukv[..., :nope_dim], wukv[..., nope_dim:]

    if absorb:
        # q_c[b,h,l] = sum_d q_nope[b,h,d] * wuk[l,h,d]
        # repro: allow-raw-param-matmul (absorbed decode: the 3-D per-head
        # W_uk slice folds into a batch-1 f32 einsum -- no 2-D tsmm form,
        # and per-step shapes never classify tall-skinny)
        q_c = torch.einsum("bhd,lhd->bhl", q_nope[:, 0].float(), wuk.float())
        cc = cache_c.float()
        s_nope = torch.einsum("bhl,bsl->bhs", q_c, cc)
        s_pe = torch.einsum("bhd,bsd->bhs", q_pe[:, 0].float(),
                            cache_kpe.float())
        scores = (s_nope + s_pe) * scale
        mask = torch.arange(s_len, device=q_nope.device)[None, None, :] <= pos
        scores = torch.where(mask, scores, _NEG)
        prob = torch.softmax(scores, dim=-1)
        ctx_c = torch.einsum("bhs,bsl->bhl", prob, cc)
        # repro: allow-raw-param-matmul (absorbed decode W_uv fold; see wuk)
        return torch.einsum("bhl,lhd->bhd", ctx_c, wuv.float())
    # repro: allow-raw-param-matmul (non-absorbed decode re-expands the
    # latent cache through the 3-D per-head W_ukv -- same exemption as
    # the absorbed path's folds above)
    kv = torch.einsum("bsl,lhd->bshd", cache_c.float(), wukv.float())
    k_nope, v = kv[..., :nope_dim], kv[..., nope_dim:]
    kpe = cache_kpe[:, :, None, :].float()
    k = torch.cat([k_nope, kpe.expand(b, s_len, n_heads, rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    return decode_attention(q, k.to(q.dtype), v.to(q.dtype), pos + 1,
                            softmax_scale=scale)[:, 0]


def mla_decode(p: MLA, x, cache_c, cache_kpe, pos: int, *, n_heads,
               nope_dim, rope_dim, v_dim, rope_theta=10000.0,
               absorb: bool = True):
    """One-token MLA decode over the latent cache, written in place at
    slot ``pos``. Returns (out, cache_c, cache_kpe).

    ``absorb=True``: fold W_uk into the query and W_uv into the output so
    attention runs in the kv_lora-dim latent space -- O(S * kv_lora) a
    step instead of re-expanding the whole cache to per-head k/v
    (O(S * H * (nope + v))). The folds are f32 einsums outside ``tsmm``,
    as in the reference (a 3-D per-head weight has no 2-D form).

    On DTensors each rank attends over its heads (``heads.layout``), with
    the latent cache gathered whole along its sequence (which the
    sequence-parallel layout splits over "model") and its heads' columns
    of ``wukv``: torch 2.11 refuses the non-absorbed arm's ``einsum``
    over a sequence-sharded cache.
    """
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q_nope, q_pe = _mla_q(p, x, positions, n_heads=n_heads,
                          nope_dim=nope_dim, rope_dim=rope_dim,
                          rope_theta=rope_theta)
    c_new, kpe_new = _mla_latent(p, x, positions, rope_theta=rope_theta)
    write_cache(cache_c, c_new, pos)
    write_cache(cache_kpe, kpe_new[:, :, 0, :], pos)
    kw = dict(nope_dim=nope_dim, rope_dim=rope_dim, v_dim=v_dim,
              absorb=absorb)
    if is_dtensor(q_nope):
        hd = heads.layout(q_nope, n_heads)
        ctx = heads.wrap(hd, _mla_decode_ctx(
            heads.local(hd, q_nope, 0, 2), heads.local(hd, q_pe, 0, 2),
            heads.local(hd, cache_c, 0, None),
            heads.local(hd, cache_kpe, 0, None),
            heads.local(hd, p.wukv, None, 1), pos, **kw), 0, 1)
    else:
        ctx = _mla_decode_ctx(q_nope, q_pe, cache_c, cache_kpe, p.wukv, pos,
                              **kw)
    out = layers.dense(p.wo, ctx.reshape(b, 1, n_heads * v_dim).to(x.dtype))
    return out, cache_c, cache_kpe
