"""LM assembly for the dense, MoE, RWKV6, zamba2 hybrid, vision and audio
families: every family of the JAX package.

Counterpart of ``src/repro/models/model.py`` (``segments`` :40, ``init``
:73, ``_embed_input`` :130, ``_shared_block_fwd`` :141,
``_scan_layers_remat`` :183, ``forward`` :219, ``unembed_fn`` :225,
``forward_hidden`` :230, ``init_cache`` :282, ``prefill`` :308,
``decode_step`` :361). Where JAX
stacks a segment's layers on a leading axis and ``lax.scan``s over them,
the port keeps them in an ``nn.ModuleList`` and walks it with a Python
loop. The cache is a flat list of per-layer dicts in execution order:
attention's ``{"k", "v"}`` (a ring of ``window`` slots under a sliding
window) and MLA's latent ``{"c", "kpe"}``, updated in place, or Mamba2's
``{"ssm", "conv"}`` and RWKV6's ``{"wkv", "tm_prev", "cm_prev"}``,
replaced by each step, or a cross layer's image ``{"k", "v"}``, replaced
by the prefill and only read by decode.

Segments (the reference's ``segments``):

* dense, audio: [attn_mlp x L]               -> ``layers``
* mixtral: [attn_moe x L]                     -> ``layers``
* deepseek-v3: [mla_mlp x first_k_dense] + [mla_moe x rest]
                                              -> ``layers``, ``tail``
* rwkv6:  [rwkv x L]                          -> ``layers``
* zamba2: [zamba_group x G] + [mamba x rem]   -> ``groups`` (each
          ``period`` Mamba2 layers in ``mamba`` and the per-application
          LoRAs ``lora_attn`` / ``lora_ffn``), ``tail``, and the
          weight-shared attention block ``shared_block``, applied after
          every group.
* llama3.2-vision: [vlm_group x G]             -> ``groups`` (each
          ``period - 1`` self-attention layers in ``self`` and one gated
          cross-attention layer ``cross``); ``n_layers // period`` whole
          groups, as the reference floors it.

A vision model reads the batch's ``"image_embeds"`` (B, vision_seq,
vision_dim) in every cross layer (``forward_hidden`` and ``prefill``;
``decode_step`` reads the cross caches the prefill filled). The
embeddings are not cast: the pipeline's f32 give f32 cross K/V and
caches over bf16 weights, as in the reference.

A model with ``cfg.input_mode == "frames"`` (hubert, an encoder) reads
the batch's ``"frames"`` (B, S, frame_dim) through ``frame_proj`` where
the others look up ``"tokens"`` (``_embed_input``); it keeps an
``embed`` table that nothing reads, as the reference does. The frames
are not cast: a bf16 model fed f32 frames runs f32 activations, as the
reference's does. ``forward`` returns every frame's logits (the
reference's encode step), ``prefill`` the last frame's and the filled
K/V caches; ``decode_step`` reads tokens only, as the reference's does.

An MoE layer's metrics (``moe_balance_loss``, ``moe_dropped_frac``,
``moe_max_load``) are summed over the layers of each segment and over
the segments, as the reference's ``forward_hidden`` sums them.

``forward_hidden`` and ``forward`` are differentiable (the training path
runs them under autograd; parameters that require grad get gradients),
while ``prefill`` and ``decode_step`` serve under ``torch.inference_mode``.

Parameters may be DTensors on a ``DeviceMesh``, placed by
``distributed.sharding`` (``named(mesh, make_param_specs(...), lm)``):
every entry point then runs under ``sharding.replicate_constants``, so
the plain tensors made beside the activations (positions, RoPE tables,
masks) count as replicated, the caches come from ``init_cache(...,
mesh=)`` (a Mamba2 or RWKV6 entry that a step replaces comes back in the
placements of the one it replaces: ``blocks._placed``), and serving runs
under ``torch.no_grad`` (DTensor's dispatch sets version counters, which
inference tensors lack). The scans and the attention core run on each
rank's heads (``models.heads``).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.distributed import sharding
from repro_torch.models import attention, blocks, layers


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str          # block kind | zamba_group | vlm_group
    n: int             # layers (groups) in the segment
    inner: int = 0     # Mamba2 (self-attention) layers a group


def segments(cfg) -> list[Segment]:
    if cfg.family in ("dense", "audio"):
        return [Segment("attn_mlp", cfg.n_layers)]
    if cfg.family == "moe":
        if cfg.mla is not None:
            return [Segment("mla_mlp", cfg.first_k_dense),
                    Segment("mla_moe", cfg.n_layers - cfg.first_k_dense)]
        return [Segment("attn_moe", cfg.n_layers)]
    if cfg.family == "ssm":
        return [Segment("rwkv", cfg.n_layers)]
    if cfg.family == "hybrid":
        g = cfg.n_layers // cfg.hybrid_period
        rem = cfg.n_layers - g * cfg.hybrid_period
        segs = [Segment("zamba_group", g, inner=cfg.hybrid_period)]
        if rem:
            segs.append(Segment("mamba", rem))
        return segs
    if cfg.family == "vlm":
        period = cfg.cross_attn_period
        return [Segment("vlm_group", cfg.n_layers // period,
                        inner=period - 1)]
    raise ValueError(f"unknown model family {cfg.family!r} (known: dense, "
                     "moe, ssm, hybrid, vlm, audio)")


class ZambaGroup(nn.Module):
    """One application of zamba2's schedule: ``mamba`` (the group's Mamba2
    layers) and the LoRAs the shared block adds on this application."""

    def __init__(self, cfg, inner: int, device=None):
        super().__init__()
        dt = getattr(torch, cfg.dtype)
        d, r = cfg.d_model, cfg.shared_lora_rank
        self.mamba = nn.ModuleList(
            blocks.Block(cfg, "mamba", device) for _ in range(inner))
        self.lora_attn = layers.LoRA(d, d, r, dt, device)
        self.lora_ffn = layers.LoRA(d, d, r, dt, device)


class VisionGroup(nn.Module):
    """One group of llama3.2-vision's schedule: ``self`` (its
    self-attention layers) and ``cross`` (the gated cross-attention layer
    after them)."""

    def __init__(self, cfg, inner: int, device=None):
        super().__init__()
        self.self = nn.ModuleList(
            blocks.Block(cfg, "attn_mlp", device) for _ in range(inner))
        self.cross = blocks.Block(cfg, "cross_mlp", device)


class FrameProj(nn.Module):
    """The frame embedding stub's projection ``w[frame_dim, d_model]``."""

    def __init__(self, frame_dim: int, d_model: int, dtype, device=None):
        super().__init__()
        self.w = layers.param(torch.empty((frame_dim, d_model), dtype=dtype,
                                          device=device))


class LM(nn.Module):
    """Parameters of an LM; attribute names follow the JAX pytree
    (``frame_proj`` of a frame model, ``embed``, ``final_norm``,
    ``lm_head``). A dense, hubert, mixtral or RWKV6
    model holds its one segment in ``layers``; deepseek-v3 its dense MLA
    layers in ``layers`` and its MoE layers in ``tail``; a hybrid holds
    ``groups``, ``tail`` (the Mamba2 layers past the last whole group) and
    ``shared_block``; a vision model its ``groups`` alone
    (``repro_torch.layout`` maps each to the JAX leaves: ``layers`` and
    ``groups`` to the first segment, ``tail`` to the second)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        segs = segments(cfg)
        dt = getattr(torch, cfg.dtype)
        self.cfg = cfg
        if cfg.input_mode == "frames":
            self.frame_proj = FrameProj(cfg.frame_dim, cfg.d_model, dt,
                                        device)
        elif cfg.input_mode != "tokens":
            raise ValueError(f"{cfg.name}: unknown input_mode "
                             f"{cfg.input_mode!r}")
        self.embed = layers.Embedding(cfg.vocab_size, cfg.d_model, dt, device)
        if cfg.family == "hybrid":
            self.groups = nn.ModuleList(
                ZambaGroup(cfg, segs[0].inner, device)
                for _ in range(segs[0].n))
            self.tail = nn.ModuleList(
                blocks.Block(cfg, "mamba", device)
                for seg in segs[1:] for _ in range(seg.n))
            self.shared_block = blocks.Block(cfg, "attn_mlp", device)
        elif cfg.family == "vlm":
            self.groups = nn.ModuleList(
                VisionGroup(cfg, segs[0].inner, device)
                for _ in range(segs[0].n))
        else:
            self.layers = nn.ModuleList(
                blocks.Block(cfg, segs[0].kind, device)
                for _ in range(segs[0].n))
            if len(segs) > 1:
                (seg,) = segs[1:]
                self.tail = nn.ModuleList(
                    blocks.Block(cfg, seg.kind, device)
                    for _ in range(seg.n))
        self.final_norm = blocks.norm_init(cfg, device)
        if not cfg.tie_embeddings:
            self.lm_head = layers.Embedding(cfg.vocab_size, cfg.d_model, dt,
                                            device)


def init(cfg, seed: int = 0, *, device=None) -> LM:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``,
    allocated on ``device`` (the card unless the caller passes one)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return layers.init_random_(LM(cfg, dev), gen)


def _embed_input(params: LM, cfg, batch):
    """The residual stream's input: the frames through ``frame_proj`` (a
    frame model) or the tokens' embedding rows. On a mesh the projection
    comes out sharded on d_model over "model" (``frame_proj.w`` is
    ``(None, "model")``); it is gathered there, so the stream leaves in
    the embedding lookup's layout (the batch over the dp dims, whole over
    "model")."""
    if cfg.input_mode == "frames":
        return sharding.replicate_dim(
            layers.dense(params.frame_proj.w, batch["frames"]), -1)
    return layers.embed(params.embed.table, batch["tokens"])


def _logits(params: LM, cfg, x):
    head = params.embed if cfg.tie_embeddings else params.lm_head
    return layers.unembed(head.table,
                          blocks.norm_apply(cfg, params.final_norm, x))


def _shared_block_fwd(shared: blocks.Block, group: ZambaGroup, x, cfg,
                      mode: str = "train", cache=None, pos=None):
    """Zamba2's weight-shared attention block plus the group's LoRAs, which
    read the *normed* inputs (``n1`` for attention, ``n2`` for the FFN).
    ``mode``: "train" (no cache), "prefill" (writes the first S slots of
    ``cache``'s K/V in place) or "decode" (one token at ``pos``). Returns
    (x, cache)."""
    n1 = blocks.norm_apply(cfg, shared.norm1, x)
    kw = blocks._attn_kwargs(cfg)
    if mode == "decode":
        h, ck, cv = attention.gqa_decode(shared.attn, n1, cache["k"],
                                         cache["v"], pos, **kw)
        cache = {"k": ck, "v": cv}
    else:
        h, (k, v) = attention.gqa_fwd(shared.attn, n1, causal=cfg.causal,
                                      q_chunk=cfg.q_chunk,
                                      kv_chunk=cfg.kv_chunk, **kw)
        if mode == "prefill":
            attention.write_cache(cache["k"], k, 0)
            attention.write_cache(cache["v"], v, 0)
    h = h + layers.lora_apply(group.lora_attn, n1)
    x = x + h
    n2 = blocks.norm_apply(cfg, shared.norm2, x)
    h2 = (layers.swiglu(shared.ffn, n2)
          + layers.lora_apply(group.lora_ffn, n2))
    return x + h2, cache


def _layer_fwd(lp, x, cfg, kind: str, remat: bool, extras=None):
    """One layer; checkpointed under ``remat`` (the reference's per-layer
    remat). ``extras``: what a cross layer reads of the batch. Returns
    (x, metrics)."""
    args = (lp, x, cfg, kind) + (() if extras is None else (extras,))
    return (layers.remat(blocks.block_fwd, *args) if remat
            else blocks.block_fwd(*args))


def _plain_segments(params: LM, cfg):
    """(kind, layers) of each segment of a model without groups."""
    lists = [params.layers] + ([params.tail] if hasattr(params, "tail")
                               else [])
    return [(seg.kind, lps) for seg, lps in zip(segments(cfg), lists)]


def forward_hidden(params: LM, cfg, batch):
    """Backbone only: returns (hidden (B,S,d), metrics). The training path
    computes the head inside ``losses.chunked_lm_loss`` to bound the live
    logits. Under autograd with ``cfg.remat`` each layer is checkpointed
    (the JAX package's per-layer remat): every layer of a plain segment,
    every Mamba2 layer of a zamba2 group and of its tail, and the shared
    block not at all (the reference's group body has no
    ``jax.checkpoint``). The backward keeps each layer's input and runs
    its forward again."""
    with sharding.replicate_constants(params):
        return _forward_hidden(params, cfg, batch)


def _extras(cfg, batch):
    """What the cross layers read of the batch: its image embeddings."""
    return ({"image_embeds": batch.get("image_embeds")}
            if cfg.family == "vlm" else None)


def _forward_hidden(params: LM, cfg, batch):
    x = _embed_input(params, cfg, batch)
    remat = cfg.remat and torch.is_grad_enabled()
    if cfg.family == "vlm":
        extras = _extras(cfg, batch)
        for group in params.groups:
            for lp in group.self:
                x, _ = _layer_fwd(lp, x, cfg, "attn_mlp", remat)
            x, _ = _layer_fwd(group.cross, x, cfg, "cross_mlp", remat,
                              extras)
        return x, {}
    if cfg.family == "hybrid":
        for group in params.groups:
            for lp in group.mamba:
                x, _ = _layer_fwd(lp, x, cfg, "mamba", remat)
            x, _ = _shared_block_fwd(params.shared_block, group, x, cfg)
        segs = [("mamba", params.tail)]
    else:
        segs = _plain_segments(params, cfg)
    metrics = {}
    for kind, lps in segs:
        mets = []
        for lp in lps:
            x, met = _layer_fwd(lp, x, cfg, kind, remat)
            mets.append(met)
        if mets and mets[0]:
            for k in mets[0]:
                metrics[k] = metrics.get(k, 0.0) + torch.stack(
                    [m[k] for m in mets]).sum()
    return x, metrics


def forward(params: LM, cfg, batch):
    """Returns (logits f32 (B,S,V), metrics)."""
    with sharding.replicate_constants(params):
        x, metrics = forward_hidden(params, cfg, batch)
        return _logits(params, cfg, x), metrics


def unembed_fn(params: LM, cfg):
    """Closure for the sequence-chunked loss: x_chunk -> logits_chunk."""
    return lambda xc: _logits(params, cfg, xc)


def _schedule(params: LM, cfg):
    """The model's layers in execution order: (block kind, layer params,
    group), where kind "shared" is the shared block applied with
    ``group``'s LoRAs. One cache entry goes with each: a vision group's
    self layers' K/V, then its cross layer's image K/V."""
    if cfg.family == "vlm":
        return [(kind, lp, None) for group in params.groups
                for kind, lp in [*(("attn_mlp", lp) for lp in group.self),
                                 ("cross_mlp", group.cross)]]
    if cfg.family != "hybrid":
        return [(kind, lp, None) for kind, lps in _plain_segments(params, cfg)
                for lp in lps]
    order = []
    for group in params.groups:
        order += [("mamba", lp, None) for lp in group.mamba]
        order.append(("shared", params.shared_block, group))
    return order + [("mamba", lp, None) for lp in params.tail]


def init_cache(cfg, batch_size: int, max_len: int, *, device=None,
               mesh=None):
    """One entry a layer in execution order; a zamba2 model has one K/V
    entry per application of its shared block (the reference broadcasts
    the shared block's entry over the G groups), a vision model one per
    self layer and one per cross layer. With ``mesh`` every
    entry is a DTensor placed by ``sharding.cache_specs`` (batch over the
    dp dims, heads or sequence over "model"), for parameters on that
    mesh."""
    dev = resolve_device(device)
    kinds = []
    for seg in segments(cfg):
        if seg.kind == "zamba_group":
            kinds += (["mamba"] * seg.inner + ["attn_mlp"]) * seg.n
        elif seg.kind == "vlm_group":
            kinds += (["attn_mlp"] * seg.inner + ["cross_mlp"]) * seg.n
        else:
            kinds += [seg.kind] * seg.n
    caches = [blocks.cache_init(cfg, kind, batch_size, max_len, dev)
              for kind in kinds]
    if mesh is not None:
        sharding.named(mesh, sharding.cache_specs(cfg, mesh, caches), caches)
    return caches


@contextlib.contextmanager
def _serving(params: LM):
    """The scope of a serving step: ``torch.inference_mode`` on plain
    tensors; on DTensors ``torch.no_grad`` and ``replicate_constants``."""
    if sharding.on_mesh(params):
        with torch.no_grad(), sharding.replicate_constants(params):
            yield
    else:
        with torch.inference_mode():
            yield


def prefill(params: LM, cfg, batch, cache):
    """Returns (last-token logits (B,V), cache); a frame model's last
    frame's."""
    with _serving(params):
        return _prefill(params, cfg, batch, cache)


def _prefill(params: LM, cfg, batch, cache):
    x = _embed_input(params, cfg, batch)
    extras = _extras(cfg, batch)
    new_cache = []
    for (kind, lp, group), lc in zip(_schedule(params, cfg), cache):
        if kind == "shared":
            x, lc = _shared_block_fwd(lp, group, x, cfg, "prefill", lc)
        else:
            x, lc = blocks.block_prefill(lp, x, cfg, kind, lc, extras)
        new_cache.append(lc)
    return _logits(params, cfg, x[:, -1:])[:, 0], new_cache


def decode_step(params: LM, cfg, tokens, pos: int, cache):
    """tokens: (B, 1) int; pos: int. Returns (logits (B,V), cache)."""
    with _serving(params):
        return _decode_step(params, cfg, tokens, pos, cache)


def _decode_step(params: LM, cfg, tokens, pos: int, cache):
    x = layers.embed(params.embed.table, tokens)
    new_cache = []
    for (kind, lp, group), lc in zip(_schedule(params, cfg), cache):
        if kind == "shared":
            x, lc = _shared_block_fwd(lp, group, x, cfg, "decode", lc, pos)
        else:
            x, lc = blocks.block_decode(lp, x, cfg, kind, lc, pos)
        new_cache.append(lc)
    return _logits(params, cfg, x)[:, 0], new_cache
