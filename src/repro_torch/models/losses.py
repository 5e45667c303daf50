"""Losses: masked softmax cross-entropy with optional z-loss.

Counterpart of ``src/repro/models/losses.py`` (``softmax_xent`` :14,
``lm_loss`` :41, ``chunked_lm_loss`` :48). Logits arrive in f32. Vocab-sharded logits
(a DTensor head sharded over "model") are gathered a chunk at a time
before the log-sum-exp and the gold logit, so the extra bytes stay one
chunk's.
"""

from __future__ import annotations

import torch
from torch.utils import checkpoint

from repro_torch.distributed import sharding


def softmax_xent(logits, targets, mask=None, z_loss: float = 0.0):
    """logits: (..., V) f32; targets: (...) int; mask broadcastable.
    Returns (mean_loss, metrics)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse.square()
    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    acc = ((logits.argmax(-1) == targets).float() * mask).sum() / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": mask.sum(),
                  "z": lse.abs().mean()}


def lm_loss(logits, batch, z_loss: float = 0.0):
    """Next-token loss for LM batches ({'tokens','targets'[,'loss_mask']})."""
    return softmax_xent(logits, batch["targets"], batch.get("loss_mask"),
                        z_loss)


def _chunk_sums(unembed_fn, hid, targets, mask, z_loss):
    logits = sharding.replicate_dim(unembed_fn(hid).float(), -1)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse.square()
    correct = (logits.argmax(-1) == targets).float()
    return ((nll * mask).sum(), (correct * mask).sum(), mask.sum(),
            lse.abs().sum())


def chunked_lm_loss(unembed_fn, hidden, batch, *, chunk: int = 512,
                    z_loss: float = 0.0):
    """Sequence-chunked loss: the full (B, S, V) logits never exist at
    once. Each chunk's logits are recomputed in the backward instead of
    saved (``torch.utils.checkpoint``, the JAX package's
    ``jax.checkpoint``), so the live logits stay (B, chunk, V).

    ``unembed_fn(x_chunk) -> logits_chunk`` closes over the head."""
    b, s = batch["targets"].shape
    c = min(chunk, s)
    while s % c:
        c -= 1
    mask = batch.get("loss_mask")
    mask = (torch.ones((b, s), device=hidden.device) if mask is None
            else mask.float())
    sums = [hidden.new_zeros((), dtype=torch.float32) for _ in range(4)]
    for c0 in range(0, s, c):
        part = checkpoint.checkpoint(
            _chunk_sums, unembed_fn, hidden[:, c0:c0 + c],
            batch["targets"][:, c0:c0 + c], mask[:, c0:c0 + c], z_loss,
            use_reentrant=False)
        sums = [acc + p for acc, p in zip(sums, part)]
    nll_sum, acc_sum, tok, z_sum = sums
    denom = torch.clamp(tok, min=1.0)
    loss = nll_sum / denom
    return loss, {"loss": loss, "accuracy": acc_sum / denom, "tokens": tok,
                  "z": z_sum / max(b * s, 1)}
