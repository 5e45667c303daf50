"""Deterministic synthetic token data: the batch for a step is a pure
function of (seed, step, host).

The port's copy of ``src/repro/data/pipeline.py`` (``DataConfig`` :30,
``_example`` :44, ``batch_for_step`` :65, ``Prefetcher`` :98), numpy
only, so both packages make the same arrays from the same config. The
token stream mixes repeated phrases, arithmetic ramps and bigram chains,
so a model has something to learn. A background ``Prefetcher`` thread
keeps ``prefetch_depth`` batches ready while a step runs; a restart
builds a new one at the step to resume from.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    seq_len: int = 128
    global_batch: int = 8
    vocab_size: int = 256
    host_index: int = 0
    host_count: int = 1
    prefetch_depth: int = 2
    mode: str = "tokens"       # tokens | frames
    frame_dim: int = 0
    vision_seq: int = 0
    vision_dim: int = 0


def _example(rng: np.random.Generator, cfg: DataConfig) -> np.ndarray:
    """One structured pseudo-document of seq_len+1 tokens."""
    n = cfg.seq_len + 1
    kind = rng.integers(0, 3)
    v = cfg.vocab_size
    if kind == 0:       # repeated phrase
        phrase = rng.integers(0, v, rng.integers(3, 12))
        reps = int(np.ceil(n / len(phrase)))
        return np.tile(phrase, reps)[:n]
    if kind == 1:       # arithmetic mod-vocab ramp
        start, stride = rng.integers(0, v), rng.integers(1, 7)
        return (start + stride * np.arange(n)) % v
    # bigram chain with a small per-example transition table
    table = rng.integers(0, v, (16,))
    out = np.empty(n, np.int64)
    out[0] = rng.integers(0, v)
    for i in range(1, n):
        out[i] = table[out[i - 1] % 16] if rng.random() < 0.8 else rng.integers(0, v)
    return out


def batch_for_step(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    """Pure function (seed, step, host) -> host-local batch."""
    assert cfg.global_batch % cfg.host_count == 0
    local = cfg.global_batch // cfg.host_count
    out_tokens = np.empty((local, cfg.seq_len), np.int32)
    out_targets = np.empty((local, cfg.seq_len), np.int32)
    extras = {}
    if cfg.mode == "frames":
        frames = np.empty((local, cfg.seq_len, cfg.frame_dim), np.float32)
    for i in range(local):
        gidx = cfg.host_index * local + i
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, gidx]))
        seq = _example(rng, cfg)
        out_tokens[i] = seq[:-1]
        out_targets[i] = seq[1:]
        if cfg.mode == "frames":
            # frame embedding stub: target class embedded + noise
            base = rng.standard_normal((cfg.vocab_size, cfg.frame_dim)).astype(np.float32)
            frames[i] = base[seq[:-1] % cfg.vocab_size] * 0.5 \
                + rng.standard_normal((cfg.seq_len, cfg.frame_dim)).astype(np.float32) * 0.1
    batch = {"tokens": out_tokens, "targets": out_targets}
    if cfg.mode == "frames":
        batch["frames"] = frames
        del batch["tokens"]
    if cfg.vision_seq:
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, 10 ** 6]))
        extras["image_embeds"] = rng.standard_normal(
            (local, cfg.vision_seq, cfg.vision_dim)).astype(np.float32)
    batch.update(extras)
    return batch


class Prefetcher:
    """Background thread producing host batches in step order from
    ``start_step``; ``get()`` returns ``(step, batch)``."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch_depth)
        self._next_step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._next_step
        while not self._stop.is_set():
            batch = batch_for_step(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def get(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
