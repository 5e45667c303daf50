"""Fault-tolerant checkpointing: async, atomic, integrity-checked.

The port's counterpart of ``src/repro/checkpoint/checkpointer.py``
(``Checkpointer`` :58), with the same layout (one directory per step)::

    <root>/step_000000123.tmp/...   while writing
    <root>/step_000000123/          after atomic rename (commit point)
        manifest.json               step; each leaf's dotted name, shape,
                                    dtype and crc32
        arr_00000.npy ...           one file per leaf, in sorted-name order

A tree is what ``ft.named_leaves`` walks: a train state
(``{"params": LM, "opt": ..., "extra": ...}``), a module or a mapping of
name to tensor. The manifest's names take the place of the reference's
pickled ``treedef.pkl``: ``restore`` returns a mapping of dotted name to
CPU tensor, which ``train_step.restore_snapshot`` writes into a live
state (``ft/elastic.py::restore_state`` does so on resume).

* **Atomicity**: a checkpoint is visible iff its rename committed; a
  preempted writer leaves only a .tmp dir that restore ignores and the
  next save garbage-collects. Every payload file and the tmp dir are
  fsync'd before the rename, and the root after it.
* **Async**: ``save`` copies every leaf to the host at once
  (``ft.host_copy``: one page-locked buffer for a state on the card) and
  returns; a worker thread serializes and fsyncs them, ``IO_THREADS``
  leaves at a time. The copy is forced and synchronous: the loop updates
  the state in place, so a queued alias of a leaf would be written as a
  mix of two steps under a crc that matches. A failed write surfaces at
  the next ``save`` or ``wait``.
* **Integrity**: per-leaf crc32 in the manifest, checked on restore
  (torn or corrupt files); ``restore_latest_good`` walks back past
  damaged steps.
* **Retention**: the ``keep_n`` newest checkpoints are kept.

bfloat16 leaves go to disk as ``uint16`` (``np.save`` has no bfloat16)
and come back by their manifest dtype, as the reference does.

A tree of DTensor leaves is saved as full leaves, so a checkpoint stays
mesh-agnostic: every rank gathers each leaf (``full_tensor``, a
collective), rank 0 writes, and in a world of more than one process the
others wait for the commit (rank 0 writes before ``save`` returns there,
then every rank meets at a barrier), so every rank sees the same
committed steps. ``restore`` hands back full leaves for
``ft/elastic.py::restore_state`` to place on the mesh.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.ft import host_copy, is_dtensor, named_leaves

# Leaves read or written at once: np.save / np.load, crc32 and fsync
# release the GIL, so a 15.6 GB state is not one thread's disk and crc rate.
IO_THREADS = min(8, os.cpu_count() or 1)


def _fsync_path(path: str) -> None:
    """fsync a file OR directory (dirs need an O_RDONLY fd on Linux --
    renaming inside a dir is a *directory* mutation, and only fsyncing the
    dir makes the new entry durable)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host tensor as the array ``np.save`` writes, and its dtype name."""
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class Checkpointer:
    def __init__(self, root: str, keep_n: int = 3, async_write: bool = True):
        self.root = root
        self.keep_n = keep_n
        self.async_write = async_write
        os.makedirs(root, exist_ok=True)
        self._q: queue.Queue = queue.Queue()
        self._error = None
        self._worker = None
        if async_write:
            self._worker = threading.Thread(target=self._run, daemon=True)
            self._worker.start()

    # -- public API ---------------------------------------------------------

    def _raise_pending(self):
        """Re-raise (and clear) a failed async write. A silently dropped
        checkpoint is the worst failure mode this class has: the loop keeps
        running, retention GCs the older good steps, and the eventual
        restore finds nothing. Both entry points the loop calls
        (``save``/``wait``) funnel through here so the error surfaces at
        the next step boundary; clearing lets the caller retry."""
        if self._error is not None:
            step, exc = self._error
            self._error = None
            raise RuntimeError(
                f"[ckpt-async] async save of step {step} failed: {exc!r}"
            ) from exc

    def save(self, step: int, tree, block: bool = False):
        """Copy every leaf to the host and enqueue the write. Returns once
        the copy is taken. Raises if a previously enqueued save failed.
        DTensor leaves are gathered whole first (every rank must call)."""
        self._raise_pending()
        sharded = any(is_dtensor(t) for _, t in named_leaves(tree))
        leaves = list(host_copy(tree, whole=sharded).items())
        if sharded and dist.is_initialized() and dist.get_world_size() > 1:
            if dist.get_rank() == 0:
                self.wait()
                self._write(step, leaves)
            dist.barrier()
            return
        if self.async_write and not block:
            self._q.put((step, leaves))
        else:
            self._write(step, leaves)

    def wait(self):
        """Block until all queued saves are durable; raise if any failed."""
        self._q.join()
        self._raise_pending()

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.root, name,
                                               "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def restore(self, step: int | None = None):
        """``(tree, step)``: the saved leaves as a mapping of dotted name to
        CPU tensor, each checked against its manifest crc32 and shape."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = os.path.join(self.root, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)

        def load(i_meta):
            i, meta = i_meta
            arr = np.load(os.path.join(d, f"arr_{i:05d}.npy"))
            crc = zlib.crc32(np.ascontiguousarray(arr))
            if crc != meta["crc32"]:
                raise IOError(f"checkpoint corruption: leaf {i} "
                              f"({meta['name']}) crc {crc} != "
                              f"{meta['crc32']}")
            if list(arr.shape) != meta["shape"]:
                raise IOError(f"checkpoint corruption: leaf {i} "
                              f"({meta['name']}) shape {list(arr.shape)} "
                              f"!= {meta['shape']}")
            return meta["name"], _from_numpy(arr, meta["dtype"])

        with ThreadPoolExecutor(IO_THREADS) as pool:
            tree = dict(pool.map(load, enumerate(manifest["leaves"])))
        return tree, step

    def restore_latest_good(self):
        """Restore the newest checkpoint that passes integrity checks,
        walking backwards past damaged ones (truncated arrays, crc
        mismatches, missing files). This is the escalation path of the
        train loop's rollback/retry: a live-state fault plus a damaged
        newest checkpoint must still land on SOME consistent state."""
        errors = []
        for step in reversed(self.all_steps()):
            try:
                return self.restore(step)
            except Exception as e:
                errors.append((step, e))
        raise FileNotFoundError(
            f"[ckpt-none-good] no restorable checkpoint under {self.root}"
            + (f"; tried {[(s, repr(e)) for s, e in errors]}" if errors
               else ""))

    # -- internals ----------------------------------------------------------

    def _run(self):
        while True:
            step, leaves = self._q.get()
            try:
                self._write(step, leaves)
            except Exception as e:  # surfaces on next save()/wait()
                self._error = (step, e)
            finally:
                # The host copy (state-sized, page-locked for a state on
                # the card) goes now: held until the next save arrives, it
                # outlived the run, one a Checkpointer.
                del leaves
                self._q.task_done()

    def _write(self, step, leaves):
        final = os.path.join(self.root, f"step_{step:09d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        def put(i_leaf):
            i, (name, t) = i_leaf
            arr, dtype = _to_numpy(t)
            path = os.path.join(tmp, f"arr_{i:05d}.npy")
            np.save(path, arr)
            _fsync_path(path)               # payload durable pre-commit
            return {"name": name, "shape": list(arr.shape), "dtype": dtype,
                    "crc32": zlib.crc32(np.ascontiguousarray(arr))}

        with ThreadPoolExecutor(IO_THREADS) as pool:
            metas = list(pool.map(put, enumerate(leaves)))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": metas}, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_path(tmp)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)               # commit point
        _fsync_path(self.root)              # make the rename itself durable
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s:09d}"),
                          ignore_errors=True)
        for name in os.listdir(self.root):   # orphaned tmp dirs
            if name.endswith(".tmp"):
                full = os.path.join(self.root, name)
                final = full[:-4]
                if os.path.exists(final):
                    shutil.rmtree(full, ignore_errors=True)
