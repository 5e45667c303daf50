"""The fault-tolerant training loop's pieces in the port, on the CPU: the
checkpointer, the checkpoint corruptors, the train-state snapshot, the
watchdog, the preemption handler, the prefetcher and the one-process
elastic plan.

Where the JAX package has the same piece, both take the same input: the
corruptors damage two copies of one checkpoint directory with the same
seed (same file, byte and bit), the watchdogs read one scripted
``time.monotonic`` (no sleep: nothing here measures real time), the
prefetchers start at the same step, and ``rescale_plan`` refuses the same
plans with the same tags.
"""

import os
import shutil
import signal
import threading
import types

import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipeline
from repro.ft import elastic as jelastic
from repro.ft import inject as jinject
from repro.ft import watchdog as jwatchdog
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import registry
from repro_torch.data import pipeline
from repro_torch.ft import elastic, inject, named_leaves, watchdog
from repro_torch.optim import adamw, powersgd
from repro_torch.train import train_step


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((64, 32), generator=g),
            "b": torch.randn((32,), generator=g).to(torch.bfloat16),
            "nested": {"m": torch.randn((64, 32), generator=g),
                       "step": torch.tensor(7, dtype=torch.int32)}}


def _same(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(torch.uint8) if a.dim() else a,
                            b.view(torch.uint8) if b.dim() else b))


def _state(extra=True):
    """The smoke train state, with PowerSGD's state over embed and
    lm_head (``min_size`` lowered to the smoke width)."""
    cfg = registry.get_config("chatglm3-6b", smoke=True)
    state = train_step.init_train_state(0, cfg, adamw.AdamWConfig(),
                                        device="cpu")
    if extra:
        state["extra"] = powersgd.init(
            powersgd.PowerSGDConfig(rank=2, min_size=1024), state["params"])
    return state


# -- checkpointer -----------------------------------------------------------

@pytest.mark.parametrize("async_write", [False, True])
def test_checkpoint_roundtrip_with_bf16(tmp_path, async_write):
    ckpt = Checkpointer(str(tmp_path), async_write=async_write)
    tree = _tree()
    ckpt.save(3, tree)
    ckpt.wait()
    restored, step = ckpt.restore()
    assert step == 3
    want = dict(named_leaves(tree))
    assert sorted(restored) == sorted(want) == ["b", "nested.m",
                                                "nested.step", "w"]
    for n, t in want.items():
        assert _same(restored[n], t), n
    meta = (tmp_path / "step_000000003" / "arr_00000.npy")
    assert np.load(meta).dtype == np.uint16          # "b", bf16 by bits


def test_checkpoint_of_a_train_state_restores_in_place(tmp_path):
    state = _state()
    ckpt = Checkpointer(str(tmp_path), async_write=False)
    ckpt.save(0, state)
    want = {n: t.clone() for n, t in named_leaves(state)}
    ptrs = {n: t.data_ptr() for n, t in named_leaves(state)}
    with torch.no_grad():
        for _, t in named_leaves(state):
            t.add_(1)
    tree, step = ckpt.restore()
    assert step == 0
    train_step.restore_snapshot(tree, state)
    for n, t in named_leaves(state):
        assert t.data_ptr() == ptrs[n] and _same(t.detach(), want[n]), n
    assert any(n.startswith("extra.embed.table.") for n in want)
    assert "opt.step" in want


def test_checkpoint_save_copies_before_it_returns(tmp_path):
    """The loop updates leaves in place right after ``save``: the queued
    write must hold the values at the call, not the tensor."""
    ckpt = Checkpointer(str(tmp_path), async_write=True)
    gate, real_write = threading.Event(), ckpt._write

    def held_write(step, leaves):
        assert gate.wait(timeout=30)
        real_write(step, leaves)

    ckpt._write = held_write
    w = torch.zeros((256, 256))
    ckpt.save(1, {"w": w})
    w.add_(1)
    gate.set()
    ckpt.wait()
    tree, _ = ckpt.restore()
    assert torch.equal(tree["w"], torch.zeros((256, 256)))


def test_checkpoint_writer_frees_its_host_copy(tmp_path):
    """Once a queued write is durable, its host copy (state-sized, and
    page-locked for a state on the card) is freed: the writer thread must
    not hold it until the next save, which for the last save of a run is
    never."""
    import gc
    import weakref

    ckpt = Checkpointer(str(tmp_path), async_write=True)
    refs, real_write = [], ckpt._write

    def watched_write(step, leaves):
        refs.extend(weakref.ref(t) for _, t in leaves)
        real_write(step, leaves)

    ckpt._write = watched_write
    ckpt.save(1, {"w": torch.ones((256, 256))})
    ckpt.wait()
    gc.collect()
    assert refs and all(r() is None for r in refs)


def test_checkpoint_retention_and_torn_tmp(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep_n=2, async_write=True)
    for s in (1, 2, 3, 4):
        ckpt.save(s, _tree(s))
    ckpt.wait()
    assert ckpt.all_steps() == [3, 4]
    torn = inject.corrupt_checkpoint(str(tmp_path), mode="torn-tmp", seed=1)
    assert torn.endswith("step_000000005.tmp") and os.path.isdir(torn)
    assert ckpt.latest_step() == 4
    _, step = ckpt.restore()
    assert step == 4
    ckpt.save(5, _tree(5), block=True)     # the torn write is replaced
    assert not os.path.exists(torn)
    assert ckpt.all_steps() == [4, 5]


@pytest.mark.parametrize("mode", ["bitflip", "truncate"])
def test_checkpoint_detects_corruption_and_walks_back(tmp_path, mode):
    ckpt = Checkpointer(str(tmp_path), async_write=False)
    ckpt.save(1, _tree(1))
    ckpt.save(2, _tree(2))
    inject.corrupt_checkpoint(str(tmp_path), mode=mode, seed=3)
    with pytest.raises((IOError, ValueError)):
        ckpt.restore(2)
    tree, step = ckpt.restore_latest_good()
    assert step == 1
    assert all(_same(tree[n], t) for n, t in named_leaves(_tree(1)))
    inject.corrupt_checkpoint(str(tmp_path), mode=mode, seed=3, step=1)
    with pytest.raises(FileNotFoundError, match=r"\[ckpt-none-good\]"):
        ckpt.restore_latest_good()


def test_checkpoint_async_error_surfaces_and_clears(tmp_path):
    ckpt = Checkpointer(str(tmp_path), async_write=True)
    ckpt.save(1, {"w": torch.ones((4, 4))})
    ckpt.wait()
    real_write = ckpt._write

    def failing_write(step, leaves):
        if step == 2:
            raise IOError("disk full")
        real_write(step, leaves)

    ckpt._write = failing_write
    ckpt.save(2, {"w": torch.ones((4, 4))})
    with pytest.raises(RuntimeError, match=r"\[ckpt-async\].*step 2"):
        ckpt.wait()
    ckpt.save(3, {"w": torch.ones((4, 4))})      # cleared: works again
    ckpt.wait()
    assert ckpt.all_steps() == [1, 3]


# -- corruptors against the JAX package -------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["torn-tmp", "truncate", "bitflip"])
def test_corrupt_checkpoint_damages_as_jax(tmp_path, seed, mode):
    src = tmp_path / "src"
    ckpt = Checkpointer(str(src), async_write=False)
    ckpt.save(1, _tree(1))
    ckpt.save(2, {**_tree(2), "extra": torch.arange(300.0)})
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    shutil.copytree(src, ours)
    shutil.copytree(src, theirs)
    got = inject.corrupt_checkpoint(str(ours), mode=mode, seed=seed)
    want = jinject.corrupt_checkpoint(str(theirs), mode=mode, seed=seed)
    assert os.path.relpath(got, ours) == os.path.relpath(want, theirs)
    files = sorted(os.path.relpath(os.path.join(d, f), ours)
                   for d, _, fs in os.walk(ours) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), theirs)
                           for d, _, fs in os.walk(theirs) for f in fs)
    for f in files:
        assert (ours / f).read_bytes() == (theirs / f).read_bytes(), f
    changed = [f for f in files if not (src / f).exists()
               or (src / f).read_bytes() != (ours / f).read_bytes()]
    assert len(changed) == 1


def test_corrupt_checkpoint_rejects_unknown_mode(tmp_path):
    with pytest.raises(ValueError, match=r"\[inject-ckpt-mode\]"):
        inject.corrupt_checkpoint(str(tmp_path), mode="melt")
    with pytest.raises(FileNotFoundError, match=r"\[inject-ckpt\]"):
        inject.corrupt_checkpoint(str(tmp_path), mode="bitflip")


# -- the train-state snapshot ------------------------------------------------

def test_host_snapshot_is_a_deep_copy_and_restores_in_place():
    state = _state()
    snap = train_step.host_snapshot(state)
    live = dict(named_leaves(state))
    assert sorted(snap) == sorted(live)
    ptrs = {n: t.data_ptr() for n, t in live.items()}
    want = {n: t.detach().clone() for n, t in live.items()}
    assert all(snap[n].data_ptr() != ptrs[n] for n in live)
    inject.poison_tree(state["params"])
    with torch.no_grad():
        for t in live.values():
            t.add_(1)
    for n in live:                        # the snapshot did not follow
        assert _same(snap[n], want[n]), n
    assert train_step.restore_snapshot(snap, state) is state
    for n, t in named_leaves(state):
        assert t.data_ptr() == ptrs[n] and _same(t.detach(), want[n]), n


def test_host_copy_reuses_its_buffer():
    """A snapshot refreshed into the one it replaces: one host buffer,
    leaves 64-byte aligned and apart, every value the state's."""
    state = _state()
    first = train_step.host_snapshot(state)
    base = next(iter(first.values())).untyped_storage().data_ptr()
    spans = sorted((t.data_ptr() - base, t.numel() * t.element_size())
                   for t in first.values())
    assert all(off % 64 == 0 for off, _ in spans)
    assert all(a + n <= b for (a, n), (b, _) in zip(spans, spans[1:]))
    assert all(t.untyped_storage().data_ptr() == base
               for t in first.values())
    with torch.no_grad():
        for _, t in named_leaves(state):
            t.add_(1)
    ptrs = {n: t.data_ptr() for n, t in first.items()}
    again = train_step.host_snapshot(state, first)
    assert again is first
    for n, t in named_leaves(state):
        assert again[n].data_ptr() == ptrs[n] and _same(again[n], t.detach())
    with pytest.raises(ValueError, match=r"\[host-copy\]"):
        train_step.host_snapshot(_state(extra=False), first)


def test_poison_tree_refuses_a_nested_mapping():
    """The launcher poisons the parameters' module in place; a nested
    mapping's leaf has no top-level key to come back under."""
    state = _state(extra=False)
    with pytest.raises(ValueError, match=r"\[inject-poison\] params.embed.table"):
        inject.poison_tree({"params": dict(
            state["params"].named_parameters())})
    assert inject.poison_tree(state["params"]) is state["params"]
    assert torch.isnan(state["params"].embed.table[0, 0])


def test_restore_snapshot_refuses_another_tree():
    state = _state()
    snap = train_step.host_snapshot(_state(extra=False))
    with pytest.raises(KeyError, match=r"\[snapshot-tree\]"):
        train_step.restore_snapshot(snap, state)
    snap = train_step.host_snapshot(state)
    snap["opt.step"] = snap["opt.step"].to(torch.int64)
    with pytest.raises(ValueError, match=r"\[snapshot-tree\] opt.step"):
        train_step.restore_snapshot(snap, state)


# -- watchdog ----------------------------------------------------------------

class _Clock:
    """A scripted ``time.monotonic``: each step begins at a whole second
    and lasts its scripted duration."""

    def __init__(self, durations):
        self.t, self.durations, self.begun = 0.0, list(durations), False

    def __call__(self):
        if not self.begun:
            self.t = float(int(self.t) + 1)
        else:
            self.t += self.durations.pop(0)
        self.begun = not self.begun
        return self.t


DURATIONS = [0.01] * 5 + [0.06, 0.011, 0.2, 0.012, 0.009, 0.05]


def _drive(mod, monkeypatch, faults_at=(6,)):
    monkeypatch.setattr(mod, "time",
                        types.SimpleNamespace(monotonic=_Clock(DURATIONS)))
    events = []
    wd = mod.StepWatchdog(straggler_factor=1.5,
                          on_straggler=lambda dt, e: events.append((dt, e)))
    out = []
    for i in range(len(DURATIONS)):
        if i in faults_at:
            wd.note_fault()
        if i % 2:
            with wd:
                pass
            out.append(dict(wd.last_metrics))
        else:
            wd.step_begin()
            out.append(wd.step_end())
    return out, events, wd.straggler_events, wd.fault_events, wd.ewma


def test_watchdog_metrics_equal_jax(monkeypatch):
    got = _drive(watchdog, monkeypatch)
    want = _drive(jwatchdog, monkeypatch)
    assert got == want
    metrics, events = got[0], got[1]
    assert [m["straggler"] for m in metrics].count(True) == 3 == len(events)
    assert metrics[5]["straggler"] and metrics[7]["straggler"]
    assert metrics[6]["fault_events"] == 1


def test_watchdog_cancels_the_hang_timer_on_a_raise():
    hangs = []
    wd = watchdog.StepWatchdog(hang_timeout_s=3600.0,
                               on_hang=lambda: hangs.append(1))
    with pytest.raises(RuntimeError):
        with wd:
            assert wd._timer is not None and wd._timer.is_alive()
            timer = wd._timer
            raise RuntimeError("step died")
    assert wd._timer is None and wd.last_metrics is None
    timer.join(timeout=5)
    assert not timer.is_alive() and hangs == []
    with wd:
        pass
    assert wd._timer is None and wd.last_metrics["step_time_s"] >= 0


def test_preemption_flag_and_chaining():
    chained = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: chained.append(s))
    try:
        h = watchdog.PreemptionHandler(signals=(signal.SIGUSR1,))
        assert not h.requested
        signal.raise_signal(signal.SIGUSR1)
        assert h.requested and chained == [signal.SIGUSR1]
        h.restore()
        assert signal.getsignal(signal.SIGUSR1) is not signal.SIG_DFL
        assert signal.getsignal(signal.SIGUSR1) is not h._handle
    finally:
        signal.signal(signal.SIGUSR1, prev)


# -- prefetcher ---------------------------------------------------------------

@pytest.mark.parametrize("start", [0, 5])
def test_prefetcher_gives_jax_steps_and_batches(start):
    kw = dict(seed=3, seq_len=16, global_batch=4, vocab_size=64)
    ours = pipeline.Prefetcher(pipeline.DataConfig(**kw), start_step=start)
    theirs = jpipeline.Prefetcher(jpipeline.DataConfig(**kw),
                                  start_step=start)
    try:
        for i in range(4):
            (s, b), (js, jb) = ours.get(), theirs.get()
            assert s == js == start + i
            assert sorted(b) == sorted(jb) == ["targets", "tokens"]
            for k in b:
                np.testing.assert_array_equal(b[k], jb[k])
    finally:
        ours.close()
        theirs.close()
    assert not ours._thread.is_alive()


# -- elastic -------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(devices=list(range(3)), model_axis=2),
    dict(devices=list(range(2)), model_axis=0),
    dict(devices=list(range(2)), host_index=2, host_count=2),
    dict(devices=list(range(2)), host_count=0),
    dict(devices=list(range(2)), host_index=-1, host_count=1),
])
def test_rescale_plan_refuses_as_jax(kw):
    with pytest.raises(ValueError) as want:
        jelastic.rescale_plan(**kw)
    with pytest.raises(ValueError) as got:
        elastic.rescale_plan(**kw)
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith(("[rescale-mesh]", "[rescale-hosts]"))


def test_rescale_plan_and_data_config():
    plan = elastic.rescale_plan(devices=["cpu"] * 4, model_axis=2,
                                host_index=1, host_count=2)
    assert plan.shape == (2, 2) and len(plan.devices) == 4
    dcfg = elastic.rescale_data_config(pipeline.DataConfig(global_batch=8),
                                       plan)
    assert (dcfg.host_index, dcfg.host_count) == (1, 2)
    jplan = jelastic.RescalePlan(mesh=None, host_index=1, host_count=2)
    assert dcfg == pipeline.DataConfig(**vars(jelastic.rescale_data_config(
        jpipeline.DataConfig(global_batch=8), jplan)))


def test_restore_state_loads_the_latest_checkpoint(tmp_path):
    state = _state()
    ckpt = Checkpointer(str(tmp_path), async_write=False)
    ckpt.save(4, state)
    want = {n: t.detach().clone() for n, t in named_leaves(state)}
    fresh = _state()
    with torch.no_grad():
        for _, t in named_leaves(fresh):
            t.add_(1)
    plan = elastic.rescale_plan(devices=[torch.device("cpu")])
    cfg = registry.get_config("chatglm3-6b", smoke=True)
    out, step = elastic.restore_state(ckpt, cfg, plan, fresh)
    assert step == 4 and out is fresh
    for n, t in named_leaves(fresh):
        assert _same(t.detach(), want[n]), n
    with pytest.raises(ValueError, match=r"\[rescale-device\]"):
        elastic.restore_state(ckpt, cfg, elastic.rescale_plan(
            devices=[torch.device("meta")]), fresh)
