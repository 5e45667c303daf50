"""Fault-tolerant training launcher.

The port's counterpart of ``src/repro/launch/train.py`` (``main`` :43-274):
config registry, resumable data pipeline, AdamW + schedule, optional
PowerSGD compression, async atomic checkpointing, the offline ABFT check
before each save, the online ABFT guard, straggler watchdog, preemption
handling and restore from the latest checkpoint. This is the entry point
a scheduler re-execs on every (re)start; all state recovery is automatic.

Step-fault rollback/retry: each step's ``step_ok`` metric (finite loss +
grad norm; an online-ABFT NaN-poison from ``--abft verify|correct`` trips
it too) gates a retry ladder -- write the last in-memory host snapshot
back into the live state and replay (bounded by ``--max-step-retries``),
then escalate to ``Checkpointer.restore_latest_good`` (committed
checkpoints only: a save still in flight is not one), then give up with
a tagged error. ``--chaos-step N`` injects a one-shot NaN into the
parameters before step N to exercise exactly this path.

    PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3-6b \\
        --smoke --device cpu --steps 6 --chaos-step 3

The state lives on ``--device`` (the card unless the caller names
another; with no card and no ``--device`` it raises). One process drives
one device. Without ``--distributed`` the state is plain tensors on it
(what the reference's specs amount to on a mesh of one device).

``--distributed``: one process a GPU under ``torchrun`` (its ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``). The
process group starts from that environment (``env://``; NCCL on the
card, gloo with ``--device cpu``), the device is ``cuda:LOCAL_RANK``,
and the state is placed on ``launch.mesh.make_host_mesh(--model-axis)``
by ``sharding.make_param_specs`` / ``make_opt_specs`` (PowerSGD's error
buffers as their parameters, its Q replicated). Each rank reads its data
coordinate's slice of the global batch (``host_index`` / ``host_count``
= the data coordinate and size) and wraps it as a ``Shard(0)``-on-dp
DTensor; checkpoints hold full leaves and restore through
``elastic.restore_state``. The group is destroyed when ``main`` returns.

    torchrun --nproc_per_node=2 -m repro_torch.launch.train \\
        --arch chatglm3-6b --smoke --device cpu --distributed \\
        --model-axis 2 --steps 6 --chaos-step 3
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import torch
import torch.distributed as dist

from repro_torch import layout, resolve_device
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import registry
from repro_torch.core import tsmm
from repro_torch.data import pipeline
from repro_torch.distributed import sharding
from repro_torch.ft import abft, elastic, inject, watchdog
from repro_torch.optim import adamw, powersgd, schedule
from repro_torch.train import train_step as ts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced per-arch config (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--abft-every", type=int, default=0,
                    help="verify param checksums every N steps (0=off)")
    ap.add_argument("--abft", choices=("none", "verify", "correct"),
                    default="none",
                    help="online per-GEMM checksum guard (GemmPolicy.abft)")
    ap.add_argument("--max-step-retries", type=int, default=2,
                    help="in-memory rollback replays per fault episode "
                         "before escalating to a checkpoint restore")
    ap.add_argument("--snapshot-every", type=int, default=1,
                    help="refresh the rollback host snapshot every N good "
                         "steps (0=never; faults then escalate directly)")
    ap.add_argument("--chaos-step", type=int, default=-1,
                    help="inject a one-shot NaN into the state before this "
                         "step (fault-injection drill; -1=off)")
    ap.add_argument("--powersgd-rank", type=int, default=0,
                    help="gradient compression rank (0=off)")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device of the state (default: the card)")
    args = ap.parse_args(argv)

    if not args.distributed:
        return _run(args, resolve_device(args.device))
    dev = _join_world(args.device)
    try:
        return _run(args, dev)
    finally:
        dist.destroy_process_group()


def _join_world(device) -> torch.device:
    """Start the process group from torchrun's environment and return this
    rank's device: ``cuda:LOCAL_RANK`` under NCCL, the CPU under gloo
    (``--device cpu``)."""
    if device is not None and torch.device(device).type == "cpu":
        dist.init_process_group("gloo", init_method="env://")
        return torch.device("cpu")
    if device is not None:
        raise ValueError(f"[train-distributed] --device {device}: a rank "
                         "drives cuda:LOCAL_RANK, or the CPU under gloo")
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method="env://", device_id=dev)
    return dev


def _world_devices(dev) -> list:
    """Every rank's device, in rank order (one process a device)."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, str(dev))
    return [torch.device(d) for d in out]


def _run(args, dev):
    cfg = registry.get_config(args.arch, smoke=args.smoke)
    if args.distributed:
        # The rank's data coordinate and the data size of the
        # (world // model, model) mesh: the ranks of one data slice (its
        # model ranks) read the same rows.
        world = dist.get_world_size()
        plan = elastic.rescale_plan(
            devices=_world_devices(dev), model_axis=args.model_axis,
            host_index=dist.get_rank() // args.model_axis,
            host_count=max(world // args.model_axis, 1))
        mesh = plan.mesh
    else:
        plan = elastic.rescale_plan(devices=[dev],
                                    model_axis=args.model_axis)
        mesh = None
    dcfg = elastic.rescale_data_config(pipeline.DataConfig(
        seed=0, seq_len=args.seq_len, global_batch=args.global_batch,
        vocab_size=cfg.vocab_size,
        mode="frames" if cfg.input_mode == "frames" else "tokens",
        frame_dim=cfg.frame_dim, vision_seq=cfg.vision_seq,
        vision_dim=cfg.vision_dim), plan)

    opt_cfg = adamw.AdamWConfig(
        lr=schedule.linear_warmup_cosine(args.lr, args.warmup, args.steps),
        weight_decay=0.1)

    state = ts.init_train_state(0, cfg, opt_cfg, device=dev)
    acc_shardings = None
    if mesh is not None:
        specs = elastic.state_specs(cfg, plan, state["params"])
        sharding.named(mesh, specs, state)
        acc_shardings = sharding.named(mesh, specs["params"])
    grad_transform = None
    if args.powersgd_rank:
        ps_cfg = powersgd.PowerSGDConfig(rank=args.powersgd_rank)
        # As the reference does, every leaf of the PowerSGD state starts
        # at zero, Q included: the first P is zero and orthonormalization
        # draws its fresh columns.
        extra = powersgd.init(ps_cfg, state["params"])
        for st in extra.values():
            for t in st.values():
                t.zero_()
        if mesh is not None:
            sharding.named(mesh, _powersgd_specs(extra, specs["params"]),
                           extra)
        state["extra"] = extra

        def grad_transform(grads, st):
            return powersgd.compress_tree(ps_cfg, grads, st)

    step_fn = ts.make_train_step(cfg, opt_cfg, n_micro=cfg.microbatch,
                                 grad_transform=grad_transform,
                                 acc_shardings=acc_shardings, mesh=mesh)
    batch_places = (None if mesh is None else sharding.placements(
        mesh, (sharding.dp_axes(mesh), None)))

    def to_device(host_batch):
        batch = to_tensors(host_batch, dev)
        if batch_places is None:
            return batch
        from torch.distributed.tensor import DTensor
        return {k: DTensor.from_local(v, mesh, batch_places, run_check=False)
                for k, v in batch.items()}

    ckpt = Checkpointer(args.ckpt_dir, keep_n=3) if args.ckpt_dir else None
    start_step = 0
    if ckpt and ckpt.latest_step() is not None:
        state, start_step = elastic.restore_state(ckpt, cfg, plan, state)
        print(f"[train] restored checkpoint at step {start_step}")
        start_step += 1

    wd = watchdog.StepWatchdog(
        on_straggler=lambda dt, ewma: print(
            f"[watchdog] straggler step: {dt:.2f}s vs ewma {ewma:.2f}s "
            "-- scheduling proactive checkpoint"))
    preempt = watchdog.PreemptionHandler()
    prefetch = pipeline.Prefetcher(dcfg, start_step=start_step)

    def refetch(from_step):
        nonlocal prefetch
        prefetch.close()
        prefetch = pipeline.Prefetcher(dcfg, start_step=from_step)

    # Rollback ladder state: last-known-good in-memory snapshot, bounded
    # replays per fault episode, then checkpoint escalation.
    snap = None                       # (step, host snapshot)
    retries_left = args.max_step_retries
    total_retries = 0
    chaos_pending = args.chaos_step >= 0
    last_metrics = {}

    abft_scope = (tsmm.policy(abft=args.abft) if args.abft != "none"
                  else contextlib.nullcontext())
    t_start = time.time()
    try:
        with abft_scope:
            cur = start_step
            while cur < args.steps:
                step, host_batch = prefetch.get()
                batch = to_device(host_batch)
                if chaos_pending and step == args.chaos_step:
                    # One-shot drill: a transient in-memory fault the
                    # step_ok gate must catch and the ladder must undo.
                    # The parameters, not the optimizer state: the fault
                    # must surface in THIS step's loss.
                    inject.poison_tree(state["params"])
                    chaos_pending = False
                    print(f"[chaos] poisoned state before step {step}")
                with wd:
                    state, metrics = step_fn(state, batch)
                    step_ok = bool(metrics["step_ok"])    # host sync
                if not step_ok:
                    wd.note_fault()
                    total_retries += 1
                    if retries_left > 0 and snap is not None:
                        retries_left -= 1
                        ts.restore_snapshot(snap[1], state)
                        cur = snap[0] + 1
                        refetch(cur)
                        print(f"[ft] step {step} fault: rolled back to "
                              f"snapshot at step {snap[0]}, replaying "
                              f"({retries_left} retries left)", flush=True)
                        continue
                    if ckpt and ckpt.all_steps():
                        tree, rstep = ckpt.restore_latest_good()
                        ts.restore_snapshot(tree, state)
                        del tree
                        cur = rstep + 1
                        refetch(cur)
                        snap = None
                        retries_left = args.max_step_retries
                        print(f"[ft] step {step} fault: retries exhausted, "
                              f"restored checkpoint step {rstep}", flush=True)
                        continue
                    raise RuntimeError(
                        f"[ft-retries] step {step} faulted with no snapshot "
                        "retries left and no restorable checkpoint")
                # -- good step ------------------------------------------
                retries_left = args.max_step_retries
                last_metrics = metrics
                wm = wd.last_metrics
                if args.snapshot_every and step % args.snapshot_every == 0:
                    # into the previous snapshot's buffer: one host copy
                    snap = (step, ts.host_snapshot(
                        state, snap[1] if snap else None))
                if step % args.log_every == 0 or step == args.steps - 1:
                    print(f"[train] step {step} "
                          f"loss {float(metrics['loss']):.4f} "
                          f"acc {float(metrics['accuracy']):.3f} "
                          f"gnorm {float(metrics['grad_norm']):.2f} "
                          f"{wm['step_time_s']:.2f}s", flush=True)
                if ckpt and (step % args.ckpt_every == 0
                             or step == args.steps - 1 or preempt.requested):
                    if args.abft_every and step % args.abft_every == 0:
                        # encode -> verify -> save: the verify re-encodes,
                        # catching SDC landing on the params between the
                        # two passes, BEFORE the state is persisted -- a
                        # detected-corrupt tree must never become the
                        # newest checkpoint.
                        checksums = abft.encode_tree(state["params"])
                        ok, _ = abft.verify_tree(state["params"], checksums)
                        if not bool(ok):
                            raise RuntimeError(
                                "[abft] silent data corruption detected in "
                                "params -- refusing to persist; restore + "
                                "replay")
                    ckpt.save(step, state)
                if preempt.requested:
                    print("[train] preemption requested: checkpointed, "
                          "exiting 42")
                    ckpt and ckpt.wait()
                    sys.exit(42)   # scheduler contract: re-exec to resume
                cur = step + 1
    finally:
        prefetch.close()
        preempt.restore()
        if ckpt:
            ckpt.wait()
    dt = time.time() - t_start
    steps_run = args.steps - start_step
    print(f"[train] done: {steps_run} steps in {dt:.1f}s "
          f"({steps_run / max(dt, 1e-9):.2f} steps/s); "
          f"fault retries: {total_retries}")
    return {"final_loss": float(last_metrics.get("loss", float("nan"))),
            "final_step": args.steps - 1,
            "fault_retries": total_retries,
            "fault_events": wd.fault_events}


def to_tensors(host_batch: dict, device) -> dict:
    """A pipeline batch as tensors on ``device``: token ids and targets as
    int64, frames (and image embeddings) as the pipeline's f32, uncast,
    as the reference feeds them."""
    return {k: torch.from_numpy(v).to(
        device, torch.long if v.dtype.kind in "iu" else None)
        for k, v in host_batch.items()}


def _powersgd_specs(extra: dict, p_specs: dict) -> dict:
    """PowerSGD's state on the mesh: a leaf's error buffer as its
    parameter (a stacked leaf's stacked axes replicated), Q replicated."""
    out = {}
    for path, st in extra.items():
        spec = next(s for n, s in p_specs.items()
                    if layout.jax_path(n)[0] == path)
        err = (None,) * (st["err"].dim() - len(spec)) + spec
        out[path] = {"err": err, "q": (None,) * st["q"].dim()}
    return out


if __name__ == "__main__":
    main()
