"""Dry run of the port: count every (arch x shape x mesh) cell's step on
the production mesh without a card.

Counterpart of ``src/repro/launch/dryrun.py``. Where the reference lowers
and compiles the step for 512 placeholder devices, this runs it once,
eagerly, on ``torch.device("meta")`` tensors over a fake process group
(``torch.testing._internal.distributed.fake_pg``) of 256 ranks, or 512
under ``--mesh multi``: the ``make_production_mesh`` shapes (32, 8)
("data", "model") and (2, 32, 8) with "pod". The dry run allocates
nothing: its device is ``meta`` by design and its world is fake, so it
neither needs nor touches a card, and nothing in it falls back. The
mesh's device type is "cuda", so DTensor plans the collectives NCCL
would run.

Per cell (``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``):

* proof that the step runs with every parameter, moment, cache and batch
  placed by the specs (``distributed/sharding.py``) -- under this torch
  only: the card's torch refuses DTensor rules that this one takes
  (``scripts/torch_dtensor_rules_probe.py``), so the JSON names the
  version;
* each rank's local bytes of parameters, optimizer state, caches and
  batch, and ``fits_80gb_hbm``. ``total_bytes`` counts these arguments
  only: no activation peak is taken;
* the rank's FLOPs, bytes and collective wire bytes by kind, counted on
  local shapes (``roofline/analyze.py``), with the TSM2X calls priced from
  the dispatcher's record (``tsm2x_calls``), and the roofline terms.

The count is loop-aware: each distinct layer of ``model._schedule`` is
counted once and multiplied by its repeats. The step runs at a few cut
depths (:func:`depth_cuts`: one layer of each kind, then one more of
each), and the counts combine linearly into the full depth's; the
embedding, the head, the loss and the optimizer's shared work count once.

The TSM2X kernels launch through ctypes, which a meta tensor cannot,
so this module registers the executor that ``tsmm`` selects for meta
tensors (:data:`SHAPE_ONLY`, "meta"): after the classifier has chosen a
kernel kind it resolves S and the body as a launch on the data sheet's
H100 would, notes the launch on the dispatch's record and returns an
empty meta result; its backward re-dispatches through ``tsmm`` as the
kernels' do. On a mesh the dispatcher's own selection stands
(``torch-dense`` on DTensors, or ``shard_map``, whose per-shard dispatch
on local meta tensors lands here).

Run one cell:   python -m repro_torch.launch.dryrun --arch chatglm3-6b \\
                  --shape train_4k --mesh single
Run everything: python -m repro_torch.launch.dryrun --all  (a subprocess a
                cell, smallest archs first, cells already written skipped)
Reprice:        python -m repro_torch.launch.dryrun --reanalyze (from each
                cell's saved op log, ``*.ops.json.gz``; nothing is counted
                again)
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import math
import os
import re
import subprocess
import sys
import time
import traceback

import torch

from repro_torch.core import tsmm

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         "artifacts", "dryrun_torch")
SHAPE_ONLY = "meta"
PLACEMENTS_NOTE = "placements proven under this torch only"
META = torch.device("meta")


def _cell_path(arch, shape, mesh_kind, out_dir, strategy="tp", variant=None):
    suffix = ("" if strategy == "tp" else f"__{strategy}") + \
        ("" if not variant else f"__{variant}")
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}{suffix}.json")


def input_specs(cfg, shape, kind: str):
    """Meta stand-ins for every model input (no allocation), in the
    reference's dtypes: bf16 frames and image embeddings, int token ids
    (int64, which the port's embedding lookup takes)."""
    b, s = shape.global_batch, shape.seq_len

    def empty(*dims, dtype=torch.int64):
        return torch.empty(dims, dtype=dtype, device=META)

    if kind == "decode":
        return {"tokens": empty(b, 1)}
    batch = {}
    if cfg.input_mode == "frames":
        batch["frames"] = empty(b, s, cfg.frame_dim, dtype=torch.bfloat16)
    else:
        batch["tokens"] = empty(b, s)
    if kind == "train":
        batch["targets"] = empty(b, s)
    if cfg.family == "vlm":
        batch["image_embeds"] = empty(b, cfg.vision_seq, cfg.vision_dim,
                                      dtype=torch.bfloat16)
    return batch


# ---------------------------------------------------------------------------
# The TSM2X route on meta tensors
# ---------------------------------------------------------------------------

def _note(entry, kind, a, b, p):
    """Note the launch a call would make on the data sheet's H100 (its S
    from ``ops.resolve_params``, its body and grid from ``perf_model``),
    as ``kernels/ops.py`` notes a real one."""
    from repro_torch.analysis import contracts
    from repro_torch.core import perf_model
    from repro_torch.kernels import ops
    if not tsmm.recording():
        return
    m, d1 = a.shape
    d2 = b.shape[1]
    q8 = p.quant == "int8"
    dtype = torch.int8 if q8 else (
        a.dtype if a.dtype == b.dtype and a.dtype != torch.float16
        else torch.float32)
    splits = ops.resolve_params(kind, m, d1, d2, dtype, p).get("splits", 1)
    shape = (m, d1, d2)
    params = perf_model.kernel_params(kind, m, d1, d2, dtype, splits)
    tsmm.note_launch(kind + ("_q8" if q8 else ""),
                     contracts.launch_grid(kind, shape, params), splits,
                     shape=shape, dtype=dtype, params=params)
    rows, cols = (m, d2) if entry == "mm" else (d1, d2)
    if perf_model.reduce_kernel_runs(splits, rows, cols):
        grid = perf_model.reduce_plan(splits, rows, cols, a.dtype)[0]
        tsmm.note_launch("reduce", grid, splits, shape=(splits, rows, cols),
                         dtype=torch.float32)


class _ShapeOnly(torch.autograd.Function):
    """A kernel-kind product's result shape and dtype, nothing computed;
    the backward's cotangent GEMMs go back through ``tsmm`` as
    ``kernels/ops.py``'s do (``tsm2r``/``tsm2l``: ``tsmm(ct, b^T)``,
    ``tsmm_t(a, ct)``; ``tsmt``: ``tsmm(y, ct^T)``, ``tsmm(x, ct)``), which
    selects this executor again for their meta tensors."""

    @staticmethod
    def forward(ctx, a, b, entry, kind, policy):
        ctx.save_for_backward(a, b)
        ctx.entry, ctx.policy = entry, policy
        _note(entry, kind, a, b, policy)
        rows = a.shape[0] if entry == "mm" else a.shape[1]
        return torch.empty((rows, b.shape[1]), dtype=a.dtype,
                           device=a.device)

    @staticmethod
    def backward(ctx, ct):
        a, b = ctx.saved_tensors
        da = db = None
        with tsmm.backward_scope(ctx.policy) as bp:
            if ctx.entry == "mm":
                if ctx.needs_input_grad[0]:
                    da = tsmm.tsmm(ct, b.transpose(0, 1), policy=bp)
                if ctx.needs_input_grad[1]:
                    db = tsmm.tsmm_t(a, ct, policy=bp)
            else:
                if ctx.needs_input_grad[0]:
                    da = tsmm.tsmm(b, ct.transpose(0, 1), policy=bp)
                if ctx.needs_input_grad[1]:
                    db = tsmm.tsmm(a, ct, policy=bp)
        return (None if da is None else da.to(a.dtype),
                None if db is None else db.to(b.dtype), None, None, None)


def _exec_shape_only(entry, kind, a, b, p):
    """The shape-only executor, which ``tsmm`` selects for a kernel kind's
    meta tensors (a dense call goes to ``torch-dense``, its product
    counted as any op)."""
    return _ShapeOnly.apply(a, b, entry, kind, p)


# It stands in for the per-shard executor on the card ("cuda") and keeps
# its reduce contract.
tsmm.register_executor(SHAPE_ONLY, _exec_shape_only,
                       reduce=tsmm.executor_reduce_contract("cuda"),
                       overwrite=True)


def count(fn, *args, **kwargs):
    """(``fn(*args, **kwargs)``, its :class:`analyze.OpLog`): every op
    counted on local shapes and every TSM2X call from the dispatcher's
    record, the GEMMs of meta tensors on the shape-only executor."""
    from repro_torch.roofline import analyze
    with tsmm.record_dispatches() as events, \
            analyze.OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, analyze.OpLog.of(counter, events)


# ---------------------------------------------------------------------------
# Loop-awareness: cut depths
# ---------------------------------------------------------------------------

def layer_counts(cfg) -> tuple:
    """The counts of each distinct layer of the schedule: the layers of a
    plain model; deepseek's dense and MoE layers; zamba2's Mamba2 layers
    and its shared block's applications; llama-3.2-vision's self layers
    and its cross layers."""
    if cfg.family == "moe" and cfg.mla is not None:
        return (cfg.first_k_dense, cfg.n_layers - cfg.first_k_dense)
    if cfg.family == "hybrid":
        return (cfg.n_layers, cfg.n_layers // cfg.hybrid_period)
    if cfg.family == "vlm":
        groups = cfg.n_layers // cfg.cross_attn_period
        return (groups * (cfg.cross_attn_period - 1), groups)
    return (cfg.n_layers,)


def depth_cuts(cfg) -> list:
    """[(coefficient, cut config)]: the full depth's count is the sum of
    each cut's count times its coefficient, wherever the count is affine
    in :func:`layer_counts` (one layer of each kind, then one more of
    each)."""
    r = dataclasses.replace
    if cfg.family == "moe" and cfg.mla is not None:
        cuts = [r(cfg, n_layers=2, first_k_dense=1),
                r(cfg, n_layers=3, first_k_dense=2),
                r(cfg, n_layers=3, first_k_dense=1)]
    elif cfg.family == "hybrid":
        cuts = [r(cfg, n_layers=1, hybrid_period=1),
                r(cfg, n_layers=2, hybrid_period=2),
                r(cfg, n_layers=2, hybrid_period=1)]
    elif cfg.family == "vlm":
        cuts = [r(cfg, n_layers=2, cross_attn_period=2),
                r(cfg, n_layers=3, cross_attn_period=3),
                r(cfg, n_layers=4, cross_attn_period=2)]
    else:
        cuts = [r(cfg, n_layers=1), r(cfg, n_layers=2)]
    rows = [(1, *layer_counts(c)) for c in cuts]
    want = (1, *layer_counts(cfg))
    coefs = _solve(rows, want)
    return list(zip(coefs, cuts))


def _solve(rows, want) -> list:
    """The integer coefficients c with sum_r c_r rows[r] == want (rows
    square and invertible), by Gaussian elimination over fractions."""
    from fractions import Fraction
    n = len(rows)
    a = [[Fraction(rows[r][i]) for r in range(n)] + [Fraction(want[i])]
         for i in range(n)]
    for col in range(n):
        piv = next(i for i in range(col, n) if a[i][col] != 0)
        a[col], a[piv] = a[piv], a[col]
        for i in range(n):
            if i != col and a[i][col] != 0:
                f = a[i][col] / a[col][col]
                a[i] = [x - f * y for x, y in zip(a[i], a[col])]
    out = [a[i][n] / a[i][i] for i in range(n)]
    if any(c.denominator != 1 for c in out):
        raise ValueError(f"depth cuts give fractional coefficients {out}")
    return [int(c) for c in out]


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

def _fake_world(world: int) -> None:
    """A fake process group of ``world`` ranks (this process is rank 0);
    one a process."""
    import torch.distributed as dist
    # repro: allow-torch-private-import (the fake process group of a
    # 256- or 512-rank world in one process; torch ships no public one)
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a world of {dist.get_world_size()} ranks "
                               f"is up; the cell needs {world}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _spec_local(mesh, spec, shape) -> int:
    """Elements of one rank's shard of a tensor of ``shape`` under
    ``spec`` (the specs shard only dims that divide their axes)."""
    from repro_torch.distributed import sharding
    n = math.prod(shape)
    for entry in spec:
        if entry is not None:
            n //= sharding._axis_size(mesh, entry)
    return n


def _local_bytes(mesh, specs: dict, tensors: dict) -> int:
    return sum(_spec_local(mesh, specs[n], t.shape) * t.element_size()
               for n, t in tensors.items())


def memory(cfg, shape, mesh, strategy, fsdp, opt_cfg, batch) -> dict:
    """Each rank's local bytes of the cell's arguments at full depth:
    parameters, optimizer moments (train), caches (serve) and the batch,
    from the specs on the full model's meta tensors."""
    from repro_torch.distributed import sharding
    from repro_torch.models import model
    from repro_torch.roofline import analyze
    lm = model.LM(cfg, META)
    params = dict(lm.named_parameters())
    p_specs = sharding.make_param_specs(cfg, lm, mesh, fsdp=fsdp,
                                        strategy=strategy)
    mem = {"param_bytes": _local_bytes(mesh, p_specs, params),
           "opt_bytes": 0, "cache_bytes": 0}
    if shape.kind == "train":
        o_specs = sharding.make_opt_specs(p_specs, mesh=mesh,
                                          params_shape=lm,
                                          zero1=strategy == "dp")
        size = torch.empty((), dtype=getattr(
            torch, opt_cfg.state_dtype or "float32")).element_size()
        mem["opt_bytes"] = 2 * size * sum(
            _spec_local(mesh, o_specs["moments"][n]["m"], p.shape)
            for n, p in params.items())
    elif not (shape.kind == "prefill" and cfg.input_mode == "frames"):
        cache = model.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 device=META)
        c_specs = sharding.cache_specs(cfg, mesh, cache)
        mem["cache_bytes"] = sum(
            _local_bytes(mesh, s, c) for s, c in zip(c_specs, cache))
    b_specs = sharding.batch_specs(cfg, mesh, batch, strategy)
    mem["batch_bytes"] = _local_bytes(mesh, b_specs, batch)
    mem["total_bytes"] = sum(mem.values())
    mem["fits_80gb_hbm"] = bool(mem["total_bytes"]
                                <= analyze.H100["hbm_per_chip"])
    mem["counts"] = "arguments only: no activation peak is taken"
    return mem


def _run_cut(cfg, shape, mesh, strategy, fsdp, opt_cfg):
    """Count one step of ``cfg`` (a cut depth) on the mesh: (OpLog, s)."""
    from repro_torch.distributed import sharding
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as ts

    lm = model.LM(cfg, META)
    p_specs = sharding.make_param_specs(cfg, lm, mesh, fsdp=fsdp,
                                        strategy=strategy)
    sharding.named(mesh, p_specs, lm)

    def place(batch):
        return sharding.named(mesh, sharding.batch_specs(
            cfg, mesh, batch, strategy), batch)

    if shape.kind == "train":
        lm.requires_grad_(True)
        state = {"params": lm, "opt": adamw.init(opt_cfg, lm)}
        upd = None
        if strategy == "dp":
            o_specs = sharding.make_opt_specs(p_specs, mesh=mesh,
                                              params_shape=lm, zero1=True)
            sharding.named(mesh, {"moments": o_specs["moments"]},
                           state["opt"])
            upd = {n: mv["m"] for n, mv in o_specs["moments"].items()}
        step = ts.make_train_step(
            cfg, opt_cfg, n_micro=0 if strategy == "dp" else cfg.microbatch,
            acc_shardings=sharding.named(mesh, p_specs), mesh=mesh,
            opt_update_specs=upd)
        batch = place(input_specs(cfg, shape, "train"))
        t0 = time.time()
        _, log = count(step, state, batch)
        return log, time.time() - t0
    lm.requires_grad_(False)
    if shape.kind == "prefill":
        batch = place(input_specs(cfg, shape, "prefill"))
        if cfg.input_mode == "frames":
            # encoder-only: "prefill" is the batched encoder forward
            def run():
                with torch.no_grad():
                    return model.forward(lm, cfg, batch)
        else:
            cache = model.init_cache(cfg, shape.global_batch, shape.seq_len,
                                     device=META, mesh=mesh)

            def run():
                return model.prefill(lm, cfg, batch, cache)
    else:
        cache = model.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 device=META, mesh=mesh)
        tokens = place(input_specs(cfg, shape, "decode"))["tokens"]

        def run():
            return model.decode_step(lm, cfg, tokens, shape.seq_len - 1,
                                     cache)
    t0 = time.time()
    _, log = count(run)
    return log, time.time() - t0


def _variant(cfg, variant):
    if variant == "noabsorb":
        return dataclasses.replace(cfg, mla_absorb=False)
    if variant and variant.startswith("mb"):
        return dataclasses.replace(
            cfg, microbatch=int(re.match(r"mb(\d+)", variant).group(1)))
    if variant:
        raise ValueError(f"unknown variant {variant!r}: valid variants are "
                         "noabsorb and mbN")
    return cfg


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               strategy: str = "tp", variant: str | None = None,
               world: int | None = None, n_layers: int | None = None):
    """Count one cell: (report, op log). ``world`` / ``n_layers`` cut the
    world (a (world / 8, 8) mesh) and the depth, for tests."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import NODE_GPUS, make_production_mesh
    from repro_torch.optim import adamw, schedule

    cfg = _variant(registry.get_config(arch), variant)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    shape = SHAPES[shape_name]
    world = world or (512 if multi_pod else 256)
    _fake_world(world)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cuda")
    n_chips = mesh.size()
    if cfg.moe is not None:
        # group-local MoE dispatch: one group per DP shard
        dp = n_chips // NODE_GPUS
        groups = dp if (shape.global_batch * shape.seq_len) % dp == 0 else 1
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch_groups=groups))
    fsdp = cfg.param_count() > sharding.FSDP_THRESHOLD
    opt_cfg = adamw.AdamWConfig(
        lr=schedule.linear_warmup_cosine(3e-4, 2000, 100000),
        state_dtype="bfloat16" if cfg.param_count() > 1e11 else None)
    runs = []
    for coef, cut in depth_cuts(cfg):
        log, secs = _run_cut(cut, shape, mesh, strategy, fsdp, opt_cfg)
        runs.append({"coef": coef, "layer_counts": list(layer_counts(cut)),
                     "count_s": round(secs, 2), "entries": log.entries})
    report = analyze_cell(runs, cfg, shape, n_chips)
    report.update({
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(map(str, mesh.shape)),
        "mesh_shape": list(mesh.shape), "n_chips": n_chips,
        "kind": shape.kind, "n_layers": cfg.n_layers,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "strategy": strategy, "variant": variant, "fsdp": fsdp,
        "layer_counts": list(layer_counts(cfg)),
        "cuts": [{"coef": r["coef"], "layer_counts": r["layer_counts"],
                  "count_s": r["count_s"]} for r in runs],
        "count_s": round(sum(r["count_s"] for r in runs), 2),
        "memory": memory(cfg, shape, mesh, strategy, fsdp, opt_cfg,
                         input_specs(cfg, shape, shape.kind)),
        "device": "meta", "world": "fake",
        "torch": torch.__version__, "placements": PLACEMENTS_NOTE,
        "status": "ok",
    })
    return report, runs


def analyze_cell(runs, cfg, shape, n_chips: int) -> dict:
    """Roofline terms from the cut runs' op logs (the counterpart of the
    reference's ``analyze_hlo``; re-runnable offline): the reference's
    keys, ``tsm2x_calls`` and the per-class bounds."""
    from repro_torch.roofline import analyze
    log = analyze.combine((r["coef"], analyze.OpLog(r["entries"]))
                          for r in runs)
    cost = analyze.cost(log)
    coll = analyze.collectives(log)
    terms = analyze.roofline_terms(cost, coll, n_chips)
    mf = analyze.model_flops(cfg, shape)
    terms["model_flops_total"] = mf
    terms["model_flops_per_chip"] = mf / n_chips
    terms["useful_flops_ratio"] = (mf / n_chips) / max(terms["hlo_flops"],
                                                       1.0)
    calls = sorted((e for e in log.entries if e["cls"] == "tsm2x"),
                   key=lambda e: -e["flops"])
    return {
        "cost_flops": terms["hlo_flops"],
        "cost_bytes": terms["hlo_bytes"],
        "bytes_note": "every op's operand and result bytes on local "
                      "shapes, nothing fused: an upper bound",
        "roofline": {k: terms[k] for k in
                     ("compute_s", "memory_s", "collective_s", "dominant",
                      "collective_bytes", "useful_flops_ratio")},
        "model_flops_per_chip": terms["model_flops_per_chip"],
        "collective_counts": terms["collective_counts"],
        "collective_by_kind": terms["collective_by_kind"],
        "by_class": analyze.by_class(log),
        "tsm2x_calls": [{k: e[k] for k in
                         ("kernel", "shape", "dtype", "executor", "S",
                          "body", "n", "flops", "bytes")} for e in calls],
    }


def run_cell(arch, shape_name, mesh_kind, out_dir, strategy="tp",
             variant=None, world=None, n_layers=None):
    path = _cell_path(arch, shape_name, mesh_kind, out_dir, strategy, variant)
    os.makedirs(out_dir, exist_ok=True)
    try:
        report, runs = build_cell(arch, shape_name, mesh_kind == "multi",
                                  strategy, variant, world, n_layers)
        with gzip.open(path[:-5] + ".ops.json.gz", "wt") as f:
            json.dump(runs, f)
        r = report["roofline"]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: OK "
              f"(count {report['count_s']}s, dominant={r['dominant']})")
        print(f"  memory/rank: {report['memory']['total_bytes'] / 2**30:.2f}"
              f" GiB (fits 80GiB: {report['memory']['fits_80gb_hbm']})")
        print(f"  flops/rank: {report['cost_flops']:.3e}  bytes/rank: "
              f"{report['cost_bytes']:.3e}  collective bytes/rank: "
              f"{r['collective_bytes']:.3e}")
    except Exception:
        report = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                  "status": "error", "torch": torch.__version__,
                  "traceback": traceback.format_exc()}
        print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: FAILED",
              file=sys.stderr)
        print(report["traceback"], file=sys.stderr)
    with open(path, "w") as f:
        json.dump(report, f, indent=2, default=str)
    return report.get("status") == "ok"


# Smallest-count-first ordering for --all.
_ARCH_ORDER = [
    "rwkv6-1.6b", "zamba2-1.2b", "hubert-xlarge", "chatglm3-6b",
    "llama3.2-3b", "mistral-nemo-12b", "llama-3.2-vision-11b",
    "mixtral-8x7b", "qwen2-72b", "deepseek-v3-671b",
]


def reanalyze(out_dir):
    """Recompute every cell's roofline from its saved op log (nothing is
    counted again)."""
    import glob

    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES

    for lf in sorted(glob.glob(os.path.join(out_dir, "*.ops.json.gz"))):
        jf = lf[:-len(".ops.json.gz")] + ".json"
        if not os.path.exists(jf):
            continue
        with open(jf) as f:
            report = json.load(f)
        if report.get("status") != "ok":
            continue
        cfg = _variant(registry.get_config(report["arch"]),
                       report.get("variant"))
        cfg = dataclasses.replace(cfg, n_layers=report["n_layers"])
        with gzip.open(lf, "rt") as f:
            runs = json.load(f)
        report.update(analyze_cell(runs, cfg, SHAPES[report["shape"]],
                                   report["n_chips"]))
        with open(jf, "w") as f:
            json.dump(report, f, indent=2, default=str)
        print(f"[reanalyze] {os.path.basename(jf)}: "
              f"dominant={report['roofline']['dominant']} "
              f"6ND/count={report['roofline']['useful_flops_ratio']:.2f}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--reanalyze", action="store_true")
    ap.add_argument("--strategy", default="tp", choices=["tp", "dp"])
    ap.add_argument("--variant", default=None)
    ap.add_argument("--out", default=os.path.abspath(ARTIFACTS))
    ap.add_argument("--world", type=int, default=None,
                    help="a smaller fake world (a multiple of 8)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this depth")
    args = ap.parse_args()

    if args.reanalyze:
        reanalyze(args.out)
        return

    from repro_torch.configs import registry

    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    if args.all:
        cells = []
        for arch in _ARCH_ORDER:
            for shape in ("decode_32k", "long_500k", "train_4k",
                          "prefill_32k"):
                ok, _ = registry.cell_supported(arch, shape)
                if not ok:
                    continue
                cells.extend((arch, shape, m) for m in meshes)
        todo = [c for c in cells if args.force or
                not os.path.exists(_cell_path(*c, args.out))]
        print(f"[dryrun] {len(todo)}/{len(cells)} cells to run")
        failures = 0
        for arch, shape, mesh_kind in todo:
            r = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--mesh", mesh_kind, "--out",
                 args.out],
                env={**os.environ,
                     "PYTHONPATH": os.environ.get("PYTHONPATH", "src")})
            failures += r.returncode != 0
        sys.exit(1 if failures else 0)

    ok = True
    for mesh_kind in meshes:
        ok &= run_cell(args.arch, args.shape, mesh_kind, args.out,
                       args.strategy, args.variant, args.world, args.layers)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
