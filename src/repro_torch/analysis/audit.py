"""Offline kernel-contract auditor of the port: sweep everything the
choosers and the resolver can emit (``python -m repro_torch.analysis.audit``).

Counterpart of ``src/repro/analysis/audit.py``. ``analysis.contracts``
holds the predicates and ``analysis.kernel_verify`` the dataflow rules;
this module drives them over the reachable configuration space and emits
a machine-readable report, so a chooser that emits an unlaunchable S, a
stale tuning record or a backward-policy drift is caught here and not by
a failed launch on the card.

Sections (one report entry each, the reference's names):

* ``candidate-grids``: every S that ``perf_model.split_candidates``
  scores, as ``perf_model.kernel_params`` states its launch, keeps
  ``contracts.check_kernel_config`` and ``check_grid``, f32, bf16 and
  int8, under each of :data:`SWEEP_SPECS`.
* ``resolved-configs``: ``ops.resolve_params`` (``device=None``: the
  card's resolution, not the CPU rule) under the split arms
  :data:`SWEEP_SPLITS`, and the chooser's pick under each spec, at base
  addresses on and off the 16-byte grid (:data:`SWEEP_PTRS`: the body a
  launch runs depends on them), each with the reduce epilogue it implies.
* ``quant-resolved``: the same under ``GemmPolicy(quant="int8")``: int8
  operands, the caller's dtype out, and the quantize passes each launch
  needs.
* ``qr-resolved``: the Gram and apply stages of ``linalg``'s CholeskyQR2
  (``contracts.qr_stage_shapes``), replicated and over 2 and 8 shards.
* ``abft-resolved``: every (abft, quant, reduce) policy against its
  backward, and every checksum GEMM of the guard
  (``contracts.abft_stage_shapes``) classified and resolved.
* ``tuning-table`` (with ``--table``): every record through
  ``contracts.check_tuning_record``, its executor registered, its bucket
  its shape's.
* ``policies``: ``tsmm.backward_policy`` against
  ``contracts.check_backward_policy`` over every reachable GemmPolicy
  combination, and every registered executor's reduce contract.
* ``kernel-dataflow``: ``kernel_verify.verify_kernel_config`` over every
  distinct launch the two resolved sweeps reach (:func:`resolved_launches`),
  the reduce epilogue and the quantize pass included; corner-sampled
  grids are listed under ``sampled``.

The reference's ``bench-dispatch`` section reads a committed benchmark
report; the port has no benchmark yet, so it has none.

CLI::

    python -m repro_torch.analysis.audit [--strict] [--json PATH]
                                         [--table PATH]

``--strict`` exits 1 on any violation. :func:`run_audit` is the API the
tests drive; it reports violations and never raises on them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from repro_torch.analysis import contracts, kernel_verify
from repro_torch.core import autotune, perf_model, tsmm
from repro_torch.kernels import ops

__all__ = [
    "AUDIT_SCHEMA",
    "SWEEP_SHAPES",
    "SWEEP_SPECS",
    "resolved_launches",
    "audit_candidate_grids",
    "audit_resolved_configs",
    "audit_quant_configs",
    "audit_qr_configs",
    "audit_abft_configs",
    "audit_tuning_table",
    "audit_policies",
    "audit_kernel_dataflow",
    "run_audit",
    "main",
]

AUDIT_SCHEMA = "repro-torch-analysis-audit/1"

# The reference's sweep: paper shapes plus awkward ones (odd dims, dims
# off every tile), where the plans and the resolver drift first.
SWEEP_SHAPES: dict[str, tuple[tuple[int, int, int], ...]] = {
    "tsm2r": ((2048, 512, 8), (4096, 4096, 16), (20480, 20480, 16),
              (4100, 130, 3), (2048, 512, 130), (1000, 100, 2)),
    "tsm2l": ((8192, 16, 16), (100000, 8, 8), (65536, 130, 4),
              (10001, 3, 5)),
    "tsmt": ((4096, 64, 8), (65536, 16, 16), (8200, 130, 8),
             (4096, 64, 512), (100000, 2, 2)),
}
SWEEP_DTYPES = (torch.bfloat16, torch.float32)
# The H100 SXM the port plans for, and its MIG 3g.40gb instance: 60 SMs
# and 4 of the 8 memory slices (NVIDIA's MIG user guide, H100 profiles),
# so half of 3.35 TB/s. Fewer SMs to fill move the chooser's S at
# [2048,512]·[512,8], [4096,4096]·[4096,16] and [4096,64]^T [4096,8].
SWEEP_SPECS = (perf_model.H100,
               dataclasses.replace(perf_model.H100, name="h100-mig-3g.40gb",
                                   n_sms=60, hbm_bw=1.675e12))
# Policy split-knob arms ("auto", a pinned S, the sequential pin).
SWEEP_SPLITS = ("auto", 2, "never")
# Operand base addresses mod 16: fresh allocations, and views 4 bytes off
# the 16-byte grid (the skinny, wgmma, stream and packed bodies need an
# aligned A; the others take any).
SWEEP_PTRS = ((0, 0), (4, 4))

# The QR sweep: (m, r) operands ``linalg`` factors (PowerSGD's P, sketch
# bases, odd widths) over the tree-TSQR shard counts.
QR_SWEEP_SHAPES = ((8192, 16), (65536, 16), (1 << 20, 32), (4096, 3),
                   (100000, 64), (16384, 130))
QR_SWEEP_SHARDS = (1, 2, 8)


def _checks(kind, shape, params, dtype, out_dtype=None) -> list:
    """Contract and grid violations of one launch (the accumulator limit is
    a contract on the shape, checked where the shape is refused)."""
    lim = contracts.H100_LIMITS
    return ([v for v in contracts.check_kernel_config(
        kind, shape, params, dtype, lim, max_b=tsmm.MAX_SKINNY_T,
        out_dtype=out_dtype) if v.rule != "accumulator-limit"]
        + contracts.check_grid(kind, shape, params))


def _epilogue(kind, shape, splits, out_dtype, ptrs, spec=perf_model.H100):
    """The sum_partials launch an S-way split implies, as ``("reduce",
    (S, rows, cols), params)``, or None where the plain sum runs
    (``perf_model.reduce_kernel_runs``)."""
    m, d1, d2 = shape
    rows, cols = (m, d2) if kind == "tsm2r" else (d1, d2)
    if not perf_model.reduce_kernel_runs(splits, rows, cols):
        return None
    _, threads, vec, _ = perf_model.reduce_plan(splits, rows, cols,
                                                out_dtype, *ptrs, spec)
    return ("reduce", (splits, rows, cols),
            {"vec": vec, "threads": threads,
             "max_blocks": perf_model.REDUCE_BLOCKS_PER_SM * spec.n_sms,
             "ptrs": {"p": ptrs[0], "c": ptrs[1]}, "out_dtype": out_dtype})


def _quantize_passes(kind, shape, splits):
    """The quantize launches ``ops`` makes for an int8 launch of ``kind``:
    ``("quantize", (rows, cols, band), {"kmajor"})`` each."""
    m, d1, d2 = shape
    band = perf_model.Q8_BAND
    if kind == "tsmt":
        return [("quantize", (m, d1, band), {"kmajor": False}),
                ("quantize", (m, d2, band), {"kmajor": False})]
    kmajor = (kind == "tsm2r" and perf_model.tsm2r_body(
        d1, d2, torch.int8, splits=splits) == "wgmma")
    # B per tensor (``quant.quantize_tensor``): one band of k rows when its
    # codes go out K-major, else one row of k * n elements.
    b_pass = (d1, d2, d1) if kmajor else (1, d1 * d2, 1)
    return [("quantize", (m, d1, band), {"kmajor": False}),
            ("quantize", b_pass, {"kmajor": kmajor})]


def _arms(kind, shape, dtype, quant):
    """(S, spec) of every resolution of one shape: ``ops.resolve_params``
    under each split arm (the H100), and the chooser under each spec."""
    out = []
    for split in SWEEP_SPLITS:
        if kind == "tsm2l" and split != "auto":
            continue                      # tsm2l has no split dimension
        p = ops.resolve_params(kind, *shape, dtype,
                               tsmm.GemmPolicy(split=split, quant=quant))
        out.append((p.get("splits", 1), perf_model.H100))
    q8 = torch.int8 if quant == "int8" else dtype
    for spec in SWEEP_SPECS:
        if kind == "tsm2r":
            s = perf_model.choose_splits_tsm2r(*shape, spec, q8)
        elif kind == "tsmt":
            s = perf_model.choose_splits_tsmt(*shape, spec, q8)
        else:
            s = 1
        out.append((s, spec))
    return list(dict.fromkeys(out))


def _resolutions(shapes, quant, card=None):
    """Every resolution of the sweep: ``(kind, shape, dtype, opd, s, spec,
    ptrs, params)``, ``dtype`` the caller's, ``opd`` what the operands
    stream as, ``params`` the launch at S = ``s`` on operands at ``ptrs``,
    stated for ``card`` (default: the spec that chose ``s``)."""
    for kind, kshapes in shapes.items():
        for shape in kshapes:
            for dtype in SWEEP_DTYPES:
                opd = torch.int8 if quant == "int8" else dtype
                kout = dtype if quant == "int8" and kind == "tsm2l" else None
                for s, spec in _arms(kind, shape, dtype, quant):
                    for ptrs in SWEEP_PTRS:
                        yield (kind, shape, dtype, opd, s, card or spec, ptrs,
                               perf_model.kernel_params(
                                   kind, *shape, opd, s, card or spec,
                                   ptrs=ptrs, out_dtype=kout))


def resolved_launches(shapes=None, *, quant=("none", "int8"),
                      card=perf_model.H100) -> list:
    """Every distinct launch the resolved sweeps reach, as
    ``(kind, shape, params, dtype, quant)`` for
    ``kernel_verify.verify_kernel_config`` (``dtype`` the caller's;
    int8 operands under ``quant="int8"``): each kernel at each
    resolution's S (every split arm, the chooser under every spec) and
    base-address arm, the reduce epilogue each split implies, and under
    int8 the quantize passes, each stated for a launch on ``card`` (its
    SM count sets the persistent grids and the one-launch tsmt's slices).
    ``chip_smoke.py``'s dataflow phase launches each of them on the
    card."""
    seen, out = set(), []

    def add(kind, shape, params, dtype, q):
        key = (kind, tuple(shape), repr(sorted(
            (k, v if k != "ptrs" else sorted(v.items()))
            for k, v in params.items())), str(dtype), q)
        if key not in seen:
            seen.add(key)
            out.append((kind, tuple(shape), params, dtype, q))

    for q in quant:
        for kind, shape, dtype, _, s, spec, ptrs, params in _resolutions(
                shapes or SWEEP_SHAPES, q, card):
            add(kind, shape, params, dtype, q)
            epi = (_epilogue(kind, shape, s, dtype, ptrs, spec)
                   if s > 1 and kind != "tsm2l" else None)
            if epi is not None:
                add(*epi, torch.float32, "none")
            if q == "int8":
                for qp in _quantize_passes(kind, shape, s):
                    add(*qp, dtype, "none")
    return out


def audit_candidate_grids(shapes=None, dtypes=SWEEP_DTYPES + (torch.int8,),
                          specs=SWEEP_SPECS):
    """Every S the choosers score is a launchable configuration (they
    filter with ``contracts.feasible``: a violation here means the filter
    and the checker have drifted apart)."""
    shapes = shapes or SWEEP_SHAPES
    checked, out = 0, []
    for kind, kshapes in shapes.items():
        for shape in kshapes:
            for dtype in dtypes:
                for spec in specs:
                    cands = (perf_model.split_candidates(kind, *shape, spec,
                                                         dtype)
                             if kind != "tsm2l" else [1])
                    for s in cands:
                        checked += 1
                        params = perf_model.kernel_params(kind, *shape, dtype,
                                                          s, spec)
                        out.extend(_checks(kind, shape, params, dtype))
    return checked, out


def _audit_resolved(shapes, quant):
    checked, out = 0, []
    for kind, shape, dtype, opd, s, spec, ptrs, params in _resolutions(
            shapes, quant):
        checked += 1
        out.extend(_checks(kind, shape, params, opd,
                           dtype if quant == "int8" else None))
        epi = (_epilogue(kind, shape, s, dtype, ptrs, spec)
               if s > 1 and kind != "tsm2l" else None)
        if epi is not None:
            checked += 1
            out.extend(contracts.check_grid(*epi))
    return checked, out


def audit_resolved_configs(shapes=None):
    """The resolver's and the choosers' S at every split arm, spec and base
    address arm are launchable and cut their reduction whole, and so is
    the reduce epilogue each split implies."""
    return _audit_resolved(shapes or SWEEP_SHAPES, "none")


def audit_quant_configs(shapes=None):
    """``resolved-configs`` under ``quant="int8"``: int8 operands (scale
    bands as the slice quantum of tsmt), the caller's dtype out."""
    return _audit_resolved(shapes or SWEEP_SHAPES, "int8")


def audit_qr_configs(qr_shapes=QR_SWEEP_SHAPES, shards=QR_SWEEP_SHARDS):
    """Every GEMM stage of a tall-skinny QR (f32 by construction),
    replicated and per shard, resolves to a launchable configuration
    under every split arm."""
    dtype = torch.float32
    checked, out = 0, []
    for m, r in qr_shapes:
        for n_shards in shards:
            if n_shards > 1 and m % n_shards:
                continue
            for kind, shape in contracts.qr_stage_shapes(m, r,
                                                         shards=n_shards):
                for split in SWEEP_SPLITS:
                    if kind == "tsm2l" and split != "auto":
                        continue
                    p = ops.resolve_params(kind, *shape, dtype,
                                           tsmm.GemmPolicy(split=split))
                    params = perf_model.kernel_params(kind, *shape, dtype,
                                                      p.get("splits", 1))
                    checked += 1
                    out.extend(_checks(kind, shape, params, dtype))
    return checked, out


def audit_abft_configs(shapes=None, splits=("auto", "never")):
    """The online-ABFT surface: every (abft, quant, reduce) policy keeps
    its guard through ``backward_policy``, and every checksum GEMM the
    guard can dispatch (f32) classifies dense or resolves to a
    launchable configuration under the arms its policy can carry (a
    pinned S belongs to the protected shape, not to its checksums)."""
    shapes = shapes if shapes is not None else SWEEP_SHAPES
    dtype = torch.float32
    checked, out = 0, []
    for abft in ("none", "verify", "correct"):
        for quant in ("none", "int8"):
            for reduce_ in ("psum", "psum_scatter", "none"):
                checked += 1
                p = tsmm.GemmPolicy(abft=abft, quant=quant, reduce=reduce_)
                out.extend(contracts.check_backward_policy(
                    p, tsmm.backward_policy(p)))
    for kind, kshapes in shapes.items():
        for shape in kshapes:
            for entry, stage in contracts.abft_stage_shapes(kind, shape):
                for split in splits:
                    pol = tsmm.GemmPolicy(split=split)
                    kindc = (tsmm.classify_gemm(*stage, pol) if entry == "mm"
                             else tsmm.classify_gemm_t(*stage, pol))
                    checked += 1
                    if kindc == "dense" or (kindc == "tsm2l"
                                            and split != "auto"):
                        continue
                    p = ops.resolve_params(kindc, *stage, dtype, pol)
                    params = perf_model.kernel_params(kindc, *stage, dtype,
                                                      p.get("splits", 1))
                    out.extend(_checks(kindc, stage, params, dtype))
    return checked, out


def audit_tuning_table(table: autotune.TuningTable):
    """Every record re-checks at its shape, names a registered executor and
    sits in the bucket its shape hashes to."""
    known = tuple(tsmm.executors())
    checked, out = 0, []
    for r in table.records:
        checked += 1
        params = autotune.record_launch(r)
        out.extend(contracts.check_tuning_record(
            r.kind, r.shape, params, autotune._torch_dtype(r.dtype),
            executor=r.executor, known_executors=known))
        want = autotune.bucket_shape(*r.shape)
        if tuple(r.bucket) != want:
            out.append(contracts.Violation(
                "bucket-mismatch", r.key,
                f"record bucket {tuple(r.bucket)} != bucket_shape{r.shape}"
                f"={want}: lookups never reach this entry"))
    return checked, out


# Reachable field combinations of the backward-policy sweep: each mode
# class (auto, the dense pin, a forward-kind force), reduce mode, split
# class, and executor pinned or not (the port's executors).
_POLICY_MODES = ("auto", "dense", "tsm2r", "tsm2l")
_POLICY_SPLITS = ("auto", "never", 4)
_POLICY_EXECUTORS = (None, "cuda", "torch-ref", "torch-dense", "shard_map",
                     "shard_map-scatter")


def audit_policies():
    """``backward_policy`` keeps the VJP re-dispatch invariants for every
    reachable GemmPolicy combination, and every registered executor
    declares a well-formed reduce contract."""
    checked, out = 0, []
    for mode in _POLICY_MODES:
        for reduce_ in ("psum", "psum_scatter", "none"):
            for split in _POLICY_SPLITS:
                for executor in _POLICY_EXECUTORS:
                    checked += 1
                    p = tsmm.GemmPolicy(mode=mode, reduce=reduce_,
                                        split=split, executor=executor)
                    out.extend(contracts.check_backward_policy(
                        p, tsmm.backward_policy(p)))
    for name in tsmm.executors():
        checked += 1
        declared = tsmm.executor_reduce_contract(name)
        bad = [m for m in declared if m not in ("psum", "psum_scatter",
                                                "none")]
        if bad or not declared:
            out.append(contracts.Violation(
                "executor-contract-modes", f"executor {name!r}",
                f"declared reduce contract {declared!r} is "
                f"{'empty' if not declared else f'invalid: {bad}'}"))
    return checked, out


def audit_kernel_dataflow(shapes=None):
    """``kernel_verify.verify_kernel_config`` over every distinct launch of
    :func:`resolved_launches`. Returns ``(checked, violations, meta)``;
    ``meta`` holds the corner-sampling bound and the sampled launches."""
    checked, out, sampled = 0, [], []
    for kind, shape, params, dtype, quant in resolved_launches(shapes):
        checked += 1
        rep = kernel_verify.verify_kernel_config(kind, shape, params, dtype,
                                                 quant=quant)
        out.extend(rep)
        if rep.sampled:
            sampled.append({"subject": rep.subject, "grid": list(rep.grid),
                            "cells": rep.cells})
    return checked, out, {"cell_limit": kernel_verify.EXHAUSTIVE_CELL_LIMIT,
                          "sampled": sampled}


def run_audit(*, table_path=None, shapes=None) -> dict:
    """Run every section; return the machine-readable report."""
    sections: dict[str, tuple] = {
        "candidate-grids": audit_candidate_grids(shapes=shapes),
        "resolved-configs": audit_resolved_configs(shapes=shapes),
        "kernel-dataflow": audit_kernel_dataflow(shapes=shapes),
        "quant-resolved": audit_quant_configs(shapes=shapes),
        "qr-resolved": audit_qr_configs(),
        "abft-resolved": audit_abft_configs(shapes=shapes),
        "policies": audit_policies(),
    }
    if table_path is not None:
        sections["tuning-table"] = audit_tuning_table(
            autotune.TuningTable.load(table_path))
    report = {
        "schema": AUDIT_SCHEMA,
        "table": str(table_path) if table_path is not None else None,
        "sections": {
            name: {"checked": sec[0],
                   "violations": [v.to_json() for v in sec[1]],
                   **(sec[2] if len(sec) > 2 else {})}
            for name, sec in sections.items()
        },
    }
    report["checked"] = sum(sec[0] for sec in sections.values())
    report["violations"] = sum(len(sec[1]) for sec in sections.values())
    report["ok"] = report["violations"] == 0
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.audit",
        description="Audit the port's kernel-launch contracts over the "
                    "reachable configuration space (see "
                    "repro_torch.analysis.contracts).")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any violation")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the machine-readable report here")
    ap.add_argument("--table", metavar="PATH", default=None,
                    help="tuning-table JSON to audit (the tuning-table "
                         "section runs only with one)")
    args = ap.parse_args(argv)

    report = run_audit(table_path=args.table)
    for name, sec in report["sections"].items():
        status = "ok" if not sec["violations"] else (
            f"{len(sec['violations'])} violation(s)")
        print(f"{name}: {sec['checked']} checked, {status}")
        if sec.get("sampled"):
            print(f"  (corner-sampled {len(sec['sampled'])} grid(s) above "
                  f"{sec['cell_limit']} cells -- see the JSON report)")
        for v in sec["violations"]:
            print(f"  [{v['rule']}] {v['subject']}: {v['detail']}")
    print(f"repro_torch.analysis.audit: {report['checked']} checked, "
          f"{report['violations']} violation(s)"
          + (" -- clean" if report["ok"] else ""))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        print(f"report written to {args.json}")
    return 1 if (args.strict and not report["ok"]) else 0


if __name__ == "__main__":
    sys.exit(main())
