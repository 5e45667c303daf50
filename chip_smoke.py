#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Runs from a checkout of the repository (it puts ``src`` on ``sys.path``
itself), imports neither JAX nor the JAX package, and exits non-zero,
printing no result, when no CUDA card is present or any phase fails.

1. Build: every kernel from ``src/repro_torch/kernels/csrc/`` (one nvcc per
   source, all started together: eleven libraries); prints the build time,
   the card's name and power limit, and the matmul precision flags (TF32
   and reduced precision bf16 reductions off, so the plain versions are
   exact f32 sums).
2. Kernels: each kernel against its plain version on the card, f32 and
   bf16, at the chatglm3, paper and ragged shapes; one JSON line per case
   with the kernel's, the plain version's and one ``torch.matmul``'s median
   time (CUDA events around the call, so the wrapper's host time is
   inside), the bound, and the worst error; at the main path's shapes also
   ``device_ms``, the kernel's own median device time from
   ``torch.profiler``, ``call_device_ms``, every device kernel and
   memset of the wrapper call summed, and ``library_device_ms``, the
   library call's device time the same way. Each kernel must
   also give bit-identical results on a second launch. tsmt (f32, bf16)
   and tsmt_q8 (f32, bf16 out) spread m over the card in one launch at
   the plan of ``perf_model.tsmt_slices``, printed as ``plan_splits`` on
   every line (a short m plans S = 1); each must equal, bit for bit, its
   split kernel's partials at the plan's S summed slice by slice from f32
   zeros on the card and cast once, plan S > 1 at [65536,128]^T
   [65536,4] and run there within 0.10 ms on the device. A sweep then
   times both at other S (``tsmt_sweep`` lines): at [65536,128]^T
   [65536,4] over the slice length, at [2^20,128]^T [2^20,4] over 1, 2
   and 4 blocks per SM, where the plan's two constants were read from.
   The split kernels
   (tsm2r_split, tsmt_split) are held against their plain (S, ., .) f32
   partials at the PowerSGD, paper and chatglm3 shapes with a pinned S
   (tsmt_split at b = 256 also at S = 1, against the sequential kernel on
   the same rows, and at S = 16, the chooser's pick before it was kept to
   outputs at most 16 wide),
   and sum_partials against an f32 sum; their lines add ``op_ms`` (split
   kernel plus epilogue) and ``seq_ms`` (the sequential kernel on the same
   product); ``library_ms`` is one ``torch.matmul`` of the whole product
   (``torch.sum`` for sum_partials). Tolerances are the
   JAX kernel tests' (f32 rtol=1e-3, atol=1e-4; bf16 rtol=atol=2e-2). Those
   were set for reductions of up to ~2048 terms; for a deeper f32 reduction
   atol grows by sqrt(depth / 1024), because the rounding error of an f32
   sum grows as the square root of its length, and two correct sums taken
   in different orders differ by that much near zero. bf16 keeps 2e-2 as
   it is: both sides round their f32 sums to bf16, and one bf16 step is at
   most 2^-7 of the value.
   tsm2r is also held at the training path's shapes: the wk/wv forward of
   a 4096-token microbatch and PowerSGD's P projection.
   The five int8 kernels are held against their plain versions on the
   same int8 operands and scales (quantized on the card by
   ``kernels/quant.py``), with f32 and bf16 outputs (the split ones write
   f32 partials), at their main-path shapes, a ragged shape, and a deep
   case whose reduction (over 133,143 terms of one sign, codes near 127)
   would overflow one int32 sum; at the same tolerances, since the integer
   sums are exact and only the folds round; bit-identical repeats. At the
   main-path shapes they are timed beside their plain version,
   ``torch._int_mm`` followed by the scale fold (``library_ms``; null where
   it refuses the shape or, for TSMT, where the scales vary along the
   reduction) and one ``torch.matmul`` of the dequantized operands in the
   caller's dtype (``library_dq_ms``). Then the whole ``tsmm``/``tsmm_t``
   op under ``quant="int8"`` is held against the f32 product (the JAX
   ``test_quant.py`` max-norm relative criterion: 5%, 6% for bf16) and
   timed.
3. Dispatch (a path of its own: every launch count is set to 0 just
   before it and read just after): under ``split="never"`` the quickstart's shapes
   through ``tsmm``/``tsmm_t`` must route to tsm2r, tsm2l and tsmt on
   executor ``cuda``, tsmt's launch record showing the planned grid
   (a-tiles, b-tiles, S) with ``splits`` 1. Under ``"auto"`` the paper's
   ``[16384^2]·[16384,16]``
   and PowerSGD's ``[65024,4096]^T·[65024,4]`` must resolve S > 1 and
   launch tsm2r_split (with sum_partials) and tsmt_split; under
   ``"never"`` the sequential kernels. The same under ``quant="int8"``:
   "never" routes the quickstart's shapes to tsm2r_q8, tsm2l_q8 and
   tsmt_q8; "auto" resolves PowerSGD's TSMT and ``[4096,65536]·[65536,16]``
   (32 row tiles) to S > 1 on tsmt_q8_split and tsm2r_q8_split, and the
   paper's TSM2R to what the int8 chooser picks. The Python mirror of the
   tile table (``core/perf_model.py``) must equal the C grid query of all
   four split libraries.
4. Serve (the serving main path; counts zeroed before it, read after):
   chatglm3-6b at its published width and depth, bf16,
   random weights from a seeded generator; 4 prompts of 2048 tokens answered
   with 16 greedy tokens, then a sampled run, then once more step by step
   for times (the main path ends here and the launch counts are read). Each
   prefill must launch tsm2r exactly 56 times (wk, wv x 28 layers) and every
   decode projection must go to ``torch-dense``. The kernel arm's prefill
   logits must match a ``policy(mode="dense")`` arm, and the cached decode
   logits the teacher-forced ``model.forward`` logits, within a normalised
   error max|a - b| / max|b| <= 5e-2 (bf16 activations through 28 layers;
   sums in another order round differently).
   Then one prefill and two decode steps are traced with
   ``torch.profiler``: device time by kernel and by category, the number
   of device kernels, and the device's busy share of the unprofiled time.
5. Serve-int8 (a main path of its own; counts zeroed before, read after):
   the same model, its weights turned into int8 records by
   ``quantize_weights`` (embed, lm_head and the stacked biases and norm
   scales: the 3-D layer weights stay dense), served under
   ``GemmPolicy(quant="int8")``: 4 x 2048 prompt tokens and 16 greedy
   tokens, then step by step for times. Each prefill must launch tsm2r_q8
   exactly 56 times and tsm2r never. Prefill logits must equal, bit for
   bit, a scheme arm: the same routing with every wk/wv product taken by
   the JAX int8 scheme written out in this script, apart from
   ``kernels/ops.py`` and ``kernels/quant.py`` (A in zero-padded 256-row
   bands, B per tensor, absmax / 127, round half to even, clip), times the
   plain version's exact integer product. So ``ops.py`` applies the scheme
   and tsm2r_q8 equals its plain version at every prefill launch. The
   logits must also match a ``mode="dense"`` arm on the same records
   within 0.1, the JAX package's criterion for int8 results through
   several products (``test_quant.py:187, 335``): the scheme's int8 K/V
   projections of 28 layers move the logits by about 5% on their own
   (``tests/test_torch_quant.py`` reads the same distance from the JAX
   package's int8 prefill at the smoke size).
   Prints prefill
   ms, decode ms a step, peak memory, the bytes the records hold and the
   dense bytes they replace, and one profiled prefill.
6. Grad: each op's autograd on the card (the backward re-dispatches
   through ``tsmm``) against autograd through its plain version, f32, at
   the kernel tolerances; a directional finite difference of a
   tsm2l-routed loss against a float64 oracle (rtol 1e-2).
7. Train (the training main path; counts zeroed before it, read after):
   chatglm3-6b at its published width with 4 layers, bf16 parameters
   from seed 0, PowerSGD rank 4, 4 microbatches of 2 x 2048 tokens, 3
   steps of ``train_step.make_train_step``. Every step must be
   ``step_ok``, compress exactly embed and lm_head, launch tsm2r exactly
   34 times (wk, wv x 4 layers x 4 microbatches + 2 P projections) and
   tsmt_split exactly twice with S > 1 (the Q projections) and the
   sequential tsmt never; every backward GEMM of wk/wv goes to
   ``torch-dense``. A ``policy(mode="dense")`` arm from the same state and
   batch must match the first step's loss, grad norm and compressed
   embed/lm_head gradients within normalised error 5e-2. Prints step
   time, tokens/s, peak memory, and a profiled fourth step's device busy
   share and device time by kernel.
8. Train-int8 (a main path of its own): the same, inside
   ``GemmPolicy(quant="int8")`` with ``PowerSGDConfig(compress="int8")``.
   Every step launches tsm2r_q8 32 times for wk/wv, the two P projections
   on tsm2r_q8 or tsm2r_q8_split at the S the int8 chooser resolves
   (checked against it), tsmt_q8_split exactly twice with S > 1, and no
   f32/bf16 TSM2X kernel. The dense arm (same compress setting, state and
   batch) must match the first step's loss and grad norm within 5e-2 and
   its compressed embed/lm_head gradients within 0.1 (the JAX criterion
   for int8 PowerSGD and int8 gradients).
9. A ``{"kernels": [...]}`` line: all eleven kernels with their launches
   on each of the five paths (dispatch, serve, train, serve-int8,
   train-int8) and their numbers at their main-path shape and dtype
   (``library_device_ms`` beside ``device_ms``; ``splits`` is the plan's
   S for tsmt and tsmt_q8); tsm2r and tsm2r_q8 add their numbers at the
   training shapes.
10. Last line: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                        # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,            # dense tensor-core bf16
              torch.float32: 67e12,              # f32 outside tensor cores
              torch.int8: 1979e12}               # dense tensor-core int8
TOL = {torch.float32: (1e-3, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
LOGIT_TOL = 5e-2
# int8 results through several products (int8 gradients, int8 PowerSGD:
# JAX tests/test_quant.py:187, 335), and int8 serving against a dense arm
Q8_GRAD_TOL = 0.1
Q8_REL_TOL = {torch.float32: 0.05, torch.bfloat16: 0.06}
# Device time the one-launch tsmt and tsmt_q8 must stay within at
# [65536,128]^T [65536,4]: 12x below one block per output tile (1.361 and
# 1.236 ms on an H100 80GB HBM3 at 700 W).
TSMT_MAX_MS = 0.10
BATCH, PROMPT, NEW = 4, 2048, 16
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4, 2048, 8, 3
KERNEL_NAMES = ("tsm2r_q8_split", "tsmt_q8_split", "tsm2r_q8", "tsm2l_q8",
                "tsmt_q8", "tsm2r_split", "tsmt_split", "tsm2r", "tsm2l",
                "tsmt", "sum_partials")


T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, min_reps: int = 3) -> float:
    """Median of CUDA-event timings after warm-up."""
    fn()
    torch.cuda.synchronize()

    def once():
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e)

    first = once()
    reps = max(min_reps, min(50, int(200 / max(first, 1e-3))))
    return statistics.median([first] + [once() for _ in range(reps - 1)])


def bound(x, y, out, flops, *extra):
    """The least time for the work: each input (``extra`` too: scale
    sidecars) read once and the output written once, or ``flops`` at the
    peak rate of the inputs' type, whichever is longer."""
    nbytes = sum(t.numel() * t.element_size() for t in (x, y, out, *extra))
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[x.dtype] * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def check(cond, what) -> None:
    """Fail the run (non-zero exit, no result line) unless ``cond``."""
    if not cond:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def normalised_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def category(name: str) -> str:
    if "tsm2l_kernel<signed char" in name:   # one template serves both
        return "tsm2l_q8"
    for kern in KERNEL_NAMES:
        if f"{kern}_kernel" in name:
            return kern
    if any(w in name for w in ("gemm", "gemv", "xmma", "cutlass", "nvjet")):
        return "library GEMM"
    return "other"


def device_profile(fn) -> dict:
    """Run ``fn`` under ``torch.profiler`` and return the device time by
    kernel and by category and the number of device kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_kernel, by_cat, n_kernels = {}, {}, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        n_kernels += 1
        us = e.time_range.elapsed_us()
        by_kernel[e.name] = by_kernel.get(e.name, 0) + us
        cat = category(e.name)
        by_cat[cat] = by_cat.get(cat, 0) + us
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    return {"device_busy_ms": sum(by_kernel.values()) / 1e3,
            "device_kernels": n_kernels,
            "by_category_ms": {k: v / 1e3 for k, v in sorted(
                by_cat.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms": [[n[:90], v / 1e3] for n, v in top]}


def device_events(run, enough, tries: int = 3) -> list:
    """The device events (kernels, memsets) of ``run()`` under
    ``torch.profiler``, in start order. Now and then a session's trace
    comes back without them; a session whose events are not ``enough`` is
    taken again, up to ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        if enough(events):
            break
    return events


def device_ms(fn, name: str, reps: int = 5) -> float:
    """Median device time of kernel ``name`` over ``reps`` calls of ``fn``
    under ``torch.profiler``: the kernel alone, without the host time
    that CUDA events around the call include."""
    return device_ms_each([fn], name, reps)[0]


def call_device_ms(fn, reps: int = 5) -> float:
    """Device time of one call of ``fn``: every device kernel (and memset)
    it runs, summed, averaged over ``reps`` calls under ``torch.profiler``.
    The library calls are timed so, device to device with ``device_ms``."""
    def run():
        for _ in range(reps):
            fn()

    fn()
    events = device_events(run, bool)
    check(events, f"no device kernel in {reps} profiled calls")
    return sum(e.time_range.elapsed_us() for e in events) / reps / 1e3


def device_ms_each(fns, name: str, reps: int = 10) -> list:
    """``device_ms`` of each of ``fns`` (median of ``reps`` calls), in one
    profiler session: the kernel events of ``name``, in launch order."""
    def run():
        for fn in fns:
            for _ in range(reps):
                fn()

    def ours(events):
        return [e for e in events if category(e.name) == name]

    for fn in fns:
        fn()
    events = ours(device_events(
        run, lambda ev: len(ours(ev)) == reps * len(fns)))
    check(len(events) == reps * len(fns), f"{name}: {len(events)} device "
          f"kernels in {reps * len(fns)} profiled calls")
    us = [e.time_range.elapsed_us() for e in events]
    return [statistics.median(us[i * reps:(i + 1) * reps]) / 1e3
            for i in range(len(fns))]


def in_slice_order(parts, dtype):
    """The one-launch TSMT's last block written out: the (S, a, b) f32
    partials summed slice by slice from f32 zeros and cast once; at S = 1
    the kernel stores its one partial straight."""
    if parts.shape[0] == 1:
        return parts[0].to(dtype)
    acc = torch.zeros_like(parts[0])
    for p in parts:
        acc += p
    return acc.to(dtype)


def same_bits(a, b) -> bool:
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def tsmt_plan_check(x, y, got, dtype, q=None) -> dict:
    """The sequential TSMT (``q``: tsmt_q8's scales) against its split
    kernel at the plan's S: the split partials summed in slice order must
    equal the kernel's output bit for bit."""
    from repro_torch.core import perf_model
    from repro_torch.kernels import tsmt as k_tsmt

    (m, a), b = x.shape, y.shape[1]
    band = perf_model.Q8_BAND
    if q is None:
        S, slice_ = k_tsmt._plan(m, a, b, x.device, dtype)
        parts = k_tsmt.tsmt_split(x, y, S, perf_model.TSMT_BLOCK_M)
    else:
        S, slice_ = k_tsmt._plan(m, a, b, x.device, torch.int8, band)
        parts = k_tsmt.tsmt_q8_split(x, y, *q, band, S)
    return {"plan_splits": S, "plan_slice": slice_,
            "bits_vs_split_sum": same_bits(got, in_slice_order(parts,
                                                               dtype))}


def tsmt_sweep(dev, uniform, gpu) -> None:
    """Device time of tsmt and tsmt_q8 at S slices other than the plan's,
    where ``perf_model``'s two constants were read from: at
    [65536,128]^T [65536,4] over the slice length, at [2^20,128]^T
    [2^20,4] over 1, 2 and 4 blocks per SM. Launches go straight through
    the C launchers, so the wrappers' counts do not move."""
    from repro_torch.core import perf_model
    from repro_torch.kernels import _launch, quant, ref
    from repro_torch.kernels import tsmt as k_tsmt

    band, n_sms = perf_model.Q8_BAND, torch.cuda.get_device_properties(
        dev).multi_processor_count
    for m, Ss in [(65536, (16, 32, 64, 128, 256)),
                  (1 << 20, (n_sms, 2 * n_sms, 4 * n_sms))]:
        x, y = uniform((m, 128), torch.float32), uniform((m, 4),
                                                         torch.float32)
        xq, xs = quant.quantize_blocks(x, band)
        yq, ys = quant.quantize_blocks(y, band)
        for name, quantum in (("tsmt", perf_model.TSMT_BLOCK_M),
                              ("tsmt_q8", band)):
            plans = []
            for S in Ss:
                slice_ = ref.split_len(m, S, quantum)
                S = -(-m // slice_)
                plans.append((S, ref.split_len(m, S, quantum)))

            def at(S, slice_, name=name):
                out = torch.empty((128, 4), device=dev)
                ws = k_tsmt._workspace(S, 128, 4, dev)
                if name == "tsmt":
                    _launch.launch(name, torch.float32, x, y, out, m, 128, 4,
                                   S, slice_, ws)
                else:
                    _launch.launch(name, torch.float32, xq, yq, xs, ys, out,
                                   m, 128, 4, band, S, slice_, ws)
            ms = device_ms_each([lambda p=p: at(*p) for p in plans], name)
            dtype, q_band = ((torch.int8, band) if name == "tsmt_q8"
                             else (torch.float32, None))
            emit({"phase": "tsmt_sweep", "kernel": name, "shape": [m, 128, 4],
                  "splits": [p[0] for p in plans],
                  "slice_rows": [p[1] for p in plans], "device_ms": ms,
                  "plan": k_tsmt._plan(m, 128, 4, dev, dtype, q_band),
                  "gpu": gpu})
        del x, y, xq, yq, xs, ys
        torch.cuda.empty_cache()


def split_kernel_phase(dev, uniform, gpu) -> dict:
    """Each split kernel and sum_partials against its plain version at the
    main path's, the paper's and the chatglm3 shapes, f32 and bf16, with
    bit-identical repeats. Returns the record of each kernel's main-path
    case."""
    from repro_torch.kernels import ref, reduce
    from repro_torch.kernels import tsm2r as k_tsm2r
    from repro_torch.kernels import tsmt as k_tsmt

    cases = {   # (m, d1, d2, S); tsm2r (m, k, n), tsmt (m, a, b)
        "tsmt_split": [(65024, 4096, 4, 8), (1 << 20, 128, 4, 32),
                       (65536, 256, 256, 1), (65536, 256, 256, 2),
                       (65536, 256, 256, 16)],
        "tsm2r_split": [(16384, 16384, 16, 2), (8192, 4096, 256, 4)],
    }
    main_case = {"tsmt_split": ((65024, 4096, 4, 8), torch.float32),
                 "tsm2r_split": ((16384, 16384, 16, 2), torch.float32),
                 "sum_partials": ((2, 16384, 16), torch.float32)}
    measured, bad = {}, []
    for name, shapes in cases.items():
        mm = name == "tsm2r_split"
        kern = k_tsm2r.tsm2r_split if mm else k_tsmt.tsmt_split
        plain = ref.tsm2r_split_ref if mm else ref.tsmt_split_ref
        seq = k_tsm2r.tsm2r if mm else k_tsmt.tsmt
        block = 32 if mm else 8
        for m, d1, d2, S in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                x = uniform((m, d1), dtype)
                y = uniform((d1, d2) if mm else (m, d2), dtype)
                got = kern(x, y, S, block)
                again = kern(x, y, S, block)
                torch.cuda.synchronize()
                want = plain(x, y, S, block)
                depth = ref.split_len(d1 if mm else m, S, block)
                # Both sides sum the same products in f32 (the partials
                # are f32 at either input dtype): f32 tolerances.
                rtol, atol = TOL[torch.float32]
                atol *= max(1.0, (depth / 1024) ** 0.5)
                err = (got - want).abs()
                same = torch.equal(got, again)
                ok = same and bool((err <= atol + rtol * want.abs()).all())
                b_ms, b_by = bound(x, y, got, 2 * m * d1 * d2)
                lib = ((lambda: torch.matmul(x, y)) if mm
                       else (lambda: torch.matmul(x.t(), y)))
                rec = {"phase": "kernel", "kernel": name,
                       "shape": [m, d1, d2], "splits": S,
                       "dtype": str(dtype)[6:],
                       "kernel_ms": time_ms(lambda: kern(x, y, S, block)),
                       "op_ms": time_ms(lambda: reduce.reduce_partials(
                           kern(x, y, S, block), dtype)[0]),
                       "seq_ms": time_ms(lambda: seq(x, y)),
                       "plain_ms": time_ms(lambda: plain(x, y, S, block)),
                       "library_ms": time_ms(lib),
                       "bound_ms": b_ms, "bound_by": b_by,
                       "max_err": float(err.max()), "rtol": rtol,
                       "atol": atol, "deterministic": same, "ok": ok,
                       "gpu": gpu}
                if main_case[name] == ((m, d1, d2, S), dtype):
                    rec["device_ms"] = device_ms(
                        lambda: kern(x, y, S, block), name)
                    rec["library_device_ms"] = call_device_ms(lib)
                    measured[name] = rec
                emit(rec)
                if not ok:
                    bad.append(f"{name} {m}x{d1}x{d2} S={S} {dtype}")
                del x, y, got, again, want, err
                torch.cuda.empty_cache()
    for S, rows, cols in [(2, 16384, 16), (8, 4096, 4), (32, 128, 4)]:
        p = uniform((S, rows, cols), torch.float32)
        for dtype in (torch.float32, torch.bfloat16):
            got = reduce.sum_partials(p, dtype)
            again = reduce.sum_partials(p, dtype)
            torch.cuda.synchronize()
            want = ref.sum_partials_ref(p, dtype)
            rtol, atol = TOL[dtype]
            err = (got.float() - want.float()).abs()
            same = torch.equal(got, again)
            ok = same and bool(
                (err <= atol + rtol * want.float().abs()).all())
            nbytes = p.numel() * 4 + got.numel() * got.element_size()
            rec = {"phase": "kernel", "kernel": "sum_partials",
                   "shape": [S, rows, cols], "dtype": str(dtype)[6:],
                   "kernel_ms": time_ms(lambda: reduce.sum_partials(p,
                                                                    dtype)),
                   "op_ms": None, "seq_ms": None,
                   "plain_ms": time_ms(lambda: ref.sum_partials_ref(p,
                                                                    dtype)),
                   "library_ms": time_ms(lambda: torch.sum(p, dim=0)),
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "bound_by": "bytes", "max_err": float(err.max()),
                   "rtol": rtol, "atol": atol, "deterministic": same,
                   "ok": ok, "gpu": gpu}
            if main_case["sum_partials"] == ((S, rows, cols), dtype):
                rec["device_ms"] = device_ms(
                    lambda: reduce.sum_partials(p, dtype), "sum_partials")
                rec["library_device_ms"] = call_device_ms(
                    lambda: torch.sum(p, dim=0))
                measured["sum_partials"] = rec
            emit(rec)
            if not ok:
                bad.append(f"sum_partials {S}x{rows}x{cols} {dtype}")
    check(not bad, f"split kernel phase mismatch in {bad}")
    return measured


def q8_kernel_phase(dev, uniform, gpu) -> tuple[dict, dict]:
    """Each int8 kernel against its plain version on the same int8
    operands and scales, with f32 and bf16 outputs, bit-identical
    repeats; timed at its main-path shapes. Then the whole ``tsmm`` /
    ``tsmm_t`` op under ``quant="int8"`` against the f32 product. Returns
    the records of each kernel's main-path case and of its training-path
    cases."""
    from repro_torch.core import perf_model, tsmm
    from repro_torch.kernels import quant, ref
    from repro_torch.kernels import tsm2l as k_tsm2l
    from repro_torch.kernels import tsm2r as k_tsm2r
    from repro_torch.kernels import tsmt as k_tsmt

    band, bk = perf_model.Q8_BAND, perf_model.TSM2R_BLOCK_K
    f32, bf16 = torch.float32, torch.bfloat16
    # name: (entry, kernel(q, dtype, S), plain(q, dtype, S), split?)
    kernels = {
        "tsm2r_q8": ("mm", lambda q, dt, S: k_tsm2r.tsm2r_q8(*q, band, dt),
                     lambda q, dt, S: ref.tsm2r_q8_ref(*q, band, dt), False),
        "tsm2r_q8_split": (
            "mm", lambda q, dt, S: k_tsm2r.tsm2r_q8_split(*q, band, S, bk),
            lambda q, dt, S: ref.tsm2r_q8_split_ref(*q, band, S, bk), True),
        "tsm2l_q8": ("mm", lambda q, dt, S: k_tsm2l.tsm2l_q8(*q, band, dt),
                     lambda q, dt, S: ref.tsm2l_q8_ref(*q, band, dt), False),
        "tsmt_q8": ("mmt", lambda q, dt, S: k_tsmt.tsmt_q8(*q, band, dt),
                    lambda q, dt, S: ref.tsmt_q8_ref(*q, band, dt), False),
        "tsmt_q8_split": (
            "mmt", lambda q, dt, S: k_tsmt.tsmt_q8_split(*q, band, S),
            lambda q, dt, S: ref.tsmt_q8_split_ref(*q, band, S), True),
    }
    # (m, d1, d2, S, deep, timed as): the main-path shapes first; "deep"
    # reductions are of one sign with codes near 127, so a single int32
    # sum over their depth (> 133,143 terms) would overflow.
    cases = {
        "tsm2r_q8": [(8192, 4096, 256, 1, False, "main"),
                     (4096, 4096, 256, 1, False, "train"),
                     (65024, 4096, 4, 1, False, "train"),
                     (1000, 777, 17, 1, False, None),
                     (512, 300000, 4, 1, True, None)],
        "tsm2r_q8_split": [(4096, 65536, 16, 4, False, "main"),
                           (16384, 16384, 16, 2, False, None),
                           (1000, 777, 17, 3, False, None),
                           (512, 300000, 4, 2, True, None)],
        "tsm2l_q8": [(102400, 4, 4, 1, False, "main"),
                     (10000, 300, 20, 1, False, None),
                     (512, 200000, 4, 1, True, None)],
        "tsmt_q8": [(65536, 128, 4, 1, False, "main"),
                    (10000, 300, 20, 1, False, None),
                    (300000, 16, 4, 1, True, None),
                    (1000, 100, 3, 1, False, None)],    # plans S = 1
        "tsmt_q8_split": [(65024, 4096, 4, 8, False, "main"),
                          (1 << 20, 128, 4, 32, False, None),
                          (10000, 300, 20, 3, False, None),
                          (300000, 16, 4, 2, True, None)],
    }
    main_dtype = {"tsm2r_q8": bf16}
    measured, at_train, bad = {}, {}, []
    for name, (entry, kern, plain, split) in kernels.items():
        for m, d1, d2, S, deep, timed in cases[name]:
            x = uniform((m, d1), f32)
            y = uniform((d1, d2) if entry == "mm" else (m, d2), f32)
            if deep:
                x, y = x.abs() * 0.5 + 0.5, y.abs() * 0.5 + 0.5
            xq, xs = quant.quantize_blocks(x, band)
            yq, ys = (quant.quantize_tensor(y) if entry == "mm"
                      else quant.quantize_blocks(y, band))
            q = (xq, yq, xs, ys)
            depth = d1 if entry == "mm" else m
            if split:
                depth = ref.split_len(depth, S, bk if entry == "mm" else band)
            for dtype in ((f32,) if split else (f32, bf16)):
                got = kern(q, dtype, S)
                again = kern(q, dtype, S)
                torch.cuda.synchronize()
                want = plain(q, dtype, S)
                rtol, atol = TOL[dtype]
                if dtype == f32:
                    atol *= max(1.0, (depth / 1024) ** 0.5)
                err = (got.float() - want.float()).abs()
                same = torch.equal(got, again)
                ok = same and bool(
                    (err <= atol + rtol * want.float().abs()).all())
                rec = {"phase": "kernel", "kernel": name,
                       "shape": [m, d1, d2], "splits": S, "deep": deep,
                       "dtype": str(dtype)[6:], "max_err": float(err.max()),
                       "rtol": rtol, "atol": atol, "deterministic": same,
                       "ok": ok, "gpu": gpu}
                if name == "tsmt_q8":
                    rec.update(tsmt_plan_check(xq, yq, got, dtype, (xs, ys)))
                    rec["ok"] = ok = ok and rec["bits_vs_split_sum"]
                if not ok:
                    bad.append(f"{name} {m}x{d1}x{d2} S={S} {dtype}")
                # wk/wv run in bf16, PowerSGD's P (n = 4) in f32.
                is_main = (timed == "main"
                           and dtype == main_dtype.get(name, f32))
                is_train = timed == "train" and (d2 == 4) == (dtype == f32)
                if is_main or is_train:
                    rec.update(q8_times(entry, q, dtype, got, band,
                                        lambda: kern(q, dtype, S),
                                        lambda: plain(q, dtype, S)))
                    rec["device_ms"] = device_ms(lambda: kern(q, dtype, S),
                                                 name)
                    rec["call_device_ms"] = call_device_ms(
                        lambda: kern(q, dtype, S))
                emit(rec)
                if is_main:
                    measured[name] = rec
                elif is_train:
                    at_train.setdefault(name, []).append(rec)
                del got, again, want, err
            del x, y, xq, yq, xs, ys, q
            torch.cuda.empty_cache()
    check(not bad, f"int8 kernel phase mismatch in {bad}")

    # The whole op under quant="int8" against the f32 product.
    for entry, (m, d1, d2), dtype, split in [
            ("mm", (8192, 4096, 256), bf16, "auto"),
            ("mm", (65024, 4096, 4), f32, "auto"),
            ("mm", (4096, 65536, 16), f32, "auto"),
            ("mm", (102400, 4, 4), f32, "auto"),
            ("mmt", (65536, 128, 4), f32, "never"),
            ("mmt", (65024, 4096, 4), f32, "auto")]:
        x = uniform((m, d1), dtype)
        y = uniform((d1, d2) if entry == "mm" else (m, d2), dtype)
        op = tsmm.tsmm if entry == "mm" else tsmm.tsmm_t
        xt = x if entry == "mm" else x.t()
        with tsmm.policy(quant="int8", split=split), \
                tsmm.record_dispatches() as log:
            got = op(x, y)
        oracle = torch.matmul(xt.float(), y.float())
        rel = normalised_err(got, oracle)
        ok = got.dtype == dtype and rel <= Q8_REL_TOL[dtype]
        with tsmm.policy(quant="int8", split=split):
            op_ms = time_ms(lambda: op(x, y))
        emit({"phase": "kernel", "op": "tsmm" if entry == "mm" else "tsmm_t",
              "quant": "int8", "shape": [m, d1, d2], "dtype": str(dtype)[6:],
              "split": split,
              "launches": [(lm.kind, lm.splits) for e in log
                           for lm in e.launches],
              "op_ms": op_ms,
              "library_ms": time_ms(lambda: torch.matmul(xt, y)),
              "rel_err_vs_f32": rel, "tol": Q8_REL_TOL[dtype], "ok": ok,
              "gpu": gpu})
        check(ok, f"int8 {entry} op {m}x{d1}x{d2} {dtype}: {rel}")
        del x, y, xt, got, oracle
        torch.cuda.empty_cache()
    return measured, at_train


def q8_times(entry, q, dtype, got, band, kern, plain) -> dict:
    """Times of one int8 kernel case: the kernel, its plain version,
    ``torch._int_mm`` and the scale fold (``library_ms``; None where it
    refuses the shape, or for TSMT, whose scales vary along the
    reduction), one ``torch.matmul`` of the dequantized operands in
    ``dtype`` (``library_dq_ms``, and its device time
    ``library_device_ms``), and the bound."""
    from repro_torch.kernels import quant

    xq, yq, xs, ys = q
    m, d1 = xq.shape
    d2 = yq.shape[1]
    library_ms = None
    if entry == "mm":
        rows = (xs.reshape(-1).repeat_interleave(band)[:m]
                * ys.reshape(()))[:, None]

        def int_mm():
            return (torch._int_mm(xq, yq).float() * rows).to(dtype)
        try:
            int_mm()
        except RuntimeError:
            pass
        else:
            library_ms = time_ms(int_mm)
    xd = quant.dequantize_blocks(xq, xs, dtype, block_rows=band)
    yd = (quant.dequantize_blocks(yq, ys, dtype) if entry == "mm"
          else quant.dequantize_blocks(yq, ys, dtype, block_rows=band))
    xd = xd if entry == "mm" else xd.t()
    b_ms, b_by = bound(xq, yq, got, 2 * m * d1 * d2, xs, ys)
    return {"kernel_ms": time_ms(kern), "plain_ms": time_ms(plain),
            "library_ms": library_ms,
            "library_dq_ms": time_ms(lambda: torch.matmul(xd, yd)),
            "library_device_ms": call_device_ms(
                lambda: torch.matmul(xd, yd)),
            "bound_ms": b_ms, "bound_by": b_by}


def q8_dispatch(dev, uniform, counts, expect) -> dict:
    """The dispatch path under ``quant="int8"``: "never" routes the
    quickstart's shapes to tsm2r_q8, tsm2l_q8 and tsmt_q8; "auto" splits
    PowerSGD's TSMT and a TSM2R of 32 row tiles, and resolves the paper's
    TSM2R to the int8 chooser's S. Every output within the JAX int8
    criterion of the f32 product. Returns the launches it made."""
    from repro_torch.core import tsmm
    from repro_torch.kernels import ops

    f32 = torch.float32
    first = before = counts()
    a, b = uniform((4096, 4096), f32), uniform((4096, 8), f32)
    a2, b2 = uniform((102400, 4), f32), uniform((4, 4), f32)
    x, y = uniform((65536, 128), f32), uniform((65536, 4), f32)
    with tsmm.policy(split="never", quant="int8"), \
            tsmm.record_dispatches() as log:
        outs = [tsmm.tsmm(a, b), tsmm.tsmm(a2, b2), tsmm.tsmm_t(x, y)]
    torch.cuda.synchronize()
    launched = [[lm.kind for lm in e.launches] for e in log]
    errs = [normalised_err(got, want) for got, want in
            zip(outs, (a @ b, a2 @ b2, x.t() @ y))]
    grown = {n: v - before[n] for n, v in counts().items()}
    emit({"phase": "dispatch", "quant": "int8", "split": "never",
          "launched": launched, "launches": grown, "rel_err_vs_f32": errs})
    check(launched == [["tsm2r_q8"], ["tsm2l_q8"], ["tsmt_q8"]]
          and all(e.quant == "int8" and e.executor == "cuda" for e in log),
          f"int8 dispatch routes {launched}")
    check(grown == expect(tsm2r_q8=1, tsm2l_q8=1, tsmt_q8=1),
          f"int8 dispatch launches {grown}")
    check(max(errs) <= Q8_REL_TOL[f32], f"int8 dispatch errors {errs}")
    del a, b, a2, b2, x, y, outs

    a, b = uniform((16384, 16384), f32), uniform((16384, 16), f32)
    a3, b3 = uniform((4096, 65536), f32), uniform((65536, 16), f32)
    x, y = uniform((65024, 4096), f32), uniform((65024, 4), f32)
    paper_s = ops.resolve_params("tsm2r", 16384, 16384, 16, f32,
                                 tsmm.GemmPolicy(quant="int8"),
                                 device=dev)["splits"]
    before = counts()
    with tsmm.policy(split="auto", quant="int8"), \
            tsmm.record_dispatches() as log:
        outs = [tsmm.tsmm(a, b), tsmm.tsmm(a3, b3), tsmm.tsmm_t(x, y)]
    torch.cuda.synchronize()
    resolved = [[(lm.kind, lm.splits) for lm in e.launches] for e in log]
    n_reduce = sum(k == "reduce" for r in resolved for k, _ in r)
    errs = [normalised_err(got, want) for got, want in
            zip(outs, (a @ b, a3 @ b3, x.t() @ y))]
    grown = {n: v - before[n] for n, v in counts().items()}
    want = expect(tsm2r_q8=int(paper_s == 1),
                  tsm2r_q8_split=1 + int(paper_s > 1), tsmt_q8_split=1,
                  sum_partials=n_reduce)
    emit({"phase": "dispatch", "quant": "int8", "split": "auto",
          "resolved": resolved, "paper_shape_int8_splits": paper_s,
          "launches": grown, "rel_err_vs_f32": errs})
    check(resolved[0][0] == ("tsm2r_q8", paper_s)
          and resolved[1][0][0] == "tsm2r_q8" and resolved[1][0][1] > 1
          and resolved[2][0][0] == "tsmt_q8" and resolved[2][0][1] > 1,
          f"int8 split=auto dispatch: {resolved}")
    check(grown == want, f"int8 split=auto launches {grown} != {want}")
    check(max(errs) <= Q8_REL_TOL[f32], f"int8 dispatch errors {errs}")
    del a, b, a3, b3, x, y, outs
    torch.cuda.empty_cache()
    return {n: v - first[n] for n, v in counts().items()}


def grad_phase(dev, uniform, gpu) -> None:
    """Autograd through each op on the card (the backward re-dispatches
    through tsmm and its kernels) against autograd through the op's plain
    version; then a directional finite difference of a tsm2l-routed loss
    against a float64 oracle."""
    from repro_torch.core import tsmm
    from repro_torch.kernels import ops, ref

    rtol, atol = TOL[torch.float32]
    atol *= 2.0        # the deepest backward reduction is m = 4096 terms
    for op, sx, sy, sct in [("tsm2r", (4096, 2048), (2048, 8), (4096, 8)),
                            ("tsm2l", (4096, 16), (16, 8), (4096, 8)),
                            ("tsmt", (4096, 32), (4096, 8), (32, 8))]:
        x, y = uniform(sx, torch.float32), uniform(sy, torch.float32)
        ct = uniform(sct, torch.float32)
        grads = []
        for fn in (getattr(ops, op), getattr(ref, f"{op}_ref")):
            xa = x.clone().requires_grad_(True)
            ya = y.clone().requires_grad_(True)
            with tsmm.record_dispatches() as log:
                out = fn(xa, ya)
                out.backward(ct)
            grads.append((out.detach(), xa.grad, ya.grad, log))
        (out, dx, dy, log), (r_out, r_dx, r_dy, _) = grads
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) for a, b in
                ((out, r_out), (dx, r_dx), (dy, r_dy))]
        ok = all(torch.allclose(a, b, rtol=rtol, atol=atol) for a, b in
                 ((out, r_out), (dx, r_dx), (dy, r_dy)))
        routes = [(e.entry, e.kind, e.executor) for e in log]
        emit({"phase": "grad", "op": op, "shapes": [sx, sy],
              "max_err_out_dx_dy": errs, "backward_routes": routes,
              "rtol": rtol, "atol": atol, "ok": ok, "gpu": gpu})
        check(ok, f"grad phase mismatch for {op}: {errs}")
        check(len(routes) == 2 and all(r[2] in ("cuda", "torch-dense")
                                       for r in routes),
              f"grad phase backward routes {routes}")

    m, k, n = 2048, 8, 8
    a, b = uniform((m, k), torch.float32), uniform((k, n), torch.float32)
    direction = uniform((m, k), torch.float32) / m

    def oracle(a64):
        return float(torch.tanh(a64 @ b.double()).sum())

    eps = 1e-2
    fd = (oracle(a.double() + eps * direction.double())
          - oracle(a.double() - eps * direction.double())) / (2 * eps)
    aa = a.clone().requires_grad_(True)
    with tsmm.record_dispatches() as log:
        torch.tanh(tsmm.tsmm(aa, b)).sum().backward()
    analytic = float((aa.grad.double() * direction.double()).sum())
    ok = (log[0].kind == "tsm2l" and log[0].executor == "cuda"
          and abs(analytic - fd) <= 1e-2 * abs(fd))
    emit({"phase": "grad", "op": "finite_difference", "shape": [m, k, n],
          "fd": fd, "analytic": analytic, "rtol": 1e-2, "ok": ok,
          "gpu": gpu})
    check(ok, f"directional finite difference {analytic} vs {fd}")


def train_phase(dev, gpu, counts, zero_counts, quant=False) -> dict:
    """Train chatglm3-6b at its published width with TRAIN_LAYERS layers:
    a dense arm's first step, then the kernel arm's TRAIN_STEPS steps (the
    training main path: counts zeroed before, read after), then one
    profiled step. ``quant``: the train-int8 path, inside
    ``GemmPolicy(quant="int8")`` with int8 PowerSGD. Returns the main
    path's launch counts."""
    import contextlib
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.core import tsmm
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw, powersgd, schedule
    from repro_torch.train import train_step

    cfg = dataclasses.replace(registry.get_config("chatglm3-6b"),
                              n_layers=TRAIN_LAYERS)
    n_micro = cfg.microbatch
    dcfg = pipeline.DataConfig(seed=0, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH,
                               vocab_size=cfg.vocab_size)
    opt = adamw.AdamWConfig(
        lr=schedule.linear_warmup_cosine(3e-3, 20, TRAIN_STEPS),
        weight_decay=0.1)
    ps = powersgd.PowerSGDConfig(rank=4,
                                 compress="int8" if quant else "none")
    pol = tsmm.GemmPolicy(quant="int8") if quant else None
    phase = "train-int8" if quant else "train"
    batches = [{k: torch.from_numpy(v).to(dev, torch.long)
                for k, v in pipeline.batch_for_step(dcfg, i).items()}
               for i in range(TRAIN_STEPS + 1)]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    heads = ("embed.table", "lm_head.table")
    captured = {}

    def make_step(tag):
        def transform(grads, st):
            out, st, met = powersgd.compress_tree(ps, grads, st)
            if tag not in captured:   # the first step's compressed grads
                captured[tag] = {n: out[n].detach().clone() for n in heads}
            return out, st, met
        return train_step.make_train_step(cfg, opt, n_micro=n_micro,
                                          grad_transform=transform)

    def fresh_state():
        state = train_step.init_train_state(0, cfg, opt, device=dev)
        state["extra"] = powersgd.init(ps, state["params"])
        return state

    # The dense arm: the same state and batch as the kernel arm's first
    # step, every GEMM on torch.matmul.
    state = fresh_state()
    with tsmm.policy(mode="dense"), tsmm.record_dispatches() as log:
        _, m = make_step("dense")(state, batches[0])
    check(log and all(e.executor == "torch-dense" for e in log),
          "train dense arm routes")
    dense = {k: float(m[k]) for k in ("loss", "grad_norm")}
    del state, m, log
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = fresh_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in state["params"].parameters())
    check(sorted(state["extra"]) == list(heads),
          f"compressed leaves {sorted(state['extra'])}")
    step = make_step("kernel")
    kv = cfg.n_kv_heads * cfg.resolved_head_dim
    mb_tokens = tokens // n_micro
    per_step_tsm2r = 2 * TRAIN_LAYERS * n_micro + 2
    # PowerSGD's P = G Q of embed and lm_head (f32 gradients): the S the
    # chooser resolves for the kernel arm's scope.
    p_shape = (cfg.vocab_size, cfg.d_model, ps.rank)
    p_splits = ops.resolve_params("tsm2r", *p_shape, torch.float32,
                                  pol or tsmm.GemmPolicy(),
                                  device=dev)["splits"]
    if quant:
        want_step = {n: 0 for n in counts()}
        want_step.update(tsmt_q8_split=2)
        want_step["tsm2r_q8"] = per_step_tsm2r - 2 * (p_splits > 1)
        want_step["tsm2r_q8_split"] = 2 * (p_splits > 1)
    zero_counts()
    step_ms, per_step, records = [], [], []
    for i in range(TRAIN_STEPS):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (tsmm.policy(pol) if pol else contextlib.nullcontext()), \
                tsmm.record_dispatches() as log:
            state, m = step(state, batches[i])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        grown = {n: v - before[n] for n, v in counts().items()}
        per_step.append(grown)
        tsmt_splits = [lm.splits for e in log if e.kind == "tsmt"
                       for lm in e.launches if lm.kind in ("tsmt",
                                                           "tsmt_q8")]
        p_resolved = [lm.splits for e in log
                      if (e.entry, e.shape) == ("mm", p_shape)
                      for lm in e.launches if lm.kind != "reduce"]
        bwd = [e for e in log if (e.entry, e.shape) in {
            ("mm", (mb_tokens, kv, cfg.d_model)),       # da = ct w^T
            ("mmt", (mb_tokens, cfg.d_model, kv))}]     # dw = x^T ct
        rec = {k: float(m[k]) for k in ("loss", "grad_norm", "lr",
                                        "accuracy", "powersgd_compression")}
        rec.update(step=i + 1, step_ok=bool(m["step_ok"]), launches=grown,
                   tsmt_splits=tsmt_splits, p_splits=p_resolved,
                   ms=step_ms[-1])
        records.append(rec)
        check(rec["step_ok"], f"{phase} step {i + 1} not ok: {rec}")
        check(p_resolved == [p_splits, p_splits],
              f"{phase} P projections in step {i + 1}: S={p_resolved}")
        if quant:
            check(grown == want_step,
                  f"train-int8 launches in step {i + 1}: {grown}")
        else:
            check(grown["tsm2r"] == per_step_tsm2r,
                  f"tsm2r launches in step {i + 1}: {grown['tsm2r']}")
            check(grown["tsmt_split"] == 2 and grown["tsmt"] == 0,
                  f"tsmt launches in step {i + 1}: {grown}")
        check(len(tsmt_splits) == 2 and min(tsmt_splits) > 1,
              f"{phase} Q projections in step {i + 1}: S={tsmt_splits}")
        check(len(bwd) == 2 * 2 * TRAIN_LAYERS * n_micro
              and all(e.executor == "torch-dense" for e in bwd),
              f"wk/wv backward routes in step {i + 1}: {len(bwd)}")
        del log, m
    main_train = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    # The main path ends here; what follows checks it and measures it.
    head_err = {n: normalised_err(captured["kernel"][n],
                                  captured["dense"][n]) for n in heads}
    loss_err = abs(records[0]["loss"] - dense["loss"]) / abs(dense["loss"])
    gnorm_err = (abs(records[0]["grad_norm"] - dense["grad_norm"])
                 / dense["grad_norm"])
    head_tol = Q8_GRAD_TOL if quant else LOGIT_TOL
    check(max(head_err.values()) <= head_tol and loss_err <= LOGIT_TOL
          and gnorm_err <= LOGIT_TOL,
          f"{phase} kernel vs dense arm: loss {loss_err} grad norm "
          f"{gnorm_err} compressed grads {head_err}")
    captured.update(kernel=None, dense=None)   # free; capture no more
    with (tsmm.policy(pol) if pol else contextlib.nullcontext()):
        prof = device_profile(lambda: step(state, batches[TRAIN_STEPS]))
    mid_ms = statistics.median(step_ms)
    emit({"phase": phase, "model": cfg.name, "quant": ps.compress, "layers": cfg.n_layers,
          "params": n_params, "dtype": cfg.dtype, "n_micro": n_micro,
          "tokens_per_step": tokens, "init_s": init_s, "steps": records,
          "step_ms": step_ms, "median_step_ms": mid_ms,
          "tokens_per_s": tokens / mid_ms * 1e3, "peak_mem_gb": peak_gb,
          "dense_arm": dense, "dense_arm_loss_err": loss_err,
          "dense_arm_grad_norm_err": gnorm_err,
          "dense_arm_compressed_grad_err": head_err,
          "compressed_grad_tol": head_tol, "p_splits": p_splits,
          "tsm2r_launches_per_step": per_step_tsm2r, "gpu": gpu})
    emit({"phase": "profile", "window": f"{phase} step", **prof,
          "unprofiled_ms": mid_ms,
          "busy_share": prof["device_busy_ms"] / mid_ms, "gpu": gpu})
    del state, batches
    torch.cuda.empty_cache()
    return main_train


SCHEME_BAND = 256   # the JAX ``quantize_param`` default band


def scheme_q8(x, band: int):
    """int8 codes and (bands, 1) f32 scales of a 2-D ``x`` as the JAX
    package forms them (``kernels/quant.py:56``): rows zero-padded to whole
    bands, absmax / 127 per band (1 for an all-zero band), divide, round
    half to even, clip to +-127. Written here apart from the port's
    ``kernels/quant.py`` so the serve-int8 scheme arm does not share it."""
    m = x.shape[0]
    bands = -(-m // band)
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, bands * band - m))
    amax = xf.reshape(bands, -1).abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    codes = (xf / scale.repeat_interleave(band)[:, None]).round()
    return codes.clamp(-127.0, 127.0)[:m].to(torch.int8), scale[:, None]


def scheme_tsm2r(a, b, policy):
    """The JAX int8 TSM2R scheme on ``a @ b``: A per ``SCHEME_BAND``-row
    band, B per tensor, then the plain version's exact integer product
    with the scales folded, in ``a``'s dtype. Stands in for
    ``kernels.ops._tsm2r_impl`` in the serve-int8 scheme arm."""
    from repro_torch.kernels import ref

    a_q, a_s = scheme_q8(a, SCHEME_BAND)
    b_q, b_s = scheme_q8(b, b.shape[0])
    return ref.tsm2r_q8_ref(a_q, b_q, a_s, b_s, SCHEME_BAND, a.dtype)


def serve_int8_phase(dev, gpu, counts, zero_counts, expect) -> dict:
    """Serve chatglm3-6b from int8 weight records under
    ``GemmPolicy(quant="int8")`` (the serve-int8 main path: counts zeroed
    before, read after), then check it against a dense arm on the same
    records and a scheme arm and profile one prefill. Returns the main
    path's launch counts."""
    from repro_torch.configs import registry
    from repro_torch.core import tsmm
    from repro_torch.kernels import ops, quant
    from repro_torch.models import model
    from repro_torch.serve import engine

    cfg = registry.get_config("chatglm3-6b")
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(cfg, seed=0, device=dev)
    dense_bytes = sum(p.numel() * p.element_size()
                      for p in params.parameters())
    qw = quant.quantize_weights(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    kept_bytes = sum(p.numel() * p.element_size()
                     for p in params.parameters())
    seg = "segments.0."
    check(sorted(qw.records) == sorted(
        ["embed.table", "lm_head.table"]
        + [seg + n for n in ("attn.bq", "attn.bk", "attn.bv", "norm1.scale",
                             "norm2.scale")]),
        f"records of {sorted(qw.records)}")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=gen, device=dev)
    pol = tsmm.GemmPolicy(quant="int8")
    per_prefill = 2 * cfg.n_layers
    kv = cfg.n_kv_heads * cfg.resolved_head_dim

    zero_counts()
    with tsmm.record_dispatches() as log:
        t0 = time.perf_counter()
        out = engine.generate(qw, cfg, prompts, NEW, policy=pol, device=dev)
        torch.cuda.synchronize()
        greedy_s = time.perf_counter() - t0
    check(counts() == expect(tsm2r_q8=per_prefill),
          f"serve-int8 launches of one request {counts()}")
    routed = [e for e in log if e.launches]
    check(len(routed) == per_prefill and all(
        e.executor == "cuda" and e.quant == "int8"
        and [lm.kind for lm in e.launches] == ["tsm2r_q8"]
        and e.shape == (BATCH * PROMPT, cfg.d_model, kv) for e in routed),
        f"serve-int8 prefill routes {routed[:2]}")
    decode_events = [e for e in log if e.shape[0] == BATCH]
    check(len(decode_events) == (NEW - 1) * cfg.n_layers * 7 and all(
        e.executor == "torch-dense" for e in decode_events),
        "every int8 decode projection goes to torch-dense")
    check(out.shape == (BATCH, NEW) and bool(
        ((out >= 0) & (out < cfg.vocab_size)).all()),
        f"serve-int8 output {out.shape}")

    prefill_step, decode_step = engine.make_serve_fns(cfg, policy=pol)
    cache = model.init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill_step(qw, {"tokens": prompts}, cache)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for i in range(1, NEW):
        _, cache = decode_step(qw, out[:, i - 1:i], PROMPT + i - 1, cache)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / (NEW - 1)
    del cache
    # The main path ends here; what follows checks it and measures it.
    main = counts()
    check(main == expect(tsm2r_q8=2 * per_prefill),
          f"serve-int8 main path launches {main}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    dense_prefill, _ = engine.make_serve_fns(
        cfg, policy=tsmm.GemmPolicy(mode="dense", quant="int8"))
    with tsmm.record_dispatches() as log:
        dense_logits, _ = dense_prefill(
            qw, {"tokens": prompts},
            model.init_cache(cfg, BATCH, PROMPT, device=dev))
    check(all(e.executor == "torch-dense" for e in log),
          "serve-int8 dense arm routes")
    dense_err = normalised_err(logits, dense_logits)
    check(dense_err <= Q8_GRAD_TOL, f"serve-int8 vs dense arm {dense_err}")
    # The scheme arm: the same routing, every wk/wv product taken by
    # scheme_tsm2r instead of ops.py's quantization and the kernel (no
    # launch, so nothing is counted). Equal bits show that ops.py applies
    # the JAX scheme and the kernel equals its plain version at every
    # prefill launch: the dense arm's distance is the scheme's own.
    impl = ops._tsm2r_impl
    ops._tsm2r_impl = scheme_tsm2r
    try:
        scheme_logits, _ = prefill_step(
            qw, {"tokens": prompts},
            model.init_cache(cfg, BATCH, PROMPT, device=dev))
    finally:
        ops._tsm2r_impl = impl
    scheme_err = normalised_err(logits, scheme_logits)
    check(torch.equal(logits, scheme_logits),
          f"serve-int8 vs scheme arm {scheme_err}")
    emit({"phase": "serve-int8", "model": cfg.name, "dtype": cfg.dtype,
          "batch": BATCH, "prompt": PROMPT, "new": NEW, "init_s": init_s,
          "records": sorted(qw.records), "records_bytes": qw.nbytes(),
          "dense_bytes_replaced": dense_bytes - kept_bytes,
          "param_bytes_dense": dense_bytes,
          "prefill_ms": prefill_ms,
          "prefill_tokens_per_s": BATCH * PROMPT / prefill_ms * 1e3,
          "decode_ms_per_step": decode_ms,
          "decode_tokens_per_s": BATCH / decode_ms * 1e3,
          "greedy_request_s": greedy_s,
          "tsm2r_q8_launches_per_prefill": per_prefill,
          "dense_arm_err": dense_err, "dense_arm_tol": Q8_GRAD_TOL,
          "scheme_arm_err": scheme_err,
          "scheme_arm_dense_err": normalised_err(scheme_logits,
                                                 dense_logits),
          "peak_mem_gb": peak_gb, "gpu": gpu})
    cache = model.init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
    rec = device_profile(
        lambda: prefill_step(qw, {"tokens": prompts}, cache))
    emit({"phase": "profile", "window": "int8 prefill", **rec,
          "unprofiled_ms": prefill_ms,
          "busy_share": rec["device_busy_ms"] / prefill_ms, "gpu": gpu})
    del qw, params, cache, prompts, out, logits, dense_logits, scheme_logits
    torch.cuda.empty_cache()
    return main


def profile_serve(engine, model, params, cfg, prompts, out, dev, step_ms,
                  gpu) -> None:
    """Trace one prefill and two decode steps with ``torch.profiler`` and
    print, per window, the device time by kernel and by category and the
    device's busy share of the same work's unprofiled time."""
    prefill_step, decode_step = engine.make_serve_fns(cfg)
    for window in ("prefill", "decode"):
        cache = model.init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
        if window == "decode":
            _, cache = prefill_step(params, {"tokens": prompts}, cache)
        torch.cuda.synchronize()
        if window == "prefill":
            rec = device_profile(
                lambda: prefill_step(params, {"tokens": prompts}, cache))
        else:
            rec = device_profile(lambda: [
                decode_step(params, out[:, i - 1:i], PROMPT + i - 1, cache)
                for i in (1, 2)])
        emit({"phase": "profile", "window": window, **rec,
              "unprofiled_ms": step_ms[window],
              "busy_share": rec["device_busy_ms"] / step_ms[window],
              "gpu": gpu})
        del cache


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import registry
    from repro_torch.core import tsmm
    from repro_torch.core import perf_model
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import reduce as k_reduce
    from repro_torch.kernels import tsm2l as k_tsm2l
    from repro_torch.kernels import tsm2r as k_tsm2r
    from repro_torch.kernels import tsmt as k_tsmt
    from repro_torch.models import model
    from repro_torch.serve import engine

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gpu = card()

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": secs, "nvcc": _build.nvcc()})
    print(gpu, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    emit({"phase": "precision",
          "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul.allow_bf16_reduced_precision_reduction":
              torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # -- 2. kernels against their plain versions ---------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def uniform(shape, dtype):
        x = torch.rand(shape, generator=gen, device=dev) * 2 - 1
        return x.to(dtype)

    kernels = {     # the sequential kernels' wrappers: no split resolution
        "tsm2r": (k_tsm2r.tsm2r, ref.tsm2r_ref, torch.matmul, "mm"),
        "tsm2l": (k_tsm2l.tsm2l, ref.tsm2l_ref, torch.matmul, "mm"),
        "tsmt": (k_tsmt.tsmt, ref.tsmt_ref,
                 lambda x, y: torch.matmul(x.t(), y), "mmt"),
    }
    # (m, d1, d2): tsm2r/tsm2l (m, k, n); tsmt (m, a, b). Besides the main
    # path's and the paper's shapes: ragged m, k, n and n = 1, and for
    # tsm2l a k past the resident B tile (B staged chunk by chunk).
    cases = {
        "tsm2r": [(8192, 4096, 256), (4096, 4096, 256), (65024, 4096, 4),
                  (16384, 16384, 16), (1000, 777, 16), (4096, 4096, 8),
                  (512, 512, 1)],
        "tsm2l": [(1 << 20, 16, 16), (102400, 4, 4), (10000, 300, 20),
                  (5000, 77, 1)],
        "tsmt": [(1 << 20, 128, 4), (65536, 256, 256), (65536, 128, 4),
                 (10000, 300, 20), (4099, 100, 1),
                 (1000, 100, 3)],       # short m: plans S = 1
    }
    # The shape and dtype each kernel meets on the main path.
    main_case = {"tsm2r": ((8192, 4096, 256), torch.bfloat16),
                 "tsm2l": ((102400, 4, 4), torch.float32),
                 "tsmt": ((65536, 128, 4), torch.float32)}
    # tsm2r on the training path: wk/wv forward of a 4096-token microbatch
    # (bf16) and PowerSGD's P = G Q of embed and lm_head (f32).
    train_cases = {"tsm2r": [((4096, 4096, 256), torch.bfloat16),
                             ((65024, 4096, 4), torch.float32)]}
    measured, at_train, bad = {}, {}, []
    for name, (kern, plain, library, entry) in kernels.items():
        for m, d1, d2 in cases[name]:
            for dtype in (torch.float32, torch.bfloat16):
                if entry == "mm":
                    x, y = uniform((m, d1), dtype), uniform((d1, d2), dtype)
                else:
                    x, y = uniform((m, d1), dtype), uniform((m, d2), dtype)
                got = kern(x, y)
                again = kern(x, y)
                torch.cuda.synchronize()
                want = plain(x, y)
                depth = d1 if entry == "mm" else m
                rtol, atol = TOL[dtype]
                if dtype == torch.float32:
                    atol *= max(1.0, (depth / 1024) ** 0.5)
                err = (got.float() - want.float()).abs()
                same = torch.equal(got, again)
                ok = same and bool(
                    (err <= atol + rtol * want.float().abs()).all())
                b_ms, b_by = bound(x, y, got, 2 * m * d1 * d2)
                rec = {"phase": "kernel", "kernel": name,
                       "shape": [m, d1, d2], "dtype": str(dtype)[6:],
                       "kernel_ms": time_ms(lambda: kern(x, y)),
                       "plain_ms": time_ms(lambda: plain(x, y)),
                       "library_ms": time_ms(lambda: library(x, y)),
                       "bound_ms": b_ms, "bound_by": b_by,
                       "max_err": float(err.max()), "rtol": rtol,
                       "atol": atol, "deterministic": same, "ok": ok,
                       "gpu": gpu}
                if name == "tsmt":
                    rec.update(tsmt_plan_check(x, y, got, dtype))
                    rec["ok"] = ok = ok and rec["bits_vs_split_sum"]
                is_main = main_case[name] == ((m, d1, d2), dtype)
                is_train = ((m, d1, d2), dtype) in train_cases.get(name, ())
                if is_main or is_train:
                    rec["device_ms"] = device_ms(lambda: kern(x, y), name)
                    rec["call_device_ms"] = call_device_ms(
                        lambda: kern(x, y))
                    rec["library_device_ms"] = call_device_ms(
                        lambda: library(x, y))
                emit(rec)
                if not ok:
                    bad.append(f"{name} {m}x{d1}x{d2} {dtype}")
                if is_main:
                    measured[name] = rec
                if is_train:
                    at_train.setdefault(name, []).append(rec)
                del x, y, got, again, want, err
    torch.cuda.empty_cache()
    check(not bad, f"kernel phase mismatch in {bad}")
    measured.update(split_kernel_phase(dev, uniform, gpu))
    q8_measured, q8_at_train = q8_kernel_phase(dev, uniform, gpu)
    measured.update(q8_measured)
    at_train.update(q8_at_train)
    # The one-launch TSMTs spread one output tile over the card, and do
    # so fast enough to beat one block per tile by far.
    for name in ("tsmt", "tsmt_q8"):
        rec = measured[name]
        check(rec["plan_splits"] > 1 and rec["device_ms"] <= TSMT_MAX_MS,
              f"{name} at {rec['shape']}: S = {rec['plan_splits']}, "
              f"{rec['device_ms']} ms on the device")
    tsmt_sweep(dev, uniform, gpu)

    # -- 3. dispatch (its own path: counts zeroed before, read after) ------
    counters = {"tsm2r": (k_tsm2r, "launches"),
                "tsm2l": (k_tsm2l, "launches"),
                "tsmt": (k_tsmt, "launches"),
                "tsm2r_split": (k_tsm2r, "split_launches"),
                "tsmt_split": (k_tsmt, "split_launches"),
                "sum_partials": (k_reduce, "launches"),
                "tsm2r_q8": (k_tsm2r, "q8_launches"),
                "tsm2l_q8": (k_tsm2l, "q8_launches"),
                "tsmt_q8": (k_tsmt, "q8_launches"),
                "tsm2r_q8_split": (k_tsm2r, "q8_split_launches"),
                "tsmt_q8_split": (k_tsmt, "q8_split_launches")}

    def counts():
        return {n: getattr(mod, attr) for n, (mod, attr) in counters.items()}

    def zero_counts():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def expect(**nonzero):
        return {n: nonzero.get(n, 0) for n in counters}

    zero_counts()
    a, b = uniform((4096, 4096), torch.float32), uniform((4096, 8),
                                                         torch.float32)
    a2, b2 = uniform((102400, 4), torch.float32), uniform((4, 4),
                                                          torch.float32)
    a4 = uniform((8, 512, 4), torch.float32)
    x, y = uniform((65536, 128), torch.float32), uniform((65536, 4),
                                                         torch.float32)
    with tsmm.policy(split="never"), tsmm.record_dispatches() as log:
        outs = [tsmm.tsmm(a, b), tsmm.tsmm(a2, b2), tsmm.tsmm(a4, b2),
                tsmm.tsmm_t(x, y)]
    torch.cuda.synchronize()
    wants = [ref.tsm2r_ref(a, b), ref.tsm2l_ref(a2, b2),
             ref.tsm2l_ref(a4.reshape(-1, 4), b2).reshape(8, 512, 4),
             ref.tsmt_ref(x, y)]
    kinds = [(e.kind, e.executor) for e in log]
    check(kinds == [("tsm2r", "cuda"), ("tsm2l", "cuda"), ("tsm2l", "cuda"),
                    ("tsmt", "cuda")], f"dispatch routes {kinds}")
    # The sequential tsmt's record shows the grid it runs: its own plan.
    plan_s = k_tsmt._plan(65536, 128, 4, dev, torch.float32)[0]
    tsmt_launch = log[3].launches[0]
    check(plan_s > 1 and tsmt_launch.grid == (1, 1, plan_s)
          and tsmt_launch.splits == 1, f"sequential tsmt launch record "
          f"{tsmt_launch} against the plan's S = {plan_s}")
    for got, want in zip(outs, wants):
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)
    grown = counts()
    check(grown == expect(tsm2r=1, tsm2l=2, tsmt=1),
          f"dispatch launches {grown}")
    emit({"phase": "dispatch", "routes": kinds, "launches": grown,
          "tsmt_grid": tsmt_launch.grid})
    del a, b, a2, b2, a4, x, y, outs, wants

    # Split-K: "auto" splits the paper's TSM2R (128 row tiles) and
    # PowerSGD's TSMT (32 output tiles); "never" keeps them sequential.
    a, b = uniform((16384, 16384), torch.float32), uniform((16384, 16),
                                                           torch.float32)
    x, y = uniform((65024, 4096), torch.float32), uniform((65024, 4),
                                                          torch.float32)
    for split in ("auto", "never"):
        before = counts()
        with tsmm.policy(split=split), tsmm.record_dispatches() as log:
            outs = [tsmm.tsmm(a, b), tsmm.tsmm_t(x, y)]
        torch.cuda.synchronize()
        grown = {n: v - before[n] for n, v in counts().items()}
        resolved = [[(lm.kind, lm.splits) for lm in e.launches] for e in log]
        if split == "auto":
            ok = (grown == expect(tsm2r_split=1, tsmt_split=1,
                                sum_partials=1)
                  and resolved[0][0][1] > 1 and resolved[1][0][1] > 1
                  and resolved[0][-1][0] == "reduce")
        else:
            ok = grown == expect(tsm2r=1, tsmt=1)
        emit({"phase": "dispatch", "split": split, "resolved": resolved,
              "launches": grown})
        check(ok, f"split={split} dispatch: {resolved} {grown}")
        for got, ref_out in zip(outs, (ref.tsm2r_ref(a, b),
                                       ref.tsmt_ref(x, y))):
            rtol, atol = TOL[torch.float32]
            torch.testing.assert_close(got, ref_out, rtol=rtol,
                                       atol=atol * 8)   # 16384-65024 terms
    del a, b, x, y, outs
    mirror = {}
    tsm2r_shapes = [(16384, 16384, 16), (8192, 4096, 256), (1000, 777, 17),
                    (4096, 4096, 1), (4096, 65536, 16)]
    tsmt_shapes = [(65024, 4096, 4), (1 << 20, 128, 4), (65536, 256, 256),
                   (10000, 300, 20), (4099, 100, 5)]
    for name, grid_fn, shapes in [
            ("tsm2r_split", perf_model.tsm2r_grid, tsm2r_shapes),
            ("tsmt_split", perf_model.tsmt_grid, tsmt_shapes),
            ("tsm2r_q8_split", perf_model.tsm2r_grid, tsm2r_shapes),
            ("tsmt_q8_split", perf_model.tsmt_grid, tsmt_shapes)]:
        for shape in shapes:
            for splits in (1, 8):
                c_grid = _build.grid(name, *shape, splits)
                mirror[f"{name}{list(shape)}S{splits}"] = c_grid
                check(c_grid == grid_fn(*shape, splits),
                      f"tile mirror {name} {shape}: C {c_grid} vs Python "
                      f"{grid_fn(*shape, splits)}")
    emit({"phase": "dispatch", "tile_grids_match_c_query": mirror})
    q8_launched = q8_dispatch(dev, uniform, counts, expect)
    dispatch_launches = counts()
    base = expect(tsm2r=2, tsm2l=2, tsmt=2, tsm2r_split=1, tsmt_split=1,
                  sum_partials=1)
    check(dispatch_launches == {n: base[n] + q8_launched[n] for n in base},
          f"dispatch path launches {dispatch_launches}")

    # -- 4. serve chatglm3-6b (the serving main path) ----------------------
    zero_counts()
    cfg = registry.get_config("chatglm3-6b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=gen, device=dev)
    per_prefill = 2 * cfg.n_layers
    kv = cfg.n_kv_heads * cfg.resolved_head_dim

    before = k_tsm2r.launches
    with tsmm.record_dispatches() as log:
        t0 = time.perf_counter()
        out = engine.generate(params, cfg, prompts, NEW, device=dev)
        torch.cuda.synchronize()
        greedy_s = time.perf_counter() - t0
    check(k_tsm2r.launches - before == per_prefill,
          f"tsm2r launches per prefill {k_tsm2r.launches - before}")
    routed = [e for e in log if e.kind == "tsm2r"]
    check(len(routed) == per_prefill and all(
        e.executor == "cuda" and e.shape == (BATCH * PROMPT, cfg.d_model, kv)
        for e in routed), f"prefill tsm2r routes {routed[:2]}")
    decode_events = [e for e in log if e.shape[0] == BATCH]
    check(len(decode_events) == (NEW - 1) * cfg.n_layers * 7 and all(
        e.executor == "torch-dense" for e in decode_events),
        "every decode projection goes to torch-dense")
    check(out.shape == (BATCH, NEW), f"greedy output shape {out.shape}")

    sampler = torch.Generator(device=dev).manual_seed(2)
    sampled = engine.generate(params, cfg, prompts, NEW, generator=sampler,
                              temperature=1.0, device=dev)
    check(sampled.shape == (BATCH, NEW) and bool(
        ((sampled >= 0) & (sampled < cfg.vocab_size)).all()),
        "sampled tokens in vocabulary")

    # Step by step through the serve functions, for times and logits.
    prefill_step, decode_step = engine.make_serve_fns(cfg)
    cache = model.init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
    before = k_tsm2r.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, {"tokens": prompts}, cache)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    check(k_tsm2r.launches - before == per_prefill, "prefill_step launches")
    step_logits = [logits]
    t0 = time.perf_counter()
    for i in range(1, NEW):
        logits, cache = decode_step(params, out[:, i - 1:i], PROMPT + i - 1,
                                    cache)
        step_logits.append(logits)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / (NEW - 1)
    del cache
    # The main path ends here; what follows only checks it.
    serve_launches = counts()
    check(serve_launches == expect(tsm2r=3 * per_prefill),
          f"serving main path launches {serve_launches}")

    dense_prefill, _ = engine.make_serve_fns(
        cfg, policy=tsmm.GemmPolicy(mode="dense"))
    with tsmm.record_dispatches() as log:
        dense_logits, _ = dense_prefill(
            params, {"tokens": prompts},
            model.init_cache(cfg, BATCH, PROMPT, device=dev))
    check(all(e.executor == "torch-dense" for e in log), "dense arm routes")
    dense_err = normalised_err(step_logits[0], dense_logits)
    check(dense_err <= LOGIT_TOL, f"kernel vs dense arm error {dense_err}")

    full = torch.cat([prompts, out[:, :-1]], dim=1)
    before = k_tsm2r.launches
    forced, _ = model.forward(params, cfg, {"tokens": full})
    check(k_tsm2r.launches - before == per_prefill, "forward launches")
    forward_err = max(normalised_err(step_logits[i], forced[:, PROMPT - 1 + i])
                      for i in range(NEW))
    check(forward_err <= LOGIT_TOL, f"decode vs forward error {forward_err}")
    greedy_agree = sum(int((torch.argmax(step_logits[i], -1) == out[:, i])
                           .sum()) for i in range(NEW))
    emit({"phase": "serve", "model": cfg.name, "params": n_params,
          "dtype": cfg.dtype, "batch": BATCH, "prompt": PROMPT, "new": NEW,
          "init_s": init_s, "prefill_ms": prefill_ms,
          "prefill_tokens_per_s": BATCH * PROMPT / prefill_ms * 1e3,
          "decode_ms_per_step": decode_ms,
          "decode_tokens_per_s": BATCH / decode_ms * 1e3,
          "greedy_request_s": greedy_s,
          "tsm2r_launches_per_prefill": per_prefill,
          "dense_arm_err": dense_err, "decode_vs_forward_err": forward_err,
          "greedy_argmax_agree": f"{greedy_agree}/{BATCH * NEW}",
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
          "gpu": gpu})
    profile_serve(engine, model, params, cfg, prompts, out, dev,
                  {"prefill": prefill_ms, "decode": 2 * decode_ms}, gpu)
    del params, prompts, out, step_logits, dense_logits, forced, full
    torch.cuda.empty_cache()

    # -- 5. serve chatglm3-6b from int8 records (the serve-int8 path) ------
    serve8_launches = serve_int8_phase(dev, gpu, counts, zero_counts, expect)

    # -- 6. grad -----------------------------------------------------------
    grad_phase(dev, uniform, gpu)

    # -- 7. train chatglm3-6b (the training main path) ---------------------
    train_launches = train_phase(dev, gpu, counts, zero_counts)
    for name in ("tsm2r", "tsmt_split"):
        check(train_launches[name] > 0,
              f"{name} was not launched on the training main path")

    # -- 8. train chatglm3-6b under int8 (the train-int8 path) -------------
    train8_launches = train_phase(dev, gpu, counts, zero_counts, quant=True)
    for name in ("tsm2r_q8", "tsmt_q8_split"):
        check(train8_launches[name] > 0,
              f"{name} was not launched on the train-int8 main path")

    # -- 9. kernels line ---------------------------------------------------
    replaces = {"tsm2r": "src/repro/kernels/tsm2r.py:62",
                "tsm2l": "src/repro/kernels/tsm2l.py:48",
                "tsmt": "src/repro/kernels/tsmt.py:63",
                "tsm2r_split": "src/repro/kernels/tsm2r.py:112",
                "tsmt_split": "src/repro/kernels/tsmt.py:115",
                "sum_partials": "src/repro/kernels/reduce.py:45",
                "tsm2r_q8": "src/repro/kernels/quant.py:192",
                "tsm2r_q8_split": "src/repro/kernels/quant.py:254",
                "tsm2l_q8": "src/repro/kernels/quant.py:318",
                "tsmt_q8": "src/repro/kernels/quant.py:387",
                "tsmt_q8_split": "src/repro/kernels/quant.py:448"}
    paths = {"dispatch": dispatch_launches, "serve": serve_launches,
             "train": train_launches, "serve_int8": serve8_launches,
             "train_int8": train8_launches}
    sources = {"sum_partials": "reduce"}
    line = []
    for name in counters:
        rec = measured[name]
        check(dispatch_launches[name] > 0,
              f"{name} was not launched on the dispatch path")
        line.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      f"{sources.get(name, name)}.cu",
            "replaces": replaces[name],
            "launches": sum(c[name] for c in paths.values()),
            **{f"launches_{p}": c[name] for p, c in paths.items()},
            "max_abs_err": rec["max_err"], "ms": rec["kernel_ms"],
            "device_ms": rec["device_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "library_dq_ms": rec.get("library_dq_ms"),
            "library_device_ms": rec["library_device_ms"],
            "shape": rec["shape"], "dtype": rec["dtype"],
            "splits": rec.get("plan_splits", rec.get("splits", 1)),
            "at_train_shapes": [{
                "shape": r["shape"], "dtype": r["dtype"],
                "max_abs_err": r["max_err"], "ms": r["kernel_ms"],
                "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "library_dq_ms": r.get("library_dq_ms"),
                "library_device_ms": r["library_device_ms"]}
                for r in at_train.get(name, ())]})
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
