#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Runs from a checkout of the repository (it puts ``src`` on ``sys.path``
itself), imports neither JAX nor the JAX package, and exits non-zero,
printing no result, when no CUDA card is present or any phase fails.

1. Build: every kernel from ``src/repro_torch/kernels/csrc/`` (one nvcc per
   source, all started together); prints the build time, the card's name
   and power limit, and the matmul precision flags (TF32 and reduced
   precision bf16 reductions off, so the plain versions are exact f32 sums).
2. Kernels: each kernel against its plain version on the card, f32 and
   bf16, at the chatglm3, paper and ragged shapes; one JSON line per case
   with the kernel's, the plain version's and one ``torch.matmul``'s median
   time (CUDA events), the bound, and the worst error. Each kernel must
   also give bit-identical results on a second launch. Tolerances are the
   JAX kernel tests' (f32 rtol=1e-3, atol=1e-4; bf16 rtol=atol=2e-2). Those
   were set for reductions of up to ~2048 terms; for a deeper f32 reduction
   atol grows by sqrt(depth / 1024), because the rounding error of an f32
   sum grows as the square root of its length, and two correct sums taken
   in different orders differ by that much near zero. bf16 keeps 2e-2 as
   it is: both sides round their f32 sums to bf16, and one bf16 step is at
   most 2^-7 of the value.
3. Dispatch (the main path starts; every launch count is set to 0 just
   before it): the quickstart's shapes through ``tsmm``/``tsmm_t`` must
   route to tsm2r, tsm2l and tsmt on executor ``cuda``.
4. Serve (main path): chatglm3-6b at its published width and depth, bf16,
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
5. A ``{"kernels": [...]}`` line: every ported kernel with its launches on
   the main path and its numbers at the main path's shape and dtype.
6. Last line: ``{"ok": true, "device": {...}}``.
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
              torch.float32: 67e12}              # f32 outside tensor cores
TOL = {torch.float32: (1e-3, 1e-4), torch.bfloat16: (2e-2, 2e-2)}
LOGIT_TOL = 5e-2
BATCH, PROMPT, NEW = 4, 2048, 16


def emit(obj) -> None:
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


def bound(x, y, out, flops):
    nbytes = sum(t.numel() * t.element_size() for t in (x, y, out))
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


def profile_serve(engine, model, params, cfg, prompts, out, dev, step_ms,
                  gpu) -> None:
    """Trace one prefill and two decode steps with ``torch.profiler`` and
    print, per window, the device time by kernel and by category and the
    device's busy share of the same work's unprofiled time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def category(name):
        for kern in ("tsm2r", "tsm2l", "tsmt"):
            if f"{kern}_kernel" in name:
                return kern
        if any(w in name for w in ("gemm", "gemv", "xmma", "cutlass",
                                   "nvjet")):
            return "library GEMM"
        return "other"

    prefill_step, decode_step = engine.make_serve_fns(cfg)
    for window in ("prefill", "decode"):
        cache = model.init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
        if window == "decode":
            _, cache = prefill_step(params, {"tokens": prompts}, cache)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if window == "prefill":
                prefill_step(params, {"tokens": prompts}, cache)
            else:
                for i in (1, 2):
                    decode_step(params, out[:, i - 1:i], PROMPT + i - 1,
                                cache)
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
        busy_ms = sum(by_kernel.values()) / 1e3
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
        emit({"phase": "profile", "window": window,
              "device_busy_ms": busy_ms, "device_kernels": n_kernels,
              "unprofiled_ms": step_ms[window],
              "busy_share": busy_ms / step_ms[window],
              "by_category_ms": {k: v / 1e3 for k, v in sorted(
                  by_cat.items(), key=lambda kv: -kv[1])},
              "top_kernels_ms": [[n[:90], v / 1e3] for n, v in top],
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
    from repro_torch.kernels import _build, ops, ref
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

    kernels = {
        "tsm2r": (ops.tsm2r, ref.tsm2r_ref, torch.matmul, "mm"),
        "tsm2l": (ops.tsm2l, ref.tsm2l_ref, torch.matmul, "mm"),
        "tsmt": (ops.tsmt, ref.tsmt_ref,
                 lambda x, y: torch.matmul(x.t(), y), "mmt"),
    }
    # (m, d1, d2): tsm2r/tsm2l (m, k, n); tsmt (m, a, b). Besides the main
    # path's and the paper's shapes: ragged m, k, n and n = 1, and for
    # tsm2l a k past the resident B tile (B staged chunk by chunk).
    cases = {
        "tsm2r": [(8192, 4096, 256), (16384, 16384, 16), (1000, 777, 16),
                  (4096, 4096, 8), (512, 512, 1)],
        "tsm2l": [(1 << 20, 16, 16), (102400, 4, 4), (10000, 300, 20),
                  (5000, 77, 1)],
        "tsmt": [(1 << 20, 128, 4), (65536, 256, 256), (65536, 128, 4),
                 (10000, 300, 20), (4099, 100, 1)],
    }
    # The shape and dtype each kernel meets on the main path.
    main_case = {"tsm2r": ((8192, 4096, 256), torch.bfloat16),
                 "tsm2l": ((102400, 4, 4), torch.float32),
                 "tsmt": ((65536, 128, 4), torch.float32)}
    measured, bad = {}, []
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
                emit(rec)
                if not ok:
                    bad.append(f"{name} {m}x{d1}x{d2} {dtype}")
                if main_case[name] == ((m, d1, d2), dtype):
                    measured[name] = rec
                del x, y, got, again, want, err
    torch.cuda.empty_cache()
    check(not bad, f"kernel phase mismatch in {bad}")

    # -- 3. dispatch (main path starts: counts zeroed) ---------------------
    counters = {"tsm2r": k_tsm2r, "tsm2l": k_tsm2l, "tsmt": k_tsmt}
    for mod in counters.values():
        mod.launches = 0
    a, b = uniform((4096, 4096), torch.float32), uniform((4096, 8),
                                                         torch.float32)
    a2, b2 = uniform((102400, 4), torch.float32), uniform((4, 4),
                                                          torch.float32)
    a4 = uniform((8, 512, 4), torch.float32)
    x, y = uniform((65536, 128), torch.float32), uniform((65536, 4),
                                                         torch.float32)
    with tsmm.record_dispatches() as log:
        outs = [tsmm.tsmm(a, b), tsmm.tsmm(a2, b2), tsmm.tsmm(a4, b2),
                tsmm.tsmm_t(x, y)]
    torch.cuda.synchronize()
    wants = [ref.tsm2r_ref(a, b), ref.tsm2l_ref(a2, b2),
             ref.tsm2l_ref(a4.reshape(-1, 4), b2).reshape(8, 512, 4),
             ref.tsmt_ref(x, y)]
    kinds = [(e.kind, e.executor) for e in log]
    check(kinds == [("tsm2r", "cuda"), ("tsm2l", "cuda"), ("tsm2l", "cuda"),
                    ("tsmt", "cuda")], f"dispatch routes {kinds}")
    for got, want in zip(outs, wants):
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)
    grown = {n: mod.launches for n, mod in counters.items()}
    check(grown == {"tsm2r": 1, "tsm2l": 2, "tsmt": 1},
          f"dispatch launches {grown}")
    emit({"phase": "dispatch", "routes": kinds, "launches": grown})
    del a, b, a2, b2, a4, x, y, outs, wants

    # -- 4. serve chatglm3-6b (main path continues) ------------------------
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
    main_launches = {n: mod.launches for n, mod in counters.items()}
    check(main_launches == {"tsm2r": 1 + 3 * per_prefill, "tsm2l": 2,
                            "tsmt": 1}, f"main path launches {main_launches}")

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

    # -- 5. kernels line ---------------------------------------------------
    replaces = {"tsm2r": "src/repro/kernels/tsm2r.py:62",
                "tsm2l": "src/repro/kernels/tsm2l.py:48",
                "tsmt": "src/repro/kernels/tsmt.py:63"}
    line = []
    for name in counters:
        rec = measured[name]
        check(main_launches[name] > 0,
              f"{name} was not launched on the main path")
        line.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": replaces[name], "launches": main_launches[name],
            "max_abs_err": rec["max_err"], "ms": rec["kernel_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": rec["shape"], "dtype": rec["dtype"]})
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
