"""Quickstart: the TSM2X public API of the PyTorch / CUDA port in a minute.

    PYTHONPATH=src python examples/torch/quickstart.py              # the card
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu

Shows: shape-dispatched tall-and-skinny matmul (the paper's TSM2R/TSM2L),
the transposed TSMT extension, batched N-d operands, the scoped GemmPolicy
(the dense A/B arm), the performance model's bound classifier and split
chooser, and each kernel against its plain version. The port of
``examples/quickstart.py``: the reference pins its Pallas kernels to
interpret mode for the CPU; the port sets nothing, since a CPU tensor
runs each kernel's plain version and a CUDA tensor the kernel.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import perf_model, tsmm
from repro_torch.kernels import ref


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="examples/torch/quickstart.py")
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def close(got, want, rtol, atol):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=rtol, atol=atol)

    # --- Paper case (i): large regular x tall-and-skinny (TSM2R) ----------
    a, b = normal(4096, 4096), normal(4096, 8)
    c = tsmm.tsmm(a, b)                     # dispatches to the TSM2R kernel
    # atol 1e-4 x sqrt(k / 1024): on the card two f32 sums of 4,096 terms
    # taken in different orders differ by that near zero (chip_smoke.py
    # holds the kernels to the same rule); on the CPU both sides are one
    # torch.matmul.
    close(c, ref.tsm2r_ref(a, b), 1e-3, 2e-4)
    print(f"TSM2R 4096x4096 @ 4096x8 -> {tuple(c.shape)}, "
          f"kind={tsmm.classify_gemm(4096, 4096, 8)}, "
          f"bound={perf_model.classify(4096, 4096, 8)}")

    # --- Paper case (ii): tall-and-skinny x small square (TSM2L) ----------
    a2, b2 = normal(102400, 4), normal(4, 4)
    c2 = tsmm.tsmm(a2, b2)
    close(c2, ref.tsm2l_ref(a2, b2), 1e-3, 1e-4)
    print(f"TSM2L 102400x4 @ 4x4 -> {tuple(c2.shape)}, "
          f"bound={perf_model.classify(102400, 4, 4)}  (the paper's latency "
          "case)")

    # --- Beyond the paper: transposed reduction over huge m (TSMT) --------
    x, y = normal(65536, 128), normal(65536, 4)
    q = tsmm.tsmm_t(x, y)                   # X^T Y without materializing X^T
    close(q, x.t() @ y, 1e-3, 1e-3)
    print(f"TSMT  (65536x128)^T @ 65536x4 -> {tuple(q.shape)}  "
          "(PowerSGD/ABFT shape)")

    # --- Batched N-d operands: tsmm owns the leading-dim collapse ---------
    a4 = normal(8, 512, 4)                  # (batch, m, k)
    c4 = tsmm.tsmm(a4, b2)                  # -> (8, 512, 4)
    close(c4, torch.einsum("bmk,kn->bmn", a4, b2), 1e-3, 1e-3)
    print(f"batched {tuple(a4.shape)} @ {tuple(b2.shape)} -> "
          f"{tuple(c4.shape)} (classified on the collapsed tall dim)")

    # --- GemmPolicy: every dispatch knob, lexically scoped ----------------
    with tsmm.policy(mode="dense"):         # the A/B escape hatch
        c_dense = tsmm.tsmm(a2, b2)
    close(c_dense, c2, 1e-3, 1e-3)
    # The reference switches TPU generations here (spec=V5P); the port
    # plans for the card its operands lie on, and the bound class moves
    # with the operand dtype instead.
    print(f"bound for 20480^2 x n=200: bf16 "
          f"{tsmm.bound_class(20480, 20480, 200, torch.bfloat16)} "
          f"(f32: {tsmm.bound_class(20480, 20480, 200, torch.float32)})")
    with tsmm.record_dispatches() as log:   # the dispatch spy
        tsmm.tsmm(a, b)
    print(f"dispatch spy: {log[0].kind} via {log[0].executor} "
          f"for shape {log[0].shape}")

    # --- The performance model that drives the split choice ---------------
    s = perf_model.choose_splits_tsm2r(20480, 20480, 16)
    t = perf_model.tsm2r_model_time(20480, 20480, 16, splits=s)
    util = (perf_model.tsm2r_model_bytes(20480, 20480, 16, splits=s)
            / (perf_model.H100.hbm_bw * t))
    print(f"h100 params for 20480^2 x n=16: block_k="
          f"{perf_model.TSM2R_BLOCK_K} splits={s}, modeled bw util="
          f"{util:.1%}")
    print(f"t2_threshold(h100, bf16) = {perf_model.t2_threshold():.0f} "
          "(paper: all n<=32 cases sit below it => memory-bound)")
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
