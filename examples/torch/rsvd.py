"""Randomized SVD (Halko-Martinsson-Tropp) on the port's TSM2X paths: the
sketching workload the QR subsystem unlocks.

Every heavy product in the algorithm is tall-and-skinny over the row
dimension of A (n_rows >> n_cols >> rank):

    Y  = A @ Omega            # (n, d) @ (d, k)    -- TSM2L (tiny contraction)
    Q  = tsqr(Y)              # CholeskyQR2: Gram=TSMT, apply=TSM2L
    Z  = A^T @ Q              # huge-m reduction    -- TSMT
    Y' = A @ Z                # power iteration     -- TSM2L
    B  = Q^T A  (= Z^T)       # small (k, d)
    U_b, s, V^T = svd(B)      # host-shaped
    U  = Q @ U_b              # (n, k) @ (k, k)     -- TSM2L

so the whole factorization runs through ``tsmm`` and the only dense
decompositions left are (k, d)- and (r, r)-shaped.

    PYTHONPATH=src python examples/torch/rsvd.py               # the card
    PYTHONPATH=src python examples/torch/rsvd.py --device cpu --n 20000

The port of ``examples/rsvd.py``; ``make_low_rank`` and ``rsvd`` import.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import linalg, resolve_device
from repro_torch.core import tsmm

N, D, RANK, OVERSAMPLE, POWER_ITERS = 200_000, 256, 8, 8, 2


def make_low_rank(gen, n=N, d=D, rank=RANK, noise=1e-3, device=None):
    """A = U diag(s) V^T + noise, with a known spectrum to recover."""
    dev = device or gen.device
    u, _ = torch.linalg.qr(torch.randn(n, rank, generator=gen, device=dev))
    v, _ = torch.linalg.qr(torch.randn(d, rank, generator=gen, device=dev))
    s = torch.tensor(np.geomspace(100.0, 1.0, rank), dtype=torch.float32,
                     device=dev)
    a = (u * s) @ v.t() + noise * torch.randn(n, d, generator=gen,
                                              device=dev)
    return a, s


def rsvd(gen, a, rank, *, oversample=OVERSAMPLE, power_iters=POWER_ITERS):
    """Rank-``rank`` randomized SVD of tall ``a``; returns (U, s, Vt)."""
    k = rank + oversample
    omega = torch.randn(a.shape[1], k, generator=gen, device=a.device,
                        dtype=a.dtype)
    y = tsmm.tsmm(a, omega)                       # TSM2L
    q, _ = linalg.tsqr(y)
    for _ in range(power_iters):                  # subspace iteration
        z = tsmm.tsmm_t(a, q)                     # TSMT: A^T Q, (d, k)
        y = tsmm.tsmm(a, z)                       # TSM2L: A (A^T Q)
        q, _ = linalg.tsqr(y)
    b = tsmm.tsmm_t(a, q).t()                     # (k, d) = Q^T A
    u_b, s, vt = torch.linalg.svd(b, full_matrices=False)
    u = tsmm.tsmm(q, u_b)                         # TSM2L back-projection
    return u[:, :rank], s[:rank], vt[:rank]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="examples/torch/rsvd.py")
    ap.add_argument("--n", type=int, default=N, help="rows of A")
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    a, s_true = make_low_rank(gen, args.n)
    t0 = time.perf_counter()
    with torch.no_grad():
        u, s, vt = rsvd(gen, a, RANK)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"rsvd of {tuple(a.shape)} rank {RANK} in "
          f"{time.perf_counter() - t0:.2f}s on {name}")
    # Weyl: the noise term moves each singular value by at most ||E||_2
    # ~ noise * (sqrt(n) + sqrt(D)); recovery is good if we sit inside it.
    noise_floor = 1e-3 * (args.n ** 0.5 + D ** 0.5)
    s_err = float((s - s_true).abs().max())
    print(f"singular values:  {s.cpu().numpy().round(2)}")
    print(f"max sv error: {s_err:.2e} (noise floor {noise_floor:.2e})")
    eye = torch.eye(RANK, device=dev)
    orth = float((u.t() @ u - eye).abs().max())
    rec = float(torch.linalg.norm((u * s) @ vt - a) / torch.linalg.norm(a))
    print(f"basis orthogonality: {orth:.2e}; reconstruction residual "
          f"(noise floor): {rec:.2e}")
    assert s_err < noise_floor and orth < 1e-4
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
