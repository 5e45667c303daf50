"""K-means on the card through tall-and-skinny GEMM: the paper's
motivating application (Section 1: "recent highly optimized K-means
implementations use GEMM as their core computation ... mostly
tall-and-skinny").

Distance expansion: ||x - c||^2 = ||x||^2 - 2 x.c + ||c||^2; the x.c term
is X[n_points, d] @ C^T[d, k_clusters] with k_clusters << n_points -- a
tall-and-skinny shape served by ``repro_torch.core.tsmm`` (TSM2L at d <=
256, where the contraction is tiny; TSM2R past it).

    PYTHONPATH=src python examples/torch/kmeans.py               # the card
    PYTHONPATH=src python examples/torch/kmeans.py --device cpu --n 20000

The port of ``examples/kmeans.py``; ``make_blobs``, ``kmeans_step`` and
``kmeanspp_init`` import.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import tsmm

N, D, K, ITERS = 200_000, 64, 8, 10


def make_blobs(gen, n=N, d=D, k=K, device=None):
    dev = device or gen.device
    centers = torch.randn(k, d, generator=gen, device=dev) * 5.0
    pts = [centers[i] + torch.randn(n // k, d, generator=gen, device=dev)
           for i in range(k)]
    return torch.cat(pts), centers


def _distances(x, centroids):
    # (N, D) @ (D, K), K skinny: TSM2L at D = 64
    dots = tsmm.tsmm(x, centroids.t())
    return ((x * x).sum(1, keepdim=True) - 2 * dots
            + (centroids * centroids).sum(1)[None, :])


def kmeans_step(x, centroids):
    d2 = _distances(x, centroids)
    assign = torch.argmin(d2, dim=1)
    # centroid update is a segment mean: one-hot^T @ x is ALSO tall-skinny
    # (N huge, K skinny) -- the TSMT orientation.
    onehot = torch.nn.functional.one_hot(assign, centroids.shape[0]).to(
        x.dtype)
    sums = tsmm.tsmm_t(x, onehot).t()        # (K, D)
    counts = onehot.sum(0)[:, None]
    new_c = sums / torch.clamp(counts, min=1)
    inertia = torch.gather(d2, 1, assign[:, None]).sum()
    return new_c, assign, inertia


def _pp_farthest(x, centers, n_filled):
    """One k-means++ pass at the FIXED (N, D) @ (D, K) shape: unfilled
    center rows are masked out of the min instead of sliced off, so every
    pass launches the same kernel plan."""
    d2 = _distances(x, centers)
    k = centers.shape[0]
    filled = torch.arange(k, device=x.device)[None, :] < n_filled
    d2 = torch.where(filled, d2, torch.inf)
    return torch.argmax(d2.min(dim=1).values)


def kmeanspp_init(gen, x, k=K):
    """k-means++ seeding (farthest point): each min-distance pass is itself
    a tall-and-skinny product, on centers padded to the full (K, D) width
    up front."""
    idx = int(torch.randint(0, x.shape[0], (), generator=gen,
                            device=gen.device))
    centers = torch.zeros(k, x.shape[1], dtype=x.dtype, device=x.device)
    centers[0] = x[idx]
    for i in range(1, k):
        centers[i] = x[_pp_farthest(x, centers, i)]
    return centers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="examples/torch/kmeans.py")
    ap.add_argument("--n", type=int, default=N, help="points")
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    x, true_centers = make_blobs(gen, args.n)
    t0 = time.perf_counter()
    # naive random init almost never covers all blobs (8!/8^8 ~ 0.2%);
    # k-means++ does -- and its distance pass is another skinny product.
    with torch.no_grad():
        centroids = kmeanspp_init(gen, x)
        for i in range(ITERS):
            centroids, assign, inertia = kmeans_step(x, centroids)
            if i % 3 == 0 or i == ITERS - 1:
                print(f"iter {i}: inertia {float(inertia):.4e}")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{ITERS} iters in {time.perf_counter() - t0:.2f}s on {name}")
    # the recovered centers match the generating ones (up to permutation)
    d = np.linalg.norm(true_centers.cpu().numpy()[:, None]
                       - centroids.cpu().numpy()[None], axis=-1)
    match = d.min(axis=1)
    print(f"center recovery error: max {match.max():.3f} (should be < 0.5)")
    assert match.max() < 0.5
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
