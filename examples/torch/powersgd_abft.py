"""The paper's kernels at work inside the port's distributed-training
substrate:

1. PowerSGD gradient compression: both projections are tall-and-skinny
   GEMMs (TSM2R + TSMT); shows the wire-byte reduction of a data-parallel
   all-reduce and the error-feedback recovery property.
2. ABFT checksums: encode and verify a parameter tree, corrupt one value,
   watch it get caught (the paper's own motivating application).

    PYTHONPATH=src python examples/torch/powersgd_abft.py              # card
    PYTHONPATH=src python examples/torch/powersgd_abft.py --device cpu

The port of ``examples/powersgd_abft.py``. The reference runs under
``GemmPolicy(interpret=True)`` to pin its Pallas kernels to their Python
bodies on the CPU; the port sets no policy: a CPU tensor runs each
kernel's plain version, a CUDA tensor the kernel.
"""

from __future__ import annotations

import argparse
import sys

import torch

from repro_torch import resolve_device
from repro_torch.ft import abft
from repro_torch.optim import powersgd


def spectral_grad(gen, d1, d2, dev, decay=0.5):
    """Gradients in practice have fast-decaying spectra: synthesize one."""
    u = torch.randn(d1, 32, generator=gen, device=dev)
    v = torch.randn(32, d2, generator=gen, device=dev)
    scales = decay ** torch.arange(32, device=dev, dtype=torch.float32)
    return (u * scales) @ v * 0.01


def fake_psum(x):   # MEAN over a 2-replica DP group with identical grads
    return (x + x) / 2.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="examples/torch/powersgd_abft.py")
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain versions (default: the card)")
    ap.add_argument("--d", type=int, default=2048,
                    help="the model width (the MLP is d x 4d)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    d = args.d

    # --- PowerSGD ---------------------------------------------------------
    grads = {"mlp.w_up": spectral_grad(gen, d, 4 * d, dev),
             "mlp.w_down": spectral_grad(gen, 4 * d, d, dev),
             "norm.scale": torch.ones(d, device=dev)}
    # The state is keyed by the parameters' names: a module holding
    # tensors of the gradients' shapes names them.
    holder = torch.nn.Module()
    for path, g in grads.items():
        owner, leaf = path.split(".")
        if not hasattr(holder, owner):
            holder.add_module(owner, torch.nn.Module())
        getattr(holder, owner).register_parameter(
            leaf, torch.nn.Parameter(torch.empty_like(g)))
    cfg = powersgd.PowerSGDConfig(rank=4, min_size=0)
    state = powersgd.init(cfg, holder, seed=2)
    out, state, metrics = powersgd.compress_tree(cfg, grads, state,
                                                 psum=fake_psum)
    dense_bytes = sum(g.numel() * 4 for g in grads.values())
    ratio = metrics["powersgd_compression"]
    print(f"PowerSGD rank-4: compression ratio {ratio:.1f}x "
          f"({dense_bytes / 1e6:.1f} MB dense all-reduce -> "
          f"{dense_bytes / ratio / 1e6:.2f} MB)")
    rel = float(torch.linalg.vector_norm(out["mlp.w_up"] - grads["mlp.w_up"])
                / torch.linalg.vector_norm(grads["mlp.w_up"]))
    print(f"  round-1 relative error {rel:.3f} on a decaying-spectrum "
          "gradient (error feedback replays any residual next step)")

    # --- ABFT -------------------------------------------------------------
    params = {"w": torch.randn(2 * d, d // 2, generator=gen, device=dev)}
    cs = abft.encode_tree(params)
    ok, _ = abft.verify_tree(params, cs)
    print(f"ABFT clean verify: {bool(ok)}")
    corrupt = {"w": params["w"].clone()}
    corrupt["w"][1234 % (2 * d), 56 % (d // 2)] += 1.0   # one changed value
    ok2, _ = abft.verify_tree(corrupt, cs)
    print(f"ABFT after single-element corruption: detected={not bool(ok2)}")
    assert bool(ok) and not bool(ok2)
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
