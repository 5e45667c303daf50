"""Batched serving example of the port: prefill a batch of prompts, decode
with greedy and temperature sampling, and check the KV-cache path against
the full forward (the correctness invariant behind the decode and long
context cells).

    PYTHONPATH=src python examples/torch/serve_lm.py --arch mixtral-8x7b
    PYTHONPATH=src python examples/torch/serve_lm.py --device cpu

The port of ``examples/serve_lm.py``. At its default sizes (4 prompts of
24 tokens) every projection of the smoke models is too short for the
TSM2X kernels and runs dense; from 2,048 prompt tokens
(``--prompt-len 512``) the prefill's projections reach them.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.models import model
from repro_torch.serve import engine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="examples/torch/serve_lm.py")
    ap.add_argument("--arch", default="llama3.2-3b",
                    choices=[a for a in registry.ARCH_NAMES
                             if a != "hubert-xlarge"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cpu to serve on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = registry.get_config(args.arch, smoke=True)
    params = model.init(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    extras = None
    if cfg.family == "vlm":
        extras = {"image_embeds": torch.randn(
            args.batch, cfg.vision_seq, cfg.vision_dim, generator=gen,
            device=dev)}

    with torch.no_grad():
        t0 = time.perf_counter()
        out_greedy = engine.generate(params, cfg, prompts, args.max_new,
                                     extras=extras, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        out_sampled = engine.generate(
            params, cfg, prompts, args.max_new, temperature=0.8,
            extras=extras, device=dev,
            generator=torch.Generator(device=dev).manual_seed(7))
        print(f"[serve] {args.arch} batch={args.batch} "
              f"prompt={args.prompt_len} new={args.max_new}")
        print(f"  greedy tokens[0]: {out_greedy[0].cpu().numpy()}")
        print(f"  sampled tokens[0]: {out_sampled[0].cpu().numpy()}")
        print(f"  prefill+decode wall: {t1 - t0:.2f}s "
              f"({args.batch * args.max_new / (t1 - t0):.1f} tok/s)")

        # correctness: greedy continuation == argmax over the
        # teacher-forced full forward at each position
        full_tokens = torch.cat([prompts, out_greedy], dim=1)
        batch = {"tokens": full_tokens, **(extras or {})}
        logits, _ = model.forward(params, cfg, batch)
        for t in range(args.max_new):
            pos = args.prompt_len + t - 1
            expect = torch.argmax(logits[:, pos], -1)
            np.testing.assert_array_equal(out_greedy[:, t].cpu().numpy(),
                                          expect.cpu().numpy())
    print("  KV-cache decode == teacher-forced forward: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
