#!/usr/bin/env python3
"""Time a model's plain serve steps under two source trees of the port,
in one run on one card, each tree in processes of its own.

    python3 scripts/torch_serve_time_ab.py --arch zamba2-1.2b \\
        --tree parent=build/parent --tree change=. \\
        --order parent,change,change,parent

Each run imports ``repro_torch`` from ``<tree>/src`` in a fresh process,
builds the config's model at its registered width and depth from seed 0
on the card, and serves 4 x 2048 prompt tokens through
``engine.make_serve_fns``: the prefill under ``GemmPolicy(mode="dense")``
(every projection a library GEMM, so no kernel is built; a decode
step's projections are dense in any case), then 15 cached decode steps
of seeded tokens, host clock, one synchronize after the prefill and one
after the last step, as ``chip_smoke.py``'s serve phases time them. That
is repeated ``--reps`` times in the process. Each run prints one JSON
line; the last line holds each tree's median prefill ms and decode ms a
step over its runs, with the card's name and power limit. Runs go in
``--order``: alternate the trees (A, B, B, A) so that a drift of the card
falls on both.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

BATCH, PROMPT, NEW = 4, 2048, 16


def child(arch: str, reps: int) -> dict:
    import torch

    from repro_torch.configs import registry
    from repro_torch.core import tsmm
    from repro_torch.models import model
    from repro_torch.serve import engine

    dev = torch.device("cuda")
    cfg = registry.get_config(arch)
    params = model.init(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=gen, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, NEW), generator=gen,
                           device=dev)
    prefill_step, _ = engine.make_serve_fns(
        cfg, policy=tsmm.GemmPolicy(mode="dense"))
    _, decode_step = engine.make_serve_fns(cfg)
    prefill, decode = [], []
    for _ in range(reps + 1):
        cache = model.init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = prefill_step(params, {"tokens": prompts}, cache)
        torch.cuda.synchronize()
        prefill.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        for i in range(1, NEW):
            _, cache = decode_step(params, tokens[:, i - 1:i],
                                   PROMPT + i - 1, cache)
        torch.cuda.synchronize()
        decode.append((time.perf_counter() - t0) * 1e3 / (NEW - 1))
        del cache
    # the first repetition warms the allocator and the library's plans
    return {"prefill_ms": prefill[1:], "decode_ms_per_step": decode[1:],
            "torch": torch.__version__}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=PATH of a checkout of the repository")
    ap.add_argument("--order", default=None,
                    help="comma-separated tree names (default A,B,B,A)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.arch, args.reps)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_serve_time_ab: no CUDA device", file=sys.stderr)
        return 2
    trees = dict(t.split("=", 1) for t in args.tree)
    if len(trees) < 2:
        ap.error("give two --tree NAME=PATH")
    names = list(trees)
    order = (args.order.split(",") if args.order
             else [names[0], names[1], names[1], names[0]])
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]
    runs = {n: {"prefill_ms": [], "decode_ms_per_step": []} for n in names}
    for name in order:
        src = str(Path(trees[name]).resolve() / "src")
        env = dict(os.environ, PYTHONPATH=src)
        out = subprocess.run(
            [sys.executable, __file__, "--child", "--arch", args.arch,
             "--reps", str(args.reps)], env=env, capture_output=True,
            text=True, check=False)
        if out.returncode:
            sys.stderr.write(out.stderr)
            return out.returncode
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": name, "arch": args.arch, **rec,
                          "gpu": gpu}))
        for k in runs[name]:
            runs[name][k] += rec[k]
    print(json.dumps({"arch": args.arch, "batch": BATCH, "prompt": PROMPT,
                      "order": order, "gpu": gpu, "median": {
                          n: {k: statistics.median(v) for k, v in r.items()}
                          for n, r in runs.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
