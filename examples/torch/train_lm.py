"""End-to-end training example of the port: train a llama-style model on the
synthetic pipeline, with checkpointing, the watchdog and ABFT: the
production loop of ``repro_torch.launch.train``.

The default runs the llama3.2-3b smoke config so the example completes in
minutes; ``--full-100m`` takes the ~100M-parameter configuration (the same
code path; size the steps to the hardware):

    PYTHONPATH=src python examples/torch/train_lm.py               # the card
    PYTHONPATH=src python examples/torch/train_lm.py --device cpu --steps 5
    PYTHONPATH=src python examples/torch/train_lm.py --full-100m --steps 300

The port of ``examples/train_lm.py``. Checkpoints go to ``--ckpt-dir``,
by default a temporary directory removed at the end. A checkpoint and an
offline ABFT check every 40 steps, or at the last step of a shorter run.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import train as train_launcher


def config_100m() -> ModelConfig:
    # ~100M params: 12L x d512 x ffn 2048, 16k vocab
    return ModelConfig(
        name="llama-100m", family="dense", n_layers=12, d_model=512,
        n_heads=8, n_kv_heads=4, d_ff=2048, vocab_size=16384, head_dim=64,
        tie_embeddings=True, q_chunk=128, kv_chunk=128, dtype="float32")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="examples/torch/train_lm.py")
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cpu to train on the CPU (default: the card)")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="repro_train_") as tmp:
        ckpt = args.ckpt_dir or tmp
        if args.full_100m:
            cfg = config_100m()
            print(f"[example] llama-100m: {cfg.param_count() / 1e6:.1f}M "
                  "params")
            # register ad hoc so the launcher can resolve it
            registry._MODULES["llama-100m"] = type(
                "M", (), {"CONFIG": cfg, "smoke": staticmethod(lambda: cfg)})
            steps, every = args.steps or 300, 50
            argv = ["--arch", "llama-100m", "--global-batch", "8",
                    "--seq-len", str(args.seq_len or 256), "--lr", "1e-3"]
        else:
            steps, every = args.steps or 120, 40
            argv = ["--arch", "llama3.2-3b", "--smoke", "--global-batch",
                    "8", "--seq-len", str(args.seq_len or 64), "--lr",
                    "3e-3"]
        every = min(every, steps)
        argv += ["--steps", str(steps), "--ckpt-dir", ckpt,
                 "--ckpt-every", str(every), "--abft-every", str(every)]
        if args.device is not None:
            argv += ["--device", args.device]
        print(f"[example] launching: train {' '.join(argv)}")
        train_launcher.main(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
