"""PyTorch / CUDA port of the TSM2X system for the NVIDIA H100.

The JAX package ``repro`` beside it is the reference; this package imports
neither it nor JAX. Entry points run on the card unless the caller passes
``device="cpu"``: with no card and no explicit device they raise.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    current CUDA device. Raises when no device is given and no card is
    present, so nothing quietly runs on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' to run on the "
            "CPU explicitly")
    return torch.device("cuda", torch.cuda.current_device())
