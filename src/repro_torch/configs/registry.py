"""Architecture registry: ``--arch <id>`` resolution + shape skip matrix.

Knows the architectures ported so far; the JAX package's other archs
(``src/repro/configs/registry.py``) join as their modules are ported.
``cell_supported`` and the two sets it reads are the reference's, so a
cell of a ported arch is skipped for the same reason in both packages.
"""

from __future__ import annotations

from repro_torch.configs import (chatglm3_6b, deepseek_v3_671b, llama3p2_3b,
                                 mistral_nemo_12b, mixtral_8x7b, qwen2_72b,
                                 rwkv6_1p6b, zamba2_1p2b)
from repro_torch.configs.base import SHAPES, ModelConfig

_MODULES = {
    "zamba2-1.2b": zamba2_1p2b,
    "chatglm3-6b": chatglm3_6b,
    "llama3.2-3b": llama3p2_3b,
    "mistral-nemo-12b": mistral_nemo_12b,
    "qwen2-72b": qwen2_72b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "mixtral-8x7b": mixtral_8x7b,
    "rwkv6-1.6b": rwkv6_1p6b,
}

ARCH_NAMES = list(_MODULES)

# long_500k needs sub-quadratic attention: runnable for SSM/hybrid/SWA.
_LONG_OK = {"zamba2-1.2b", "rwkv6-1.6b", "mixtral-8x7b"}
# encoder-only: no autoregressive decode at all.
_ENCODER_ONLY = {"hubert-xlarge"}


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"arch {name!r} is not ported yet: known archs are "
                       f"{', '.join(ARCH_NAMES)}")
    mod = _MODULES[name]
    return mod.smoke() if smoke else mod.CONFIG


def cell_supported(arch: str, shape: str) -> tuple[bool, str]:
    """Skip matrix per DESIGN.md. Returns (supported, reason-if-not)."""
    sc = SHAPES[shape]
    if arch in _ENCODER_ONLY and sc.kind == "decode":
        return False, "encoder-only: no autoregressive decode"
    if shape == "long_500k" and arch not in _LONG_OK:
        return False, "pure full-attention arch: 500k KV decode excluded (needs sub-quadratic attention)"
    return True, ""


def all_cells(include_skipped: bool = False):
    for arch in ARCH_NAMES:
        for shape in SHAPES:
            ok, reason = cell_supported(arch, shape)
            if ok or include_skipped:
                yield arch, shape, ok, reason
