"""Architecture registry: ``--arch <id>`` resolution.

Knows the architectures ported so far; the JAX package's other archs
(``src/repro/configs/registry.py``) join as their modules are ported.
"""

from __future__ import annotations

from repro_torch.configs import chatglm3_6b
from repro_torch.configs.base import ModelConfig

_MODULES = {
    "chatglm3-6b": chatglm3_6b,
}

ARCH_NAMES = list(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"arch {name!r} is not ported yet: known archs are "
                       f"{', '.join(ARCH_NAMES)}")
    mod = _MODULES[name]
    return mod.smoke() if smoke else mod.CONFIG
