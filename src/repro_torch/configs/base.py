"""Model configuration dataclass.

The port's own copy of ``src/repro/configs/base.py::ModelConfig``, with the
fields of the dense family this package serves. The sub-configs of the
other families (MoE, MLA, Mamba2, RWKV6, vision, audio) and the remat
knobs arrive with the slices that port those modules.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense (the one family ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # attention
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0     # chatglm3: 0.5 (partial/'2d' RoPE)
    qkv_bias: bool = False
    attn_window: Optional[int] = None
    causal: bool = True
    norm: str = "rms"
    # ffn
    mlp_type: str = "swiglu"
    # misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "float32"
    q_chunk: int = 512
    kv_chunk: int = 512
    microbatch: int = 0            # number of grad-accumulation microbatches

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads
