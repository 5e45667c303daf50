"""Model and run configuration dataclasses.

The port's own copy of ``src/repro/configs/base.py`` (``ModelConfig``
:28, ``param_count`` :85, ``active_param_count`` :122, ``ShapeConfig``
and ``SHAPES`` :133-146), with the fields of the families this package
serves: dense ``attn_mlp``, RWKV6 (``family="ssm"``) and the zamba2
hybrid (Mamba2 with a weight-shared attention block). The sub-configs of
the other families (MoE, MLA, vision, audio) arrive with the slices that
port those modules, and ``remat_group`` (remat of several layers as one)
with the first config that sets it past 1.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.models.mamba2 import Mamba2Config
from repro_torch.models.rwkv6 import RWKV6Config


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | ssm (rwkv6) | hybrid (zamba2):
                                   # the ported ones
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
    qkv_bias: bool = False         # qwen2: True
    attn_window: Optional[int] = None
    causal: bool = True
    norm: str = "rms"              # rms|ln
    # ffn
    mlp_type: str = "swiglu"
    # ssm / hybrid
    ssm: Optional[Mamba2Config] = None
    rwkv: Optional[RWKV6Config] = None
    hybrid_period: int = 0         # zamba2: shared attn block every N mamba layers
    shared_lora_rank: int = 0      # zamba2: per-application LoRA rank
    # misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "float32"
    q_chunk: int = 512
    kv_chunk: int = 512
    remat: bool = True             # checkpoint each layer under autograd
    microbatch: int = 0            # number of grad-accumulation microbatches

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND roofline math), the
        reference's formulas for the dense, RWKV6 and Mamba2 branches."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd = self.resolved_head_dim
        total = v * d * (1 if self.tie_embeddings else 2)
        if self.rwkv is not None:
            per = 5 * d * d + 2 * d * self.rwkv.decay_lora_rank + d * self.d_ff + \
                d * self.d_ff + d * d
            return total + L * per
        if self.ssm is not None:
            di = self.ssm.d_inner
            per_m = d * (2 * di + 2 * self.ssm.n_groups * self.ssm.state_dim
                         + self.ssm.n_heads) + di * d
            n_shared = (L // self.hybrid_period) if self.hybrid_period else 0
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            shared = attn + 3 * d * f if n_shared else 0
            return total + L * per_m + shared
        if self.family != "dense":
            raise NotImplementedError(
                f"{self.name}: param_count of family {self.family!r} arrives "
                "with its modules (ported: dense, ssm, hybrid)")
        per_attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        ff_mult = 3 if self.mlp_type == "swiglu" else 2
        return total + L * (per_attn + ff_mult * d * f)

    def active_param_count(self) -> int:
        """Params touched per token: all of them for the ported families
        (the reference subtracts the unrouted experts of an MoE)."""
        return self.param_count()


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str                      # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
