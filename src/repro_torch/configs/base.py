"""Model and run configuration dataclasses.

The port's own copy of ``src/repro/configs/base.py`` (``MLAConfig`` :20,
``ModelConfig`` :28, ``param_count`` :85, ``active_param_count`` :122,
``ShapeConfig`` and ``SHAPES`` :133-146), with the fields of the families
this package serves: dense ``attn_mlp``, the MoE family (mixtral's routed
experts beside sliding-window attention, deepseek-v3's MLA with dense
first layers), RWKV6 (``family="ssm"``), the zamba2 hybrid (Mamba2 with a
weight-shared attention block), the vision family (llama-3.2-vision:
a gated cross-attention layer to image embeddings every
``cross_attn_period`` layers) and the audio encoder (hubert: frame
input, bidirectional attention, a GELU MLP). ``remat_group`` (remat of
several layers as one) arrives with the first config that sets it past
1.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.models.mamba2 import Mamba2Config
from repro_torch.models.moe import MoEConfig
from repro_torch.models.rwkv6 import RWKV6Config


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora: int = 1536
    kv_lora: int = 512
    nope_dim: int = 128
    rope_dim: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense|moe|ssm|hybrid|vlm|audio
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
    attn_window: Optional[int] = None  # mixtral SWA: 4096
    causal: bool = True            # hubert: False (encoder-only)
    norm: str = "rms"              # rms|ln
    mla: Optional[MLAConfig] = None
    mla_absorb: bool = True        # absorbed latent decode (W_uk/W_uv folded)
    # ffn
    mlp_type: str = "swiglu"       # swiglu|gelu
    moe: Optional[MoEConfig] = None
    first_k_dense: int = 0         # deepseek-v3: 3
    # ssm / hybrid
    ssm: Optional[Mamba2Config] = None
    rwkv: Optional[RWKV6Config] = None
    hybrid_period: int = 0         # zamba2: shared attn block every N mamba layers
    shared_lora_rank: int = 0      # zamba2: per-application LoRA rank
    # vlm
    cross_attn_period: int = 0     # llama3.2-vision: every 5th layer
    vision_seq: int = 0
    vision_dim: int = 0
    # audio (stub frontend: precomputed frame embeddings)
    input_mode: str = "tokens"     # tokens|frames
    frame_dim: int = 0
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
        reference's formulas."""
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
        if self.mla is not None:
            m = self.mla
            per_attn = d * m.q_lora + m.q_lora * self.n_heads * (m.nope_dim + m.rope_dim) \
                + d * m.kv_lora + m.kv_lora * self.n_heads * (m.nope_dim + m.v_dim) \
                + d * m.rope_dim + self.n_heads * m.v_dim * d
        else:
            per_attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.moe is not None:
            e = self.moe
            per_moe = 3 * d * e.d_ff_expert * e.n_experts + d * e.n_experts
            if e.n_shared:
                per_moe += 3 * d * (e.d_ff_shared or e.d_ff_expert * e.n_shared)
            n_moe = L - self.first_k_dense
            n_dense = self.first_k_dense
            ff = 3 * d * f
            return total + L * per_attn + n_moe * per_moe + n_dense * ff
        ff_mult = 3 if self.mlp_type == "swiglu" else 2
        return total + L * (per_attn + ff_mult * d * f)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        d, L = self.d_model, self.n_layers
        full_experts = 3 * d * e.d_ff_expert * e.n_experts
        active = 3 * d * e.d_ff_expert * e.top_k
        n_moe = L - self.first_k_dense
        return self.param_count() - n_moe * (full_experts - active)


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
