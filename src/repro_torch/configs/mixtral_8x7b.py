"""mixtral-8x7b [moe]: 8 experts top-2 + sliding-window attention.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000 [arXiv:2401.04088].
The same numbers as ``src/repro/configs/mixtral_8x7b.py``. SWA window
4096 => ring KV cache bounds decode memory, making long_500k runnable
(window-bounded).
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, head_dim=128,
    rope_theta=1000000.0, attn_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336, router="softmax",
                  capacity_factor=1.25),
    dtype="bfloat16", microbatch=4,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=16, attn_window=16,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64, router="softmax",
                      capacity_factor=8.0),   # drop-free for smoke determinism
        q_chunk=16, kv_chunk=16, dtype="float32",
    )
