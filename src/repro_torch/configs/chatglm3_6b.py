"""chatglm3-6b [dense]: GQA kv=2, partial ('2d') RoPE, SwiGLU.

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024 [arXiv:2406.12793].
ChatGLM rotates only half of each head dim (rope_fraction=0.5) and carries
QKV bias. The same numbers as ``src/repro/configs/chatglm3_6b.py``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab_size=65024, head_dim=128,
    rope_fraction=0.5, qkv_bias=True,
    dtype="bfloat16", microbatch=4,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=16, rope_fraction=0.5, qkv_bias=True,
        q_chunk=16, kv_chunk=16, dtype="float32",
    )
