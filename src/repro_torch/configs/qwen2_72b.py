"""qwen2-72b [dense]: large dense model with QKV bias.

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064 [arXiv:2407.10671].
The same numbers as ``src/repro/configs/qwen2_72b.py``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab_size=152064, head_dim=128,
    rope_theta=1000000.0, qkv_bias=True,
    dtype="bfloat16", microbatch=8,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192,
        vocab_size=256, head_dim=16, qkv_bias=True,
        q_chunk=16, kv_chunk=16, dtype="float32",
    )
