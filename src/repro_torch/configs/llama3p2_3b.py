"""llama3.2-3b [dense]: small llama3 with GQA and tied embeddings.

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256
[hf:meta-llama/Llama-3.2-3B].
The same numbers as ``src/repro/configs/llama3p2_3b.py``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, d_ff=8192,
    vocab_size=128256, head_dim=128,
    rope_theta=500000.0, tie_embeddings=True,
    dtype="bfloat16", microbatch=4,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=16, rope_theta=500000.0, tie_embeddings=True,
        q_chunk=16, kv_chunk=16, dtype="float32",
    )
