"""mistral-nemo-12b [dense]: 128k-context dense model.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072
[hf:mistralai/Mistral-Nemo-Base-2407]. head_dim=128 (not d_model/n_heads).
The same numbers as ``src/repro/configs/mistral_nemo_12b.py``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=131072, head_dim=128,
    rope_theta=1000000.0,
    dtype="bfloat16", microbatch=4,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=32,   # head_dim != d_model/n_heads, as in full
        q_chunk=16, kv_chunk=16, dtype="float32",
    )
