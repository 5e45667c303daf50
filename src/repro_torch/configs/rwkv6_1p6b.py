"""rwkv6-1.6b [ssm]: Finch -- attention-free, data-dependent decay.

24L d_model=2048 d_ff=7168 vocab=65536 [arXiv:2404.05892]. 32 heads of
dim 64; the decay LoRA (rank 64) is a TSM2X dispatch shape. O(1) decode
state => long_500k runs natively. The same numbers as
``src/repro/configs/rwkv6_1p6b.py``.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.models.rwkv6 import RWKV6Config

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=7168,
    vocab_size=65536, head_dim=64, norm="ln",
    rwkv=RWKV6Config(n_heads=32, head_dim=64, decay_lora_rank=64, chunk=32),
    dtype="bfloat16", microbatch=4,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, head_dim=16, norm="ln",
        rwkv=RWKV6Config(n_heads=4, head_dim=16, decay_lora_rank=8, chunk=8),
        q_chunk=16, kv_chunk=16, dtype="float32",
    )
