"""zamba2-1.2b [hybrid]: Mamba2 backbone + weight-shared attention block.

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64
[arXiv:2411.15242]. The shared attention + MLP block is applied after
every 6 Mamba2 layers with a per-application LoRA (rank 128): the LoRA's
down projection ``[T,2048]·[2048,128]`` is a TSM2X dispatch shape. The
same numbers as ``src/repro/configs/zamba2_1p2b.py``.
"""

from repro_torch.configs.base import ModelConfig
from repro_torch.models.mamba2 import Mamba2Config

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32000, head_dim=64,
    ssm=Mamba2Config(d_inner=4096, n_heads=64, state_dim=64, n_groups=1,
                     chunk=128),
    hybrid_period=6, shared_lora_rank=128,
    dtype="bfloat16", microbatch=8,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, head_dim=16,
        ssm=Mamba2Config(d_inner=128, n_heads=4, state_dim=8, n_groups=1,
                         chunk=8),
        hybrid_period=2, shared_lora_rank=8,
        q_chunk=16, kv_chunk=16, dtype="float32",
    )
