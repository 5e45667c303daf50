"""deepseek-v3-671b [moe]: MLA + 1 shared / 256 routed top-8 experts.

61L d_model=7168 128H d_ff(expert)=2048 vocab=129280 [arXiv:2412.19437].
The same numbers as ``src/repro/configs/deepseek_v3_671b.py``. First 3
layers dense (d_ff=18432); sigmoid router with aux-loss-free bias; routed
output scaled 2.5. MLA: q_lora 1536, kv_lora 512, rope 64 -- the
low-rank projections are TSM2X dispatch shapes (``wkr``, the rope key's
``[T, 7168]·[7168, 64]``, classifies TSM2R).

MTP (multi-token prediction) is not implemented, as in the reference.
"""

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=18432,
    vocab_size=129280, head_dim=128,
    mla=MLAConfig(q_lora=1536, kv_lora=512, nope_dim=128, rope_dim=64,
                  v_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1,
                  d_ff_shared=2048, router="sigmoid", capacity_factor=1.25,
                  routed_scale=2.5),
    first_k_dense=3,
    dtype="bfloat16", microbatch=4,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-smoke", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
        vocab_size=256, head_dim=16,
        mla=MLAConfig(q_lora=32, kv_lora=16, nope_dim=16, rope_dim=8, v_dim=16),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32, n_shared=1,
                      d_ff_shared=32, router="sigmoid", routed_scale=2.5,
                      capacity_factor=8.0),   # drop-free for smoke determinism
        first_k_dense=1,
        q_chunk=16, kv_chunk=16, dtype="float32",
    )
