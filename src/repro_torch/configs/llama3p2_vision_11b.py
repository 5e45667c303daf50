"""llama-3.2-vision-11b [vlm]: text backbone with gated cross-attention
layers to image patch embeddings.

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256
[hf:meta-llama/Llama-3.2-11B-Vision]. A gated cross-attention layer
after every 4 self-attention layers (8 in all). The vision frontend is
a stub, as in the JAX package: the batch carries precomputed patch
embeddings under ``"image_embeds"`` (1601 tokens x 4096, one tile). The
same numbers as ``src/repro/configs/llama3p2_vision_11b.py``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=128256, head_dim=128,
    rope_theta=500000.0,
    cross_attn_period=5, vision_seq=1601, vision_dim=4096,
    dtype="bfloat16", microbatch=4,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-vision-smoke", family="vlm",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, head_dim=16,
        cross_attn_period=2, vision_seq=24, vision_dim=48,
        q_chunk=16, kv_chunk=16, dtype="float32",
    )
