"""hubert-xlarge [audio]: encoder-only bidirectional transformer.

48L d_model=1280 16H d_ff=5120 vocab=504 [arXiv:2106.07447]. The conv
waveform frontend is a stub, as in the JAX package: the batch carries
precomputed frame embeddings (dim 512, the wav2vec2 conv output width)
under ``"frames"``, and training is frame-level classification over 504
cluster targets. Encoder-only, so the decode cells are skipped
(``registry._ENCODER_ONLY``). RoPE stands in for HuBERT's convolutional
relative positional embedding (frontend-adjacent, stubbed). The same
numbers as ``src/repro/configs/hubert_xlarge.py``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_ff=5120,
    vocab_size=504, head_dim=80,
    causal=False, norm="ln", mlp_type="gelu",
    input_mode="frames", frame_dim=512,
    dtype="bfloat16", microbatch=4,
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hubert-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=64, head_dim=16,
        causal=False, norm="ln", mlp_type="gelu",
        input_mode="frames", frame_dim=32,
        q_chunk=16, kv_chunk=16, dtype="float32",
    )
