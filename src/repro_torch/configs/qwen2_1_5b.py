"""qwen2-1.5b — 28L d1536 12H(kv2) d_ff=8960, QKV bias, tied embeddings
[arXiv:2407.10671].  Counterpart of ``repro/configs/qwen2_1_5b.py``."""

from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b", family="dense",
        num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
        d_ff=8960, vocab_size=151_936, head_dim=128,
        qkv_bias=True, tie_embeddings=True, rope_theta=1_000_000.0,
        attn_chunk=1024,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b-smoke", family="dense",
        num_layers=2, d_model=48, num_heads=4, num_kv_heads=2,
        d_ff=96, vocab_size=128, head_dim=16,
        qkv_bias=True, tie_embeddings=True,
        param_dtype="float32", compute_dtype="float32", remat="none",
    )
