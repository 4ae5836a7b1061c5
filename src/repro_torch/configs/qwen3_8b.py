"""qwen3-8b — 36L d4096 32H(kv8) d_ff=12288, qk_norm [hf:Qwen/Qwen3-8B].
Counterpart of ``repro/configs/qwen3_8b.py``."""

from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b", family="dense",
        num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=12_288, vocab_size=151_936, head_dim=128,
        qk_norm=True, rope_theta=1_000_000.0,
        attn_chunk=1024,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=128, head_dim=16, qk_norm=True,
        param_dtype="float32", compute_dtype="float32", remat="none",
    )
