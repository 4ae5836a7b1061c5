"""llama3-8b — 32L d4096 32H(kv8) d_ff=14336, 128k vocab
[arXiv:2407.21783].  Counterpart of ``repro/configs/llama3_8b.py``."""

from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b", family="dense",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14_336, vocab_size=128_256, head_dim=128,
        rope_theta=500_000.0, attn_chunk=1024,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=128, head_dim=16,
        param_dtype="float32", compute_dtype="float32", remat="none",
    )
