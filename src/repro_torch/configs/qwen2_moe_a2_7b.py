"""qwen2-moe-a2.7b — 24L d2048 16H(kv16) d_ff=1408/expert, 60e top-4 + 4
shared experts (fused 5632) [hf:Qwen/Qwen1.5-MoE-A2.7B].  Counterpart of
``repro/configs/qwen2_moe_a2_7b.py``, field for field: the port has no use
yet for ``attn_chunk`` (its prefill always runs the flash kernel) or
``seq_shard_activations`` (one card, no mesh)."""

from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe",
        num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1408, vocab_size=151_936, head_dim=128,
        num_experts=60, top_k=4, num_shared_experts=4, d_ff_shared=5632,
        qkv_bias=True, rope_theta=1_000_000.0,
        attn_chunk=1024,
        moe_capacity_factor=1.25, seq_shard_activations=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=32, vocab_size=128, head_dim=16,
        num_experts=8, top_k=2, num_shared_experts=1, d_ff_shared=64,
        qkv_bias=True, param_dtype="float32", compute_dtype="float32",
        remat="none",
    )
