"""qwen3-moe-235b-a22b — 94L d4096 64H(kv4) d_ff=1536/expert, 128e top-8,
qk_norm [assignment values; hf:Qwen/Qwen3-235B-A22B family].  Counterpart
of ``repro/configs/qwen3_moe_235b_a22b.py``, field for field.  At bf16 the
94 layers hold 470 GB, more than one 80 GB card: the card runs it at full
width with its depth cut (``launch.serve --layers 4``)."""

from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
        d_ff=1536, vocab_size=151_936, head_dim=128,
        num_experts=128, top_k=8,
        qk_norm=True, rope_theta=1_000_000.0,
        attn_chunk=1024, seq_shard_activations=True,
        moe_capacity_factor=1.25,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b-smoke", family="moe",
        num_layers=3, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=32, vocab_size=128, head_dim=16,
        num_experts=16, top_k=4, qk_norm=True,
        param_dtype="float32", compute_dtype="float32", remat="none",
    )
