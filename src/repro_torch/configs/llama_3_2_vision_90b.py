"""llama-3.2-vision-90b — 100L d8192 64H(kv8) d_ff=28672, gated cross-attn
every 5th layer, vision frontend stubbed to patch embeddings
[hf:meta-llama/Llama-3.2-90B-Vision family].  Counterpart of
``repro/configs/llama_3_2_vision_90b.py``, field for field: the port has
no use yet for ``attn_chunk`` or ``seq_shard_activations`` (one card, the
flash kernel)."""

from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b", family="mllama",
        num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=28_672, vocab_size=128_256, head_dim=128,
        cross_attn_every=5, vision_tokens=4096,
        rope_theta=500_000.0, attn_chunk=1024,
        seq_shard_activations=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b-smoke", family="mllama",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=128, head_dim=16,
        cross_attn_every=2, vision_tokens=8,
        param_dtype="float32", compute_dtype="float32", remat="none",
    )
