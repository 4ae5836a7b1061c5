"""gemma-2b — 18L d2048 8H MQA(kv1) d_ff=16384 GeGLU head_dim=256,
vocab 256k, embed scaling + (1+w) RMSNorm [arXiv:2403.08295].
Counterpart of ``repro/configs/gemma_2b.py``, copied as it is: ``full()``
leaves ``tie_embeddings`` False (an untied ``lm_head``), ``smoke()`` ties."""

from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b", family="dense",
        num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
        d_ff=16_384, vocab_size=256_000, head_dim=256,
        mlp_act="geglu", embed_scale=True, gemma_norm=True,
        rope_theta=10_000.0, attn_chunk=1024,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
        d_ff=128, vocab_size=256, head_dim=32,
        mlp_act="geglu", embed_scale=True, gemma_norm=True,
        tie_embeddings=True,
        param_dtype="float32", compute_dtype="float32", remat="none",
    )
