"""whisper-small — 12L enc + 12L dec, d768 12H d_ff=3072, conv frontend
stubbed to precomputed frame embeddings [arXiv:2212.04356].  Counterpart of
``repro/configs/whisper_small.py``, field for field: the port has no use
yet for ``attn_chunk`` (its prefill always runs the flash kernel)."""

from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="whisper",
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
        d_ff=3072, vocab_size=51_865,
        encoder_layers=12, encoder_positions=1500,
        max_seq=33_024,  # decode_32k needs learned positions past 32768
        attn_chunk=1024,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-small-smoke", family="whisper",
        num_layers=2, d_model=32, num_heads=4, num_kv_heads=4,
        d_ff=64, vocab_size=128,
        encoder_layers=2, encoder_positions=12, max_seq=64,
        param_dtype="float32", compute_dtype="float32", remat="none",
    )
