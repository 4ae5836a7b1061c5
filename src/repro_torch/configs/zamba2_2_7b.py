"""zamba2-2.7b — 54 Mamba2 blocks + ONE weight-shared attention block
invoked every 6 blocks; d2560 32H(kv32) d_ff=10240 ssm_state=64
[arXiv:2411.15242].  Counterpart of ``repro/configs/zamba2_2_7b.py``,
field for field: the port has no use yet for ``attn_chunk`` (its prefill
always runs the flash kernel)."""

from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="zamba2",
        num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
        d_ff=10_240, vocab_size=32_000, head_dim=80,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
        attn_every=6, attn_chunk=1024,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b-smoke", family="zamba2",
        num_layers=4, d_model=32, num_heads=4, num_kv_heads=4,
        d_ff=64, vocab_size=128,
        ssm_state=16, ssm_head_dim=8, ssm_expand=2, ssm_chunk=4,
        attn_every=2,
        param_dtype="float32", compute_dtype="float32", remat="none",
    )
