"""xlstm-1.3b — 48 blocks [7 mLSTM : 1 sLSTM], d2048 4H, GPT-NeoX vocab
[arXiv:2405.04517].  Counterpart of ``repro/configs/xlstm_1_3b.py``."""

from repro_torch.models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", family="xlstm",
        num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=50_304,
        slstm_every=8, ssm_expand=2, ssm_chunk=256,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b-smoke", family="xlstm",
        num_layers=4, d_model=32, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=128,
        slstm_every=2, ssm_expand=2, ssm_chunk=4,
        param_dtype="float32", compute_dtype="float32", remat="none",
    )
