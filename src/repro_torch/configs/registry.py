"""Architecture registry: ``--arch <id>`` -> ModelConfig (full, smoke, 100m).

Counterpart of ``repro/configs/registry.py`` plus ``model_100m`` (the
reference keeps it in ``repro/launch/train.py``).  Every one of the
reference's ten architectures has a config module here.
"""

from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config", "model_100m"]

_MODULES: dict[str, str] = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "qwen3-8b": "qwen3_8b",
    "qwen2-1.5b": "qwen2_1_5b",
    "gemma-2b": "gemma_2b",
    "llama3-8b": "llama3_8b",
    "xlstm-1.3b": "xlstm_1_3b",
    "whisper-small": "whisper_small",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "zamba2-2.7b": "zamba2_2_7b",
}

ARCH_IDS: tuple[str, ...] = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {', '.join(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).full()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke()


def model_100m(arch: str) -> ModelConfig:
    """~100M-param reduction of ``arch`` (same family/features, small dims)."""
    cfg = get_config(arch)
    over = dict(num_layers=max(4, min(8, cfg.num_layers)), d_model=512,
                num_heads=8, num_kv_heads=min(8, max(1, cfg.num_kv_heads)),
                d_ff=2048, vocab_size=32_000, head_dim=64,
                param_dtype="float32", compute_dtype="float32")
    if cfg.num_experts:
        over.update(num_experts=8, top_k=2, d_ff=512)
    if cfg.encoder_layers:
        over.update(encoder_layers=2, encoder_positions=128)
    if cfg.vision_tokens:
        over.update(vision_tokens=64, cross_attn_every=2)
    if cfg.ssm_state:
        over.update(ssm_state=16)
    if cfg.attn_every:
        # whole groups of attn_every blocks: the reference's 8 layers against
        # zamba2's attn_every of 6 cannot be built (ROADMAP.md, Queue 3)
        n = over["num_layers"]
        over.update(num_layers=max(cfg.attn_every, n - n % cfg.attn_every))
    return cfg.scaled(**over)
