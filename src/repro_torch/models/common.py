"""Shared model substrate: config, init helper, RMSNorm, RoPE.

Counterpart of ``repro/models/common.py``.  ``ModelConfig`` mirrors the
reference field for field; ``pdt``/``cdt`` return torch dtypes.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

__all__ = ["ModelConfig", "rms_norm", "apply_rope", "rope_freqs", "dense_init"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | xlstm | zamba2 | whisper | mllama
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    # attention / mlp features
    mlp_act: str = "swiglu"          # swiglu | geglu
    qk_norm: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    embed_scale: bool = False        # gemma: inputs scaled by sqrt(d_model)
    gemma_norm: bool = False         # RMSNorm with (1 + scale)
    # moe
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    router_aux_weight: float = 0.001
    moe_capacity_factor: float = 0.0
    # ssm (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    attn_every: int = 0
    # xlstm
    slstm_every: int = 8
    # enc-dec / vlm
    encoder_layers: int = 0
    encoder_positions: int = 0
    cross_attn_every: int = 0
    vision_tokens: int = 0
    # numerics / system
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "block"             # training only; read by no serving path
    seq_shard_activations: bool = False
    attn_chunk: int = 0              # reference's XLA attention strategy; the
                                     # port's prefill always runs the flash kernel
    attn_scores_bf16: bool = False
    use_pallas: bool = False         # reference's TPU switch; the port's dense
                                     # path always goes through its kernels' ops
    max_seq: int = 0

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def pdt(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdt(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def scaled(self, **overrides) -> "ModelConfig":
        return replace(self, **overrides)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6, *,
             gemma: bool = False) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    s = (1.0 + scale.float()) if gemma else scale.float()
    return (xf * s).to(dt)


def rope_freqs(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., S) -> (sin, cos) of shape (..., S, head_dim//2)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freq = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freq
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd); sin/cos: (..., S, hd//2) broadcast over heads."""
    half = x.shape[-1] // 2
    s = sin[..., None, :]
    c = cos[..., None, :]
    xf = x.float()
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def dense_init(gen: torch.Generator, shape, dtype: torch.dtype, *,
               fan_in: int | None = None, scale: float = 1.0) -> torch.Tensor:
    """Normal(0, scale/sqrt(fan_in)) on the generator's device, cast to dtype."""
    fan = fan_in if fan_in is not None else shape[0]
    std = scale / (fan ** 0.5)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (w * std).to(dtype)
