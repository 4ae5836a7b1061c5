"""Attention for the port's model: adapters from the model's layouts to the
kernels' ``ops``.

Counterpart of ``repro/models/attention.py``.  The reference computes
attention in XLA (einsum or chunked online softmax); the port sends the
same math through its Hopper kernels:

* :func:`attention` — prefill: the model's (B, S, H, hd) q and
  (B, S, KV, hd) k/v go to the flash-attention kernel as ``transpose``
  views, so nothing is copied;
* :func:`decode_attention_append` — decode: replaces the reference's
  ``decode_attention_plus``.  The step's new k/v are written in place into
  the cache layer at position ``len`` *before* attention, and the
  decode-attention kernel then attends with length ``len + 1``: the same
  function, under the TPU kernel's own contract, and no separate
  whole-cache scatter after the layers;
* :func:`cross_attention_decode` — decode's cross-attention (Whisper's
  decoder over its encoder output, mLLaMA's cross layers over the vision
  tokens): the reference's ``attention(q, ck, cv, causal=False)`` with one
  query per row, which is the decode-attention kernel's contract with
  every row's length the whole fixed-length K/V.

Prefill's non-causal calls (Whisper's encoder, both families'
cross-attention, Sq != Sk) go through :func:`attention` with
``causal=False``.

``plain=True`` calls the kernels' plain versions instead, on any device;
it exists so a run on the card can hold the kernel path against them.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ops import decode_attention, decode_attention_ref
from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_ref

__all__ = ["attention", "cross_attention_decode", "decode_attention_append", "kv_heads_for"]


def kv_heads_for(rank: int, local_heads: int, heads: int, kv_heads: int) -> tuple[int, int]:
    """(first, count) of the KV heads that query heads ``[rank * local_heads,
    (rank + 1) * local_heads)`` read under GQA (query head j reads KV head
    ``j // (heads / kv_heads)``), where the heads are split over a mesh axis
    that the KV heads do not tile, so every rank keeps them whole and
    slices its own.  The rank's slice must hold an integral group, so the
    attention kernel's local G = local_heads / count maps its query heads
    onto the slice as the global G does: qwen2-1.5b's 12 heads over 2 at
    ``model`` 4, 3 query heads over KV head ``rank // 2``; llama3-8b's 32
    over 8 at 16, 2 over ``rank // 2``.  Raises where the slice would not."""
    g = heads // kv_heads
    first = rank * local_heads // g
    count = ((rank + 1) * local_heads - 1) // g - first + 1
    if local_heads % count or any((rank * local_heads + i) // g - first != i // (local_heads // count)
                                  for i in range(local_heads)):
        raise ValueError(f"query heads {rank * local_heads}..{(rank + 1) * local_heads - 1} of "
                         f"{heads} over {kv_heads} KV heads do not read a whole group of KV "
                         f"heads: no integral local G")
    return first, count


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              plain: bool = False) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, Skv, KV, hd) -> (B, S, H, hd).

    Causal is top-left aligned (query i sees keys 0..i), which for the
    model's prefill (S == Skv) is the usual causal mask."""
    fn = flash_attention_ref if plain else flash_attention
    out = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal)
    return out.transpose(1, 2)


def decode_attention_append(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                            k_new: torch.Tensor, v_new: torch.Tensor,
                            write_pos: torch.Tensor, lengths: torch.Tensor, *,
                            plain: bool = False) -> torch.Tensor:
    """Append the current token to one cache layer, then attend over it.

    q/k_new/v_new: (B, 1, H|KV, hd); caches: (B, Smax, KV, hd), written in
    place at ``write_pos`` (B,) int64; ``lengths`` (B,) int32 is the step's
    ``len + 1``.  The caller clamps ``write_pos`` to ``Smax - 1``: an idle
    slot's length keeps growing past ``Smax`` (the reference's
    ``dynamic_update_slice`` clamps that write silently; an index past
    ``Smax`` here would be a device-side assert), and the kernel bounds its
    loop by ``min(len, Smax)``.  Returns (B, 1, H, hd).
    """
    rows = torch.arange(q.shape[0], device=q.device)
    k_cache[rows, write_pos] = k_new[:, 0]
    v_cache[rows, write_pos] = v_new[:, 0]
    fn = decode_attention_ref if plain else decode_attention
    out = fn(q[:, 0], k_cache.transpose(1, 2), v_cache.transpose(1, 2), lengths)
    return out[:, None]


def cross_attention_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, *, plain: bool = False) -> torch.Tensor:
    """q: (B, 1, H, hd); k/v: (B, Sk, KV, hd), every position valid, so
    ``lengths`` (B,) int32 is Sk in every row (the caller builds it once a
    step for all its cross layers) -> (B, 1, H, hd)."""
    fn = decode_attention_ref if plain else decode_attention
    return fn(q[:, 0], k.transpose(1, 2), v.transpose(1, 2), lengths)[:, None]
