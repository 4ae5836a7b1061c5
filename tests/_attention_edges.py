"""The tile and split edge cases of the attention kernels, in one place for
the card tests (``tests/test_torch_cuda.py``) and ``chip_smoke.py``'s
kernel phase, so a change to the tiling updates both.

Flash attention (K2) works in 64-row query tiles and 64-key tiles; decode
attention (K3) splits the cache into blocks of ``decode_split_plan``
positions and builds 1, 2, 4, 6 and 8 query rows per KV head (an odd
count runs padded to the next even one); 9 to 16 run as two row groups of
at most 8 rows, each its own block.  Both build head dims 64, 80, 128 and
256; the 256 cases are gemma-2b's G = 8 over KV = 1, qwen3-moe's G = 16
over KV = 4 runs at 128, and zamba2-2.7b's G = 1 over KV = 32 at 80."""

EDGES = [1, 15, 63, 64, 65, 127, 383, 384, 385]
EDGE_PAIRS = [(n, n) for n in EDGES] + [(n, m) for n, m in zip(EDGES, reversed(EDGES)) if n != m]
FLASH_GROUPS = (1, 4, 6, 8)


def flash_edge_cases() -> list[tuple[int, int, int, int, int]]:
    """(Sq, Sk, G, B, KV): Sq and Sk over the tile edges, equal and unequal
    both ways, G = H / KV cycling through ``FLASH_GROUPS``, B 1 or 2 and
    KV 1 or 2."""
    return [(sq, sk, FLASH_GROUPS[i % 4], 1 + i % 2, 2 if i % 3 else 1)
            for i, (sq, sk) in enumerate(EDGE_PAIRS)]


# gemma-2b's attention at head_dim 256: G = 8 query heads over KV = 1
GEMMA_G, GEMMA_KV, GEMMA_HD = 8, 1, 256


def flash_edge_cases_gemma() -> list[tuple[int, int, int, int, int]]:
    """The same (Sq, Sk) edges and batches with G = 8 over KV = 1."""
    return [(sq, sk, GEMMA_G, b, GEMMA_KV) for sq, sk, _, b, _ in flash_edge_cases()]


# qwen3-moe-235b-a22b's attention at head_dim 128: G = 16 query heads over KV = 4
MOE_G, MOE_KV, MOE_HD = 16, 4, 128


def flash_edge_cases_moe() -> list[tuple[int, int, int, int, int]]:
    """The same (Sq, Sk) edges and batches with G = 16 over KV = 4."""
    return [(sq, sk, MOE_G, b, MOE_KV) for sq, sk, _, b, _ in flash_edge_cases()]


# zamba2-2.7b's shared attention block at head_dim 80: G = 1 query head over
# each of KV = 32
ZAMBA_G, ZAMBA_KV, ZAMBA_HD = 1, 32, 80


def flash_edge_cases_zamba2() -> list[tuple[int, int, int, int, int]]:
    """The same (Sq, Sk) edges and batches with G = 1 over KV = 32."""
    return [(sq, sk, ZAMBA_G, b, ZAMBA_KV) for sq, sk, _, b, _ in flash_edge_cases()]


# (B, KV, S): one split (S = 16, 32 on 132 SMs) and many (16, 64)
DECODE_SHAPES = [(4, 2, 512), (1, 1, 2048), (2, 2, 32), (3, 1, 16)]
# gemma-2b's serving cache, KV = 1: 16 splits of 32 (4, 1, 512), one split, many
DECODE_SHAPES_GEMMA = [(4, 1, 512), (2, 1, 32), (1, 1, 2048)]
# qwen3-moe's serving cache, KV = 4 at G = 16 (two row groups): 4 splits of
# 128 (4, 4, 512), one split, many
DECODE_SHAPES_MOE = [(4, 4, 512), (2, 4, 32), (1, 4, 2048)]
# zamba2-2.7b's serving cache, KV = 32 at G = 1: 2 splits of 256 (4, 32, 512),
# one split, many
DECODE_SHAPES_ZAMBA2 = [(4, 32, 512), (2, 32, 32), (1, 32, 2048)]
# 9: two row groups of 5 and 4 rows (the 6-slot build, the last group short)
DECODE_GROUPS = (1, 3, 6, 7, 8, 9, 16)


def decode_edge_lens(per: int, s: int, b: int) -> list[list[int]]:
    """Length rows of ``b`` requests covering 0, 1, P-1, P, P+1, S-1, S and
    > S for ``per`` = P positions per block, then a row all full."""
    edges = [0, 1, per - 1, per, per + 1, s - 1, s, s + 7]
    rows = [(edges[i:i + b] + [s] * b)[:b] for i in range(0, len(edges), b)]
    return rows + [[s] * b]


# The cross-attention families' shapes, non-causal with every key valid, as
# (B, H, KV, Sq, Sk, hd): whisper-small's encoder (Sq = Sk = 1500) and its
# decoder's cross-attention from prompts of 100 and 384 tokens to the 1500
# frames (12 heads over 12 at hd 64), and llama-3.2-vision-90b's cross
# layers from the same prompts to 4096 vision tokens (64 heads over 8 at hd
# 128); four requests a batch.
CROSS_FLASH = [(4, 12, 12, 1500, 1500, 64), (4, 12, 12, 100, 1500, 64),
               (4, 12, 12, 384, 1500, 64), (4, 64, 8, 100, 4096, 128),
               (4, 64, 8, 384, 4096, 128)]
# decode's cross-attention, one query a request over the whole K/V, as (B,
# H, KV, Sk, hd): 3 splits of 512 (whisper) and 5 of 832 (mLLaMA) on 132 SMs
CROSS_DECODE = [(4, 12, 12, 1500, 64), (4, 64, 8, 4096, 128)]
# K2-bwd at the training paths' shapes, as (B, H, KV, Sq, Sk, hd, causal):
# qwen2-1.5b at B 8 x S 1024 (12 heads over 2 at hd 128); the 100m
# reductions at B 4 x S 256 (hd 64): qwen2's 8 heads over 2, and 8 over 8
# for the MoE, zamba2's shared block, whisper's decoder and mLLaMA's self
# layers; whisper's encoder over its 128 frames and its decoder's cross
# attention to them; mLLaMA's cross layers over 64 vision tokens.
TRAIN_FLASH = [(8, 12, 2, 1024, 1024, 128, True), (4, 8, 2, 256, 256, 64, True),
               (4, 8, 8, 256, 256, 64, True), (4, 8, 8, 128, 128, 64, False),
               (4, 8, 8, 256, 128, 64, False), (4, 8, 8, 256, 64, 64, False)]
