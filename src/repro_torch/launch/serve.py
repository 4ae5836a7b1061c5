"""Serving launcher: unsized requests through the continuous-batching server.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 8 --max-new 32

Counterpart of ``repro/launch/serve.py``.  By default it serves full-width
qwen2-1.5b (28 layers, d_model 1536, bf16, about 1.5 B parameters with
random weights drawn from ``--seed``) on the GPU, through the port's flash
attention, decode attention and fused RMSNorm kernels.  ``--arch
xlstm-1.3b`` serves full-width xlstm-1.3b (48 blocks [7 mLSTM : 1 sLSTM],
d_model 2048, bf16, 3.61 B parameters) through the sLSTM scan and fused
RMSNorm kernels; ``--arch llama3-8b``, ``qwen3-8b`` or ``gemma-2b`` serve
those dense models at full width through the same kernels as qwen2-1.5b
(gemma-2b's attention at head dim 256).  ``--arch qwen2-moe-a2.7b``
serves the MoE family at full width (24 layers, 60 experts top-4 plus 4
shared, 14.3 B parameters); ``--arch qwen3-moe-235b-a22b --layers 4``
serves qwen3-moe at full width cut to 4 of its 94 layers (11.2 B
parameters; the 94 layers, 470 GB in bf16, do not fit one card), with
decode attention at 16 query heads per KV head.  ``--arch zamba2-2.7b``
serves the Zamba2 family at full width (54 Mamba2 blocks and one shared
attention block invoked every 6, 2.42 B parameters), its attention at
head dim 80; its ``--layers`` must be a multiple of 6.  ``--arch`` takes
``SERVED_ARCH_IDS`` only: whisper-small and llama-3.2-vision-90b need
audio frames or a vision input beside the tokens, which a request does not
carry, so they run through ``Model.prefill`` and ``Model.decode_step``
instead (``chip_smoke.py`` phases 22-25).  ``--size smoke`` or
``100m`` give the reduced configs, ``--layers N`` cuts any config's depth;
``--device cpu`` runs the kernels' plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config, model_100m
from repro_torch.models import Model, ModelConfig
from repro_torch.models.model import EXTRA_INPUTS
from repro_torch.runtime import InferenceServer, Request

__all__ = ["SERVED_ARCH_IDS", "build_config", "make_requests", "run", "warmup", "main"]

PROMPT_MIN, PROMPT_MAX = 16, 384     # unsized prompts, drawn uniformly
# the archs whose prefill takes a request's tokens alone
SERVED_ARCH_IDS: tuple[str, ...] = tuple(
    a for a in ARCH_IDS if get_config(a).family not in EXTRA_INPUTS)


def build_config(arch: str, size: str, layers: int | None = None) -> ModelConfig:
    """``arch`` at ``size``, its depth cut to ``layers`` when given; Zamba2's
    depth must stay whole groups of ``attn_every`` blocks."""
    cfg = {"smoke": get_smoke_config, "100m": model_100m, "full": get_config}[size](arch)
    if layers and cfg.attn_every and layers % cfg.attn_every:
        raise ValueError(f"--layers {layers}: {cfg.name} runs groups of attn_every="
                         f"{cfg.attn_every} Mamba2 blocks, so its depth must be a multiple "
                         f"of attn_every={cfg.attn_every}")
    return cfg.scaled(num_layers=layers) if layers else cfg


def make_requests(n: int, *, vocab: int, prompt_min: int, prompt_max: int, max_new: int,
                  seed: int, prefix: str = "req") -> list[Request]:
    """``n`` requests with prompt lengths drawn uniformly from
    ``[prompt_min, prompt_max]`` and tokens from ``[0, vocab)``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(prompt_min, prompt_max + 1))
        out.append(Request(rid=f"{prefix}-{i}", tokens=rng.integers(0, vocab, plen),
                           max_new=max_new))
    return out


def warmup(server: InferenceServer, vocab: int, prompt_len: int) -> None:
    """One request of ``prompt_len`` tokens: builds and loads the kernels and
    grows the allocator's pool, so the measured requests' TTFT is not a
    build or an allocation."""
    server.submit(Request(rid="warmup", tokens=np.arange(prompt_len) % vocab, max_new=2))
    server.serve()
    server.results.pop("warmup", None)


def run(server: InferenceServer, requests: list[Request]) -> dict:
    """Serve ``requests`` to completion; returns the results and metrics.

    Times are host times around work that ends in a device sync (reading a
    token back forces one), so they include the device's time."""
    steps0, dsec0 = server.steps, server.decode_seconds
    on_cuda = server.device.type == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(server.device)
    t0 = time.monotonic()
    for r in requests:
        r.stamp = t0
        server.submit(r)
    server.serve()
    wall = time.monotonic() - t0
    results = {r.rid: server.results[r.rid] for r in requests if r.rid in server.results}
    steps = server.steps - steps0
    generated = sum(len(r.tokens) for r in results.values())
    stats = server.stats()
    return {
        "results": results,
        "requests": len(requests),
        "completed": len(results),
        "generated_tokens": generated,
        "wall_s": wall,
        "tokens_per_s": generated / wall if wall > 0 else float("nan"),
        "decode_steps": steps,
        "decode_step_ms": 1e3 * (server.decode_seconds - dsec0) / max(steps, 1),
        "ttft_ms": sorted((r.prompt_len, 1e3 * r.ttft) for r in results.values()),
        "peak_mem_gib": (torch.cuda.max_memory_allocated(server.device) / 2**30
                         if on_cuda else None),
        "pool_clean": (stats["live_publications"] == 0
                       and stats["free_pages"] == server.pool.num_pages),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=SERVED_ARCH_IDS, default="qwen2-1.5b")
    ap.add_argument("--size", choices=("smoke", "100m", "full"), default="full")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth (default: all)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    try:
        cfg = build_config(args.arch, args.size, args.layers)
    except ValueError as e:
        ap.error(str(e))
    model = Model(cfg, device=args.device)
    server = InferenceServer(model, slots=args.slots, max_seq=args.max_seq)
    server.load(model.init(args.seed))
    prompt_max = min(PROMPT_MAX, args.max_seq - args.max_new - 1)
    warmup(server, cfg.vocab_size, prompt_max)
    reqs = make_requests(args.requests, vocab=cfg.vocab_size, prompt_min=PROMPT_MIN,
                         prompt_max=prompt_max, max_new=args.max_new, seed=args.seed)
    out = run(server, reqs)
    print(f"[serve] {cfg.name} on {model.device}: {out['completed']}/{out['requests']} "
          f"done in {out['decode_steps']} decode rounds; "
          f"{out['tokens_per_s']:.1f} tok/s, decode step {out['decode_step_ms']:.2f} ms")
    print("[serve] ttft by prompt length: "
          + json.dumps([[n, round(ms, 3)] for n, ms in out["ttft_ms"]]))
    if not out["pool_clean"]:
        raise RuntimeError("leaked KV pages or publications")
    print(f"[serve] pool clean: {server.pool.free_pages} pages free, 0 live publications")
    return out


if __name__ == "__main__":
    main()
