#!/usr/bin/env python3
"""Device time of the decode-attention kernel (``csrc/decode_attention.cu``)
for several choices of positions per block P, at the qwen2-1.5b decode
shape (B=4 H=12 KV=2 S=512 hd=128 bf16, lengths 397/250/130/17).

    PYTHONPATH=src python scripts/decode_split_sweep.py    # needs an NVIDIA GPU

P = 32 is what ``decode_split_plan`` picks at this shape on 132 SMs; P = S
gives one block per (request, KV head), so no request spans two blocks and
the kernel never takes the ticket-counter merge.  Each P is held against
the plain version first, then timed with ``torch.profiler``.  Prints one
JSON line ``{"card": ..., "by_P": {P: {"ms": ..., "splits": ...}}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import device_ms

    from repro_torch.kernels.decode_attention import ops

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    b, h, kv, s, hd = 4, 12, 2, 512, 128
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)  # noqa: E731
    q = rnd(b, h, hd)
    kc, vc = rnd(b, s, kv, hd).transpose(1, 2), rnd(b, s, kv, hd).transpose(1, 2)
    lt = torch.tensor([397, 250, 130, 17], dtype=torch.int32, device=dev)
    ref = ops.decode_attention_ref(q, kc, vc, lt).float()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    planned = ops.decode_split_plan(s, b, kv, sms)[0]
    plan = ops.decode_split_plan
    by_p = {}
    try:
        for p in sorted({planned, 32, 64, 128, 256, s}):
            ops.decode_split_plan = lambda s_, b_, kv_, sms_, p=p: (p, -(-s_ // p))
            out = ops.decode_attention(q, kc, vc, lt).float()
            if not torch.allclose(out, ref, atol=2e-2, rtol=2e-2):
                sys.exit(f"P={p}: max |kernel - plain| {(out - ref).abs().max():.3e}")
            by_p[p] = {"ms": device_ms(lambda: ops.decode_attention(q, kc, vc, lt)),
                       "splits": -(-s // p), "planned": p == planned}
            print(f"P={p}: {by_p[p]['splits']} split(s), {by_p[p]['ms']:.5f} device ms "
                  f"per call{' (the wrapper rule)' if p == planned else ''}", flush=True)
    finally:
        ops.decode_split_plan = plan
    print(json.dumps({"card": card, "by_P": by_p}), flush=True)


if __name__ == "__main__":
    main()
