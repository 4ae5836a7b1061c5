#!/usr/bin/env python3
"""The attention kernels of one source tree, as compiled and as timed: for a
before/after of ``csrc/decode_attention.cu`` and ``csrc/flash_attention.cu``.

    PYTHONPATH=src python scripts/decode_sass_compare.py [--src DIR]   # needs an NVIDIA GPU

``--src`` names the ``src`` directory whose ``repro_torch`` is built and
imported (default: this checkout's); unpack an older tree with ``git
archive`` to compare.  Prints one JSON line: for each instantiation of
``decode_fwd``, keyed by (dtype, head dim, row slots, row groups), its
instruction count and a hash of its SASS opcodes and operands with the
kernel-parameter offsets (``c[0x0][...]``) masked, so two builds whose
parameter lists differ but whose code is the same hash alike, and the same
for each instantiation of ``flash_fwd`` (f32) and ``flash_fwd_mma``
(bf16), keyed by head dim; then K3's device ms (torch.profiler) at
qwen2-1.5b's decode (G = 6, hd 128), gemma-2b's (G = 8 over 1, hd 256)
and, where the tree builds it, qwen3-moe's (G = 16 over 4, hd 128),
lengths 397/250/130/17 over 512, and K2's bf16 device ms at qwen2-1.5b's
and gemma-2b's prefill of 384 tokens.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def sass_by_kernel(lib: Path, cuda_tool) -> dict:
    sass = subprocess.run([cuda_tool("cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            out[fn] = []
        elif fn and (m := re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)):
            out[fn].append(re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][P]", m.group(1)))
    names = subprocess.run([cuda_tool("cu++filt")], input="\n".join(out), capture_output=True,
                           text=True, timeout=60, check=True).stdout.splitlines()
    report = {}
    for (_, ins), name in zip(out.items(), names):
        name = name.replace("(int)", "")
        m = re.search(r"decode_fwd<([^,]+), (\d+), (\d+)(?:, (\d+))?>", name)
        f = re.search(r"(flash_fwd(?:_mma)?)<(?:([^,>]+), )?(\d+)>", name)
        key = None
        if m:
            key = f"{m.group(1)} hd={m.group(2)} G={m.group(3)} RG={m.group(4) or 1}"
        elif f:
            key = f"{f.group(1)} {f.group(2) or '__nv_bfloat16'} hd={f.group(3)}"
        if key:
            report[key] = {"instructions": len(ins),
                           "hash": hashlib.sha1("\n".join(ins).encode()).hexdigest()[:16]}
    return report


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    from chip_smoke import device_ms

    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.flash_attention import ops as flash

    _build.build(["decode_attention", "flash_attention"])
    report = {"src": args.src, "sass": {}, "ms": {}}
    for name in ("decode_attention", "flash_attention"):
        report["sass"].update(sass_by_kernel(_build._target(name), _build.cuda_tool))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    lens = torch.tensor([397, 250, 130, 17], dtype=torch.int32, device=dev)
    for what, h, kv, hd in (("qwen2 G=6 hd=128", 12, 2, 128), ("gemma G=8 hd=256", 8, 1, 256),
                            ("qwen3-moe G=16 hd=128", 64, 4, 128)):
        if h // kv > ops.KERNEL_MAX_GROUP:
            continue
        q = torch.randn(4, h, hd, generator=gen, device=dev).bfloat16()
        kc, vc = (torch.randn(4, 512, kv, hd, generator=gen, device=dev).bfloat16()
                  .transpose(1, 2) for _ in range(2))
        torch.testing.assert_close(ops.decode_attention(q, kc, vc, lens).float(),
                                   ops.decode_attention_ref(q, kc, vc, lens).float(),
                                   atol=2e-2, rtol=2e-2)
        report["ms"][what] = device_ms(lambda: ops.decode_attention(q, kc, vc, lens), iters=50)
    for what, h, kv, hd in (("flash qwen2 S=384 hd=128", 12, 2, 128),
                            ("flash gemma S=384 hd=256", 8, 1, 256)):
        q = torch.randn(1, 384, h, hd, generator=gen, device=dev).bfloat16().transpose(1, 2)
        k, v = (torch.randn(1, 384, kv, hd, generator=gen, device=dev).bfloat16()
                .transpose(1, 2) for _ in range(2))
        torch.testing.assert_close(flash.flash_attention(q, k, v).float(),
                                   flash.flash_attention_ref(q, k, v).float(),
                                   atol=2e-2, rtol=2e-2)
        report["ms"][what] = device_ms(lambda: flash.flash_attention(q, k, v), iters=50)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
