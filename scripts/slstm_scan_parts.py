#!/usr/bin/env python3
"""Where the sLSTM scan's cluster kernel spends its time: device ms of
diagnostic builds of ``csrc/slstm_scan.cu`` with one part of the kernel
taken out, beside the full kernel and the exchange's own floor.

    PYTHONPATH=src python scripts/slstm_scan_parts.py      # needs an NVIDIA GPU and nvcc

Each variant is the source with one text substitution, compiled with the
port's ``nvcc`` flags into ``build/diag/`` and loaded in place of the
library for the timing only (the variants compute wrong results, except
"full"):

- ``full``: the kernel as it is;
- ``noprod``: no recurrent product (the gates see only xg and the bias);
- ``nogate``: a few additions in place of the gate math;
- ``prologue``: the kernel returns after its prologue (the w slice, xg[0],
  the state and the bias loaded; no step);
- ``prologue_no_w``: the same without the w slice's copy: the fixed cost
  of launching 16-block clusters with this much shared memory.

Beside them: ``cluster_sync_loop`` at S rounds (the exchange and its
waits alone) and at 0 rounds (a launch of 16-block clusters with 4 KB and
with 137 KB of shared memory a block).  bf16 at D = 2048, H = 4: B = 1 with S = 16 and 384, and
B = 4 with S = 1.  Prints one line per variant and one JSON line
``{"card": ..., "ms": {...}}``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

GATE = """  const float logf = fminf(gf, 0.f) - __logf(1.f + __expf(-fabsf(gf)));   // log sigmoid(f)
  const float mn = fmaxf(logf + m, gi);
  const float ip = __expf(gi - mn), fp = __expf(logf + m - mn);
  c = fp * c + ip * (1.f - __fdividef(2.f, __expf(2.f * gz) + 1.f));
  n = fp * n + ip;
  m = mn;
  return __fdividef(c, (1.f + __expf(-go)) * fmaxf(n, 1e-6f));"""
STEPS = "  const unsigned round_bytes = cs * B * J * 4;"
W_COPY = "cp_async16(smem_u32(dst), j < dh ? src : wh, j < dh);"
VARIANTS = {
    "full": [],
    "noprod": [("    cluster_product<TW, RB>(w_s, h_s + (size_t)cur * Bp * hstride, g_s, dh, "
                "hstride, W, Bp);", "")],
    "nogate": [(GATE, "  c = gi + gf;\n  n = gz;\n  m = go;\n  return 1e-3f * (gi + gf);")],
    "prologue": [(STEPS, "  if (S > 0) return;\n" + STEPS)],
    "prologue_no_w": [(STEPS, "  if (S > 0) return;\n" + STEPS),
                      (W_COPY, "cp_async16(smem_u32(dst), wh, false);")],
}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import device_breakdown

    from repro_torch.kernels import _build
    from repro_torch.kernels.slstm_scan import ops

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    d, h = 2048, 4
    dh = d // h
    w = (torch.randn(h, dh, 4 * dh, generator=gen, device=dev) * dh ** -0.5).to(torch.bfloat16)
    bias = torch.randn(4 * d, generator=gen, device=dev) * 0.1
    shapes = {}
    for b, s in ((1, 384), (1, 16), (4, 1)):
        z = torch.zeros(b, d, device=dev)
        shapes[f"B={b} S={s}"] = (torch.randn(b, s, 4 * d, generator=gen, device=dev)
                                  .to(torch.bfloat16), w, bias, z, z, z,
                                  torch.full((b, d), float("-inf"), device=dev))

    def ms(fn):
        return sum(t for t, _ in device_breakdown(fn).values())

    out = {}
    src = (_build.CSRC / "slstm_scan.cu").read_text()
    diag = ROOT / "build" / "diag"
    diag.mkdir(parents=True, exist_ok=True)
    try:
        for name, subs in VARIANTS.items():
            text = src
            for old, new in subs:
                if old not in text:
                    sys.exit(f"{name}: the source no longer holds {old[:60]!r}")
                text = text.replace(old, new)
            cu, so = diag / f"slstm_scan_{name}.cu", diag / f"slstm_scan_{name}.so"
            cu.write_text(text)
            r = subprocess.run([_build.cuda_tool("nvcc"), *_build.NVCC_FLAGS, "-I",
                                str(_build.CSRC), "-o", str(so), str(cu)],
                               capture_output=True, text=True, timeout=600)
            if r.returncode:
                sys.exit(f"{name}: nvcc failed\n{r.stdout[-3000:]}")
            _build._LIBS["slstm_scan"] = ctypes.CDLL(str(so))
            ops._plan.cache_clear()
            out[name] = {k: ms(lambda a=a: ops.slstm_scan(*a)) for k, a in shapes.items()}
            print(f"{name}: " + ", ".join(f"{k} {v:.5f} ms" for k, v in out[name].items()),
                  flush=True)
        # 32 floats a block is B = 1's exchange (4 KB of shared memory); 1040
        # gives a block 137 KB, the cluster kernel's at B = 1
        out["cluster_sync_loop"] = {
            f"S={s} floats={f}": ms(lambda s=s, f=f: ops.cluster_sync_loop(16, h, f, s, dev))
            for s, f in ((384, 32), (0, 32), (0, 1040))}
        print("cluster_sync_loop (4 clusters of 16 blocks): "
              + ", ".join(f"{k} {v:.5f} ms" for k, v in out["cluster_sync_loop"].items()),
              flush=True)
    finally:
        _build._LIBS.pop("slstm_scan", None)
        ops._plan.cache_clear()
    print(json.dumps({"card": card, "ms": out}), flush=True)


if __name__ == "__main__":
    main()
