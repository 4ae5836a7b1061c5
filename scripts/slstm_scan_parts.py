#!/usr/bin/env python3
"""Where the sLSTM scan's cluster kernels spend their time: device ms of
diagnostic builds of ``csrc/slstm_scan.cu`` (K5) and
``csrc/slstm_scan_bwd.cu`` (K5-bwd) with one part of the kernel taken
out, beside the full kernel and the exchange's own floor.

    PYTHONPATH=src python scripts/slstm_scan_parts.py      # needs an NVIDIA GPU and nvcc

Each variant is the source with one text substitution, compiled with the
port's ``nvcc`` flags into ``build/diag/`` (all at once) and loaded in
place of the library for the timing only (the variants compute wrong
results, except "full").  K5's:

- ``full``: the kernel as it is;
- ``noprod``: no recurrent product (the gates see only xg and the bias);
- ``nogate``: a few additions in place of the gate math;
- ``prologue``: the kernel returns after its prologue (the w slice, xg[0],
  the state and the bias loaded; no step);
- ``prologue_no_w``: the same without the w slice's copy: the fixed cost
  of launching 16-block clusters with this much shared memory.

K5-bwd's: ``full``; ``noprod`` (no FMA of the product: the exchange
sends zeros); ``nogate`` (a few products in place of the
gate math's gradient); ``nostage`` (no copy of the next step's saved
gates and states: the chain without waiting on them); ``prologue`` (the
kernel returns after its prologue).

Beside them: ``cluster_sync_loop`` at S rounds (the exchange and its
waits alone) and at 0 rounds (a launch of 16-block clusters with 4 KB and
with 137 KB of shared memory a block), and at K5-bwd's shapes with its
bytes.  bf16 at D = 2048, H = 4: K5 at B = 1 with S = 16 and 384, and B
= 4 with S = 1; K5-bwd at B = 8, S = 1024 (xlstm-1.3b's training shape)
and at the 100m reduction's D = 512, H = 8, B = 4, S = 256.  Prints one
line per variant and one JSON line ``{"card": ..., "ms": {...}}``.
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
BWD_GATE = "  const float logf_ = fminf(gf, 0.f) - log1pf(expf(-fabsf(gf)));   // log sigmoid(f)"
BWD_STAGE = "      if (t > 0)\n        load_stage("
BWD_LOOP = "  for (int t = S - 1; t >= 0; --t) {"
BWD_VARIANTS = {
    "full": [],
    "noprod": [("              for (int i = 0; i < kThreadK; ++i) a[r][i] = fmaf(gv, w[i], "
                "a[r][i]);", "              (void)gv;")],
    "nogate": [(BWD_GATE, "  dg[0] = gi * dht;\n  dg[1] = gf * c;\n  dg[2] = gz * n;\n"
                          "  dg[3] = go * m + cprev + nprev + mprev;\n  dc *= 0.5f;\n"
                          "  dn *= 0.5f;\n  dm *= 0.5f;\n  return;\n" + BWD_GATE)],
    "nostage": [(BWD_STAGE, "      if (t < 0)\n        load_stage(")],
    "prologue": [(BWD_LOOP, "  if (S > 0) return;\n" + BWD_LOOP)],
}
VARIANTS = {
    "full": [],
    "noprod": [("    cluster_product<TW, RB>(w_s, h_s + (size_t)cur * Bp * hstride, g_s, dh, "
                "hstride, W, Bp);", "")],
    "nogate": [(GATE, "  c = gi + gf;\n  n = gz;\n  m = go;\n  return 1e-3f * (gi + gf);")],
    "prologue": [(STEPS, "  if (S > 0) return;\n" + STEPS)],
    "prologue_no_w": [(STEPS, "  if (S > 0) return;\n" + STEPS),
                      (W_COPY, "cp_async16(smem_u32(dst), wh, false);")],
}


def build_variants(_build, name: str, variants: dict, diag: Path) -> dict:
    """Each variant of ``csrc/<name>.cu`` compiled into ``diag``, all nvcc
    processes at once, the compiler's report beside each library as
    ``.log``: {variant: library path}."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    procs = {}
    for var, subs in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                sys.exit(f"{name} {var}: the source no longer holds {old[:60]!r}")
            text = text.replace(old, new)
        cu, so = diag / f"{name}_{var}.cu", diag / f"{name}_{var}.so"
        cu.write_text(text)
        procs[var] = (so, subprocess.Popen(
            [_build.cuda_tool("nvcc"), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for var, (so, p) in procs.items():
        log, _ = p.communicate(timeout=600)
        so.with_suffix(".log").write_text(log)      # ptxas's registers and spills
        if p.returncode:
            sys.exit(f"{name} {var}: nvcc failed\n{log[-3000:]}")
        out[var] = so
    return out


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
    bwd_shapes = {}
    for b, s, dd, hh in ((8, 1024, 2048, 4), (4, 256, 512, 8)):
        ddh = dd // hh
        z = torch.zeros(b, dd, device=dev)
        fwd = (torch.randn(b, s, 4 * dd, generator=gen, device=dev).to(torch.bfloat16),
               (torch.randn(hh, ddh, 4 * ddh, generator=gen, device=dev) * ddh ** -0.5)
               .to(torch.bfloat16), torch.randn(4 * dd, generator=gen, device=dev) * 0.1,
               z, z, z, torch.full((b, dd), float("-inf"), device=dev))
        hs, _, saved = ops._launch_fwd(*fwd, True)
        bwd_shapes[f"B={b} S={s} D={dd} H={hh}"] = (
            fwd[1], *fwd[3:], hs, *saved, torch.randn(b, s, dd, generator=gen, device=dev))

    def ms(fn):
        return sum(t for t, _ in device_breakdown(fn).values())

    out = {}
    diag = ROOT / "build" / "diag"
    diag.mkdir(parents=True, exist_ok=True)
    libs = {"slstm_scan": build_variants(_build, "slstm_scan", VARIANTS, diag),
            "slstm_scan_bwd": build_variants(_build, "slstm_scan_bwd", BWD_VARIANTS, diag)}
    try:
        for name, so in libs["slstm_scan"].items():
            _build._LIBS["slstm_scan"] = ctypes.CDLL(str(so))
            ops._plan.cache_clear()
            out[name] = {k: ms(lambda a=a: ops.slstm_scan(*a)) for k, a in shapes.items()}
            print(f"{name}: " + ", ".join(f"{k} {v:.5f} ms" for k, v in out[name].items()),
                  flush=True)
        _build._LIBS.pop("slstm_scan", None)
        ops._plan.cache_clear()
        for name, so in libs["slstm_scan_bwd"].items():
            _build._LIBS["slstm_scan_bwd"] = ctypes.CDLL(str(so))
            ops._bwd_plan.cache_clear()
            out[f"bwd {name}"] = {
                k: ms(lambda a=a: ops.slstm_scan_bwd(*a, x_dtype=torch.bfloat16))
                for k, a in bwd_shapes.items()}
            print(f"slstm_scan_bwd {name}: "
                  + ", ".join(f"{k} {v:.5f} ms" for k, v in out[f"bwd {name}"].items()),
                  flush=True)
        _build._LIBS.pop("slstm_scan_bwd", None)
        ops._bwd_plan.cache_clear()
        # 32 floats a block is B = 1's exchange (4 KB of shared memory); 1040
        # gives a block 137 KB, the cluster kernel's at B = 1
        out["cluster_sync_loop"] = {
            f"S={s} floats={f}": ms(lambda s=s, f=f: ops.cluster_sync_loop(16, h, f, s, dev))
            for s, f in ((384, 32), (0, 32), (0, 1040))}
        print("cluster_sync_loop (4 clusters of 16 blocks): "
              + ", ".join(f"{k} {v:.5f} ms" for k, v in out["cluster_sync_loop"].items()),
              flush=True)
        # K5-bwd's exchange: each block's rows x J floats to every peer, S rounds
        for key, a in bwd_shapes.items():
            b, s, dd = a[5].shape
            p = ops.slstm_scan_bwd_plan(b, dd, a[0].shape[0])
            out["cluster_sync_loop"][f"K5-bwd {key}"] = ms(
                lambda p=p, s=s: ops.cluster_sync_loop(p.cluster, p.blocks // p.cluster,
                                                       p.rows * p.j, s, dev))
            print(f"cluster_sync_loop at K5-bwd {key} ({p.blocks // p.cluster} clusters of "
                  f"{p.cluster}, {p.rows * p.j} floats): "
                  f"{out['cluster_sync_loop'][f'K5-bwd {key}']:.5f} ms", flush=True)
    finally:
        _build._LIBS.pop("slstm_scan", None)
        _build._LIBS.pop("slstm_scan_bwd", None)
        ops._plan.cache_clear()
        ops._bwd_plan.cache_clear()
    print(json.dumps({"card": card, "ms": out}), flush=True)


if __name__ == "__main__":
    main()
