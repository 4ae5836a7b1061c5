#!/usr/bin/env python3
"""Device time of the ragged concat (K4), sLSTM scan (K5) and sLSTM scan
backward (K5-bwd) calls, broken down by kernel name, at the shapes of
``chip_smoke.py``.

    PYTHONPATH=src python scripts/scan_concat_breakdown.py [--src DIR]   # needs an NVIDIA GPU

``--src`` names the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so the same script times another tree of the
port, e.g. an older commit unpacked with ``git archive``, in the same
process setup.  Shapes: K4 at the concatenate node's size (lens 500000,
3011, 2987; C = 4 f32; capacity total + 1000) beside ``torch.cat`` of the
valid views; K5 in bf16 at D = 2048, H = 4 for B = 1, S = 16, 100, 384
and B = 4, S = 1, the last also with the L2 cache flushed (a 64 MB buffer
written between calls) as the decode path finds it; K5 in save mode and
K5-bwd (with its ``dw_hh`` einsum) in bf16 at xlstm-1.3b's training shape
(B = 8, S = 1024, D = 2048, H = 4) and the 100m reduction's (B = 4, S =
256, D = 512, H = 8), from the zero state.  K5-bwd's call is the one of
the tree imported: before K5 saved the gates (three saved tensors) its
wrapper took xg and b_ih; after, w_hh, the state and xg's dtype.  Each
timing comes
from ``torch.profiler`` over 20 calls (``chip_smoke.device_breakdown``:
mean device time per activity times launches per call); the flush's own
kernel is left out by name.
The K5 serving calls' outputs (hs and the final state) are also printed
as a sha256 digest, so two trees' runs on one card show whether they
agree bit for bit.  Prints one line per call and one JSON line ``{"card":
..., "src": ..., "calls": {name: {kernel: [ms per call, launches per
call]}}, "digests": {name: digest}}``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path[:0] = [str(Path(args.src).resolve()), str(ROOT)]
    from chip_smoke import device_breakdown as breakdown

    from repro_torch.kernels.ragged_concat.ops import ragged_concat
    from repro_torch.kernels.slstm_scan import ops as scan_ops
    from repro_torch.kernels.slstm_scan.ops import slstm_scan

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    calls, digests = {}, {}

    def report(name, by):
        calls[name] = by
        total = sum(ms for ms, _ in by.values())
        print(f"{name}: {total:.5f} device ms per call: "
              + "; ".join(f"{k[:60]} {ms:.5f} ms x{n:g}" for k, (ms, n) in by.items()),
              flush=True)

    lens = [500_000, 3_011, 2_987]
    src = torch.randn(len(lens), max(lens), 4, generator=gen, device=dev)
    lt = torch.tensor(lens, dtype=torch.int32, device=dev)
    cap = sum(lens) + 1000
    report("ragged_concat", breakdown(lambda: ragged_concat(src, lt, capacity=cap)))
    report("torch.cat", breakdown(lambda: torch.cat([src[i, :k] for i, k in enumerate(lens)])))

    d, h = 2048, 4
    dh = d // h
    w = (torch.randn(h, dh, 4 * dh, generator=gen, device=dev) * dh ** -0.5).to(torch.bfloat16)
    bias = torch.randn(4 * d, generator=gen, device=dev) * 0.1
    flush_buf = torch.empty(64 * 2 ** 20 // 4, device=dev)
    for b, s in ((1, 16), (1, 100), (1, 384), (4, 1)):
        xg = torch.randn(b, s, 4 * d, generator=gen, device=dev).to(torch.bfloat16)
        z = torch.zeros(b, d, device=dev)
        m0 = torch.full((b, d), float("-inf"), device=dev)
        fn = lambda: slstm_scan(xg, w, bias, z, z, z, m0)  # noqa: E731
        report(f"slstm_scan B={b} S={s}", breakdown(fn))
        hs, st = fn()
        digests[f"slstm_scan B={b} S={s}"] = hashlib.sha256(
            torch.cat([hs.flatten(), *(t.flatten() for t in st)]).cpu().numpy().tobytes()
        ).hexdigest()[:16]
        if s == 1:
            report(f"slstm_scan B={b} S={s} L2 flushed",
                   breakdown(fn, flush=lambda: flush_buf.fill_(1.0)))
    for b, s, d, h in ((8, 1024, 2048, 4), (4, 256, 512, 8)):
        dh = d // h
        xg = torch.randn(b, s, 4 * d, generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn(h, dh, 4 * dh, generator=gen, device=dev) * dh ** -0.5).to(
            torch.bfloat16)
        bias = torch.randn(4 * d, generator=gen, device=dev) * 0.1
        z = torch.zeros(b, d, device=dev)
        fwd = (xg, w, bias, z, z, z, torch.full((b, d), float("-inf"), device=dev))
        report(f"slstm_scan save mode B={b} S={s} D={d} H={h}",
               breakdown(lambda: scan_ops._launch_fwd(*fwd, True)))
        hs, _, saved = scan_ops._launch_fwd(*fwd, True)
        dhs = torch.randn(b, s, d, generator=gen, device=dev)
        if len(saved) == 3:
            bwd = lambda: scan_ops.slstm_scan_bwd(*fwd, hs, *saved, dhs)  # noqa: E731
        else:
            bwd = lambda: scan_ops.slstm_scan_bwd(  # noqa: E731
                w, *fwd[3:], hs, *saved, dhs, x_dtype=xg.dtype)
        report(f"slstm_scan_bwd B={b} S={s} D={d} H={h}", breakdown(bwd))
        del hs, saved
    print(f"slstm_scan serving outputs (hs and the final state), sha256: {digests}", flush=True)
    print(json.dumps({"card": card, "src": str(Path(args.src).resolve()), "calls": calls,
                      "digests": digests}), flush=True)


if __name__ == "__main__":
    main()
