#!/usr/bin/env python3
"""Host time per call of each kernel wrapper, and where it goes, at the
shapes of ``chip_smoke.py``.

    PYTHONPATH=src python scripts/wrapper_host_cost.py [--src DIR]   # needs an NVIDIA GPU

``--src`` names the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so the same script times another tree of the
port, e.g. an older commit unpacked with ``git archive``; run the two in
turns in one call (parent, change, change, parent) to compare them.

Every number is host time on the CPU's clock, per call, over back-to-back
calls issued without a synchronise: the parts of one wrapper take turns,
one block of 400 calls each per round, and each part is the median of nine
rounds, so a drift of the host's speed falls on all parts alike.  For each
wrapper (K1 fused norm, R = 4 D = 1536
bf16 with the residual add; K2 flash attention, S = 100; K3 decode
attention, 4 slots; K4 ragged concat, the concatenate node's clouds; K5
sLSTM scan, B = 4 S = 1 bf16) it reports:

* ``call``: the wrapper as the model calls it;
* ``no_launch``: the same call with the kernel's entry point (the ctypes
  function, or the Triton launcher) replaced by a Python stub, so
  ``launch = call - no_launch`` is the entry point's own cost, the CUDA
  launch included;
* ``alloc``: the wrapper's output allocations alone;
* ``device_context``: entering and leaving the device context the wrapper
  enters around its launch (``on_device`` where the tree has it, else
  ``torch.cuda.device``);
* ``stream``: the tree's ``stream_of`` alone;
* ``checks_and_glue``: ``no_launch`` less the three parts above: input
  checks, views, ``data_ptr`` reads and the Python around them.

Beside them, in K1's turns, ``torch.add`` of K1's two inputs: one PyTorch
op's host cost.
Prints one line per wrapper and one JSON line ``{"card": ..., "src": ...,
"wrappers": {name: {part: ms}}, "torch_add": ms}``.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


class _Stub:
    """Stands in for a kernel library: every entry point returns 0 (success)
    at once and launches nothing."""

    def __getattr__(self, name):
        return lambda *args: 0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import _device

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape, dt=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    ops = {n: importlib.import_module(f"repro_torch.kernels.{n}.ops")
           for n in ("rmsnorm", "flash_attention", "decode_attention", "ragged_concat",
                     "slstm_scan")}
    x, r, sc = rnd(4, 1536, dt=bf), rnd(4, 1536, dt=bf), rnd(1536)
    q, k, v = (rnd(1, 100, n, 128, dt=bf).transpose(1, 2) for n in (12, 2, 2))
    qd = rnd(4, 12, 128, dt=bf)
    kc, vc = (rnd(4, 512, 2, 128, dt=bf).transpose(1, 2) for _ in range(2))
    lens = torch.tensor([397, 250, 130, 17], dtype=torch.int32, device=dev)
    clouds = [500_000, 3_011, 2_987]
    src = rnd(3, max(clouds), 4)
    lt = torch.tensor(clouds, dtype=torch.int32, device=dev)
    d, h = 2048, 4
    xg, w = rnd(4, 1, 4 * d, dt=bf), rnd(h, d // h, 4 * d // h, dt=bf)
    bias, z = rnd(4 * d), torch.zeros(4, d, device=dev)
    m0 = torch.full((4, d), float("-inf"), device=dev)
    empty = lambda shape, dt: torch.empty(shape, dtype=dt, device=dev)  # noqa: E731
    # each wrapper: (call, its output allocations as the wrapper makes them)
    cases = {
        "rmsnorm": (lambda: ops["rmsnorm"].fused_rmsnorm(x, r, sc),
                    lambda: (torch.empty_like(x), torch.empty_like(x))),
        "flash_attention": (lambda: ops["flash_attention"].flash_attention(q, k, v),
                            lambda: empty((1, 100, 12, 128), bf).transpose(1, 2)),
        "decode_attention": (lambda: ops["decode_attention"].decode_attention(qd, kc, vc, lens),
                             lambda: (empty(qd.shape, bf),
                                      empty((4 * 2 * 8 * 8 * 130,), torch.float32))),
        "ragged_concat": (lambda: ops["ragged_concat"].ragged_concat(src, lt,
                                                                     capacity=sum(clouds)),
                          lambda: (empty((3,), torch.int32), empty((), torch.int32),
                                   empty((sum(clouds), 4), torch.float32))),
        "slstm_scan": (lambda: ops["slstm_scan"].slstm_scan(xg, w, bias, z, z, z, m0),
                       lambda: (empty((4, 1, d), torch.float32),
                                empty((4, 4, d), torch.float32))),
    }
    enter = getattr(_device, "on_device", None)

    def context():
        with (enter(x) if enter else torch.cuda.device(dev)):
            pass

    @contextlib.contextmanager
    def no_launch(mod):
        """The entry point replaced by a stub for the block: the ctypes
        library, or the parent tree's Triton launcher (``rmsnorm.ops.launch``)."""
        saved = {a: getattr(mod, a) for a in ("_lib", "launch") if hasattr(mod, a)}
        if "launch" in saved:
            mod.launch = lambda *a, **kw: None
        else:
            mod._lib = lambda: _Stub()
        try:
            yield
        finally:
            for a, f in saved.items():
                setattr(mod, a, f)

    def in_turns(blocks: dict, iters: int = 400, reps: int = 9) -> dict:
        """{part: host ms per call}: each part's block of ``iters`` calls in
        turn, ``reps`` rounds, the median per part.  A block is (fn, the
        context it runs in)."""
        for fn, ctx in blocks.values():
            with ctx():
                for _ in range(10):
                    fn()
        runs = {k: [] for k in blocks}
        for _ in range(reps):
            for k, (fn, ctx) in blocks.items():
                torch.cuda.synchronize()
                with ctx():
                    t0 = time.perf_counter()
                    for _ in range(iters):
                        fn()
                    runs[k].append((time.perf_counter() - t0) * 1e3 / iters)
        torch.cuda.synchronize()
        return {k: statistics.median(v) for k, v in runs.items()}

    plain = contextlib.nullcontext
    out, add_ms = {}, None
    for name, (call, alloc) in cases.items():
        mod = ops[name]
        blocks = {"call": (call, plain), "no_launch": (call, lambda: no_launch(mod)),
                  "alloc": (alloc, plain), "device_context": (context, plain),
                  "stream": (lambda: _device.stream_of(x), plain)}
        if name == "rmsnorm":       # one PyTorch op on K1's inputs, in the same turns
            blocks["torch_add"] = (lambda: torch.add(x, r), plain)
        parts = in_turns(blocks)
        if name == "rmsnorm":
            add_ms = parts.pop("torch_add")
        parts["launch"] = parts["call"] - parts["no_launch"]
        parts["checks_and_glue"] = (parts["no_launch"] - parts["alloc"] -
                                    parts["device_context"] - parts["stream"])
        out[name] = parts
        print(f"{name}: host ms per call " + ", ".join(f"{p} {ms:.5f}" for p, ms in parts.items()),
              flush=True)
    print(f"torch.add (4, 1536) bf16, in turns with rmsnorm: host ms per call {add_ms:.5f}",
          flush=True)
    print(json.dumps({"card": card, "src": str(Path(args.src).resolve()), "wrappers": out,
                      "torch_add": add_ms}), flush=True)


if __name__ == "__main__":
    main()
