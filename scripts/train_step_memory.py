#!/usr/bin/env python3
"""Device memory of one training step, stage by stage.

    PYTHONPATH=src python scripts/train_step_memory.py --arch xlstm-1.3b --batch 8 --seq 1024

Builds the full-width model in bf16 with AdamW's f32 master weights and
moments, then runs one step by hand: ``Model.loss``, its gradient,
``AdamW.update``.  After each stage it prints the memory allocated and the
peak so far (``torch.cuda.memory_allocated`` / ``max_memory_allocated``),
then times two more steps through ``make_train_step``.  A stage that runs
out of device memory is reported as such and ends the run with exit code
1.  Needs an NVIDIA GPU; the card's name and power limit are printed first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="xlstm-1.3b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.models.common import tree_items, tree_map
    from repro_torch.optim import AdamW, adamw

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    cfg = get_config(args.arch).scaled(param_dtype="bfloat16", compute_dtype="bfloat16")
    opt = AdamW(lr=1e-4)
    print(f"{cfg.name}: {cfg.num_layers} layers, param_count {cfg.param_count() / 1e9:.4f} B, "
          f"B={args.batch} S={args.seq}, remat {cfg.remat}, AdamW update in passes of "
          f"{adamw.CHUNK_BYTES} f32 bytes", flush=True)

    def stage(what: str) -> None:
        torch.cuda.synchronize()
        print(f"  {what}: allocated {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB, peak "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB", flush=True)

    model = Model(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (args.batch, args.seq), device=dev,
                                     generator=gen)}
    try:
        params = model.init(0)
        n = sum(t.numel() for _, t in tree_items(params))
        stage(f"params ({n / 1e9:.4f} B elements)")
        state = opt.init(params)
        stage("AdamW state")
        leaves = [p.requires_grad_() for _, p in tree_items(params)]
        loss = model.loss(params, batch)
        stage("forward")
        grads = iter(torch.autograd.grad(loss, leaves))
        stage("backward")
        state, m = opt.update(state, tree_map(lambda _: next(grads), params))
        del grads, loss                       # the iterator holds the grads
        stage("update")
        step = make_train_step(model, opt)
        for i in (2, 3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            print(f"  step {i}: loss {float(m['loss']):.5f}, "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
        stage("after 3 steps")
    except torch.OutOfMemoryError as e:
        stage("out of device memory")
        print(f"  {str(e).splitlines()[0]}", flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
