#!/usr/bin/env python3
"""The loss gap that int8 error-feedback compression opens over a few steps.

    PYTHONPATH=src python scripts/ef_loss_gap.py [--size smoke|100m|full] [--device cpu]
        [--steps 5] [--seeds 0 1 2] [--batch 2] [--seq 64] [--lr 3e-4] [--bf16]
        [--set vocab_size=151936 d_model=128 ...] [--profile] [--zeros]

Runs ``optim.make_hierarchical_train_step`` on a ``("pod",)`` mesh of one
rank (a one-rank group of its own: ``nccl`` on the card, where it runs
unless ``--device cpu`` asks for ``gloo`` on the CPU; without a card and
without ``--device cpu`` it exits) from the same init and on one fixed
random batch per seed, three ways: uncompressed, compressed, and
compressed with the error feedback dropped (the error memory zeroed
after every step: a planted fault).  Prints each step's losses and each
compressed run's absolute gap to the uncompressed run, also as a share
of the uncompressed run's fall since step 1, then the largest of each
over all seeds and steps.  ``chip_smoke.py`` phase 31 holds the
compressed step's sums and errors exactly against a plain quantisation
and its losses within a bound of the uncompressed run's fall; these
readings are that bound's source.  With ``--profile`` (on the card) it
also prints one more compressed and one uncompressed step's device time
by kernel (``torch.profiler``) and their host wall; with ``--zeros`` the
share of step 1's gradient elements that quantize to 0 (all compressed
leaves, and the leaves with the largest shares).
"""

from __future__ import annotations

import argparse
import datetime
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

MODES = ("uncompressed", "compressed", "no feedback")


def _profile(step, state, err, batch, label: str, top: int = 12) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, err, batch)
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(e.device_time_total for e in prof.events()
               if e.device_type.name == "CUDA") / 1e3
    print(json.dumps({"profile": label, "wall_ms": 1e3 * wall, "device_busy_ms": busy,
                      "top_ms": [(k[:70], round(ms, 3), n) for k, ms, n in rows[:top]]}),
          flush=True)


def _zeros(model, params, batch, label: str, top: int = 5) -> None:
    """The share of step 1's gradient elements whose int8 ``q`` is 0."""
    import torch

    from repro_torch.models.common import tree_items
    from repro_torch.optim.grad_compress import SMALL_BYTES

    items = list(tree_items(params))
    leaves = [p.requires_grad_() for _, p in items]
    grads = torch.autograd.grad(model.loss(params, batch), leaves)
    zero = total = 0
    shares = []
    with torch.no_grad():
        for (path, _), g in zip(items, grads):
            if g.numel() * g.element_size() < SMALL_BYTES:
                continue
            x = g.float()
            scale = torch.clamp(x.abs().amax(), min=1e-30) / 127.0
            z = int((torch.round(x / scale) == 0).sum())
            zero, total = zero + z, total + g.numel()
            shares.append((z / g.numel(), path, g.numel()))
    shares.sort(reverse=True)
    print(json.dumps({"zeros": label, "share": zero / total, "elements": total,
                      "top": [(path, round(sh, 4), n) for sh, path, n in shares[:top]]}),
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--size", choices=("smoke", "100m", "full"), default="smoke")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 params and compute (the smoke and 100m configs are f32)")
    ap.add_argument("--set", nargs="*", default=[], metavar="FIELD=INT",
                    help="config fields to override (integers), e.g. vocab_size=151936")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--zeros", action="store_true")
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, get_smoke_config, model_100m
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.models.common import tree_items
    from repro_torch.optim import AdamW, init_error_state, make_hierarchical_train_step

    cfg = {"smoke": get_smoke_config, "100m": model_100m, "full": get_config}[args.size](args.arch)
    if args.bf16:
        cfg = cfg.scaled(param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = cfg.scaled(**{k: int(v) for k, v in (kv.split("=") for kv in args.set)})
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("ef_loss_gap.py: no CUDA device (pass --device cpu to run on the CPU)")
    dist.init_process_group("gloo" if dev.type == "cpu" else "nccl", store=dist.HashStore(),
                            rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh((1,), ("pod",), device=dev.type)
        model, opt = Model(cfg, device=dev), AdamW(lr=args.lr)
        worst = {m: [0.0, 0.0] for m in MODES[1:]}
        for seed in args.seeds:
            gen = torch.Generator(device=dev).manual_seed(seed)
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (args.batch, args.seq),
                                             generator=gen, device=dev, dtype=torch.int32)}
            runs = {}
            if args.zeros and seed == args.seeds[0]:
                _zeros(model, model.init(seed), batch, f"{cfg.name} seed {seed}")
            for mode in MODES:
                state = opt.init(model.init(seed))
                err = init_error_state(state["params"]) if mode != "uncompressed" else None
                step = make_hierarchical_train_step(model, opt, mesh,
                                                    compress=mode != "uncompressed")
                losses = []
                for _ in range(args.steps):
                    state, err, m = step(state, err, batch)
                    losses.append(float(m["loss"]))
                    if mode == "no feedback":
                        for _, e in tree_items(err):
                            e.zero_()
                runs[mode] = losses
                if args.profile and seed == args.seeds[0] and mode != "no feedback":
                    _profile(step, state, err, batch, f"{cfg.name} {mode} step")
                del state, err
            falls = [runs["uncompressed"][0] - x for x in runs["uncompressed"]]
            rec = {"arch": cfg.name, "seed": seed, **{m: runs[m] for m in MODES}}
            for mode in MODES[1:]:
                gaps = [abs(a - b) for a, b in zip(runs[mode], runs["uncompressed"])]
                shares = [g / f if f > 0 else None for g, f in zip(gaps, falls)]
                rec[f"{mode} gap"], rec[f"{mode} gap_over_fall"] = gaps, shares
                worst[mode][0] = max(worst[mode][0], *gaps)
                worst[mode][1] = max([worst[mode][1]] + [x for x in shares if x is not None])
            print(json.dumps(rec), flush=True)
        card = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
        print(json.dumps({"arch": cfg.name, "size": args.size, "set": args.set, "device": card,
                          "dtype": str(cfg.pdt), "steps": args.steps,
                          "batch": [args.batch, args.seq], "lr": args.lr,
                          **{f"max {m} gap": w[0] for m, w in worst.items()},
                          **{f"max {m} gap_over_fall": w[1] for m, w in worst.items()}}),
              flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
