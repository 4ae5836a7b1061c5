"""Training launcher: the ``Trainer`` over the zero-copy data plane.

    PYTHONPATH=src python -m repro_torch.launch.train --steps 8 --batch 8 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train --size smoke --device cpu --steps 4

Counterpart of ``repro/launch/train.py``, with its flags and two of
``launch.serve``'s: ``--device`` (default ``cuda``; ``cpu`` trains
through the kernels' plain versions) and ``--layers`` (cut the depth).
By default it trains full-width qwen2-1.5b (28 layers, d_model 1536, bf16
params with f32 master weights and moments, 1.54 B parameters drawn from
``TrainerConfig.seed``) on the GPU, through the fused RMSNorm and flash-attention
kernels and their backward kernels.  ``--arch`` takes the archs whose loss
takes tokens alone (``launch.serve.SERVED_ARCH_IDS``), xlstm-1.3b
included (its sLSTM scan through K5 and K5-bwd).  ``--resume`` is not a
flag: a restarted run restores the latest checkpoint in ``--ckpt-dir``
(default under the system's temporary directory) by itself.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.launch.serve import SERVED_ARCH_IDS, build_config
from repro_torch.models import Model
from repro_torch.runtime.trainer import Trainer, TrainerConfig

__all__ = ["main"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=SERVED_ARCH_IDS, default="qwen2-1.5b")
    ap.add_argument("--size", choices=("smoke", "100m", "full"), default="full")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth (default: all)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "agnocast-train-ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50, help="0: no checkpoint")
    ap.add_argument("--data", choices=("zero-copy", "in-process"), default="zero-copy")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    cfg = build_config(args.arch, args.size, args.layers)
    model = Model(cfg, device=args.device)
    n = cfg.param_count()
    print(f"[train] {args.arch} ({args.size}, {cfg.num_layers} layers) on {model.device}: "
          f"{n/1e6:.1f}M params, {args.steps} steps @ batch {args.batch} x seq {args.seq}")
    tc = TrainerConfig(batch=args.batch, seq_len=args.seq, lr=args.lr,
                       total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every,
                       zero_copy_data=(args.data == "zero-copy"))
    with Trainer(model, tc) as tr:
        summary = tr.run()
    if summary["loss_first"] is not None:
        print(f"[train] done: loss {summary['loss_first']:.4f} -> "
              f"{summary['loss_last']:.4f} in {summary['wall_s']:.1f}s")
    return summary


if __name__ == "__main__":
    main()
