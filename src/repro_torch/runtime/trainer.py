"""Training loop: zero-copy data plane + checkpoint/restart + stragglers.

Counterpart of ``repro/runtime/trainer.py`` at world size 1 (no mesh:
that waits for ROADMAP.md, Queue 1 item 8)::

    ZeroCopyPipeline (separate process, agnocast topics)
        └─▶ Trainer.step: tokens to the device → train_step (state in place)
                └─▶ Checkpointer (async, atomic) every ``ckpt_every`` (0: never)
                └─▶ StragglerMonitor hook

It runs on the model's device: ``cuda`` unless the ``Model`` was built
with ``device="cpu"``.  ``Trainer.run`` restores the latest checkpoint in
``ckpt_dir`` if one exists (params, optimizer state, data cursor) and
continues from the next step.

The data cursor: the in-process pipeline's is its document cursor and the
packer's buffer, as in the reference.  The zero-copy data plane is
``OrderedZeroCopyPipeline`` (``data/ordered.py``): the copied stage and
topic with credits, so no batch is dropped, and the index of the next
batch as its cursor, so a resumed run trains on the batches the
uninterrupted one would have.  The reference's trainer saves a zero-copy
cursor of 0 and its keep-last topic drops batches a slow trainer has not
taken (ROADMAP.md, Queue 3).
"""

from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field

import torch

from repro_torch.checkpoint import Checkpointer, latest_step
from repro_torch.data import BatchSpec, InProcessPipeline
from repro_torch.data.ordered import OrderedZeroCopyPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.runtime.fault_tolerance import StragglerMonitor

__all__ = ["Trainer", "TrainerConfig"]


@dataclass
class TrainerConfig:
    batch: int = 8
    seq_len: int = 256
    lr: float = 3e-4
    warmup: int = 20
    total_steps: int = 200
    ckpt_every: int = 50
    ckpt_dir: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "agnocast-ckpt"))
    ckpt_keep: int = 2
    zero_copy_data: bool = True   # False -> in-process pipeline (tests)
    log_every: int = 10
    seed: int = 0


class Trainer:
    def __init__(self, model, tc: TrainerConfig):
        self.model = model
        self.tc = tc
        self.opt = AdamW(lr=cosine_schedule(tc.lr, tc.warmup, tc.total_steps))
        self.ckpt = Checkpointer(tc.ckpt_dir, keep=tc.ckpt_keep)
        self.monitor = StragglerMonitor([0])
        self.metrics_log: list[dict] = []
        self.step_num = 0
        self._pipeline = None
        self._state = None
        self._step_fn = make_train_step(model, self.opt)

    @property
    def state(self) -> dict | None:
        return self._state

    # -- setup -----------------------------------------------------------------

    def _init_or_restore(self):
        spec = BatchSpec(self.tc.batch, self.tc.seq_len, self.model.cfg.vocab_size,
                         seed=self.tc.seed)
        self._state = self.opt.init(self.model.init(self.tc.seed))
        dstate = None
        if latest_step(self.tc.ckpt_dir) is not None:
            # filled in place: one state on the card, not two
            _, step, extra = self.ckpt.restore(self._state)
            self.step_num = step
            dstate = extra.get("data_state", {"cursor": 0})
            cursor = {k: v for k, v in dstate.items() if k != "buf"}
            print(f"[trainer] restored step {step} (data cursor {cursor})")
        if self.tc.zero_copy_data:
            self._pipeline = OrderedZeroCopyPipeline(
                spec, cursor=int((dstate or {}).get("batches", 0)))
        elif dstate is not None:
            self._pipeline = InProcessPipeline.restore(spec, dstate)
        else:
            self._pipeline = InProcessPipeline(spec)

    # -- loop ------------------------------------------------------------------

    def _next_batch(self) -> dict:
        if isinstance(self._pipeline, InProcessPipeline):
            return next(self._pipeline)
        return self._pipeline.next_batch()

    def run(self, steps: int | None = None) -> dict:
        if self._state is None:
            self._init_or_restore()
        steps = steps or self.tc.total_steps
        dev = self.model.device
        t_run = time.monotonic()
        losses = []
        while self.step_num < steps:
            t0 = time.monotonic()
            raw = self._next_batch()
            batch = {"tokens": torch.from_numpy(raw["tokens"]).to(dev)}
            self._state, metrics = self._step_fn(self._state, batch)
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            self.monitor.record(0, dt)
            self.step_num += 1
            losses.append(loss)
            rec = {"step": self.step_num, "loss": loss, "dt": dt,
                   "grad_norm": float(metrics["grad_norm"])}
            self.metrics_log.append(rec)
            if self.step_num % self.tc.log_every == 0:
                print(f"[trainer] step {rec['step']:5d} loss {loss:8.4f} "
                      f"gnorm {rec['grad_norm']:7.3f} {dt*1e3:7.1f} ms")
            if self.tc.ckpt_every and self.step_num % self.tc.ckpt_every == 0:
                self._save()
        if self.tc.ckpt_every and self.step_num % self.tc.ckpt_every:
            self._save()                         # not saved by the loop's last step
        wall = time.monotonic() - t_run
        return {"steps": self.step_num, "loss_first": losses[0] if losses else None,
                "loss_last": losses[-1] if losses else None, "wall_s": wall,
                "stragglers": self.monitor.stragglers()}

    def _save(self):
        dstate = (self._pipeline.state()
                  if isinstance(self._pipeline, InProcessPipeline)
                  else {"batches": self._pipeline.cursor})
        self.ckpt.save(self.step_num, self._state, extra={"data_state": dstate})

    def close(self):
        self.ckpt.wait()
        if isinstance(self._pipeline, OrderedZeroCopyPipeline):
            self._pipeline.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
