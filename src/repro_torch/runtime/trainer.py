"""Training loop: zero-copy data plane + checkpoint/restart + stragglers.

Counterpart of ``repro/runtime/trainer.py``::

    ZeroCopyPipeline (separate process, agnocast topics)
        └─▶ Trainer.step: tokens to the device → train_step (state in place)
                └─▶ Checkpointer (async, atomic) every ``ckpt_every`` (0: never)
                └─▶ StragglerMonitor hook

It runs on the model's device: ``cuda`` unless the ``Model`` was built
with ``device="cpu"``.  ``Trainer.run`` restores the latest checkpoint in
``ckpt_dir`` if one exists (params, optimizer state, data cursor) and
continues from the next step.

With a ``mesh`` (``launch.mesh.make_mesh``, every rank of the world
running its own ``Trainer``; ``rules`` override
``launch.steps.train_rules``) the state is the rank's blocks under
``sharding.param_partition_specs`` (the optimizer's trees as the params,
the step replicated): ``Model.init`` under the mesh gives them.  The
restore keeps each leaf's block of those shardings
(``Checkpointer.restore(shardings=...)``, so a checkpoint saved on
another mesh, or without one, restores onto it) and the save writes
each global leaf once (``Checkpointer.save(shardings=...)``).  The step
runs under ``sharding.use_mesh``: tensor parallelism over ``model``, FSDP
over ``data``, data parallelism over ``("pod", "data")``
(``launch.steps.make_train_step``).  Each rank takes its rows of every
global batch, row-major over the batch axes (the same rows on every
``model`` rank); every rank draws the same global batches, so the data
cursor is the global one.  ``loss`` and ``grad_norm`` in ``metrics_log``
are the global values.  On a mesh of size 1 the run equals the run
without one.  The dense family trains there; the others, and serving on
a mesh, are the later parts of ROADMAP.md Queue 1 item 8c, and raise.

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
from repro_torch.launch.steps import batch_specs, make_train_step, shardings_for, train_rules
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.runtime.fault_tolerance import StragglerMonitor
from repro_torch.sharding import (P, MeshContext, NamedSharding, check_on_mesh,
                                  param_partition_specs, use_mesh)

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
    def __init__(self, model, tc: TrainerConfig, *, mesh=None, rules: dict | None = None):
        if mesh is not None:
            check_on_mesh(model.cfg, "train", mesh)
        self.model = model
        self.tc = tc
        self.mesh = mesh
        self.rules = {**(train_rules(model.cfg, mesh) if mesh is not None else {}),
                      **(rules or {})}
        self._state_sh = self._batch_sh = None
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

    def _state_shardings(self) -> dict:
        """The state's ``NamedSharding``s on the mesh: params, master, m and
        v by the params' specs, the step replicated."""
        ctx = MeshContext(self.mesh, self.rules)
        psh = shardings_for(param_partition_specs(self.model.abstract_params(whole=True), ctx),
                            self.mesh)
        return {"params": psh, "master": psh, "m": psh, "v": psh,
                "step": NamedSharding(self.mesh, P())}

    def _init_or_restore(self):
        spec = BatchSpec(self.tc.batch, self.tc.seq_len, self.model.cfg.vocab_size,
                         seed=self.tc.seed)
        if self.mesh is None:
            self._state = self.opt.init(self.model.init(self.tc.seed))
        else:
            self._state_sh = self._state_shardings()
            with use_mesh(self.mesh, self.rules) as ctx:
                self._state = self.opt.init(self.model.init(self.tc.seed))
                tokens = torch.empty((self.tc.batch, self.tc.seq_len), dtype=torch.int32,
                                     device="meta")
                self._batch_sh = NamedSharding(
                    self.mesh, batch_specs(self.model.cfg, {"tokens": tokens}, ctx)["tokens"])
        dstate = None
        if latest_step(self.tc.ckpt_dir) is not None:
            # filled in place: one state on the card, not two
            _, step, extra = self.ckpt.restore(self._state, shardings=self._state_sh)
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
            raw = torch.from_numpy(self._next_batch()["tokens"])
            if self._batch_sh is not None:      # the rank's rows of the global batch
                raw = self._batch_sh.block(raw)
            batch = {"tokens": raw.to(dev)}
            if self.mesh is None:
                self._state, metrics = self._step_fn(self._state, batch)
            else:
                with use_mesh(self.mesh, self.rules):
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
        self.ckpt.save(self.step_num, self._state, extra={"data_state": dstate},
                       shardings=self._state_sh)

    def close(self):
        self.ckpt.wait()
        if isinstance(self._pipeline, OrderedZeroCopyPipeline):
            self._pipeline.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
