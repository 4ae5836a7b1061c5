"""Optimizer for the port's trainer: AdamW with f32 master weights and the
reference's cosine schedule.

Counterpart of ``repro/optim``.  Its ``grad_compress`` (error-feedback int8
gradient all-reduce under ``shard_map``) needs the trainer's mesh and
waits for it (ROADMAP.md, Queue 1 item 8).
"""

from .adamw import AdamW, TrainState
from .schedule import cosine_schedule

__all__ = ["AdamW", "TrainState", "cosine_schedule"]
