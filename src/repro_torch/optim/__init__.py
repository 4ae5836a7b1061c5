"""Optimizer for the port's trainer: AdamW with f32 master weights, the
reference's cosine schedule, and the error-feedback int8 gradient sum
across pods (``grad_compress``, over a mesh's ``pod`` axis).

Counterpart of ``repro/optim``.
"""

from .adamw import AdamW, TrainState
from .grad_compress import (ef_int8_psum, init_error_state, make_hierarchical_train_step,
                            tree_ef_int8_psum)
from .schedule import cosine_schedule

__all__ = ["AdamW", "TrainState", "cosine_schedule", "ef_int8_psum", "tree_ef_int8_psum",
           "init_error_state", "make_hierarchical_train_step"]
