"""The port's ``Trainer`` on the CPU: a checkpoint restart resumes at the
next step with its data cursor (the reference's
``tests/test_runtime.py::test_trainer_checkpoint_restart``), and the f32
losses after a restart equal those of the uninterrupted run, with the
in-process and with the zero-copy data plane."""

import numpy as np
import pytest

from repro_torch.configs import model_100m
from repro_torch.models import Model
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from _port_env import port_test_env  # noqa: F401  (autouse)


def _cfg():
    return model_100m("qwen2-1.5b").scaled(num_layers=2, d_model=64, d_ff=128,
                                          vocab_size=512, num_heads=2,
                                          num_kv_heads=1, head_dim=32)


def _run(tmp, total: int, zero_copy: bool = False, stop: int | None = None,
         ckpt_every: int = 2) -> Trainer:
    """A trainer of ``total`` steps on ``tmp``, run to ``stop`` (its end by
    default) and closed."""
    tc = TrainerConfig(batch=2, seq_len=64, total_steps=total, ckpt_every=ckpt_every, warmup=2,
                       lr=3e-3, ckpt_dir=str(tmp), zero_copy_data=zero_copy, log_every=100)
    t = Trainer(Model(_cfg(), device="cpu"), tc)
    t.run(stop)
    t.close()
    return t


def test_trainer_checkpoint_restart(tmp_path):
    t1 = _run(tmp_path, 4)
    assert t1.step_num == 4
    # "crash" and restart: must resume from step 4, run to 6, data cursor kept
    t2 = _run(tmp_path, 6)
    assert t2.step_num == 6
    assert t2.metrics_log[0]["step"] == 5       # continued, not restarted
    assert t2._pipeline.cursor >= t1._pipeline.cursor > 0


@pytest.mark.parametrize("zero_copy", [False, True])
def test_restart_losses_equal_the_uninterrupted_run(tmp_path, zero_copy):
    """Six steps straight against four, a restart, and two more of the same
    six-step schedule: the same f32 losses at steps 5 and 6 (the same
    batches, the same restored state; the CPU's arithmetic is
    deterministic, so exactly)."""
    straight = _run(tmp_path / "a", 6, zero_copy)
    _run(tmp_path / "b", 6, zero_copy, stop=4)
    resumed = _run(tmp_path / "b", 6, zero_copy)
    want = [r["loss"] for r in straight.metrics_log[4:]]
    got = [r["loss"] for r in resumed.metrics_log]
    assert [r["step"] for r in resumed.metrics_log] == [5, 6]
    np.testing.assert_array_equal(got, want)
    assert straight.metrics_log[-1]["loss"] < straight.metrics_log[0]["loss"]


def test_ckpt_every_zero_saves_no_checkpoint(tmp_path):
    """``ckpt_every=0`` trains without writing a checkpoint, in the loop or
    at its end (what a run that only measures its steps asks for)."""
    t = _run(tmp_path, 3, ckpt_every=0)
    assert t.step_num == 3 and not any(tmp_path.iterdir())
