"""The port's checkpointer: atomic commit, GC, async errors, restore in
place and onto a device, bf16 leaves bit for bit, and its directory and
manifest format shared with the reference's (``tests/test_checkpoint.py``
holds the reference's)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro_torch.checkpoint import Checkpointer, latest_step
from _port_env import port_test_env  # noqa: F401  (autouse)


def _state(k=0):
    return {"params": {"w": torch.arange(12.0).reshape(3, 4) + k,
                       "b": torch.ones((4,)) * k},
            "step": torch.tensor(k, dtype=torch.int32)}


def _jax_state(k=0):
    return {"params": {"w": jnp.arange(12.0).reshape(3, 4) + k, "b": jnp.ones((4,)) * k},
            "step": jnp.int32(k)}


def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(5, _state(5), extra={"data_cursor": 17})
    got, step, extra = ck.restore(_state())
    assert step == 5 and extra["data_cursor"] == 17
    assert torch.equal(got["params"]["w"], _state(5)["params"]["w"])
    assert int(got["step"]) == 5


def test_restore_fills_in_place_or_onto_a_device(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(2, _state(2))
    live = _state()
    w = live["params"]["w"]
    got, _, _ = ck.restore(live)
    assert got["params"]["w"] is w and float(w[0, 0]) == 2.0     # the same tensor, filled
    fresh = _state()
    got, _, _ = ck.restore(fresh, device="cpu")
    assert got["params"]["w"] is not fresh["params"]["w"]
    assert float(fresh["params"]["w"][0, 0]) == 0.0 and float(got["params"]["w"][0, 0]) == 2.0


def test_save_snapshots_before_returning(tmp_path):
    """The next step updates the state in place right after ``save``: the
    checkpoint must hold the values at the call, not later ones."""
    ck = Checkpointer(str(tmp_path), async_save=True)
    st = _state(1)
    ck.save(1, st)
    st["params"]["w"].add_(100.0)
    ck.wait()
    got, _, _ = ck.restore(_state())
    assert torch.equal(got["params"]["w"], _state(1)["params"]["w"])


def test_latest_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        ck.save(s, _state(s))
    assert latest_step(str(tmp_path)) == 4
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert len(kept) == 2  # keep=2
    got, step, _ = ck.restore(_state())
    assert step == 4 and float(got["params"]["b"][0]) == 4.0


def test_async_save_overlaps_and_waits(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(1, _state(1))
    ck.wait()
    assert latest_step(str(tmp_path)) == 1


def test_async_error_surfaces_on_wait(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"), async_save=True)
    os.rmdir(tmp_path / "ck")                        # the write must fail
    (tmp_path / "ck").write_text("not a directory")
    ck.save(1, _state(1))
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        ck.wait()


def test_atomic_no_partial_pickup(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, _state(1))
    # simulate a crash mid-save: a stale tmp dir must be ignored by restore
    stale = os.path.join(tmp_path, "step_0000000002.tmp-999")
    os.makedirs(stale)
    with open(os.path.join(stale, "manifest.json"), "w") as f:
        json.dump({"step": 2}, f)
    assert latest_step(str(tmp_path)) == 1
    _, step, _ = ck.restore(_state())
    assert step == 1


def test_restore_shape_mismatch_raises(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, _state(1))
    bad = {"params": {"w": torch.zeros((2, 2)), "b": torch.zeros((4,))},
           "step": torch.tensor(0, dtype=torch.int32)}
    with pytest.raises(ValueError, match="shape"):
        ck.restore(bad)
    with pytest.raises(ValueError, match="leaves"):
        ck.restore({"params": {"w": torch.zeros((3, 4))}, "step": torch.tensor(0)})


def test_bf16_leaf_round_trips_bit_for_bit(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    w = torch.randn(5, 7, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    w[0, :3] = torch.tensor([float("inf"), -0.0, 1e-40]).to(torch.bfloat16)
    ck.save(3, {"w": w, "m": w.float()})
    with open(tmp_path / "step_0000000003" / "manifest.json") as f:
        recs = {r["path"]: r for r in json.load(f)["leaves"]}
    assert recs["['w']"]["dtype"] == "bfloat16" and recs["['m']"]["dtype"] == "float32"
    got, _, _ = ck.restore({"w": torch.zeros(5, 7, dtype=torch.bfloat16),
                            "m": torch.zeros(5, 7)})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), w.view(torch.int16))


def test_format_is_the_references(tmp_path):
    """A checkpoint of f32/int leaves written by either package restores in
    the other: the same directory, leaf files, manifest and leaf paths."""
    Checkpointer(str(tmp_path / "port"), async_save=False).save(4, _state(4), extra={"c": 1})
    got, step, extra = JaxCheckpointer(str(tmp_path / "port"), async_save=False).restore(
        jax.eval_shape(_jax_state))
    assert step == 4 and extra == {"c": 1}
    np.testing.assert_array_equal(np.asarray(got["params"]["w"]), _state(4)["params"]["w"])
    JaxCheckpointer(str(tmp_path / "ref"), async_save=False).save(6, _jax_state(6))
    got, step, _ = Checkpointer(str(tmp_path / "ref")).restore(_state())
    assert step == 6 and torch.equal(got["params"]["w"], _state(6)["params"]["w"])
