"""The port's error-feedback int8 gradient compression
(``repro_torch.optim.grad_compress``) held against the reference's
(``repro.optim.grad_compress``, its cases in ``tests/test_grad_compress.py``)
on the same numpy inputs.

* Pod size 1 (one ``gloo`` rank): the quantization identity, the error
  bound (hypothesis), error feedback over 20 steps, small leaves left
  uncompressed, ``ef_int8_psum``'s sum and error against JAX's within
  1e-6, and the hierarchical step: uncompressed equal to ``make_train_step``
  (exactly, on the CPU), compressed learning and tracking it.
* Pod size 2 (spawned ``gloo`` ranks, ``tests/_mesh_ranks.py``) on smoke
  qwen2: two uncompressed steps equal one process's plain step on the
  whole batch within 3e-5, and the compressed step hands both ranks'
  optimizers the same grads, the numpy sum of each rank's dequantised
  ``q * scale`` over 2.
"""

import dataclasses
import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.optim import ef_int8_psum as jax_ef_int8_psum
from repro.sharding import shard_map as jax_shard_map
from repro_torch.configs import model_100m
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model
from repro_torch.models.common import tree_items
from repro_torch.optim import (AdamW, ef_int8_psum, init_error_state,
                               make_hierarchical_train_step, tree_ef_int8_psum)
from repro_torch.sharding import shard_map
from _mesh_ranks import run_ranks
from _port_env import port_test_env  # noqa: F401  (autouse)

TOL = 3e-5      # tests/test_kernels.py:17-18, f32


@pytest.fixture(scope="module")
def pod1():
    """A ``("pod",)`` mesh of one ``gloo`` rank, its group destroyed when the
    module ends (the xdist worker runs other files after this one)."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    yield make_mesh((1,), ("pod",), device="cpu")
    dist.destroy_process_group()


def _on_pod(mesh, fn, *args):
    return shard_map(fn, mesh=mesh)(*args)


def test_quantization_identity(pod1):
    """x == dequant(q) + error (EF memory loses nothing)."""
    g = torch.from_numpy((np.random.default_rng(0).normal(size=(64, 64)) * 3).astype(np.float32))
    total, err = _on_pod(pod1, lambda g, e: ef_int8_psum(g, e, "pod"), g, torch.zeros_like(g))
    np.testing.assert_allclose((total + err).numpy(), g.numpy(), rtol=0, atol=1e-5)


@settings(max_examples=15, deadline=None)
@given(st.floats(0.01, 1e4), st.integers(0, 5))
def test_quantization_error_bounded(pod1, scale, seed):
    g = torch.from_numpy((np.random.default_rng(seed).normal(size=(32,)) * scale)
                         .astype(np.float32))
    _, err = _on_pod(pod1, lambda g, e: ef_int8_psum(g, e, "pod"), g, torch.zeros_like(g))
    bound = float(g.abs().max()) / 127.0 / 2 + 1e-6
    assert float(err.abs().max()) <= bound * 1.01


def test_error_feedback_converges(pod1):
    """Constant gradient: the running sum of compressed outputs stays within
    one quantization step of step x g."""
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(128,)).astype(np.float32))
    err, acc = torch.zeros_like(g), torch.zeros_like(g)
    for step in range(1, 21):
        out, err = _on_pod(pod1, lambda g, e: ef_int8_psum(g, e, "pod"), g, err)
        acc = acc + out
        assert float((acc - step * g).abs().max()) <= float(g.abs().max()) / 127.0 + 1e-5


def test_tree_small_leaves_uncompressed(pod1):
    tree = {"big": torch.ones((64, 64)), "tiny": torch.tensor(3.0)}
    errs = {"big": torch.zeros((64, 64)), "tiny": torch.tensor(0.0)}
    out, new_err = _on_pod(pod1, lambda t, e: tree_ef_int8_psum(t, e, "pod"), tree, errs)
    assert float(out["tiny"]) == 3.0 and float(new_err["tiny"]) == 0.0
    assert new_err["tiny"] is errs["tiny"]
    assert float(new_err["big"].abs().max()) == 0.0      # ones quantize exactly


def _jax_ef(g: np.ndarray, e: np.ndarray):
    mesh = jax.make_mesh((1,), ("pod",))
    from jax.sharding import PartitionSpec

    return jax.jit(jax_shard_map(lambda g, e: jax_ef_int8_psum(g, e, "pod"), mesh=mesh,
                                 in_specs=PartitionSpec(), out_specs=PartitionSpec(),
                                 check_rep=False))(jnp.asarray(g), jnp.asarray(e))


@pytest.mark.parametrize("shape,scale", [((64, 64), 3.0), ((1000,), 1e-3), ((7, 33), 50.0)])
def test_ef_int8_psum_matches_the_reference(pod1, shape, scale):
    """Sum and new error within 1e-6 of JAX's, from a non-zero error."""
    rng = np.random.default_rng(2)
    g = (rng.normal(size=shape) * scale).astype(np.float32)
    e = (rng.normal(size=shape) * scale / 300).astype(np.float32)
    jt, je = _jax_ef(g, e)
    tt, te = _on_pod(pod1, lambda g, e: ef_int8_psum(g, e, "pod"), torch.from_numpy(g),
                     torch.from_numpy(e))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-6 * max(1, scale))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=1e-6 * max(1, scale))


def _cfg():
    return model_100m("qwen2-1.5b").scaled(num_layers=2, d_model=64, d_ff=128, vocab_size=256,
                                          num_heads=2, num_kv_heads=1, head_dim=32)


def _tokens(b: int, s: int = 64) -> np.ndarray:
    return np.random.default_rng(0).integers(0, 256, (b, s)).astype(np.int32)


def test_hierarchical_step_at_one_pod(pod1):
    """Uncompressed: the same losses and params as ``make_train_step``,
    exactly.  Compressed (the reference's ``test_hierarchical_step_trains``):
    the loss falls over 5 steps and ends within 0.15 of the uncompressed
    run's."""
    model, opt = Model(_cfg(), device="cpu"), AdamW(lr=1e-3)
    batch = {"tokens": torch.from_numpy(_tokens(2))}
    runs = {}
    for mode in ("plain", "uncompressed", "compressed"):
        state = opt.init(model.init(0))
        err = init_error_state(state["params"])
        losses = []
        for _ in range(5):
            if mode == "plain":
                state, m = make_train_step(model, opt)(state, batch)
            else:
                state, err, m = make_hierarchical_train_step(
                    model, opt, pod1, compress=mode == "compressed")(state, err, batch)
            losses.append(float(m["loss"]))
        runs[mode] = (losses, state, err)
    assert runs["uncompressed"][0] == runs["plain"][0]
    for (p, a), (_, b) in zip(tree_items(runs["plain"][1]["params"]),
                              tree_items(runs["uncompressed"][1]["params"])):
        assert torch.equal(a, b), p
    losses = runs["compressed"][0]
    assert losses[-1] < losses[0]
    assert abs(losses[-1] - runs["uncompressed"][0][-1]) < 0.15
    assert any(float(e.abs().max()) > 0 for _, e in tree_items(runs["compressed"][2]))


def test_hierarchical_step_refuses_a_mesh_without_pods_or_with_inner_axes(pod1):
    from repro_torch.sharding import AbstractMesh

    model, opt = Model(_cfg(), device="cpu"), AdamW()
    with pytest.raises(ValueError, match="pod"):
        make_hierarchical_train_step(model, opt, AbstractMesh((1,), ("data",)))
    with pytest.raises(NotImplementedError, match="8c"):
        make_hierarchical_train_step(model, opt, AbstractMesh((1, 2), ("pod", "model")))


@pytest.fixture(scope="module")
def two_pods(tmp_path_factory):
    """One spawn of 2 ranks, mesh ``("pod",)`` of 2, each on its half of a
    batch of 4 (``_mesh_ranks.hierarchical``)."""
    return run_ranks("hierarchical", 2, tmp_path_factory.mktemp("pods"),
                     dataclasses.asdict(_cfg()), _tokens(4), 2)


def test_two_pods_uncompressed_equal_the_whole_batch_step(two_pods):
    model, opt = Model(_cfg(), device="cpu"), AdamW(lr=1e-3)
    state = opt.init(model.init(0))
    step = make_train_step(model, opt)
    batch = {"tokens": torch.from_numpy(_tokens(4))}
    losses = []
    for _ in range(2):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    for rank in two_pods:
        np.testing.assert_allclose(rank["losses"], losses, atol=TOL, rtol=TOL)
        for p, t in tree_items(state["params"]):
            np.testing.assert_allclose(rank["params"][p].numpy(), t.detach().numpy(),
                                       atol=TOL, rtol=TOL, err_msg=p)


def test_two_pods_compressed_sum_the_dequantised_blocks(two_pods):
    """Both ranks hand their optimizer the same grads: for each leaf of 1
    KiB or more, (q0 * s0 + q1 * s1) / 2 with each rank's int8 ``q`` and
    scale formed in numpy from its own grads; a smaller leaf's plain mean.
    Each rank's new error is its own grad less its ``q * s``."""
    r0, r1 = two_pods
    for p, g0 in r0["local_grads"].items():
        g = [g0.numpy(), r1["local_grads"][p].numpy()]
        np.testing.assert_array_equal(r0["reduced_grads"][p].numpy(),
                                      r1["reduced_grads"][p].numpy(), err_msg=p)
        if g[0].size * g[0].itemsize < 1024:
            want, errs = (g[0] + g[1]) / 2, [np.zeros_like(g[0])] * 2
        else:
            deq = []
            for x in g:
                s = np.float32(max(np.abs(x).max(), 1e-30) / np.float32(127.0))
                q = np.clip(np.round(x / s), -127, 127).astype(np.int8)
                deq.append(q.astype(np.float32) * s)
            want = (deq[0] + deq[1]) / 2
            errs = [g[0] - deq[0], g[1] - deq[1]]
        np.testing.assert_allclose(r0["reduced_grads"][p].numpy(), want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max() + 1e-30), err_msg=p)
        for r, e in zip((r0, r1), errs):
            np.testing.assert_allclose(r["errors"][p].numpy(), e, rtol=0,
                                       atol=1e-6 * float(np.abs(g[0]).max() + 1e-30),
                                       err_msg=p)
    assert r0["compressed_loss"] == r1["compressed_loss"]
