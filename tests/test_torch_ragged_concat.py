"""The port's ragged concat (K4): its plain version (what
``ops.ragged_concat`` runs for CPU tensors) held against the JAX
reference's ``ragged_concat_ref`` on the same inputs — exactly — over the
property test and dtype sweep of ``tests/test_kernels.py``, plus capacity
below the total and lengths above Lmax.  The reference's Pallas kernel is
not the yardstick: it fails on the installed jax (``pl.load`` is gone).
The CUDA kernel itself runs only on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.ragged_concat.ref import ragged_concat_ref as jax_ref
from repro_torch.kernels.ragged_concat.ops import ragged_concat
from _port_env import port_test_env  # noqa: F401  (autouse)

_JAX_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.int32: jnp.int32, torch.uint8: jnp.uint8}


def _check(src: torch.Tensor, lens, capacity: int):
    before = ragged_concat.launches
    out, offs, total = ragged_concat(src, torch.tensor(lens, dtype=torch.int32),
                                     capacity=capacity)
    assert ragged_concat.launches == before            # the plain version is no launch
    jsrc = jnp.asarray(src.float().numpy(), _JAX_DT[src.dtype])
    ref, ref_offs, ref_total = jax_ref(jsrc, jnp.asarray(lens, jnp.int32), capacity)
    assert out.dtype == src.dtype and out.shape == (capacity, src.shape[2])
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))
    np.testing.assert_array_equal(offs.numpy(), np.asarray(ref_offs))
    assert offs.dtype == total.dtype == torch.int32
    assert int(total) == int(ref_total) == sum(lens)
    return out


@settings(max_examples=30, deadline=None)
@given(lens=st.lists(st.integers(0, 16), min_size=1, max_size=6),
       c=st.sampled_from([1, 4, 8]))
def test_ragged_concat_plain_matches_jax_ref(lens, c):
    rng = np.random.default_rng(len(lens) * c)
    src = torch.from_numpy(rng.standard_normal((len(lens), 16, c), np.float32))
    _check(src, lens, sum(lens) + 8)


@pytest.mark.parametrize("dt", list(_JAX_DT), ids=str)
def test_ragged_concat_dtype_sweep(dt):
    src = (torch.arange(2 * 8 * 4).reshape(2, 8, 4) % 127).to(dt)
    _check(src, [3, 8], 11)


def test_ragged_concat_capacity_below_total_drops_rows():
    src = torch.arange(3 * 12 * 4, dtype=torch.float32).reshape(3, 12, 4) + 1
    out = _check(src, [10, 7, 12], 15)
    assert torch.equal(out[10:15], src[1, :5])        # source 1 cut at capacity
    assert out.shape[0] == 15


def test_ragged_concat_length_above_lmax_leaves_zero_gap():
    """A length above Lmax advances the offsets by the length; the rows past
    Lmax stay 0, as in the reference oracle."""
    src = torch.ones(2, 4, 2)
    out = _check(src, [6, 3], 12)
    assert torch.all(out[4:6] == 0) and torch.all(out[6:9] == 1) and torch.all(out[9:] == 0)


def test_ragged_concat_wrapper_checks():
    out, offsets, total = ragged_concat(torch.zeros(2, 4, 3, device="meta"),
                                        torch.ones(2, dtype=torch.int32, device="meta"),
                                        capacity=4)             # meta: shapes, no launch
    assert [(t.device.type, tuple(t.shape)) for t in (out, offsets, total)] == \
        [("meta", (4, 3)), ("meta", (2,)), ("meta", ())]
    with pytest.raises(ValueError, match="different devices"):
        ragged_concat(torch.zeros(2, 4, 3, device="meta"), torch.ones(2, dtype=torch.int32),
                      capacity=4)
    with pytest.raises(ValueError, match="lengths"):
        ragged_concat(torch.zeros(2, 4, 3), torch.ones(3, dtype=torch.int32), capacity=4)
    with pytest.raises(TypeError):
        ragged_concat(torch.zeros(2, 4, 3, dtype=torch.float64),
                      torch.ones(2, dtype=torch.int32), capacity=4)
    with pytest.raises(ValueError, match="capacity"):
        ragged_concat(torch.zeros(2, 4, 3), torch.ones(2, dtype=torch.int32), capacity=-1)


@pytest.mark.parametrize("cap", ["total+7", "below", 0], ids=str)
def test_ragged_concat_plain_matches_jax_many_sources(cap):
    """About 300 sources with zero lengths mixed in (more sources than one
    256-wide scan pass of the CUDA kernel), lengths above and below Lmax."""
    rng = np.random.default_rng(300)
    lens = rng.integers(0, 13, 301)
    lens[rng.random(301) < 0.3] = 0
    lens = lens.tolist()
    cap = {"total+7": sum(lens) + 7, "below": sum(lens) // 2}.get(cap, cap)
    src = torch.from_numpy(rng.standard_normal((len(lens), 10, 3), np.float32))
    _check(src, lens, cap)


def test_ragged_concat_plain_matches_jax_no_sources():
    """N = 0: a zero-filled buffer, total 0, and the reference's offsets [0]."""
    out = _check(torch.zeros(0, 4, 2), [], 5)
    assert not out.any()
