"""The port's pointcloud chain (``repro_torch.apps.pointcloud``) held against
the reference's (``repro.apps.pointcloud``).

The clouds and the four preprocessing stages are the reference's bit for bit.
The chain runs both ways at a small size and, since the LiDAR processes start
only once the concatenate node has subscribed, delivers every frame with its
exact merged point count (the reference's test accepts 6 of 8 frames)."""

import numpy as np
import pytest

from repro.apps import pointcloud as ref
from repro_torch.apps import pointcloud as port
from repro_torch.apps import LidarSpec, make_cloud, preprocess_chain, run_chain
from _port_env import port_test_env  # noqa: F401  (autouse)

STAGES = ("cropbox_self", "cropbox_mirror", "distortion_corrector", "ring_outlier_filter",
          "preprocess_chain")


@pytest.mark.parametrize("points", (0, 2, 3, 1_000, 20_000))
def test_clouds_and_stages_equal_the_references_bit_for_bit(points):
    for seed in (0, 1, 7):
        for frame in (0, 3):
            got = port.make_cloud(points, frame=frame, seed=seed)
            want = ref.make_cloud(points, frame=frame, seed=seed)
            assert got.dtype == want.dtype == np.float32 and got.shape == (points, 4)
            assert np.array_equal(got, want)
            for name in STAGES:
                a, b = getattr(port, name)(got), getattr(ref, name)(want)
                assert a.dtype == b.dtype and np.array_equal(a, b), (name, points, seed, frame)


def test_public_names_equal_the_references():
    assert port.__all__ == ref.__all__
    assert port.DEFAULT_LIDARS == tuple(port.LidarSpec(s.name, s.points, s.period_s)
                                        for s in ref.DEFAULT_LIDARS)


SMALL = (LidarSpec("top", 20_000, 0.02), LidarSpec("left", 1_000, 0.02),
         LidarSpec("right", 1_000, 0.02))
FRAMES = 6


@pytest.mark.parametrize("edges", (frozenset(), frozenset({"top"}),
                                   frozenset({"top", "left", "right"})),
                         ids=("bus", "top-agnocast", "all-agnocast"))
def test_chain_delivers_every_frame_with_exact_counts(edges):
    res = run_chain(frames=FRAMES, agnocast_edges=edges, lidars=SMALL, arena_mb=64)
    assert len(res.response_times) == FRAMES
    assert all(t > 0 for t in res.response_times)
    want = [sum(len(preprocess_chain(make_cloud(l.points, frame=i, seed=0))) for l in SMALL)
            for i in range(FRAMES)]
    assert res.merged_points == want
    assert res.worst >= res.mean > 0
