"""Autoware LiDAR-preprocessing chain analogue (paper §V-D / Fig. 12-13).

Three LiDARs (Top / Left / Right). Each LiDAR's four preprocessing nodes —
cropbox_self → cropbox_mirror → distortion_corrector → ring_outlier_filter
— run fused in one OS process (the ComponentContainer analogue: pointer
passing, no IPC). The *concatenate* node runs in a separate process (fault
isolation), so every LiDAR→concatenate edge crosses processes and pays IPC.

The Top LiDAR cloud is MB-scale while Left/Right are KB-scale (paper: "Top
LiDAR data is in the MB order, while the other two are in the KB order"),
so the Top edge dominates response time. ``run_chain(agnocast_edges=
{"top"})`` converts exactly that one edge to the zero-copy plane — the
paper's experiment — while the other edges stay on the conventional
serialized bus.

Response time (per frame) = concatenate completion − Top-frame sensor
stamp, matching the paper's "cropbox_filter_self → concatenate" span (the
preprocessing work happens inside the producer process either way; the
delta between transports is pure IPC cost).

The port's copy of ``repro/apps/pointcloud.py`` over ``repro_torch.core``:
the same clouds, stages, nodes and transports.  One repair: the reference
starts the LiDAR processes after a fixed ``time.sleep(0.3)`` and loses
frames when the concatenate node has not subscribed by then (ROADMAP
Queue 3).  Here the concatenate process reports ready through its queue
once its agnocast subscriptions exist and the bus has confirmed its bus
subscriptions (``transport.sync_subscriptions``), and the LiDAR processes
start only after that, so every frame is delivered.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time
from dataclasses import dataclass

import numpy as np

from repro_torch.core import (
    POINT_CLOUD2,
    Bus,
    BusClient,
    Domain,
    EventExecutor,
    deserialize,
    serialize,
)
from repro_torch.core.transport import sync_subscriptions

__all__ = ["LidarSpec", "ChainResult", "make_cloud", "preprocess_chain",
           "run_chain"]

_FIELDS = 4  # x, y, z, intensity (float32)
_READY_TIMEOUT_S = 60.0  # the concatenate node's subscriptions, at most


@dataclass(frozen=True)
class LidarSpec:
    name: str
    points: int           # points per frame (Top: ~500k = 8 MB; sides: ~3k)
    period_s: float = 0.1


DEFAULT_LIDARS = (
    LidarSpec("top", 250_000),     # ~4 MB / frame
    LidarSpec("left", 3_000),      # ~48 KB
    LidarSpec("right", 3_000),
)


# ---------------------------------------------------------------------------
# Synthetic clouds + the four preprocessing stages (numpy ports of the
# Autoware nodes' math; the cost model is "some vector arithmetic per point")
# ---------------------------------------------------------------------------


def make_cloud(points: int, *, frame: int, seed: int = 0,
               n_rings: int = 32, outlier_frac: float = 0.01) -> np.ndarray:
    """Ring-structured cloud (spinning-LiDAR geometry): consecutive points
    on a ring are angular neighbours (centimetres apart), so the ring
    outlier filter keeps the cloud and removes only the injected outliers.
    (A uniform-random cloud has ~100 m neighbour gaps and the filter
    deletes everything — payloads silently shrink to a handful of points.)
    """
    rng = np.random.default_rng((seed, frame))
    per = max(points // n_rings, 1)
    i = np.arange(points)
    ring = np.minimum(i // per, n_rings - 1)
    idx = i - ring * per
    theta = (idx / per) * 2 * np.pi + frame * 0.01
    r = 4.0 + ring * 1.5 + rng.normal(0.0, 0.05, points)
    out = rng.random(points) < outlier_frac
    r = np.where(out, r * rng.uniform(1.5, 3.0, points), r)
    x = (r * np.cos(theta)).astype(np.float32)
    y = (r * np.sin(theta)).astype(np.float32)
    z = (ring * 0.08 - 1.5 + rng.normal(0.0, 0.02, points)).astype(np.float32)
    inten = rng.uniform(0.0, 1.0, points).astype(np.float32)
    return np.stack([x, y, z, inten], axis=1)


def cropbox_self(cloud: np.ndarray, r: float = 1.5) -> np.ndarray:
    keep = np.abs(cloud[:, :2]).max(axis=1) > r
    return cloud[keep]


def cropbox_mirror(cloud: np.ndarray) -> np.ndarray:
    in_mirror = ((np.abs(cloud[:, 0] - 0.8) < 0.3)
                 & (np.abs(np.abs(cloud[:, 1]) - 1.0) < 0.3)
                 & (cloud[:, 2] > 0.5) & (cloud[:, 2] < 1.2))
    return cloud[~in_mirror]


def distortion_corrector(cloud: np.ndarray, omega: float = 0.05) -> np.ndarray:
    """De-skew: rotate each point by the yaw accumulated since scan start."""
    n = len(cloud)
    if n == 0:
        return cloud
    theta = (np.arange(n, dtype=np.float32) / max(n, 1)) * omega
    c, s = np.cos(theta), np.sin(theta)
    out = cloud.copy()
    out[:, 0] = c * cloud[:, 0] - s * cloud[:, 1]
    out[:, 1] = s * cloud[:, 0] + c * cloud[:, 1]
    return out


def ring_outlier_filter(cloud: np.ndarray, thresh: float = 3.0) -> np.ndarray:
    """Drop points far from both ring neighbours (walk-based outlier test)."""
    n = len(cloud)
    if n < 3:
        return cloud
    d_prev = np.linalg.norm(np.diff(cloud[:, :3], axis=0), axis=1)
    bad = np.zeros(n, bool)
    bad[1:-1] = (d_prev[:-1] > thresh) & (d_prev[1:] > thresh)
    return cloud[~bad]


def preprocess_chain(cloud: np.ndarray) -> np.ndarray:
    return ring_outlier_filter(
        distortion_corrector(cropbox_mirror(cropbox_self(cloud))))


# ---------------------------------------------------------------------------
# Processes
# ---------------------------------------------------------------------------


def _lidar_proc(spec: LidarSpec, frames: int, transport: str, dom_name: str,
                bus_path: str, arena_mb: int, seed: int) -> None:
    """One LiDAR: generate → 4-stage preprocess (in-process) → publish."""
    topic = f"sensing/{spec.name}/filtered"
    if transport == "agnocast":
        dom = Domain.join(dom_name, arena_capacity=arena_mb << 20)
        pub = dom.create_publisher(POINT_CLOUD2, topic, depth=8)
    else:
        cli = BusClient(bus_path)
    for frame in range(frames):
        t_frame = time.monotonic()           # sensor stamp
        raw = make_cloud(spec.points, frame=frame, seed=seed)
        filtered = preprocess_chain(raw)
        if transport == "agnocast":
            msg = pub.borrow_loaded_message()
            msg.data.extend(filtered.view(np.uint8).reshape(-1))  # unsized
            msg.set("point_step", _FIELDS * 4)
            msg.set("width", len(filtered))
            msg.set("height", 1)
            msg.set("stamp", t_frame)
            msg.set("is_dense", 1)
            pub.reclaim()
            # backpressure: event-driven wait on the slot-freed FIFO
            pub.publish_blocking(msg)
        else:
            m = POINT_CLOUD2.plain()
            m.data = filtered.view(np.uint8).reshape(-1)
            m.point_step = _FIELDS * 4
            m.width = len(filtered)
            m.height = 1
            m.stamp = t_frame
            m.is_dense = 1
            cli.publish(topic, serialize(m))   # serialization: O(bytes)
        # pace to the sensor period, measured from frame start
        sleep = spec.period_s - (time.monotonic() - t_frame)
        if sleep > 0:
            time.sleep(sleep)
    if transport == "agnocast":
        # drain: keep the process alive until consumers released everything
        deadline = time.monotonic() + 10.0
        while pub.reclaim() >= 0 and pub._inflight and time.monotonic() < deadline:
            time.sleep(0.01)
        dom.close()
    else:
        cli.close()


def _concat_proc(lidars: tuple[LidarSpec, ...], frames: int,
                 edge_transport: dict[str, str], dom_name: str, bus_path: str,
                 out_q) -> None:
    """The concatenate node: sync one frame from each LiDAR, merge, stamp.

    Event-driven (no busy-polling): one :class:`EventExecutor` multiplexes
    every agnocast wakeup FIFO and the bus socket; each arrival callback
    appends to the frame-sync buffer and merges as soon as all LiDARs have a
    pending frame — the ROS 2 single-threaded-executor shape of the paper's
    Autoware pipeline.
    """
    agno_names = [l.name for l in lidars if edge_transport[l.name] == "agnocast"]
    bus_names = [l.name for l in lidars if edge_transport[l.name] == "bus"]

    pending: dict[str, list] = {l.name: [] for l in lidars}
    response_times: list[float] = []
    merged_points: list[int] = []

    def merge_ready() -> None:
        # frame sync: merge when every lidar has one pending
        while all(pending[l.name] for l in lidars):
            stamps, clouds = zip(*(pending[l.name].pop(0) for l in lidars))
            merged = np.concatenate(clouds, axis=0)     # the concatenate node
            merged_points.append(len(merged))
            top_stamp = stamps[0]                       # lidars[0] is Top
            response_times.append(time.monotonic() - top_stamp)

    ex = EventExecutor(name="concatenate")
    dom = None
    if agno_names:
        dom = Domain.join(dom_name, publisher=False)
        for n in agno_names:
            sub = dom.create_subscription(POINT_CLOUD2,
                                          f"sensing/{n}/filtered")

            def on_cloud(ptr, n=n):
                cloud = np.asarray(ptr.msg.data).view(np.float32)
                cloud = cloud.reshape(-1, _FIELDS).copy()
                pending[n].append((float(ptr.msg.get("stamp")), cloud))
                merge_ready()

            ex.add_subscription(sub, on_cloud)
    cli = None
    if bus_names:
        cli = BusClient(bus_path)
        for n in bus_names:
            cli.subscribe(f"sensing/{n}/filtered")

        def on_frame(topic, _origin, payload):
            n = topic.split("/")[1]
            f = deserialize(payload)           # deserialization: O(bytes)
            cloud = f["data"].view(np.float32).reshape(-1, _FIELDS)
            pending[n].append((float(f["stamp"][0]), cloud))
            merge_ready()

        # no LiDAR process exists yet: nothing reads this socket and nothing
        # is published on these topics, as sync_subscriptions requires
        sync_subscriptions(cli)
        ex.add_bus_client(cli, on_frame)

    out_q.put("ready")
    ex.spin(until=lambda: len(response_times) >= frames,
            timeout=max(60.0, frames * 2.0))
    ex.shutdown()
    out_q.put((response_times, merged_points))
    if dom is not None:
        dom.close()
    if cli is not None:
        cli.close()


@dataclass
class ChainResult:
    response_times: list[float]
    merged_points: list[int]

    @property
    def mean(self) -> float:
        return float(np.mean(self.response_times))

    @property
    def worst(self) -> float:
        return float(np.max(self.response_times))


def run_chain(*, frames: int = 50, agnocast_edges: frozenset[str] = frozenset(),
              lidars: tuple[LidarSpec, ...] = DEFAULT_LIDARS,
              seed: int = 0, arena_mb: int = 512) -> ChainResult:
    """Run the full chain; returns per-frame response times of the Top span."""
    edge_transport = {l.name: ("agnocast" if l.name in agnocast_edges
                               else "bus") for l in lidars}
    bus = Bus().start()
    dom = Domain.create(arena_capacity=4 << 20)
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    concat = ctx.Process(target=_concat_proc,
                         args=(lidars, frames, edge_transport, dom.name,
                               bus.path, out_q), daemon=True)
    concat.start()
    # the LiDARs start once the concatenate node has subscribed everywhere
    out_q.get(timeout=_READY_TIMEOUT_S)
    procs = [ctx.Process(target=_lidar_proc,
                         args=(l, frames, edge_transport[l.name], dom.name,
                               bus.path, arena_mb, seed), daemon=True)
             for l in lidars]
    for p in procs:
        p.start()
    times, merged = out_q.get(timeout=max(60.0, frames * 1.0))
    for p in procs:
        p.join(timeout=15)
        if p.is_alive():
            p.terminate()
    concat.join(timeout=5)
    if concat.is_alive():
        concat.terminate()
    dom.close()
    bus.stop()
    return ChainResult(times, merged)
