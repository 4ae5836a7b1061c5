"""Failure detection, straggler mitigation, elastic re-mesh planning.

Three mechanisms, each host-side and framework-agnostic:

* :class:`FailureDetector` — liveness via heartbeats published on an
  agnocast topic plus registry PID sweeps (the kernel-module exit hook
  analogue). A host is *suspect* after ``suspect_after`` missed beats and
  *dead* after ``dead_after``.
* :class:`StragglerMonitor` — per-step wall-time EWMA per host; a host
  whose step time exceeds ``threshold ×`` the fleet median is flagged. The
  trainer's mitigation is data-plane level: the straggler's next microbatch
  is re-assigned (deterministic corpus = any host can regenerate any
  document), and persistent stragglers are proposed for eviction to the
  re-mesh planner.
* :func:`plan_remesh` — given the healthy host set, produce the largest
  (pod, data, model) mesh not exceeding it, plus the checkpoint-reshard
  instruction (restore with the new mesh's shardings — the checkpointer
  reshards transparently).

The port's copy of ``repro/runtime/fault_tolerance.py``, word for word: it
imports nothing of either package.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

__all__ = ["FailureDetector", "StragglerMonitor", "RemeshPlan", "plan_remesh"]


class FailureDetector:
    def __init__(self, hosts: list[int], *, suspect_after: float = 3.0,
                 dead_after: float = 10.0):
        self.suspect_after = suspect_after
        self.dead_after = dead_after
        now = time.monotonic()
        self._last: dict[int, float] = {h: now for h in hosts}

    def beat(self, host: int, t: float | None = None) -> None:
        self._last[host] = time.monotonic() if t is None else t

    def state(self, now: float | None = None) -> dict[int, str]:
        now = time.monotonic() if now is None else now
        out = {}
        for h, t in self._last.items():
            dt = now - t
            out[h] = ("dead" if dt > self.dead_after
                      else "suspect" if dt > self.suspect_after else "alive")
        return out

    def healthy(self, now: float | None = None) -> list[int]:
        return [h for h, s in self.state(now).items() if s != "dead"]


class StragglerMonitor:
    """EWMA step times per host; flags hosts slower than threshold × median."""

    def __init__(self, hosts: list[int], *, alpha: float = 0.2,
                 threshold: float = 1.5, grace_steps: int = 5):
        self.alpha = alpha
        self.threshold = threshold
        self.grace_steps = grace_steps
        self._ewma: dict[int, float] = {h: 0.0 for h in hosts}
        self._n: dict[int, int] = {h: 0 for h in hosts}

    def record(self, host: int, step_time: float) -> None:
        n = self._n[host]
        self._ewma[host] = (step_time if n == 0
                            else (1 - self.alpha) * self._ewma[host]
                            + self.alpha * step_time)
        self._n[host] = n + 1

    def stragglers(self) -> list[int]:
        ready = {h: t for h, t in self._ewma.items()
                 if self._n[h] >= self.grace_steps}
        if len(ready) < 2:
            return []
        med = float(np.median(list(ready.values())))
        return [h for h, t in ready.items() if t > self.threshold * med]

    def ewma(self, host: int) -> float:
        return self._ewma[host]


@dataclass(frozen=True)
class RemeshPlan:
    mesh_shape: tuple[int, ...]
    mesh_axes: tuple[str, ...]
    hosts: tuple[int, ...]
    dropped: tuple[int, ...]
    batch_scale: float          # new global batch / old (elastic: shrink DP)
    reason: str = ""


def plan_remesh(healthy_hosts: list[int], chips_per_host: int,
                old_shape: tuple[int, ...],
                axes: tuple[str, ...] = ("pod", "data", "model"),
                *, keep_model: bool = True) -> RemeshPlan:
    """Largest power-of-two-friendly mesh over the surviving chips.

    Policy: preserve the ``model`` (TP) extent — parameters are sharded over
    it and changing TP forces a different layout everywhere — and shrink
    ``data`` (DP), which only rescales the global batch. Drop to one pod
    before shrinking DP below 2. Hosts beyond the largest usable count are
    spares (kept warm for the next failure — at 1000+ nodes spares are how
    MTBF-scale failures avoid full restarts).
    """
    old = dict(zip(axes[-len(old_shape):], old_shape))
    model = old.get("model", 1) if keep_model else 1
    total = len(healthy_hosts) * chips_per_host
    if total < model:
        raise ValueError(f"cannot keep model={model} with {total} chips")
    rest = total // model
    # pods: keep multi-pod only if at least 2 full former-pod slices survive
    old_data = old.get("data", 1)
    pods = old.get("pod", 1)
    while pods > 1 and rest // pods < max(old_data // 2, 1):
        pods //= 2
    data = 1
    while data * 2 * pods * model <= total:
        data *= 2
    used = pods * data * model
    hosts_needed = -(-used // chips_per_host)
    chosen = tuple(sorted(healthy_hosts)[:hosts_needed])
    dropped = tuple(h for h in healthy_hosts if h not in chosen)
    shape = (pods, data, model) if pods > 1 else (data, model)
    used_axes = axes[-len(shape):]
    new_data_total = pods * data
    old_data_total = old.get("pod", 1) * old_data
    return RemeshPlan(
        mesh_shape=shape, mesh_axes=used_axes, hosts=chosen, dropped=dropped,
        batch_scale=new_data_total / old_data_total,
        reason=f"{len(healthy_hosts)} healthy hosts x {chips_per_host} chips; "
               f"kept model={model}, data {old_data_total}->{new_data_total}")
