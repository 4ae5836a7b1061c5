"""Arm-only-while-busy executor wiring for continuous-batching servers.

The one canonical copy of the pattern both the real
:class:`repro_torch.runtime.InferenceServer` and the torch-free
:class:`repro_torch.serving.replica.EchoServer` ride (``server`` is duck-typed
on ``queue`` / ``_active`` / ``step_rounds`` / ``ingest_message``):
request messages are admitted by the subscription callback; a oneshot
round timer is armed only while work is pending, so an idle server
sleeps on epoll instead of ticking at 1/period; everything shares one
mutually-exclusive callback group so server state is never mutated
concurrently.

Lives in :mod:`repro_torch.serving` (not ``repro_torch.runtime``) because it
must be importable without torch — ``repro_torch.runtime.server`` imports
torch at module scope, and echo replicas' spawn cost must stay numpy +
repro_torch.core only.

The port's copy of ``repro/serving/attach.py``: only the import paths differ.  Layouts,
magic numbers and shm names are the reference's on purpose, so a message
published through one package is taken by the other.
"""

from __future__ import annotations

from repro_torch.core.executor import CallbackGroup

__all__ = ["attach_server_executor"]


def attach_server_executor(server, executor, sub, *, group=None,
                           max_new: int = 16,
                           round_period_s: float = 0.0005,
                           ingest=None, on_round_end=None):
    """Wire ``server`` onto ``executor`` (see module docstring).

    * ``ingest`` — alternative message decoder (e.g. the bound
      ``server.ingest_serve_message`` for rows with router-assigned
      rids); defaults to ``server.ingest_message``.
    * ``on_round_end`` — called after every decode round, in the same
      group: the replica's hook to flush its streamed token chunks.
    * ``round_period_s`` — the continuous-batching tick; on an
      accelerator-bound replica it models the device's round latency.

    Returns the subscription handle."""
    g = group or CallbackGroup(name=f"server-{id(server):x}")
    armed = [False]
    if ingest is None:
        def ingest(ptr):
            server.ingest_message(ptr, max_new=max_new)

    def _arm_if_busy():
        if not armed[0] and (server.queue or server._active):
            armed[0] = True
            executor.add_timer(round_period_s, _round, group=g, oneshot=True)

    def _round():
        armed[0] = False
        server.step_rounds()
        if on_round_end is not None:
            on_round_end()
        _arm_if_busy()

    def _on_request(ptr):
        ingest(ptr)
        _arm_if_busy()

    return executor.add_subscription(sub, _on_request, group=g)
