"""Compatibility shim — the single-topic bridge now lives in
:mod:`repro_torch.core.routing` as the one-rule special case of
:class:`~repro_torch.core.routing.DomainBridge` (see that module's docstring for
the routing table, loop-prevention invariants, and the backpressure FIFO
protocol).

The port's copy of ``repro/core/bridge.py``."""

from .routing import Bridge, DomainBridge, Router, RoutingRule, RoutingTable

__all__ = ["Bridge", "DomainBridge", "Router", "RoutingRule", "RoutingTable"]
