"""The card's constants for the roofline.

Counterpart of ``repro/launch/mesh.py``'s ``HW`` (the reference's are a
TPU v5e's).  Its mesh builders, ``make_mesh`` and
``make_production_mesh``, come with the sharding item (ROADMAP.md, Queue
1 item 8b): at world size 1 there is no mesh.
"""

from __future__ import annotations

__all__ = ["HW"]


class HW:
    """One NVIDIA H100 80GB HBM3 (SXM, 700 W), NVIDIA's published dense
    peaks: the roofline's and the kernel bounds' denominators.  A card set
    below 700 W runs slower under load; ``chip_smoke.py`` prints the limit
    beside every time."""

    NAME = "NVIDIA H100 80GB HBM3"
    POWER_W = 700
    PEAK_BF16_FLOPS = 989e12      # FLOP/s, bf16 on the tensor cores, dense
    PEAK_F32_FLOPS = 67e12        # FLOP/s, f32 on the CUDA cores
    HBM_BW = 3.35e12              # B/s
