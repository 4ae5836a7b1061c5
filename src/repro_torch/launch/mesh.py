"""Mesh builders and the card's constants for the roofline.

Counterpart of ``repro/launch/mesh.py``.  ``make_mesh`` builds a
``torch.distributed`` ``DeviceMesh`` over the process group the caller
initialised (one process per rank; nothing here starts a group);
``make_production_mesh`` gives the reference's 16x16 and 2x16x16 meshes,
as an ``AbstractMesh`` (shape and axis names) unless the world is that
size, so the spec functions of ``repro_torch.sharding`` can lay out the
production meshes on one process.  ``HW`` holds the H100's constants where
the reference's are a TPU v5e's.  ``launch/ranks.py`` starts the ranks of
a job on one host.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.sharding import AbstractMesh

__all__ = ["make_production_mesh", "make_mesh", "HW"]


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
    # B/s each way a card, NVLink 4 (NVIDIA's published 900 GB/s is both ways):
    # the collective term's denominator.  No H100 machine has an NVLink domain
    # of 256 (16x16) or 512 cards, so over the production meshes the term is an
    # idealisation, as the reference's ICI_BW is over its mesh.
    NVLINK_BW = 450e9


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device: torch.device | str | None = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialised
    process group, for tensors on ``cuda`` unless ``device`` says ``cpu``
    (the tests' ``gloo`` ranks).  Raises if no group is initialised, if the
    mesh's size is not the world size, or if ``cuda`` is asked for with no
    card.

    A ``gloo`` group makes a ``DeviceMesh`` on ``cpu`` whatever ``device``
    says: the ranks of one machine with one card (``launch.ranks``) share
    it (``nccl`` refuses two ranks on one device), their tensors on
    ``cuda:0`` and their collectives through pinned host buffers, every
    collective, counted in ``sharding.partition.STAGED_BYTES``.  Such a
    run shows the sharded layers and the kernels at the ranks' shapes, not
    a fabric's speed."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: call "
                           "torch.distributed.init_process_group first")
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"a mesh of {shape} holds {math.prod(shape)} ranks; the world has "
                         f"{dist.get_world_size()}")
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' for a CPU mesh")
    if dist.get_backend() == "gloo":
        kind = "cpu"
    return init_device_mesh(kind, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 ``("data", "model")``, or 2x16x16 ``("pod", "data", "model")``:
    the ``DeviceMesh`` where the initialised world has that many ranks,
    else the ``AbstractMesh`` of that shape."""
    shape, axes = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else \
        ((16, 16), ("data", "model"))
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() == math.prod(shape):
        return make_mesh(shape, axes)
    return AbstractMesh(shape, axes)
