"""Roofline over the dry run's records, per H100.

    PYTHONPATH=src python -m repro_torch.launch.roofline [DRYRUN_DIR]

The port's counterpart of ``benchmarks/roofline.py``, kept in the package:
it reads the records ``repro_torch.launch.dryrun`` wrote (default
``experiments/dryrun_torch``) and reports, per (arch x workload x mesh),
for one device:

    compute    = bf16 FLOPs / peak bf16 + f32 FLOPs / peak f32    [s]
    memory     = bytes / HBM bandwidth                           [s]
    collective = collective wire bytes / NVLink bandwidth        [s]

on ``launch.mesh.HW``.  The counter files each product under the peak of
its operands' type (f32 products run on the CUDA cores, 15x slower), so
the compute term sums the two.  The collective term is 0 at world size 1
(mesh "1"); on a mesh it reads the per-device wire bytes of the reference's
ring formulas over ``HW.NVLINK_BW``, an idealisation over the production
meshes (``HW`` says why).  The dominant term is the bottleneck;
``roofline_fraction`` = compute / max(terms), and ``useful_ratio`` =
model FLOPs / (counted FLOPs x devices) (the count includes remat's
recompute, the S^2 attention that 6 N D leaves out, and the work a mesh
repeats where a dim stays whole).  The rows of each mesh go to
``roofline_<mesh>.json`` beside the records.
"""

from __future__ import annotations

import glob
import json
import os
import sys

from repro_torch.launch.dryrun import DRYRUN_DIR, MESH
from repro_torch.launch.mesh import HW

__all__ = ["load_cells", "roofline_row", "main"]


def load_cells(dryrun_dir: str = DRYRUN_DIR) -> list[dict]:
    """The records of the cells that counted (``status`` ok)."""
    cells = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*__*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") == "ok":
            cells.append(rec)
    return cells


def roofline_row(rec: dict) -> dict:
    costs = rec["costs"]
    n = rec.get("n_devices", 1)
    t_compute = costs["flops_bf16"] / HW.PEAK_BF16_FLOPS + costs["flops_f32"] / HW.PEAK_F32_FLOPS
    t_memory = costs["bytes"] / HW.HBM_BW
    t_coll = rec["collectives"]["total_bytes"] / HW.NVLINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    t_bound = terms[dominant]
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"], "kind": rec["kind"],
        "t_compute_s": t_compute, "t_memory_s": t_memory, "t_collective_s": t_coll,
        "dominant": dominant,
        "roofline_fraction": (t_compute / t_bound) if t_bound > 0 else 0.0,
        "useful_ratio": (rec["model_flops"] / (costs["flops"] * n)) if costs["flops"] else 0.0,
        "model_flops_per_dev": rec["model_flops"] / n,
        "flops_per_dev": costs["flops"],
        "bytes_per_dev": costs["bytes"],
        "collective_bytes_per_dev": rec["collectives"]["total_bytes"],
        "peak_memory_bytes": rec["memory"]["peak_memory_in_bytes"],
    }


HEADER = ("arch,shape,mesh,dominant,t_compute_s,t_memory_s,t_collective_s,"
          "roofline_fraction,useful_ratio,flops,bytes,peak_gb")


def main(dryrun_dir: str = DRYRUN_DIR) -> list[dict]:
    cells = load_cells(dryrun_dir)
    if not cells:
        print(f"# roofline: no dry-run records in {dryrun_dir} "
              f"(run: python -m repro_torch.launch.dryrun --all)")
        return []
    meshes = sorted({rec["mesh"] for rec in cells}, key=lambda m: (m != MESH, m))
    print(f"# roofline: {len(cells)} cells on meshes {meshes} ({HW.NAME}, {HW.POWER_W} W: "
          f"{HW.PEAK_BF16_FLOPS / 1e12:.0f} TF/s bf16, {HW.PEAK_F32_FLOPS / 1e12:.0f} TF/s "
          f"f32, {HW.HBM_BW / 1e9:.0f} GB/s HBM, {HW.NVLINK_BW / 1e9:.0f} GB/s NVLink a way)")
    print(HEADER)
    rows = []
    for mesh in meshes:
        mine = [roofline_row(rec) for rec in cells if rec["mesh"] == mesh]
        for r in mine:
            print(f"{r['arch']},{r['shape']},{r['mesh']},{r['dominant']},"
                  f"{r['t_compute_s']:.4e},{r['t_memory_s']:.4e},{r['t_collective_s']:.4e},"
                  f"{r['roofline_fraction']:.3f},{r['useful_ratio']:.3f},"
                  f"{r['flops_per_dev']:.4e},{r['bytes_per_dev']:.4e},"
                  f"{r['peak_memory_bytes'] / 1e9:.2f}")
        with open(os.path.join(dryrun_dir, f"roofline_{mesh}.json"), "w") as f:
            json.dump(mine, f, indent=1)
        rows += mine
    return rows


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else DRYRUN_DIR)
