"""Roofline over the dry run's records, on one H100.

    PYTHONPATH=src python -m repro_torch.launch.roofline [DRYRUN_DIR]

The port's counterpart of ``benchmarks/roofline.py``, kept in the package:
it reads the records ``repro_torch.launch.dryrun`` wrote (default
``experiments/dryrun_torch``) and reports, per (arch x workload):

    compute    = bf16 FLOPs / peak bf16 + f32 FLOPs / peak f32    [s]
    memory     = bytes / HBM bandwidth                           [s]
    collective = 0 (world size 1)                                [s]

on ``launch.mesh.HW``.  The counter files each product under the peak of
its operands' type (f32 products run on the CUDA cores, 15x slower), so
the compute term sums the two.  The dominant term is the bottleneck;
``roofline_fraction`` = compute / max(terms), and ``useful_ratio`` =
model FLOPs / counted FLOPs (the count includes remat's recompute and the
S^2 attention that 6 N D leaves out).  The rows go to
``roofline_1.json`` beside the records.
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
    t_compute = costs["flops_bf16"] / HW.PEAK_BF16_FLOPS + costs["flops_f32"] / HW.PEAK_F32_FLOPS
    t_memory = costs["bytes"] / HW.HBM_BW
    t_coll = 0.0
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    t_bound = terms[dominant]
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"], "kind": rec["kind"],
        "t_compute_s": t_compute, "t_memory_s": t_memory, "t_collective_s": t_coll,
        "dominant": dominant,
        "roofline_fraction": (t_compute / t_bound) if t_bound > 0 else 0.0,
        "useful_ratio": (rec["model_flops"] / costs["flops"]) if costs["flops"] else 0.0,
        "model_flops_per_dev": rec["model_flops"],
        "flops_per_dev": costs["flops"],
        "bytes_per_dev": costs["bytes"],
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
    print(f"# roofline: {len(cells)} cells at world size {MESH} ({HW.NAME}, {HW.POWER_W} W: "
          f"{HW.PEAK_BF16_FLOPS / 1e12:.0f} TF/s bf16, {HW.PEAK_F32_FLOPS / 1e12:.0f} TF/s "
          f"f32, {HW.HBM_BW / 1e9:.0f} GB/s HBM)")
    print(HEADER)
    rows = []
    for rec in cells:
        r = roofline_row(rec)
        rows.append(r)
        print(f"{r['arch']},{r['shape']},{r['mesh']},{r['dominant']},"
              f"{r['t_compute_s']:.4e},{r['t_memory_s']:.4e},{r['t_collective_s']:.4e},"
              f"{r['roofline_fraction']:.3f},{r['useful_ratio']:.3f},"
              f"{r['flops_per_dev']:.4e},{r['bytes_per_dev']:.4e},"
              f"{r['peak_memory_bytes'] / 1e9:.2f}")
    with open(os.path.join(dryrun_dir, f"roofline_{MESH}.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else DRYRUN_DIR)
