"""Dry run: count every (arch x workload) cell on ``meta``, per device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out experiments/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --smoke
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k \
        --multi-pod                      # 2x16x16 ("pod", "data", "model"); --mesh 16x16, 2x2 ...

The port's counterpart of ``repro/launch/dryrun.py``.  The reference
lowers and compiles each cell for a TPU mesh and reads its cost from the
HLO; here each cell's step (``launch/steps.py``: the train step with
AdamW's state, the prefill step or the decode step) runs once on the
``meta`` inputs of ``Model.input_specs`` and ``Model.abstract_params``
under the cost counter (``launch/cost_analysis.py``): nothing is
allocated and no kernel launches; every Hopper kernel's wrapper stands in
with its outputs' shapes and records its ``cost``.  A cell the model does
not support is ``skipped`` with the reference's reason; a cell that
raises is ``error`` (the count found a fault: a shape a kernel refuses, a
host read on the path) and the command exits 1.

With no mesh (``--all`` or one cell, no ``--mesh``/``--multi-pod``) the
count is of one card running the whole global batch: ``mesh`` "1",
``n_devices`` 1 and every collective 0.  With ``--mesh AxB[xC]`` (axes
the last of ``("pod", "data", "model")``) or ``--multi-pod`` (2x16x16;
16x16 is ``--mesh 16x16``) the count is of ONE device's step: under an
``AbstractMesh`` with a coordinate (``run_cell(coordinate=...)``, 0 on
every axis by default) and ``launch.steps.train_rules``, the rank's blocks of the
params (``Model.abstract_params`` under the mesh) and its rows of the
global batch, so FLOPs, bytes and memory are per device, and each
collective of ``repro_torch.sharding`` launches nothing and records its
per-device wire bytes by the reference's ring formulas.  On a mesh only
the dense family's training cells run (ROADMAP.md Queue 1 item 8c, part
one); every other cell there is ``skipped`` naming the later part of item
8c that brings it.

Each record holds the reference's fields: ``status``, ``flops``,
``bytes_accessed``, ``collectives`` (per kind ``count``,
``result_bytes``, ``wire_bytes``, and ``total_bytes``), ``costs`` (in
place of ``hlo``: the counter's totals, FLOPs by peak and the per-op
breakdown), ``model_flops`` (6 N_active tokens for training, 2 N_active
tokens to serve, over the whole mesh: the reference's formula),
``n_params``, ``n_active_params``, ``n_devices``, ``mesh`` and ``memory``
per device: the arguments', results' and aliased bytes and the peak of
live storages (``cost_analysis`` says how it is estimated).  A step at
the reference's global batch on one card needs far more than its 80 GB;
the record says so, it does not refuse.  ``launch/roofline.py`` reads the
records.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import math

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch.cost_analysis import COLLECTIVES, count
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (batch_specs, make_decode_step, make_prefill_step,
                                      make_train_step, train_rules)
from repro_torch.models import WORKLOADS, Model, Workload
from repro_torch.optim import AdamW
from repro_torch.sharding import AbstractMesh, NamedSharding, mesh_unsupported, use_mesh

__all__ = ["build_cell", "count_cell", "run_cell", "abstract_mesh", "main",
           "DRYRUN_DIR"]

DRYRUN_DIR = os.environ.get("AGNO_TORCH_DRYRUN_OUT", "experiments/dryrun_torch")
MESH = "1"
AXES = ("pod", "data", "model")


def abstract_mesh(*, multi_pod: bool = False, mesh_spec: str = "",
                  coordinate: tuple[int, ...] | None = None) -> AbstractMesh:
    """The mesh of ``--mesh AxB[xC]`` (the last axes of ``AXES``) or the
    production mesh (16x16, or 2x16x16 with ``multi_pod``), as an
    ``AbstractMesh`` placing the counted device at ``coordinate`` (0 on
    every axis by default)."""
    if mesh_spec:
        dims = tuple(int(x) for x in mesh_spec.split("x"))
        mesh = AbstractMesh(dims, AXES[-len(dims):])
    else:
        prod = make_production_mesh(multi_pod=multi_pod)
        mesh = AbstractMesh(tuple(prod.shape), tuple(prod.mesh_dim_names))
    return AbstractMesh(mesh.shape, mesh.mesh_dim_names,
                        coordinate or (0,) * len(mesh.shape))


def _model_flops(cfg, wl) -> float:
    n_active = cfg.active_param_count()
    if wl.kind == "train":
        tokens = wl.global_batch * wl.seq_len
        return 6.0 * n_active * tokens
    if wl.kind == "prefill":
        tokens = wl.global_batch * wl.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * wl.global_batch  # decode: 1 token per request


def build_cell(arch: str, shape: str, *, smoke: bool = False,
               workload: Workload | None = None):
    """(model on ``meta`` or None, why not, cfg, workload) of one cell;
    ``workload`` replaces ``WORKLOADS[shape]`` (a reduced one)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    wl = workload or WORKLOADS[shape]
    model = Model(cfg, device="meta")
    ok, why = model.supports(wl)
    if not ok:
        return None, why, cfg, wl
    return model, "", cfg, wl


def count_cell(model: Model, wl: Workload, mesh: AbstractMesh | None = None):
    """The cell's step on ``meta`` inputs under the cost counter; on
    ``mesh`` (training only) one device's step: the rank's param blocks
    and batch rows, under ``train_rules``."""
    if mesh is not None:
        with use_mesh(mesh, train_rules(model.cfg, mesh)) as ctx:
            params = model.abstract_params()
            batch = model.input_specs(wl)
            specs = batch_specs(model.cfg, batch, ctx)
            rows = {k: NamedSharding(mesh, specs[k]).block(v).clone() for k, v in batch.items()}
            opt = AdamW(lr=3e-4)
            return count(make_train_step(model, opt), opt.init(params), rows)
    params = model.abstract_params()
    if wl.kind == "train":
        opt = AdamW(lr=3e-4)
        return count(make_train_step(model, opt), opt.init(params), model.input_specs(wl))
    if wl.kind == "prefill":
        return count(make_prefill_step(model, wl), params, model.input_specs(wl))
    specs = model.input_specs(wl)
    return count(make_decode_step(model), params, specs["cache"], specs["tokens"])


def run_cell(arch: str, shape: str, *, smoke: bool = False, out_dir: str | None = None,
             workload: Workload | None = None, multi_pod: bool = False, mesh_spec: str = "",
             coordinate: tuple[int, ...] | None = None) -> dict:
    """Count one cell: with no mesh at world size 1, else one device's step
    on :func:`abstract_mesh`."""
    model, why, cfg, wl = build_cell(arch, shape, smoke=smoke, workload=workload)
    mesh = abstract_mesh(multi_pod=multi_pod, mesh_spec=mesh_spec, coordinate=coordinate) \
        if (multi_pod or mesh_spec) else None
    name = MESH if mesh is None else "x".join(str(n) for n in mesh.shape)
    rec = {"arch": arch, "shape": shape, "mesh": name, "kind": wl.kind, "smoke": smoke}
    if model is not None and mesh is not None:
        why = mesh_unsupported(cfg, wl.kind)
        model = None if why else model
    if model is None:
        rec["status"] = "skipped"
        rec["why"] = why
        return _finish(rec, out_dir)
    if mesh is not None:
        rec["coordinate"] = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    t0 = time.time()
    try:
        costs = count_cell(model, wl) if mesh is None else count_cell(model, wl, mesh)
        mem = costs.memory
        coll = {c: {"count": costs.collectives[c]["count"],
                    "result_bytes": costs.collective_result_bytes.get(c, 0),
                    "wire_bytes": costs.collectives[c]["wire_bytes"]} for c in COLLECTIVES}
        rec.update(
            status="ok", count_s=round(time.time() - t0, 2),
            flops=costs.flops, bytes_accessed=costs.bytes,
            memory={"argument_size_in_bytes": mem["argument_bytes"],
                    "output_size_in_bytes": mem["output_bytes"],
                    "alias_size_in_bytes": mem["alias_bytes"],
                    "peak_memory_in_bytes": mem["peak_bytes"]},
            collectives={**coll, "total_bytes": costs.collective_wire_bytes},
            costs=costs.as_dict(),
            model_flops=_model_flops(cfg, wl),
            n_params=int(cfg.param_count()),
            n_active_params=int(cfg.active_param_count()),
            n_devices=1 if mesh is None else math.prod(mesh.shape),
        )
    except Exception as e:  # noqa: BLE001 — a failed cell is a bug, record it
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["trace"] = traceback.format_exc()[-4000:]
    return _finish(rec, out_dir)


def _finish(rec: dict, out_dir: str | None) -> dict:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    status = rec["status"]
    if status == "ok":
        extra = (f" flops={rec['flops']:.3e} bytes={rec['bytes_accessed']:.3e}"
                 f" coll={rec['collectives']['total_bytes']:.3e}"
                 f" count={rec['count_s']}s peak="
                 f"{rec['memory']['peak_memory_in_bytes'] / 1e9:.2f}GB")
    elif status == "skipped":
        extra = f" ({rec['why']})"
    else:
        extra = f" !! {rec['error']}"
    print(f"[dryrun] {rec['arch']} × {rec['shape']} × {rec['mesh']}: {status}{extra}",
          flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(WORKLOADS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--smoke", action="store_true", help="use reduced configs")
    ap.add_argument("--multi-pod", action="store_true", help="count on 2x16x16")
    ap.add_argument("--mesh", default="", help="count on a mesh, e.g. 16x16 or 2x2x4")
    ap.add_argument("--out", default=DRYRUN_DIR)
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, shape) for arch in ARCH_IDS for shape in WORKLOADS]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    bad = 0
    for arch, shape in cells:
        rec = run_cell(arch, shape, smoke=args.smoke, out_dir=args.out,
                       multi_pod=args.multi_pod, mesh_spec=args.mesh)
        bad += rec["status"] == "error"
    raise SystemExit(1 if bad else 0)


if __name__ == "__main__":
    main()
