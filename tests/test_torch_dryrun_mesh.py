"""The dry run on a mesh: one device's count of a training step, with its
collective term.

The per-device wire bytes of each collective kind are held against the
reference's ``collective_stats`` on synthetic HLO lines; the port's
collectives record them on ``meta`` under an ``AbstractMesh``; a smoke
dense training cell at (2, 2) equals a hand count from its specs, product
FLOPs and every collective by kind; a count is the same at every
coordinate; the four dense archs' full-width ``train_4k`` cells count on
16x16 and 2x16x16, and every other meshed cell is ``skipped`` naming the
part of ROADMAP.md Queue 1 item 8c that brings it; the roofline's
collective term.
"""

from __future__ import annotations

import json
import os

import jax
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.cost_analysis import COLLECTIVES, WIRE, count
from repro_torch.launch.mesh import HW
from repro_torch.models import WORKLOADS, Model, Workload
from repro_torch.sharding import AbstractMesh, all_gather, psum, use_mesh
from _port_env import port_test_env  # noqa: F401  (autouse)

DENSE = ("qwen2-1.5b", "llama3-8b", "qwen3-8b", "gemma-2b")
SMALL = Workload("w", 32, 4, "train")          # 4 rows of 32 tokens
# a synthetic HLO line of each kind: (result type, operand type)
_HLO = {
    "all-gather": "%x = bf16[64,128]{1,0} all-gather(bf16[{blk},128]{1,0} %p), "
                  "channel_id=1, replica_groups=[{n},{g}]<=[{w}], dimensions={0}",
    "all-reduce": "%x = f32[1024]{0} all-reduce(f32[1024]{0} %p), channel_id=2, "
                  "replica_groups=[{n},{g}]<=[{w}], to_apply=%add",
    "reduce-scatter": "%x = f32[256]{0} reduce-scatter(f32[{full}]{0} %p), channel_id=3, "
                      "replica_groups=[{n},{g}]<=[{w}], dimensions={0}, to_apply=%add",
    "all-to-all": "%x = f32[8,128]{1,0} all-to-all(f32[8,128]{1,0} %p), channel_id=4, "
                  "replica_groups=[{n},{g}]<=[{w}], dimensions={0}",
    "collective-permute": "%x = f32[4,4]{1,0} collective-permute(f32[4,4]{1,0} %p), "
                          "channel_id=5, source_target_pairs={{0,1},{1,0}}",
}
_RESULT_BYTES = {"all-gather": 64 * 128 * 2, "all-reduce": 1024 * 4, "reduce-scatter": 256 * 4,
                 "all-to-all": 8 * 128 * 4, "collective-permute": 16 * 4}


@pytest.fixture(scope="module")
def collective_stats():
    """The reference's ``collective_stats``.  Its module sets ``XLA_FLAGS``
    when imported (512 host devices for its own dry run): jax's backend is
    started first, so the flag has no effect here, and the variable is
    put back."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import collective_stats as fn
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return fn


@pytest.mark.parametrize("g", [2, 4, 16])
@pytest.mark.parametrize("kind", COLLECTIVES)
def test_ring_formulas_match_the_references_collective_stats(collective_stats, kind, g):
    w = 4 * g
    line = _HLO[kind].replace("{blk}", str(64 // g)).replace("{full}", str(256 * g)) \
        .replace("{n}", str(w // g)).replace("{g}", str(g)).replace("{w}", str(w))
    ref = collective_stats(line, world=g)
    assert ref[kind]["count"] == 1 and ref[kind]["result_bytes"] == _RESULT_BYTES[kind]
    assert ref["total_bytes"] == ref[kind]["wire_bytes"]
    assert WIRE[kind](_RESULT_BYTES[kind], g) == pytest.approx(ref[kind]["wire_bytes"], rel=1e-12)


def test_the_collectives_record_their_wire_bytes_on_meta():
    """On a (2, 2) ``AbstractMesh`` at a coordinate, on ``meta``: a psum
    over ``model`` is one all-reduce, a tiled all-gather over ``data`` one
    all-gather and its backward one reduce-scatter of the rank's block,
    each charged by the ring formula over its group; nothing is sent."""
    mesh = AbstractMesh((2, 2), ("data", "model"), coordinate=(1, 0))
    x = torch.empty((8, 16), device="meta", requires_grad=True)

    def step(x):
        with use_mesh(mesh):
            y = all_gather(x, "data", axis=1, tiled=True)
            assert y.shape == (8, 32)
            z = psum(y, "model")
            z.sum().backward()
            return z

    c = count(step, x)
    got = {k: (v["count"], v["wire_bytes"]) for k, v in c.collectives.items()}
    want = {k: (0, 0.0) for k in COLLECTIVES}
    want["all-gather"] = (1, WIRE["all-gather"](8 * 32 * 4, 2))
    want["all-reduce"] = (1, WIRE["all-reduce"](8 * 32 * 4, 2))
    want["reduce-scatter"] = (1, WIRE["reduce-scatter"](8 * 16 * 4, 2))
    assert got == want
    assert c.collective_wire_bytes == sum(w for _, w in want.values())
    assert c.collective_result_bytes["reduce-scatter"] == 8 * 16 * 4


def test_a_smoke_dense_train_cell_at_2x2_equals_a_hand_count():
    """llama3-8b's smoke config (untied, no bias, remat none, f32) on (2, 2)
    ``("data", "model")``, 4 rows of 32 tokens: each rank holds 2 rows,
    half the heads, KV heads, FFN columns and vocab rows, and half of every
    ``embed`` dim (FSDP).  Product FLOPs: every projection forward and twice
    in backward, on the rank's blocks.  Collectives: a layer gathers its 9
    leaves over ``data`` (their gradients reduce-scattered back) and
    all-reduces 2 activations forward over ``model`` (``wo``'s and
    ``w_down``'s psums) and 2 gradients backward (the ``copy_to`` at the
    attention's and the MLP's entries); the embedding, ``lm_head`` and the
    final norm's scale are gathered alike; the vocab-parallel embedding's
    psum, ``lm_head``'s ``copy_to``, the cross entropy's pmax and two
    psums, the loss's pmean over ``data`` and the gradient norm's psum over
    the world are one all-reduce each.  No leaf's gradient needs a psum of
    its own at this mesh (every leaf is split over both axes)."""
    cfg = get_smoke_config("llama3-8b")
    rec = dryrun.run_cell("llama3-8b", "train_4k", smoke=True, mesh_spec="2x2", workload=SMALL)
    assert rec["status"] == "ok" and rec["n_devices"] == 4 and rec["mesh"] == "2x2"
    d, hd, L, f32 = cfg.d_model, cfg.head_dim, cfg.num_layers, 4
    t = (SMALL.global_batch // 2) * SMALL.seq_len
    hq, kv, ff, v = cfg.num_heads // 2, cfg.num_kv_heads // 2, cfg.d_ff // 2, cfg.vocab_size // 2
    layer = 2 * t * d * hd * (hq + 2 * kv) + 2 * t * hq * hd * d + 3 * 2 * t * d * ff
    mm = 3 * (L * layer + 2 * t * d * v)
    assert rec["costs"]["ops"]["aten.mm"]["flops"] == mm
    # result bytes: gathered leaves (model-split, data-gathered), activations
    leaves = 2 * d + d * hd * (hq + 2 * kv) + hq * hd * d + 3 * d * ff
    top = 2 * v * d + d                       # tok_embed, lm_head, the final norm's scale
    act = t * d
    ce = (SMALL.global_batch // 2) * (SMALL.seq_len - 1)
    want = {
        "all-gather": (9 * L + 3, f32 * (L * leaves + top)),
        "reduce-scatter": (9 * L + 3, f32 * (L * leaves + top) // 2),
        "all-reduce": (4 * L + 7, f32 * ((4 * L + 2) * act + 3 * ce + 2)),
    }
    for kind, (n, result) in want.items():
        got = rec["collectives"][kind]
        assert (got["count"], got["result_bytes"]) == (n, result), kind
    wire = {"all-gather": f32 * (L * leaves + top) / 2,
            "reduce-scatter": f32 * (L * leaves + top) / 2,
            # every all-reduce over 2 ranks moves its size; the norm's over 4, 1.5x it
            "all-reduce": f32 * ((4 * L + 2) * act + 3 * ce + 1) + 2 * f32 * 3 / 4}
    for kind, w in wire.items():
        assert rec["collectives"][kind]["wire_bytes"] == pytest.approx(w, rel=1e-12), kind
    assert rec["collectives"]["total_bytes"] == pytest.approx(sum(wire.values()), rel=1e-12)
    assert rec["collectives"]["all-to-all"]["count"] == 0


@pytest.mark.parametrize("arch,mesh", [("qwen2-1.5b", "1x4"), ("llama3-8b", "2x2"),
                                       ("qwen3-8b", "2x1x2"), ("gemma-2b", "4x1")])
def test_the_count_is_the_same_at_every_coordinate(arch, mesh):
    """Every rank runs the same step on blocks of the same shapes: the
    count at coordinate 0 equals the count at the last coordinate (qwen2's
    KV heads sliced per rank at ``model`` 4 included)."""
    dims = tuple(int(x) for x in mesh.split("x"))
    recs = [dryrun.run_cell(arch, "train_4k", smoke=True, mesh_spec=mesh, workload=SMALL,
                            coordinate=c) for c in ((0,) * len(dims), tuple(n - 1 for n in dims))]
    assert recs[0]["coordinate"] != recs[1]["coordinate"]
    for key in ("flops", "bytes_accessed", "collectives", "memory"):
        assert recs[0][key] == recs[1][key], key
    assert recs[0]["collectives"]["total_bytes"] > 0


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", DENSE)
def test_full_width_dense_train_cells_count_on_the_production_meshes(tmp_path, arch,
                                                                     multi_pod):
    """``python -m repro_torch.launch.dryrun --arch A --shape train_4k
    [--mesh 16x16 | --multi-pod]`` writes an ``ok`` record: one device's
    FLOPs, bytes and memory, a non-zero collective term, ``n_devices``
    256 or 512; the roofline names its three terms."""
    args = ["--arch", arch, "--shape", "train_4k", "--out", str(tmp_path)]
    args += ["--multi-pod"] if multi_pod else ["--mesh", "16x16"]
    with pytest.raises(SystemExit) as e:
        dryrun.main(args)
    assert e.value.code == 0
    name = "2x16x16" if multi_pod else "16x16"
    rec = json.loads((tmp_path / f"{arch}__train_4k__{name}.json").read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == (512 if multi_pod else 256)
    assert rec["coordinate"] == dict.fromkeys(("pod", "data", "model")[-len(name.split("x")):],
                                              0)
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["memory"]["peak_memory_in_bytes"] > 0
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["collectives"]["all-gather"]["count"] > 0      # FSDP over data
    assert rec["collectives"]["reduce-scatter"]["count"] > 0
    # per device: well under the world-size-1 count of the same step
    whole = get_config(arch)
    assert rec["model_flops"] == 6.0 * whole.active_param_count() * 256 * 4096
    rows = roofline.main(str(tmp_path))
    (row,) = rows
    assert row["t_collective_s"] == rec["collectives"]["total_bytes"] / HW.NVLINK_BW > 0
    assert row["dominant"] in ("compute", "memory", "collective")
    assert row["dominant"] == max(("compute", "memory", "collective"),
                                  key=lambda k: row[f"t_{k}_s"])
    assert (tmp_path / f"roofline_{name}.json").exists()


def test_every_other_meshed_cell_is_skipped_with_its_roadmap_reason():
    """On 16x16 only the dense family's training cells count: the serving
    cells, the MoE family's training and the other families' are
    ``skipped`` naming the part of item 8c that brings them; a cell the
    model does not support keeps the reference's reason."""
    seen = set()
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape, wl in WORKLOADS.items():
            ok, why = Model(cfg, device="meta").supports(wl)
            if cfg.family == "dense" and wl.kind == "train":
                continue
            rec = dryrun.run_cell(arch, shape, mesh_spec="16x16")
            assert rec["status"] == "skipped" and rec["mesh"] == "16x16", (arch, shape)
            if not ok:
                assert rec["why"] == why
                continue
            assert "ROADMAP.md Queue 1 item 8c" in rec["why"], (arch, shape, rec["why"])
            seen.add(rec["why"].split(": ", 1)[1])
    assert seen == {"serving steps under decode_rules on a mesh",
                    "MoE training through the expert-parallel collectives, and SP",
                    "the xlstm layers under a mesh", "the zamba2 layers under a mesh",
                    "the whisper layers under a mesh", "the mllama layers under a mesh"}


def test_the_world_size_1_count_has_no_collective_term(tmp_path):
    """Without a mesh a cell is counted as before: mesh "1", one device,
    every collective 0, and the roofline's collective term 0."""
    rec = dryrun.run_cell("qwen2-1.5b", "train_4k", smoke=True, out_dir=str(tmp_path),
                          workload=SMALL)
    assert rec["mesh"] == "1" and rec["n_devices"] == 1 and "coordinate" not in rec
    assert rec["collectives"] == {**{c: {"count": 0, "result_bytes": 0, "wire_bytes": 0.0}
                                     for c in COLLECTIVES}, "total_bytes": 0.0}
    (row,) = roofline.main(str(tmp_path))
    assert row["t_collective_s"] == 0.0 and row["dominant"] != "collective"
