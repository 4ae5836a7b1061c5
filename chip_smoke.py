#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # from the root of a checkout, on a machine with one GPU

Drives the port's main paths (the serving plane's model step, for the
dense and the xLSTM families) on the GPU, never the JAX reference
package, in eight phases; any failed phase exits non-zero before the
final line:

1. the card's name and power limit, and the torch/CUDA versions;
2. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all started together), report the build time and each kernel's
   registers, shared memory and spills (the fused norm's instantiations
   must spill nothing), and count the tensor-core instructions (``HMMA``)
   in the built flash-attention library: the bf16 kernels must have some;
3. hold each kernel (K1-K5) against its plain PyTorch version on the card
   at the main paths' shapes plus ragged ones and the attention kernels'
   tile and split edges, in f32 and bf16 (K1 in every mode the models call:
   with and without the residual add, Gemma's ``1 + scale``, with and
   without the residual output, on strided and unaligned rows), and time
   kernel, plain version and the nearest PyTorch library call (flash
   attention at S = 16, 100, 384 and 1024), and each wrapper's host time
   per call (K1's beside one ``torch.add``); the K4 and K5 windows are
   also printed by kernel name,
   K4 must be one kernel per call, and K5 is timed at the admission
   path's S = 16, 100 and 384, at decode's B = 4 S = 1 warm and with L2
   flushed, and beside its serial floor (S rounds of the cluster's h
   exchange and barrier alone, or of the grid barrier for the f32 grid
   kernel);
4. full-width qwen2-1.5b in f32: kernel path against plain path on the same
   random weights, prefill logits of 4 ragged prompts and 4 decode steps
   with the 4 slots at their ragged lengths;
5. full-width qwen2-1.5b in bf16: serve unsized requests through
   ``repro_torch.runtime.server.InferenceServer``, with every kernel's
   launch counter set to 0 just before and read just after, check that
   every prefill and decode call launched the fused norm once per
   full-width RMSNorm (2L + 1), and check in a profile that each
   decode-attention call is one kernel launch;
6. full-width xlstm-1.3b in f32: kernel path against plain path, as in 4;
7. full-width xlstm-1.3b in bf16: serve unsized requests, as in 5 (103
   fused norms a call), and check that the sLSTM scan and the fused norm
   ran in prefill and decode.
8. the serving fleet (``repro_torch.launch.fleet``): two replica processes
   of full-width qwen2-1.5b in bf16 on the one card, fed 16 unsized
   request messages through the shared-memory planes, once as they are and
   once with replica 1 killed after its first result chunk; each run must
   complete every request exactly once with whole streams and the tokens
   of one in-process server on the same weights, and every replica must
   report, through the metrics plane, a ``cuda`` device and launches of
   the fused norm, flash attention and decode attention (its counts zeroed
   after its prewarm, so they count the fleet's requests only).

It prints a ``{"kernels": [...]}`` line and ends with one JSON line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or run from a
directory without ``src/repro_torch``, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): the least-time bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # bf16 tensor cores; f32 CUDA cores
TOL = {"float32": 3e-5, "bfloat16": 2e-2}              # tests/test_kernels.py:17-18
# sLSTM scan, kernel vs plain: the two differ only in the order of the f32
# recurrent sums, carried through up to 384 dependent steps; the
# tolerances of tests/test_slstm_kernel.py:28 (1e-5 f32, 5e-2 bf16) are
# for 64 steps, so both get the repo's f32 3e-5: the kernel widens bf16
# inputs to f32 as the plain version does
SLSTM_TOL = 3e-5

SEED = 0
N_REQUESTS = 8
MAX_NEW = 32
PROMPT_MIN, PROMPT_MAX = 16, 384
SLOTS, MAX_SEQ, PAGE_TOKENS = 4, 512, 64
# f32 full-width model, kernel path vs plain path: the two differ only in
# the summation order inside attention and the fused norm (~1e-6 relative
# per call), carried through 28 layers; 1e-3 of the logits' scale leaves
# room for that growth while any indexing or masking fault is O(1).
MODEL_F32_REL_TOL = 1e-3


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int = 50, warm: int = 5) -> float:
    """Time per call between CUDA events around back-to-back calls: for a
    small kernel this is the host's launch rate, not the device's time."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def host_ms_each(fns: dict, iters: int = 100, reps: int = 5, warm: int = 10) -> dict:
    """Host time per call of each of ``fns``, on the CPU's clock, around
    ``iters`` back-to-back calls issued without a synchronise: what a call
    costs the host (checks, allocation, the launch), whatever the device
    does meanwhile.  The functions take turns, one block of ``iters`` calls
    each per round, so a drift of the host's speed falls on all alike; the
    median of ``reps`` rounds."""
    import torch

    for fn in fns.values():
        for _ in range(warm):
            fn()
    runs = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            runs[k].append((time.perf_counter() - t0) * 1e3 / iters)
    torch.cuda.synchronize()
    return {k: sorted(v)[reps // 2] for k, v in runs.items()}


def host_ms(fn, **kw) -> float:
    """Host time per call of ``fn`` alone (see :func:`host_ms_each`)."""
    return host_ms_each({0: fn}, **kw)[0]


def cuda_activity(prof) -> list:
    """The profiler's device-side entries (kernels, copies, memsets)."""
    return [e for e in prof.key_averages() if e.device_type.name == "CUDA"]


def device_breakdown(fn, iters: int = 20, warm: int = 3, tries: int = 3,
                     flush=None) -> dict:
    """{kernel name: [device ms per call, launches per call]} from the CUDA
    activity ``torch.profiler`` records over ``iters`` calls.  ``flush``
    (e.g. a write of a buffer larger than L2) runs before each call; its
    activity, which it must launch as a fill, is left out.  The profiler
    can deliver fewer activities than were launched (seen on the H100: 14
    of 20 calls of a 5 us kernel), so a name's ms per call is its mean time
    per activity times its launches per call, rounded to a whole number (at
    least 1).  A window with no device activity at all is profiled again;
    after ``tries`` such windows the run fails rather than report 0."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        seen = {}
        for e in cuda_activity(prof):
            if e.self_device_time_total <= 0 or (flush is not None and "fill" in e.key.lower()):
                continue
            us, n = seen.get(e.key, (0.0, 0))
            seen[e.key] = (us + e.self_device_time_total, n + e.count)
        if seen:
            by = {}
            for k, (us, n) in seen.items():
                per_call = max(1, round(n / iters))
                by[k] = [us / 1e3 / n * per_call, per_call]
            return by
        log("profiler window held no device activity; profiling again")
    fail(f"torch.profiler recorded no device activity in {tries} windows")


def device_ms(fn, iters: int = 20, warm: int = 3, tries: int = 3) -> float:
    """Device time per call (see :func:`device_breakdown`)."""
    return sum(ms for ms, _ in device_breakdown(fn, iters, warm, tries).values())


def log_breakdown(what: str, by: dict) -> None:
    log(f"{what}: device ms per call by kernel: "
        + "; ".join(f"{k[:80]} {ms:.5f} x{n:g}" for k, (ms, n) in
                    sorted(by.items(), key=lambda kv: -kv[1][0])))


def timings(kernel, plain, library, *, plain_iters: int = 20, what: str | None = None) -> dict:
    """Device ms per call of the kernel, its plain version and the library
    call (None where there is none); ``plain_iters`` cuts the profiled
    calls of a plain version that issues thousands of launches per call.
    With ``what``, the kernel's window is logged by kernel name, and
    ``kernels_per_call`` counts its device activities per call."""
    by = device_breakdown(kernel)
    if what:
        log_breakdown(what, by)
    return {"ms": sum(ms for ms, _ in by.values()),
            "kernels_per_call": sum(n for _, n in by.values()),
            "plain_ms": device_ms(plain, iters=plain_iters, warm=1),
            "library_ms": None if library is None else device_ms(library),
            "wall_ms": cuda_ms(kernel), "host_ms": host_ms(kernel)}


def log_timings(what: str, t: dict, library: str | None) -> None:
    lib = f"{library} {t['library_ms']:.5f}" if library else "no library call"
    log(f"{what}: device ms per call: kernel {t['ms']:.5f}, plain {t['plain_ms']:.5f}, "
        f"{lib}, bound {t['bound_ms']:.5f} ({t['bound_by']}); "
        f"kernel wall per back-to-back call {t['wall_ms']:.5f} ms, host {t['host_ms']:.5f} ms")


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (1e3 * max(tb, tf), "bytes" if tb >= tf else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def check_close(name: str, got, ref, dtype: str, tol: float | None = None) -> float:
    import torch

    tol = TOL[dtype] if tol is None else tol
    if got.shape != ref.shape:
        fail(f"{name}: shape {tuple(got.shape)} != plain {tuple(ref.shape)}")
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite output")
    if not torch.allclose(got.float(), ref.float(), atol=tol, rtol=tol):
        fail(f"{name}: max |kernel - plain| {max_err(got, ref):.3e} beyond atol=rtol={tol}")
    return max_err(got, ref)


def demangle(names: list[str]) -> list[str]:
    """Readable kernel names, through the toolkit's ``cu++filt``; anonymous
    namespaces and parameter lists dropped."""
    from repro_torch.kernels import _build

    out = subprocess.run([_build.cuda_tool("cu++filt")], input="\n".join(names),
                         capture_output=True, text=True, timeout=60, check=True).stdout
    short = []
    for line in out.splitlines():
        line = re.sub(r"\(anonymous namespace\)::|<unnamed>::", "", line)
        depth, cut = 0, len(line)
        for i, ch in enumerate(line):       # cut at the parameter list
            depth += ch == "<"
            depth -= ch == ">"
            if ch == "(" and depth == 0:
                cut = i
                break
        short.append(line[:cut].replace("void ", "").replace("(int)", "").strip())
    return short


def ptxas_by_kernel(names: list[str]) -> dict:
    """Each kernel's registers, shared memory and spills, from ``ptxas -v``:
    logged, and returned as {source: [(kernel, registers line, spill line)]}."""
    from repro_torch.kernels import _build

    report = {}
    for n in names:
        entries = []                          # [mangled name, registers, spills]
        for line in _build.ptxas_report(n).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entries.append([m.group(1), "", ""])
            elif entries and "spill" in line:
                entries[-1][2] = line.strip()
            elif entries and "registers" in line:
                entries[-1][1] = line.split(":", 1)[-1].strip()
        report[n] = []
        for (_, regs, spill), short in zip(entries, demangle([e[0] for e in entries])):
            log(f"ptxas {n} {short}: {regs}; {spill}")
            report[n].append((short, regs, spill))
    return report


def sass_counts(name: str, opcode: str) -> dict:
    """How many ``opcode`` instructions each kernel of the built library for
    ``csrc/<name>.cu`` holds, from ``cuobjdump -sass``."""
    from repro_torch.kernels import _build

    sass = subprocess.run([_build.cuda_tool("cuobjdump"), "-sass",
                           str(_build._target(name))], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn and f" {opcode}" in line:
            counts[fn] += 1
    return dict(zip(demangle(list(counts)), counts.values()))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_kernels(dev) -> dict:
    import torch
    import torch.nn.functional as F

    from _attention_edges import DECODE_SHAPES, decode_edge_lens, flash_edge_cases

    from repro_torch.kernels.decode_attention.ops import decode_attention, decode_attention_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_ref
    from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm, rmsnorm_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rnd = lambda *shape, dt: torch.randn(shape, generator=gen, device=dev).to(dt)  # noqa: E731
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    report = {}

    report["rmsnorm"] = phase_rmsnorm(dev, gen, rnd, dts)

    # K2 flash attention: the model's (B,S,H,hd) tensors viewed as (B,H,S,hd)
    def qkv(b, h, kv, sq, sk, hd, dt):
        q = rnd(b, sq, h, hd, dt=dt).transpose(1, 2)
        k = rnd(b, sk, kv, hd, dt=dt).transpose(1, 2)
        v = rnd(b, sk, kv, hd, dt=dt).transpose(1, 2)
        return q, k, v

    cases = [(1, 12, 2, 384, 384, 128, True), (1, 12, 2, 16, 16, 128, True),
             (1, 12, 2, 100, 100, 128, True), (1, 12, 2, 1, 1, 128, True),
             (2, 12, 2, 50, 130, 128, True),       # top-left causal, Sq != Sk
             (2, 8, 2, 77, 45, 64, False), (1, 4, 1, 33, 33, 64, True)]
    errs = {}
    for dname, dt in dts.items():
        for case in cases:
            b, h, kv, sq, sk, hd, causal = case
            q, k, v = qkv(b, h, kv, sq, sk, hd, dt)
            o = flash_attention(q, k, v, causal=causal)
            e = check_close(f"flash {dname} {case}", o, flash_attention_ref(q, k, v, causal=causal),
                            dname)
            errs[(dname, case)] = e
            log(f"flash_attention {dname} B,H,KV,Sq,Sk,hd,causal={case}: max_abs_err {e:.3e}")
    # the 64-row query tiles' and 64-key tiles' edges (tests/_attention_edges.py)
    worst = {}
    for dname, dt in dts.items():
        for sq, sk, g, eb, ekv in flash_edge_cases():
            for hd in (64, 128):
                for causal in (True, False):
                    q, k, v = qkv(eb, g * ekv, ekv, sq, sk, hd, dt)
                    o = flash_attention(q, k, v, causal=causal)
                    e = check_close(f"flash {dname} edge B={eb} KV={ekv} Sq={sq} Sk={sk} "
                                    f"G={g} hd={hd} causal={causal}", o,
                                    flash_attention_ref(q, k, v, causal=causal), dname)
                    worst[dname] = max(worst.get(dname, 0.0), e)
    log(f"flash_attention tile edges ({len(flash_edge_cases())} (Sq, Sk, G, B, KV) cases x "
        f"hd 64/128 x causal or not): max_abs_err "
        + ", ".join(f"{d} {e:.3e}" for d, e in worst.items()))

    b, h, kv, hd = 1, 12, 2, 128
    by_seq = {}
    for s in (16, 100, 384, 1024):        # the path's prompts reach 384; 1024 beyond
        q, k, v = qkv(b, h, kv, s, s, hd, torch.bfloat16)
        qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
        t = timings(lambda: flash_attention(q, k, v, causal=True),
                    lambda: flash_attention_ref(q, k, v, causal=True),
                    lambda: F.scaled_dot_product_attention(qc, kc, vc, is_causal=True,
                                                           enable_gqa=True))
        nbytes = 2 * (2 * b * s * h * hd + 2 * b * s * kv * hd)
        flops = 4 * hd * h * b * (s * (s + 1) // 2)
        t["bound_ms"], t["bound_by"] = bound_ms(nbytes, flops, "bfloat16")
        log_timings(f"flash_attention bf16 B=1 H=12 KV=2 S={s} hd=128", t, "SDPA")
        by_seq[s] = t
    report["flash_attention"] = {"max_abs_err": errs[("bfloat16", cases[0])],
                                 "shape": "B=1 H=12 KV=2 Sq=Sk=384 hd=128 causal bf16",
                                 **by_seq[384], "by_seq": {s: by_seq[s] for s in (16, 100, 1024)}}

    # K3 decode attention: one layer of the (B, Smax, KV, hd) cache, read in place
    b, h, kv, s, hd = 4, 12, 2, 512, 128
    len_cases = [[397, 250, 130, 17], [0, 1, 512, 700], [512, 512, 512, 512], [5, 0, 0, 129]]
    errs = {}
    for dname, dt in dts.items():
        for lens in len_cases:
            qd = rnd(b, 1, h, hd, dt=dt)[:, 0]
            kc4, vc4 = rnd(b, s, kv, hd, dt=dt), rnd(b, s, kv, hd, dt=dt)
            lt = torch.tensor(lens, dtype=torch.int32, device=dev)
            o = decode_attention(qd, kc4.transpose(1, 2), vc4.transpose(1, 2), lt)
            ref = decode_attention_ref(qd, kc4.transpose(1, 2), vc4.transpose(1, 2), lt)
            e = check_close(f"decode {dname} lens={lens}", o, ref, dname)
            if 0 in lens and o[lt == 0].abs().max() != 0:
                fail(f"decode {dname} lens={lens}: a length-0 row is not 0")
            errs[(dname, tuple(lens))] = e
            log(f"decode_attention {dname} B=4 H=12 KV=2 S=512 lens={lens}: max_abs_err {e:.3e}")
    # split edges (tests/_attention_edges.py): P-1, P, P+1 positions per
    # block, S-1, S and > S, one split and many, G even and odd; the calls
    # above and below run back to back on one stream with other lengths
    # each, which a ticket counter left non-zero fails
    from repro_torch.kernels.decode_attention.ops import decode_split_plan

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for dname, dt in dts.items():
        for (bb, kvv, ss), g in zip(DECODE_SHAPES, (6, 7, 1, 3)):
            per, ns = decode_split_plan(ss, bb, kvv, sms)
            qd = rnd(bb, 1, g * kvv, hd, dt=dt)[:, 0]
            kc4, vc4 = rnd(bb, ss, kvv, hd, dt=dt), rnd(bb, ss, kvv, hd, dt=dt)
            for lens in decode_edge_lens(per, ss, bb):
                lt = torch.tensor(lens, dtype=torch.int32, device=dev)
                o = decode_attention(qd, kc4.transpose(1, 2), vc4.transpose(1, 2), lt)
                ref = decode_attention_ref(qd, kc4.transpose(1, 2), vc4.transpose(1, 2), lt)
                e = check_close(f"decode {dname} B={bb} KV={kvv} S={ss} G={g} P={per} "
                                f"lens={lens}", o, ref, dname)
                if 0 in lens and o[lt == 0].abs().max() != 0:
                    fail(f"decode {dname} S={ss} lens={lens}: a length-0 row is not 0")
            log(f"decode_attention {dname} B={bb} KV={kvv} S={ss} G={g}: P={per}, {ns} "
                f"split(s), lengths at the split edges and full: last max_abs_err {e:.3e}")

    lens = len_cases[0]
    qd = rnd(b, 1, h, hd, dt=torch.bfloat16)[:, 0]
    kc4, vc4 = rnd(b, s, kv, hd, dt=torch.bfloat16), rnd(b, s, kv, hd, dt=torch.bfloat16)
    kt, vt = kc4.transpose(1, 2), vc4.transpose(1, 2)
    lt = torch.tensor(lens, dtype=torch.int32, device=dev)
    mask = (torch.arange(s, device=dev)[None, :] < lt[:, None])[:, None, None, :]
    q4, kct, vct = qd[:, :, None], kt.contiguous(), vt.contiguous()
    t = timings(lambda: decode_attention(qd, kt, vt, lt),
                lambda: decode_attention_ref(qd, kt, vt, lt),
                lambda: F.scaled_dot_product_attention(q4, kct, vct, attn_mask=mask,
                                                       enable_gqa=True))
    n_valid = sum(min(max(n, 0), s) for n in lens)
    nbytes = 2 * (2 * b * h * hd + 2 * n_valid * kv * hd) + 4 * b
    t["bound_ms"], t["bound_by"] = bound_ms(nbytes, 4 * hd * h * n_valid, "bfloat16")
    log_timings(f"decode_attention bf16 B=4 H=12 KV=2 S=512 hd=128 lens={lens}", t, "SDPA")
    report["decode_attention"] = {"max_abs_err": errs[("bfloat16", tuple(lens))],
                                  "shape": f"B=4 H=12 KV=2 S=512 hd=128 lens={lens} bf16", **t}
    report.update(phase_slstm_scan(dev, rnd, dts))
    report.update(phase_ragged_concat(dev, gen))
    return report


def phase_rmsnorm(dev, gen, rnd, dts) -> dict:
    """K1 in every mode the paths call, at their widths: D = 1536 (qwen2),
    2048 (xlstm) and 4096 (the mLSTM's inner norm), the smoke configs' 48
    and the unaligned 52; R = 4 (decode's slots) to 384 (prefill).  Then
    the views the model hands over: prefill's last position of (B, S, D),
    strided rows, and a view offset by one element (the scalar
    instantiation).  Timed in bf16 at D = 1536, R = 4 and 384 beside
    ``F.rms_norm`` (the norm alone on the pre-added input: PyTorch has no
    add + norm call), at D = 2048 and 4096, R = 4, and the host time of one
    call beside one ``torch.add`` of the same tensors."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm, rmsnorm_ref

    def cmp(what, got, ref, dname):
        (y, h), (yr, hr) = got, ref
        e = check_close(f"{what} y", y, yr, dname)
        if (h is None) != (hr is None):
            fail(f"{what}: residual output {h is None} vs plain {hr is None}")
        return e if h is None else max(e, check_close(f"{what} h", h, hr, dname))

    errs = {}
    modes = {"add": (True, False, True), "add-gemma": (True, True, True),
             "add-no-out": (True, False, False), "norm": (False, False, False),
             "norm-gemma": (False, True, True)}
    for dname, dt in dts.items():
        for d in (1536, 2048, 4096, 48, 52):
            worst = 0.0
            for rows in (4, 384, 16, 1, 37):
                for mode, (with_r, gemma, want) in modes.items():
                    x = rnd(rows, d, dt=dt)
                    r = rnd(rows, d, dt=dt) if with_r else None
                    sc = torch.randn(d, generator=gen, device=dev)
                    kw = dict(eps=1e-6, gemma=gemma, want_residual=want)
                    e = cmp(f"rmsnorm {dname} R={rows} D={d} {mode}", fused_rmsnorm(x, r, sc, **kw),
                            rmsnorm_ref(x, r, sc, **kw), dname)
                    errs[(dname, rows, d, mode)] = e
                    worst = max(worst, e)
            log(f"rmsnorm {dname} D={d} R=4/384/16/1/37, modes {'/'.join(modes)}: "
                f"max_abs_err {worst:.3e}")
        base, res = rnd(4, 40, 1536, dt=dt), rnd(4, 40, 1536, dt=dt)
        sc = torch.randn(1536, generator=gen, device=dev)
        e = cmp(f"rmsnorm {dname} (4, 1, 1536) slice of (4, 40, 1536)",
                fused_rmsnorm(base[:, -1:], res[:, -1:], sc),
                rmsnorm_ref(base[:, -1:].contiguous(), res[:, -1:].contiguous(), sc), dname)
        flat = rnd(4 * 2048 + 1, dt=dt)
        xu, sc2 = flat[1:].view(4, 2048), torch.randn(2048, generator=gen, device=dev)
        e = max(e, cmp(f"rmsnorm {dname} unaligned view", fused_rmsnorm(xu, xu.flip(0), sc2),
                       rmsnorm_ref(xu, xu.flip(0), sc2), dname))
        log(f"rmsnorm {dname} strided last-position rows and a view offset by one element "
            f"(scalar instantiation): max_abs_err {e:.3e}")

    times = {}
    for rows, d in ((4, 1536), (384, 1536), (4, 2048), (4, 4096)):
        x, r = rnd(rows, d, dt=torch.bfloat16), rnd(rows, d, dt=torch.bfloat16)
        sc = torch.randn(d, generator=gen, device=dev)
        hsum = (x.float() + r.float()).to(torch.bfloat16)
        sc16 = sc.to(torch.bfloat16)
        t = timings(lambda: fused_rmsnorm(x, r, sc, eps=1e-6),
                    lambda: rmsnorm_ref(x, r, sc, eps=1e-6),
                    lambda: F.rms_norm(hsum, (d,), sc16, 1e-6))
        # x and r read once, y and h written once, the f32 scale read once
        t["bound_ms"], t["bound_by"] = bound_ms(4 * rows * d * 2 + d * 4, 6 * rows * d,
                                                "bfloat16")
        # the wrapper and one torch.add in turns, for their ratio
        pair = host_ms_each({"k1": lambda: fused_rmsnorm(x, r, sc, eps=1e-6),
                             "add": lambda: torch.add(x, r)}, reps=9)
        t["host_ms"], t["torch_add_host_ms"] = pair["k1"], pair["add"]
        times[(rows, d)] = t
        log_timings(f"rmsnorm bf16 R={rows} D={d}", t, "F.rms_norm")
        log(f"rmsnorm bf16 R={rows} D={d}: host ms per back-to-back call: wrapper "
            f"{t['host_ms']:.5f}, one torch.add of the same tensors "
            f"{t['torch_add_host_ms']:.5f} (ratio {t['host_ms'] / t['torch_add_host_ms']:.2f})")
    shapes = {f"R={rows} D={d} bf16": {k: v for k, v in t.items() if k != "wall_ms"}
              for (rows, d), t in times.items()}
    return {"max_abs_err": errs[("bfloat16", 4, 1536, "add")], "shape": "R=4 D=1536 bf16",
            **times[(4, 1536)], "shapes": shapes}


def phase_slstm_scan(dev, rnd, dts) -> dict:
    """K5 at the xLSTM path's shapes: D = 2048, H = 4; prefill B = 1 with
    S = 1, 16, 17, 100 and 384 (the admission path's prompts), decode B = 4
    with S = 1, both from the zero state, and a resume from a carried
    state.  bf16 takes the cluster kernel, f32 the grid kernel.  Timed: bf16
    B = 1 at S = 16, 100, 384, and B = 4 S = 1 warm and with L2 flushed;
    f32 B = 1 S = 384 (the grid kernel); each kernel's serial floor (the
    cluster's exchange and barrier, the grid's barrier) at S = 384."""
    import torch

    from repro_torch.kernels.slstm_scan.ops import (cluster_sync_loop, grid_sync_loop,
                                                    slstm_scan, slstm_scan_plan,
                                                    slstm_scan_ref)

    d, h = 2048, 4
    dh = d // h

    def inputs(b, s, dt):
        z = torch.zeros(b, d, device=dev)
        return (rnd(b, s, 4 * d, dt=dt), rnd(h, dh, 4 * dh, dt=dt) * dh ** -0.5,
                rnd(4 * d, dt=torch.float32) * 0.1, z, z, z,
                torch.full((b, d), float("-inf"), device=dev))

    def cmp(what, got, ref, dname):
        (hs, st), (hr, sr) = got, ref
        return max([check_close(f"{what} hs", hs, hr, dname, SLSTM_TOL)] +
                   [check_close(f"{what} {n}N", a, c, dname, SLSTM_TOL)
                    for a, c, n in zip(st, sr, "hcnm")])

    def variant(b, dt):
        p = slstm_scan_plan(b, d, h, x_dtype=dt, w_dtype=dt)
        where = f"cluster of {p.cluster}" if p.variant == "cluster" else "cooperative grid"
        return p, (f"{p.variant} kernel: {p.blocks} blocks of J={p.j} ({where}), "
                   f"{p.smem} B shared memory a block, {p.active} resident at once")

    errs = {}
    for dname, dt in dts.items():
        for b, s in ((1, 1), (1, 16), (1, 17), (1, 100), (1, 384), (4, 1)):
            args = inputs(b, s, dt)
            e = cmp(f"slstm_scan {dname} B={b} S={s}", slstm_scan(*args), slstm_scan_ref(*args),
                    dname)
            errs[(dname, b, s)] = e
            log(f"slstm_scan {dname} B={b} S={s} D={d} H={h}: max_abs_err {e:.3e} "
                f"({variant(b, dt)[1]})")
        # resume: 24 steps in one call == 16 steps, then 8 from the carried state
        args = inputs(2, 24, dt)
        full = slstm_scan(*args)
        _, st = slstm_scan(args[0][:, :16].contiguous(), *args[1:])
        tail = slstm_scan(args[0][:, 16:].contiguous(), args[1], args[2], *st)
        e = cmp(f"slstm_scan {dname} resume", tail, (full[0][:, 16:], full[1]), dname)
        log(f"slstm_scan {dname} B=2 S=16+8 resumed vs one call: max_abs_err {e:.3e}")
        e = cmp(f"slstm_scan {dname} resumed vs plain", tail,
                slstm_scan_ref(args[0][:, 16:], args[1], args[2], *st), dname)
        log(f"slstm_scan {dname} B=2 S=8 from a carried state vs plain: max_abs_err {e:.3e}")

    def bound(b, s, wbytes):
        # bytes: xg, w_hh, b and the state in once, hs and the state out once;
        # operations: the f32 recurrent product (h is f32), on CUDA cores
        nbytes = 2 * b * s * 4 * d * (2 if wbytes == 4 else 1) + wbytes * h * dh * 4 * dh + \
            4 * 4 * d + 16 * b * d + 4 * b * s * d + 16 * b * d
        return bound_ms(nbytes, 2 * b * s * 4 * d * dh, "float32")

    flush_buf = torch.empty(64 * 2 ** 20 // 4, device=dev)      # 64 MB > the 50 MB L2
    out = {}
    for b, s, dt in ((1, 384, torch.bfloat16), (1, 100, torch.bfloat16),
                     (1, 16, torch.bfloat16), (4, 1, torch.bfloat16), (1, 384, torch.float32)):
        dname = str(dt).split(".")[-1]
        args = inputs(b, s, dt)
        fn = lambda: slstm_scan(*args)  # noqa: E731
        t = timings(fn, lambda: slstm_scan_ref(*args), None, plain_iters=3 if s > 100 else 20,
                    what=f"slstm_scan {dname} B={b} S={s}")
        t["bound_ms"], t["bound_by"] = bound(b, s, 4 if dt == torch.float32 else 2)
        p, desc = variant(b, dt)
        t["variant"], t["cluster"], t["blocks"], t["j"] = p.variant, p.cluster, p.blocks, p.j
        if s == 1:
            by = device_breakdown(fn, flush=lambda: flush_buf.fill_(1.0))
            log_breakdown(f"slstm_scan {dname} B={b} S={s} L2 flushed", by)
            t["l2_flushed_ms"] = sum(ms for ms, _ in by.values())
        if s == 384:
            if p.variant == "cluster":
                t["chain_ms"] = device_ms(lambda: cluster_sync_loop(p.cluster, h, b * p.j, s,
                                                                    dev))
                floor = f"{s} rounds of the DSMEM exchange (st.async, mbarrier wait) alone"
            else:
                t["chain_ms"] = device_ms(lambda: grid_sync_loop(p.blocks, s, dev))
                floor = f"{s} grid barriers alone"
            log(f"slstm_scan {dname} B={b} S={s}: {floor} (the chain's floor) "
                f"{t['chain_ms']:.5f} ms")
        log_timings(f"slstm_scan {dname} B={b} S={s} D={d} H={h} [{desc}]", t, None)
        if s == 1:
            log(f"slstm_scan {dname} B={b} S={s}: with L2 flushed {t['l2_flushed_ms']:.5f} ms "
                f"(warm {t['ms']:.5f})")
        out[(b, s, dname)] = t
    shapes = {f"B={b} S={s} {dn}": {k: v for k, v in t.items() if k != "wall_ms"}
              for (b, s, dn), t in out.items()}
    return {"slstm_scan": {"max_abs_err": errs[("bfloat16", 1, 384)],
                           "shape": f"B=1 S=384 D={d} H={h} bf16 (prefill)",
                           **out[(1, 384, "bfloat16")], "shapes": shapes}}


def phase_ragged_concat(dev, gen) -> dict:
    """K4 at the concatenate node's size: the Top LiDAR's ~500k points and
    two sides' ~3k, 4 fields each (src/repro/apps/pointcloud.py:50), over
    the dtype sweep, with room to spare and with capacity < total; then
    timed beside ``torch.cat``, and required to be one kernel per call."""
    import torch

    from repro_torch.kernels.ragged_concat.ops import ragged_concat, ragged_concat_ref

    lens = [500_000, 3_011, 2_987]
    n, lmax, c = len(lens), max(lens), 4
    lt = torch.tensor(lens, dtype=torch.int32, device=dev)
    for dt in (torch.float32, torch.bfloat16, torch.int32, torch.uint8):
        src = (torch.randn(n, lmax, c, generator=gen, device=dev) * 100).to(dt)
        for cap in (sum(lens) + 1000, 400_000):
            out, offs, total = ragged_concat(src, lt, capacity=cap)
            ref, roffs, rtotal = ragged_concat_ref(src, lt, cap)
            if not (torch.equal(out, ref) and torch.equal(offs, roffs)
                    and int(total) == int(rtotal) == sum(lens)):
                fail(f"ragged_concat {dt} capacity {cap}: kernel differs from plain")
            log(f"ragged_concat {dt} lens={lens} C={c} capacity={cap}: equal to plain")
    src = torch.randn(n, lmax, c, generator=gen, device=dev)
    cap = sum(lens) + 1000
    cat = lambda: torch.cat([src[i, :k] for i, k in enumerate(lens)])  # noqa: E731
    t = timings(lambda: ragged_concat(src, lt, capacity=cap),
                lambda: ragged_concat_ref(src, lt, cap),
                # the valid rows alone, no zero-filled tail
                cat, plain_iters=5, what=f"ragged_concat f32 lens={lens} capacity={cap}")
    log_breakdown("torch.cat of the valid views", device_breakdown(cat))
    if t["kernels_per_call"] != 1:
        fail(f"ragged_concat: {t['kernels_per_call']:g} kernels per call, not one")
    nbytes = 4 * c * (sum(lens) + cap) + 8 * n
    t["bound_ms"], t["bound_by"] = bound_ms(nbytes, 0, "float32")
    log_timings(f"ragged_concat f32 lens={lens} C={c} capacity={cap}", t, "torch.cat")
    return {"ragged_concat": {"max_abs_err": 0.0, "shape": f"N=3 lens={lens} C=4 f32", **t}}


# ---------------------------------------------------------------------------
# phases 4 and 6: full-width f32 model, kernel path vs plain path
# ---------------------------------------------------------------------------

# the kernels each family's path goes through, by wrapper
PATH_KERNELS = {"qwen2-1.5b": ("rmsnorm", "flash_attention", "decode_attention"),
                "xlstm-1.3b": ("rmsnorm", "slstm_scan")}


def wrappers() -> dict:
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ragged_concat.ops import ragged_concat
    from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm
    from repro_torch.kernels.slstm_scan.ops import slstm_scan

    return {"rmsnorm": fused_rmsnorm, "flash_attention": flash_attention,
            "decode_attention": decode_attention, "slstm_scan": slstm_scan,
            "ragged_concat": ragged_concat}


def phase_model_f32(dev, arch: str) -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config(arch).scaled(param_dtype="float32", compute_dtype="float32")
    fast, plain = Model(cfg, device=dev), Model(cfg, device=dev, plain=True)
    params = fast.init(SEED)
    rng = np.random.default_rng(SEED)

    def cmp(what, a, b):
        if not torch.isfinite(a).all():
            fail(f"f32 {arch} {what}: non-finite logits")
        scale = float(b.abs().max())
        err = max_err(a, b)
        agree = bool((a[:, -1].argmax(-1) == b[:, -1].argmax(-1)).all())
        log(f"f32 {arch} {what}: max_abs_err {err:.3e} (logit scale {scale:.3e}, "
            f"rel {err / scale:.3e}, bound {MODEL_F32_REL_TOL}), argmax agree {agree}")
        if err > MODEL_F32_REL_TOL * scale:
            fail(f"f32 {arch} {what}: kernel path differs from plain path by {err:.3e}")

    # four slots with ragged prompts, spliced in as the server splices them
    lens = [200, 37, 311, 5]
    ck, cp = fast.init_cache(len(lens), MAX_SEQ), plain.init_cache(len(lens), MAX_SEQ)
    first = []
    for slot, n in enumerate(lens):
        tt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n)), device=dev)
        lk, k1 = fast.prefill(params, {"tokens": tt})
        lp, p1 = plain.prefill(params, {"tokens": tt})
        cmp(f"prefill S={n}", lk, lp)
        fast.splice_cache(ck, k1, slot, n)
        plain.splice_cache(cp, p1, slot, n)
        first.append(lp[0, -1].argmax())
        del k1, p1
    nxt = torch.stack(first)[:, None]
    for i in range(4):
        lk, ck = fast.decode_step(params, ck, nxt)
        lp, cp = plain.decode_step(params, cp, nxt)
        cmp(f"decode step {i + 1}, 4 slots at lengths {[n + i for n in lens]}", lk, lp)
        nxt = lp[:, -1].argmax(-1, keepdim=True)
    want = [n + 4 for n in lens]
    if ck["len"].tolist() != want or cp["len"].tolist() != want:
        fail(f"f32 {arch}: cache len {ck['len'].tolist()} / {cp['len'].tolist()}, "
             f"expected {want}")
    del params, ck, cp, lk, lp
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 5 and 7: full-width bf16 serving through InferenceServer
# ---------------------------------------------------------------------------


def count_by_stage(model, names: tuple, ws: dict) -> dict:
    """Count each path kernel's launches inside ``model.prefill`` and inside
    ``model.decode_step`` separately, by wrapping the two on this instance;
    ``calls`` counts the calls of each."""
    counts = {"prefill": dict.fromkeys(names, 0), "decode": dict.fromkeys(names, 0),
              "calls": {"prefill": 0, "decode": 0}}

    def counted(fn, stage):
        bucket = counts[stage]

        def call(*args, **kw):
            before = {n: ws[n].launches for n in names}
            out = fn(*args, **kw)
            for n in names:
                bucket[n] += ws[n].launches - before[n]
            counts["calls"][stage] += 1
            return out
        return call

    model.prefill = counted(model.prefill, "prefill")
    model.decode_step = counted(model.decode_step, "decode")
    return counts


def norms_per_call(cfg) -> int:
    """K1 launches one prefill or decode step makes: every full-width
    RMSNorm, its residual add fused in.  Dense: ln1 and ln2 of each layer
    and the final norm (2L + 1); xLSTM: each block's pre-norm and inner
    norm, each sLSTM block's ln_s2 and the final norm (103 at full width)."""
    if cfg.family == "xlstm":
        n_slstm = cfg.num_layers // cfg.slstm_every if cfg.slstm_every > 0 else 0
        return 2 * cfg.num_layers + n_slstm + 1
    return 2 * cfg.num_layers + 1


def phase_serve_bf16(dev, arch: str) -> tuple[dict, dict]:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests, run, warmup
    from repro_torch.models import Model
    from repro_torch.runtime.server import InferenceServer

    ws = wrappers()
    names = PATH_KERNELS[arch]
    cfg = get_config(arch)
    model = Model(cfg, device=dev)
    params = model.init(SEED)
    n_params = sum(t.numel() for t in _leaves(params))
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"bf16 {arch}: {n_params / 1e9:.3f} B parameters, {weight_bytes / 1e9:.3f} GB")

    def serve(m):
        srv = InferenceServer(m, slots=SLOTS, max_seq=MAX_SEQ, page_tokens=PAGE_TOKENS)
        srv.load(params)
        warmup(srv, cfg.vocab_size, PROMPT_MAX)
        return srv

    def requests(prefix):
        return make_requests(N_REQUESTS, vocab=cfg.vocab_size, prompt_min=PROMPT_MIN,
                             prompt_max=PROMPT_MAX, max_new=MAX_NEW, seed=SEED, prefix=prefix)

    srv = serve(model)
    state_bytes = sum(t.numel() * t.element_size() for k, t in _items(srv._cache)
                      if k != "len") if cfg.family == "xlstm" else 0
    stages = count_by_stage(model, names, ws)
    for w in ws.values():
        w.launches = 0
    out = run(srv, requests("req"))
    launches = {name: w.launches for name, w in ws.items()}
    torch.cuda.synchronize()
    if out["completed"] != N_REQUESTS:
        fail(f"{arch}: served {out['completed']}/{N_REQUESTS} requests")
    if not out["pool_clean"]:
        fail(f"{arch}: KV page pool not clean after serving: {srv.stats()}")
    for r in out["results"].values():
        if len(r.tokens) != MAX_NEW or not all(0 <= t < cfg.vocab_size for t in r.tokens):
            fail(f"{arch} request {r.rid}: bad tokens {r.tokens}")
    for name in names:
        if launches[name] <= 0:
            fail(f"{arch}: kernel {name} was launched {launches[name]} times on the main path")
    log(f"{arch} launches on the main path (counters zeroed just before): {launches}")
    log(f"{arch} launches by stage: prefill {stages['prefill']}, decode {stages['decode']} "
        f"({stages['calls']['prefill']} prefill and {stages['calls']['decode']} decode calls)")
    for stage in ("prefill", "decode"):
        calls, want = stages["calls"][stage], norms_per_call(cfg)
        if not calls or stages[stage]["rmsnorm"] != calls * want:
            fail(f"{arch}: {stages[stage]['rmsnorm']} rmsnorm launches in {calls} {stage} "
                 f"calls, expected {want} per call")
    log(f"{arch}: {norms_per_call(cfg)} rmsnorm launches per prefill and per decode call")
    if cfg.family == "xlstm":
        for stage in ("prefill", "decode"):
            for name in names:
                if stages[stage][name] <= 0:
                    fail(f"{arch}: kernel {name} was not launched in {stage}")
        log(f"{arch}: state cache {state_bytes / 1e9:.3f} GB for {SLOTS} slots")
    bound_step = 1e3 * (weight_bytes + 2 * state_bytes) / HBM_BYTES_PER_S
    log(f"{arch} decode-round bound {bound_step:.3f} ms ((weights {weight_bytes / 1e9:.3f} GB "
        f"+ 2 x state {state_bytes / 1e9:.3f} GB) / 3.35 TB/s)")
    again = run(srv, requests("again"))      # the same prompts again: run-to-run spread
    for i, o in enumerate((out, again)):
        log(f"{arch} serve run {i + 1}: {o['completed']} requests, prompts "
            f"{PROMPT_MIN}-{PROMPT_MAX} tokens, max_new {MAX_NEW}, slots {SLOTS}: "
            f"{o['generated_tokens']} tokens in {o['wall_s']:.3f} s = "
            f"{o['tokens_per_s']:.2f} tok/s; decode step {o['decode_step_ms']:.3f} ms over "
            f"{o['decode_steps']} rounds; peak device memory {o['peak_mem_gib']} GiB; "
            f"pool clean {o['pool_clean']}")
        log(f"{arch} serve run {i + 1}: TTFT ms by prompt length: "
            + json.dumps([[n, round(ms, 3)] for n, ms in o["ttft_ms"]]))
    if not again["pool_clean"] or again["completed"] != N_REQUESTS:
        fail(f"{arch}: second serve run did not complete cleanly")

    path_ms = profile_rounds(srv, cfg, {n: ws[n] for n in names})

    plain_srv = serve(Model(cfg, device=dev, plain=True))
    plain_out = run(plain_srv, requests("req"))
    same_seq = same_first = same_tok = total = 0
    for rid, r in out["results"].items():
        p = plain_out["results"][rid].tokens
        same_seq += r.tokens == p
        same_first += r.tokens[0] == p[0]
        same_tok += sum(a == b for a, b in zip(r.tokens, p))
        total += len(r.tokens)
    log(f"{arch} bf16 greedy agreement with the plain path (information): "
        f"{same_seq}/{N_REQUESTS} identical sequences, {same_first}/{N_REQUESTS} first tokens "
        f"(from prefill), {same_tok}/{total} tokens; plain path "
        f"{plain_out['tokens_per_s']:.2f} tok/s, decode step {plain_out['decode_step_ms']:.3f} ms")
    del srv, plain_srv, params, model
    torch.cuda.empty_cache()
    return {n: launches[n] for n in names}, path_ms


# ---------------------------------------------------------------------------
# phase 8: the serving fleet
# ---------------------------------------------------------------------------

FLEET_ARCH, FLEET_REPLICAS, FLEET_REQUESTS = "qwen2-1.5b", 2, 16


def phase_fleet(dev) -> dict:
    """Two fleet runs (no fault, then one replica killed) against one
    in-process server; returns the first run's launches summed over the
    replicas."""
    from repro_torch.launch import fleet
    from repro_torch.serving.replica import model_config

    names = PATH_KERNELS[FLEET_ARCH]
    model_kwargs = dict(arch=FLEET_ARCH, size="full", device=dev.type)
    cfg, _ = model_config(model_kwargs)
    reqs = fleet.fleet_requests(cfg, FLEET_REQUESTS, max_new=MAX_NEW, max_seq=MAX_SEQ,
                                seed=SEED)
    prompts = {r.rid: r.tokens for r in reqs}
    t0 = time.monotonic()
    want = fleet.serve_in_process(model_kwargs, prompts, max_new=MAX_NEW, slots=SLOTS,
                                  max_seq=MAX_SEQ)
    log(f"fleet: in-process server, {len(want)} requests, in {time.monotonic() - t0:.1f} s")
    launches = None
    for kill in (False, True):
        what = "kill-one run" if kill else "run"
        out = fleet.run(arch=FLEET_ARCH, size="full", replicas=FLEET_REPLICAS,
                        requests=FLEET_REQUESTS, max_new=MAX_NEW, slots=SLOTS, max_seq=MAX_SEQ,
                        seed=SEED, kill_one=kill, device=dev.type)
        if not fleet.exactly_once(out):
            fail(f"fleet {what}: not exactly once: missing {out['missing']}, bad streams "
                 f"{out['bad_streams']}, completions {out['completions']}, "
                 f"collector {out['collector']}")
        bad = sorted(rid for rid in want if out["tokens"].get(rid) != want[rid])
        if bad:
            fail(f"fleet {what}: tokens differ from the in-process server for {bad}")
        if kill and (out["killed"] is None or not out["replays"]
                     or out["dead"] != [out["killed"]]):
            fail(f"fleet {what}: killed {out['killed']}, dead {out['dead']}, "
                 f"replays {out['replays']}")
        metrics = out["replica_metrics"]
        if sorted(metrics) != list(range(FLEET_REPLICAS)):
            fail(f"fleet {what}: metrics from replicas {sorted(metrics)}")
        for shard, m in sorted(metrics.items()):
            if not str(m["device"]).startswith("cuda") or \
                    any(m["launches"].get(n, 0) <= 0 for n in names):
                fail(f"fleet {what}: replica {shard} reports device {m['device']}, "
                     f"launches {m['launches']}")
        log(f"fleet {what}: {FLEET_REPLICAS} replicas of {FLEET_ARCH} (full, bf16), "
            f"{out['requests']} requests, prompts {fleet.PROMPT_MIN}-{fleet.PROMPT_MAX}, max_new "
            f"{MAX_NEW}, slots {SLOTS}, round tick {out['round_period_s']} s: every rid "
            f"once, streams whole, tokens equal to the in-process server; replicas ready "
            f"in {out['ready_s']:.1f} s; killed {out['killed']}, replays {out['replays']}, "
            f"collector {out['collector']}, declared dead {out['death_evidence']}")
        log(f"fleet {what}: {out['generated_tokens']} tokens in {out['wall_s']:.3f} s = "
            f"{out['tokens_per_s']:.2f} tok/s")
        log(f"fleet {what}: client TTFT ms by prompt length: "
            + json.dumps([[n, round(ms, 3)] for n, ms in out["ttft_ms"]]))
        log(f"fleet {what}: publish-to-take us by request message bytes: "
            + json.dumps([[b, round(us, 1)] for b, us in out["pub_take_us"]]))
        for shard, m in sorted(metrics.items()):
            log(f"fleet {what}: replica {shard} on {m['device']}: launches {m['launches']}, "
                f"peak device memory {m['peak_mem_bytes'] / 2**30:.3f} GiB")
        if launches is None:
            launches = {n: sum(m["launches"].get(n, 0) for m in metrics.values())
                        for n in names}
    return launches


# the CUDA kernels each wrapper launches, by name as the profiler shows them
KERNEL_NAMES = {"rmsnorm": ("rmsnorm_fwd",), "flash_attention": ("flash_fwd",),
                "decode_attention": ("decode_fwd",),
                "slstm_scan": ("slstm_scan",)}


def profile_rounds(srv, cfg, wrappers: dict, rounds: int = 4) -> dict:
    """Where the time goes, from ``torch.profiler``: one admission round
    (``SLOTS`` prefills and a decode round) and then ``rounds`` decode rounds
    with every slot busy.  Runs after the measured serving runs, so it costs
    them nothing.  Returns each kernel's device ms per wrapper launch, by
    window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import make_requests

    for r in make_requests(SLOTS, vocab=cfg.vocab_size, prompt_min=PROMPT_MIN,
                           prompt_max=PROMPT_MAX, max_new=rounds + 4, seed=SEED + 1,
                           prefix="profile"):
        srv.submit(r)
    windows = []
    for n_rounds in (1, rounds):
        before = {k: w.launches for k, w in wrappers.items()}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for _ in range(n_rounds):
                srv.step_rounds()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        windows.append((prof, wall, n_rounds,
                        {k: w.launches - before[k] for k, w in wrappers.items()}))
    srv.serve()

    path_ms = {}
    for label, (prof, wall, n, calls) in zip(("admission round", "decode rounds"), windows):
        acts = cuda_activity(prof)
        dev_us = {}
        for e in acts:
            dev_us[e.key] = dev_us.get(e.key, 0.0) + e.self_device_time_total
        busy = sum(dev_us.values()) / 1e6
        log(f"profile, {label} ({n} round(s), {SLOTS} slots busy): wall "
            f"{1e3 * wall / n:.3f} ms/round, device busy {1e3 * busy / n:.3f} ms/round "
            f"(idle share {1 - busy / wall:.3f}), "
            f"{sum(e.count for e in acts) / n:.0f} device activities/round")
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
        log(f"profile, {label}, device ms/round by kernel: " + json.dumps(
            [[k[:70], round(v / 1e3 / n, 4)] for k, v in top]))
        n_kernels = {}
        for e in acts:
            n_kernels[e.key] = n_kernels.get(e.key, 0) + e.count
        for name in wrappers:
            us = sum(v for k, v in dev_us.items() if any(p in k for p in KERNEL_NAMES[name]))
            kernels = sum(c for k, c in n_kernels.items()
                          if any(p in k for p in KERNEL_NAMES[name]))
            # each decode-attention call is one launch: the profiler may
            # deliver fewer activities than were launched (seen on the H100:
            # 111 of 112), never more
            if name == "decode_attention" and not 0 < kernels <= calls[name]:
                fail(f"{label}: {calls[name]} decode_attention calls ran {kernels} kernels; "
                     "each call must be one launch")
            if name == "decode_attention" and kernels < calls[name]:
                log(f"profile, {label}: the profiler delivered {kernels} of "
                    f"{calls[name]} decode_attention activities")
            if calls[name]:
                path_ms.setdefault(name, {})[label] = us / 1e3 / calls[name]
                log(f"profile, {label}: {name} {calls[name]} launches, device "
                    f"{us / 1e3 / calls[name]:.5f} ms per launch")
    return path_ms


def _items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------


REPLACES = {
    "rmsnorm": ("cuda", "src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm/kernel.py:25"),
    "flash_attention": ("cuda", "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:70"),
    "decode_attention": ("cuda", "src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:61"),
    "ragged_concat": ("cuda", "src/repro_torch/csrc/ragged_concat.cu",
                      "src/repro/kernels/ragged_concat/kernel.py:42"),
    "slstm_scan": ("cuda", "src/repro_torch/csrc/slstm_scan.cu",
                   "src/repro/kernels/slstm_scan/kernel.py:88"),
}


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"{ROOT / 'src' / 'repro_torch'} not found: run from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))       # the attention kernels' edge cases
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # phase 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    print(card, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")

    # phase 2
    from repro_torch.kernels import _build

    t0 = time.monotonic()
    secs = _build.build()
    log(f"built {sorted(secs)} in {time.monotonic() - t0:.1f} s (per source: "
        + ", ".join(f"{n} {s:.1f} s" for n, s in sorted(secs.items())) + ")")
    ptxas = ptxas_by_kernel(list(secs))
    spilled = [k for k, _, spill in ptxas.get("rmsnorm", ())
               if re.search(r"[1-9]\d* bytes spill", spill)]
    if not ptxas.get("rmsnorm") or spilled:
        fail(f"rmsnorm: no ptxas report, or instantiations that spill: {spilled}")
    hmma = sass_counts("flash_attention", "HMMA")
    for fn, count in hmma.items():
        log(f"SASS flash_attention {fn}: {count} HMMA")
    mma_kernels = {fn: c for fn, c in hmma.items() if "flash_fwd_mma" in fn}
    if not mma_kernels or not all(mma_kernels.values()):
        fail(f"the bf16 flash-attention kernels have no tensor-core instructions: {hmma}")

    t0 = time.monotonic()
    report = phase_kernels(dev)
    log(f"phase 3 (kernels vs plain) done in {time.monotonic() - t0:.1f} s")
    launches, path_ms = {}, {}
    for n, (what, fn, arch) in enumerate((("f32 model", phase_model_f32, "qwen2-1.5b"),
                                          ("bf16 serving", phase_serve_bf16, "qwen2-1.5b"),
                                          ("f32 model", phase_model_f32, "xlstm-1.3b"),
                                          ("bf16 serving", phase_serve_bf16, "xlstm-1.3b")),
                                         start=4):
        t0 = time.monotonic()
        out = fn(dev, arch)
        if out is not None:
            launches[arch], path_ms[arch] = out
        log(f"phase {n} ({what}, {arch}) done in {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    launches[f"fleet {FLEET_ARCH}"] = phase_fleet(dev)
    log(f"phase 8 (serving fleet, {FLEET_ARCH}) done in {time.monotonic() - t0:.1f} s")

    kernels = []
    for name, (route, source, replaces) in REPLACES.items():
        r = report[name]
        by_path = {a: c[name] for a, c in launches.items() if name in c}
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": sum(by_path.values()), "launches_by_path": by_path,
                        "on_path": bool(by_path),
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": r["shape"], "wall_ms": r["wall_ms"],
                        "host_ms": r["host_ms"],
                        "path_device_ms_per_launch": {a: p[name] for a, p in path_ms.items()
                                                      if name in p},
                        **{k: r[k] for k in ("by_seq", "shapes", "variant", "cluster",
                                             "torch_add_host_ms")
                           if k in r}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
