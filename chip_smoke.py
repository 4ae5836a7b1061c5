#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # from the root of a checkout, on a machine with one GPU

Drives the port's main path (the serving plane's model step) on the GPU,
never the JAX reference package, in five phases; any failed phase exits
non-zero before the final line:

1. the card's name and power limit, and the torch/CUDA versions;
2. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all started together) and report the build time;
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes plus ragged ones, in f32 and bf16, and time kernel,
   plain version and the nearest PyTorch library call;
4. full-width qwen2-1.5b in f32: kernel path against plain path on the same
   random weights, prefill logits of 4 ragged prompts and 4 decode steps
   with the 4 slots at their ragged lengths;
5. full-width qwen2-1.5b in bf16: serve unsized requests through
   ``repro_torch.runtime.server.InferenceServer``, with every kernel's
   launch counter set to 0 just before and read just after.

It prints a ``{"kernels": [...]}`` line and ends with one JSON line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or run from a
directory without ``src/repro_torch``, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): the least-time bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # bf16 tensor cores; f32 CUDA cores
TOL = {"float32": 3e-5, "bfloat16": 2e-2}              # tests/test_kernels.py:17-18

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


def cuda_activity(prof) -> list:
    """The profiler's device-side entries (kernels, copies, memsets)."""
    return [e for e in prof.key_averages() if e.device_type.name == "CUDA"]


def device_ms(fn, iters: int = 20, warm: int = 3) -> float:
    """Device time per call: all the CUDA activity ``torch.profiler`` records
    over ``iters`` calls, divided by ``iters``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in cuda_activity(prof)) / 1e3 / iters


def timings(kernel, plain, library) -> dict:
    return {"ms": device_ms(kernel), "plain_ms": device_ms(plain),
            "library_ms": device_ms(library), "wall_ms": cuda_ms(kernel)}


def log_timings(what: str, t: dict, library: str) -> None:
    log(f"{what}: device ms per call: kernel {t['ms']:.5f}, plain {t['plain_ms']:.5f}, "
        f"{library} {t['library_ms']:.5f}, bound {t['bound_ms']:.5f} ({t['bound_by']}); "
        f"kernel wall per back-to-back call {t['wall_ms']:.5f} ms")


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (1e3 * max(tb, tf), "bytes" if tb >= tf else "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def check_close(name: str, got, ref, dtype: str) -> float:
    import torch

    tol = TOL[dtype]
    if got.shape != ref.shape:
        fail(f"{name}: shape {tuple(got.shape)} != plain {tuple(ref.shape)}")
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite output")
    if not torch.allclose(got.float(), ref.float(), atol=tol, rtol=tol):
        fail(f"{name}: max |kernel - plain| {max_err(got, ref):.3e} beyond atol=rtol={tol}")
    return max_err(got, ref)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_kernels(dev) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention.ops import decode_attention, decode_attention_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_ref
    from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm, rmsnorm_ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rnd = lambda *shape, dt: torch.randn(shape, generator=gen, device=dev).to(dt)  # noqa: E731
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    report = {}

    # K1 fused residual-add + RMSNorm: decode (4 slots), prefill (16..384 rows), ragged
    d = 1536
    errs = {}
    for dname, dt in dts.items():
        for rows in (4, 384, 16, 1, 37):
            x, r = rnd(rows, d, dt=dt), rnd(rows, d, dt=dt)
            sc = torch.randn(d, generator=gen, device=dev)
            y, h = fused_rmsnorm(x, r, sc, eps=1e-6)
            yr, hr = rmsnorm_ref(x, r, sc, eps=1e-6)
            e = max(check_close(f"rmsnorm {dname} R={rows} y", y, yr, dname),
                    check_close(f"rmsnorm {dname} R={rows} h", h, hr, dname))
            errs[(dname, rows)] = e
            log(f"rmsnorm {dname} R={rows} D={d}: max_abs_err {e:.3e}")
    times = {}
    for rows in (4, 384):
        x, r = rnd(rows, d, dt=torch.bfloat16), rnd(rows, d, dt=torch.bfloat16)
        sc = torch.randn(d, generator=gen, device=dev)
        hsum = (x.float() + r.float()).to(torch.bfloat16)
        sc16 = sc.to(torch.bfloat16)
        t = timings(lambda: fused_rmsnorm(x, r, sc, eps=1e-6),
                    lambda: rmsnorm_ref(x, r, sc, eps=1e-6),
                    # the norm alone on the pre-added input: PyTorch has no add+norm call
                    lambda: F.rms_norm(hsum, (d,), sc16, 1e-6))
        t["bound_ms"], t["bound_by"] = bound_ms(4 * rows * d * 2 + d * 4, 6 * rows * d,
                                                "bfloat16")
        times[rows] = t
        log_timings(f"rmsnorm bf16 R={rows}", t, "F.rms_norm")
    report["rmsnorm"] = {"max_abs_err": errs[("bfloat16", 4)], "shape": "R=4 D=1536 bf16",
                         **times[4], "prefill_R384": times[384]}

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
    b, h, kv, s, hd = 1, 12, 2, 384, 128
    q, k, v = qkv(b, h, kv, s, s, hd, torch.bfloat16)
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    t = timings(lambda: flash_attention(q, k, v, causal=True),
                lambda: flash_attention_ref(q, k, v, causal=True),
                lambda: F.scaled_dot_product_attention(qc, kc, vc, is_causal=True,
                                                       enable_gqa=True))
    nbytes = 2 * (2 * b * s * h * hd + 2 * b * s * kv * hd)
    flops = 4 * hd * h * b * (s * (s + 1) // 2)
    t["bound_ms"], t["bound_by"] = bound_ms(nbytes, flops, "bfloat16")
    log_timings("flash_attention bf16 B=1 H=12 KV=2 S=384 hd=128", t, "SDPA")
    report["flash_attention"] = {"max_abs_err": errs[("bfloat16", cases[0])],
                                 "shape": "B=1 H=12 KV=2 Sq=Sk=384 hd=128 causal bf16", **t}

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
    return report


# ---------------------------------------------------------------------------
# phase 4: full-width f32 model, kernel path vs plain path
# ---------------------------------------------------------------------------


def phase_model_f32(dev) -> None:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config("qwen2-1.5b").scaled(param_dtype="float32", compute_dtype="float32")
    fast, plain = Model(cfg, device=dev), Model(cfg, device=dev, plain=True)
    params = fast.init(SEED)
    rng = np.random.default_rng(SEED)

    def cmp(what, a, b):
        if not torch.isfinite(a).all():
            fail(f"f32 model {what}: non-finite logits")
        scale = float(b.abs().max())
        err = max_err(a, b)
        agree = bool((a[:, -1].argmax(-1) == b[:, -1].argmax(-1)).all())
        log(f"f32 qwen2-1.5b {what}: max_abs_err {err:.3e} (logit scale {scale:.3e}, "
            f"rel {err / scale:.3e}, bound {MODEL_F32_REL_TOL}), argmax agree {agree}")
        if err > MODEL_F32_REL_TOL * scale:
            fail(f"f32 model {what}: kernel path differs from plain path by {err:.3e}")

    # four slots with ragged prompts, laid out as the server lays them out
    lens = [200, 37, 311, 5]
    ck, cp = fast.init_cache(len(lens), MAX_SEQ), plain.init_cache(len(lens), MAX_SEQ)
    first = []
    for slot, n in enumerate(lens):
        tt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n)), device=dev)
        lk, k1 = fast.prefill(params, {"tokens": tt})
        lp, p1 = plain.prefill(params, {"tokens": tt})
        cmp(f"prefill S={n}", lk, lp)
        for cache, one in ((ck, k1), (cp, p1)):
            cache["k"][:, slot, :n] = one["k"][:, 0]
            cache["v"][:, slot, :n] = one["v"][:, 0]
            cache["len"][slot] = n
        first.append(lp[0, -1].argmax())
    nxt = torch.stack(first)[:, None]
    for i in range(4):
        lk, ck = fast.decode_step(params, ck, nxt)
        lp, cp = plain.decode_step(params, cp, nxt)
        cmp(f"decode step {i + 1}, 4 slots at lengths {[n + i for n in lens]}", lk, lp)
        nxt = lp[:, -1].argmax(-1, keepdim=True)
    want = [n + 4 for n in lens]
    if ck["len"].tolist() != want or cp["len"].tolist() != want:
        fail(f"f32 model: cache len {ck['len'].tolist()} / {cp['len'].tolist()}, "
             f"expected {want}")
    del params, ck, cp, lk, lp
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: full-width bf16 serving through InferenceServer
# ---------------------------------------------------------------------------


def phase_serve_bf16(dev) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm
    from repro_torch.launch.serve import make_requests, run, warmup
    from repro_torch.models import Model
    from repro_torch.runtime.server import InferenceServer

    wrappers = {"rmsnorm": fused_rmsnorm, "flash_attention": flash_attention,
                "decode_attention": decode_attention}
    cfg = get_config("qwen2-1.5b")
    model = Model(cfg, device=dev)
    params = model.init(SEED)
    n_params = sum(t.numel() for t in _leaves(params))
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"bf16 qwen2-1.5b: {n_params / 1e9:.3f} B parameters, {weight_bytes / 1e9:.3f} GB")

    def serve(m):
        srv = InferenceServer(m, slots=SLOTS, max_seq=MAX_SEQ, page_tokens=PAGE_TOKENS)
        srv.load(params)
        warmup(srv, cfg.vocab_size, PROMPT_MAX)
        return srv

    def requests(prefix):
        return make_requests(N_REQUESTS, vocab=cfg.vocab_size, prompt_min=PROMPT_MIN,
                             prompt_max=PROMPT_MAX, max_new=MAX_NEW, seed=SEED, prefix=prefix)

    srv = serve(model)
    for w in wrappers.values():
        w.launches = 0
    out = run(srv, requests("req"))
    launches = {name: w.launches for name, w in wrappers.items()}
    torch.cuda.synchronize()
    if out["completed"] != N_REQUESTS:
        fail(f"served {out['completed']}/{N_REQUESTS} requests")
    if not out["pool_clean"]:
        fail(f"KV page pool not clean after serving: {srv.stats()}")
    for r in out["results"].values():
        if len(r.tokens) != MAX_NEW or not all(0 <= t < cfg.vocab_size for t in r.tokens):
            fail(f"request {r.rid}: bad tokens {r.tokens}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was launched {n} times on the main path")
    log(f"launches on the main path (counters zeroed just before): {launches}")
    bound_step = 1e3 * weight_bytes / HBM_BYTES_PER_S
    log(f"decode-step weight-read bound {bound_step:.3f} ms ({weight_bytes / 1e9:.3f} GB / "
        f"3.35 TB/s)")
    again = run(srv, requests("again"))      # the same prompts again: run-to-run spread
    for i, o in enumerate((out, again)):
        log(f"serve run {i + 1}: {o['completed']} requests, prompts {PROMPT_MIN}-{PROMPT_MAX} "
            f"tokens, max_new {MAX_NEW}, slots {SLOTS}: {o['generated_tokens']} tokens in "
            f"{o['wall_s']:.3f} s = {o['tokens_per_s']:.2f} tok/s; decode step "
            f"{o['decode_step_ms']:.3f} ms over {o['decode_steps']} rounds; peak device memory "
            f"{o['peak_mem_gib']} GiB; pool clean {o['pool_clean']}")
        log(f"serve run {i + 1}: TTFT ms by prompt length: "
            + json.dumps([[n, round(ms, 3)] for n, ms in o["ttft_ms"]]))
    if not again["pool_clean"] or again["completed"] != N_REQUESTS:
        fail("second serve run did not complete cleanly")

    path_ms = profile_rounds(srv, cfg, wrappers)

    plain_srv = serve(Model(cfg, device=dev, plain=True))
    plain_out = run(plain_srv, requests("req"))
    same_seq = same_tok = total = 0
    for rid, r in out["results"].items():
        p = plain_out["results"][rid].tokens
        same_seq += r.tokens == p
        same_tok += sum(a == b for a, b in zip(r.tokens, p))
        total += len(r.tokens)
    log(f"bf16 greedy agreement with the plain path (information): {same_seq}/{N_REQUESTS} "
        f"identical sequences, {same_tok}/{total} tokens; plain path "
        f"{plain_out['tokens_per_s']:.2f} tok/s, decode step {plain_out['decode_step_ms']:.3f} ms")
    return launches, path_ms


# the CUDA kernels each wrapper launches, by name as the profiler shows them
KERNEL_NAMES = {"rmsnorm": ("rmsnorm_fwd",), "flash_attention": ("flash_fwd",),
                "decode_attention": ("decode_partial", "decode_combine")}


def profile_rounds(srv, cfg, wrappers: dict, rounds: int = 4) -> dict:
    """Where the time goes, from ``torch.profiler``: one admission round
    (``SLOTS`` prefills and a decode round) and then ``rounds`` decode rounds
    with every slot busy.  Runs after the measured serving runs, so it costs
    them nothing.  Returns each kernel's device ms per wrapper launch."""
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
        for name, pats in KERNEL_NAMES.items():
            us = sum(v for k, v in dev_us.items() if any(p in k for p in pats))
            if calls[name]:
                path_ms.setdefault(name, us / 1e3 / calls[name])
                log(f"profile, {label}: {name} {calls[name]} launches, device "
                    f"{us / 1e3 / calls[name]:.5f} ms per launch")
    return path_ms


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
    "rmsnorm": ("triton", "src/repro_torch/kernels/rmsnorm/kernel.py",
                "src/repro/kernels/rmsnorm/kernel.py:25"),
    "flash_attention": ("cuda", "src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:70"),
    "decode_attention": ("cuda", "src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:61"),
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
    for n in secs:
        for line in _build.ptxas_report(n).splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {n}: {line.strip()}")

    t0 = time.monotonic()
    report = phase_kernels(dev)
    log(f"phase 3 (kernels vs plain) done in {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    phase_model_f32(dev)
    log(f"phase 4 (f32 model) done in {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    launches, path_ms = phase_serve_bf16(dev)
    log(f"phase 5 (bf16 serving) done in {time.monotonic() - t0:.1f} s")

    kernels = []
    for name, (route, source, replaces) in REPLACES.items():
        r = report[name]
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": r["shape"], "wall_ms": r["wall_ms"],
                        "path_device_ms_per_launch": path_ms.get(name)})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
