#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # from the root of a checkout, on a machine with one GPU

Drives the port's main paths (the serving plane's model step, for the
dense, xLSTM, MoE and Zamba2 families; ``Model.prefill`` and
``decode_step`` for Whisper and mLLaMA, whose prefill takes frames or a
vision input that no request carries; training through ``Trainer``,
``Model.loss`` and the backward kernels) on the GPU, never the JAX
reference package, in thirty-two phases; any failed phase exits
non-zero before the final line:

1. the card's name and power limit, and the torch/CUDA versions;
2. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all started together), report the build time and each kernel's
   registers, shared memory and spills (the fused norm's instantiations,
   and the head-dim-256 ones of flash and decode attention, must spill
   nothing), and count the tensor-core instructions (``HMMA``) in the
   built flash-attention library: the bf16 kernels must have some,
   ``flash_fwd_mma<256>`` included, and so must K2-bwd's tensor-core
   kernels (``bwd_dkdv_mma`` and ``bwd_dq_mma`` at hd 64, 80 and 128,
   counted in the built backward library); the decode-attention instantiations
   that G = 16 runs (``decode_fwd<T, 128, 8, 2>``) must spill nothing, and
   so must every head-dim-80 instantiation of both, ``flash_fwd_mma<80>``
   holding ``HMMA``;
3. hold each kernel (K1-K5) against its plain PyTorch version on the card
   at the main paths' shapes plus ragged ones and the attention kernels'
   tile and split edges, in f32 and bf16 (K1 in every mode the models call:
   with and without the residual add, Gemma's ``1 + scale``, with and
   without the residual output, on strided and unaligned rows, up to
   mLLaMA's D = 8192, the kernel's widest), and time
   kernel, plain version and the nearest PyTorch library call (flash
   attention at S = 16, 100, 384 and 1024), and each wrapper's host time
   per call (K1's beside one ``torch.add``); K2 and K3 also at head dim
   256 with G = 8 over KV = 1 (gemma-2b) and at head dim 128 with G = 16
   over KV = 4 (qwen3-moe: K3 as two row groups) and at head dim 80 with
   G = 1 over KV = 32 (zamba2-2.7b): the tile and split edges, prefill
   S = 16, 100 and 384, decode over 4 slots; K2 non-causal with Sq != Sk
   and K3 over a whole fixed-length K/V at the cross-attention families'
   shapes (whisper-small: B = 4, 12 heads over 12 at hd 64, the encoder's
   Sq = Sk = 1500, cross-attention from 100 and 384 tokens to 1500 frames,
   K3 over 1500 in 3 splits; llama-3.2-vision-90b: 64 heads over 8 at hd
   128 from 100 and 384 tokens to 4096 vision tokens, K3 over 4096 in 5
   splits), each beside SDPA and its bound; K1 on
   qk_norm's rows of 128 beside ``F.rms_norm``; the K4 and K5 windows are
   also printed by kernel name,
   K4 must be one kernel per call, and K5 is timed at the admission
   path's S = 16, 100 and 384, at decode's B = 4 S = 1 warm and with L2
   flushed, and beside its serial floor (S rounds of the cluster's h
   exchange and barrier alone, or of the grid barrier for the f32 grid
   kernel); then the backward kernels, K1-bwd in every forward mode at D =
   48-8192 (512, the 100m reductions' width, included) and R = 1-8192
   (each call repeated bit for bit) and K2-bwd through its autograd
   Function at the tile edges (causal or not, hd 64, 80, 128 and 256, G
   1-16), the cross shapes (Sq != Sk) and the training paths' shapes
   (``TRAIN_FLASH``), K2's forward at each of them also with its
   logsumexp output (the output the same bit for bit, the logsumexp that
   of the scaled scores), each timed beside its bound and the library's
   backward (autograd through ``F.rms_norm``; through SDPA) at the
   training path's shapes; then K5 in save mode (hs and the final state
   the same bit for bit as without it, the saved gates those formed from
   hs) and K5-bwd against its plain backward (``slstm_scan_bwd_ref``) on
   the kernel's own saved gates and states, in f32 and bf16, at D 2048 H 4
   (xlstm-1.3b) and D 512 H 8 (its 100m reduction), B 1-8 and S 1-1024,
   from the zero state (m0 = -inf) and from a random one, with cotangents
   on hs and on the final state, each call repeated bit for bit (20 times
   at the training shape), the kernel each shape ran (cluster or grid)
   logged, timed at the training shapes beside its bound, the plain
   backward (no library call computes it) and its exchange alone;
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
   after its prewarm, so they count the fleet's requests only); each run
   also rebuilds every request's serving flow from its trace rings
   (``repro_torch.obs.flows``) and passes the fleet's flow gates
   (``fleet.flow_failures``: one complete, monotonic flow a request with
   no negative stage, the mean stage sum within 10% of the head's own
   submit-to-complete time; with a replica killed, one complete flow a
   request and truncated ones only for replayed requests), and logs each
   stage's p50/p99 ms (head enqueue to flush, flush to the replica's
   enqueue, replica enqueue to first chunk, the stream);
9-14. full-width gemma-2b, llama3-8b and qwen3-8b, each in f32 (kernel
   path against plain path, as in 4) and in bf16 (served as in 5: 37, 65
   and 145 fused norms a call, qwen3's qk_norm included);
15. the MoE layer at qwen2-moe-a2.7b's width on 1024 tokens: the capacity
   path with nothing dropped against the dropless path in f32, the pairs
   the config's capacity drops, and each path's device and host ms beside
   its bound, in f32 and bf16;
16-19. full-width qwen2-moe-a2.7b (24 layers) and qwen3-moe-235b-a22b at
   full width cut to 4 of its 94 layers, each in f32 (as in 4, under the
   route rule: a route that differs between the paths must be a near tie,
   and at most one call may be exempted for it) and in bf16 (served as in
   5: 49 and 17 fused norms a call; the decode rounds' routed experts and
   the bound they give);
20. full-width zamba2-2.7b in f32: kernel path against plain path, as in
   4 (its 311-token prompt spans a chunk and a padded one), then the
   parallel prefill's Mamba states and next-step logits against the
   sequential replay of a 300-token prompt;
21. full-width zamba2-2.7b in bf16, served as in 5: 127 fused norms a
   call, one flash-attention launch a prefill and one decode-attention
   launch a decode step per invocation of the shared block (9 each), and
   the decode round's bytes bound with the shared block's weights read at
   each of its 9 invocations;
22. full-width whisper-small in f32 through ``Model``: kernel path against
   plain path on the same weights, two batches of 4 prompts (100 and 311
   tokens) with their own frames, prefill logits and cross K/V, then 4
   decode steps; then prefill of n tokens plus one decode step against
   prefill of n + 1;
23. full-width whisper-small in bf16: 8 requests in two batches of 4
   (prompt lengths from the seed in 16-384, frames of their own, 32 new
   tokens), exactly 36 flash-attention launches a prefill (12 encoder,
   12 self, 12 cross), 24 decode-attention launches a decode step (12
   self, 12 cross) and no fused norm; TTFT, step ms, tok/s and memory; a
   profile of one prefill and 4 decode steps (each decode-attention call
   one kernel) beside the step's bytes bound;
24-25. llama-3.2-vision-90b at full width cut to 10 of its 100 layers (2
   groups of [4 self + 1 cross]), every cross layer's gates set to 0.7 and
   -0.5 first (zero at init, where the cross path adds nothing), as in 22
   (f32) and 23 (bf16, 4096 vision tokens a request): 21 fused norms a
   call, 10 flash-attention launches a prefill (8 self, 2 cross), 10
   decode-attention launches a step; 23 and 25 also print one batch's
   bf16 prefill logits on the kernel path beside the plain path's;
26. training in f32 (B 2, S 256, remat ``block``), full-width qwen2-1.5b
   (28 layers) and then full-width xlstm-1.3b (48 blocks, K5 and K5-bwd
   in each of its 6 sLSTM blocks): ``Model.loss`` and every gradient leaf
   on the kernel path against ``plain=True``, the max relative error per
   leaf group, and the launches remat implies (qwen2: K1 4L + 1, K1-bwd
   2L + 1, K2 2L, K2-bwd L; xlstm: K1 2L + 6 + 1 and each mLSTM block's two
   again, K1-bwd 2L + 6 + 1, K5 and K5-bwd 6);
27. training: full-width qwen2-1.5b in bf16 with f32 master weights and
   moments through ``repro_torch.runtime.trainer.Trainer`` over the
   zero-copy data plane, B 8 x S 1024, 8 steps with a checkpoint at step
   4; a second ``Trainer`` on the same directory resumes at step 5 and its
   losses for steps 5-8 must equal the uninterrupted run's (within
   ``RESUME_LOSS_TOL``), while each of four restore faults planted in
   further resumes (moments zeroed, master weights rebuilt from the bf16
   params, the optimizer's step or the data cursor one ahead) must move
   them beyond it; the losses must be finite and fall; prints the step
   ms, tokens/s, the model-FLOP share (from ``param_count`` and from the
   step's FLOPs as the dry run counts them on ``meta``), peak device
   memory beside the count's peak of live storages, and the losses
   at steps 1 and 8, and one step's device time by kernel group; then full-width xlstm-1.3b in bf16 the
   same way (``XLSTM_TRAIN_BS``, ``XLSTM_TRAIN_STEPS`` steps, no
   checkpoint): K5 and K5-bwd launched once per sLSTM block every step,
   the losses finite and falling, and the same measurements with K5 and
   K5-bwd named in the step's device time;
28. training: the 100m reductions of qwen2-1.5b, qwen2-moe-a2.7b,
   zamba2-2.7b, whisper-small, llama-3.2-vision-90b (head dim 64) and
   xlstm-1.3b (d 512 over 8 heads) in bf16, 3 steps each, kernel path
   against plain path at step 1, every kernel of the family's step
   launched;
29. every dtype, shape, stride and mode K1-bwd, K2-bwd and K5-bwd ran on
   in phases 26-28 (recorded as they ran), again on unit-scale random
   inputs of that layout against the plain backward, K2's forward with
   its logsumexp output as in phase 3;
30. the step builders of ``repro_torch.launch.steps`` on full-width
   qwen2-1.5b and xlstm-1.3b in bf16 (4 prompts of 384 tokens, then 8
   greedy steps): each greedy token equal to ``Model(..., plain=True)``'s
   but at a near tie of the plain logits, the path's kernels launched;
   the cost count (``repro_torch.launch.cost_analysis``) of qwen2-1.5b's
   prefill step, its decode step over filled caches and its train step
   (B 8 x S 1024) and of xlstm-1.3b's prefill (B 1 x S 384) on the card,
   each equal to the count on ``meta`` in FLOPs and bytes; then the dry
   run's whole grid (``python -m repro_torch.launch.dryrun --all``,
   started in a child process after phase 2, on the host's CPU): no cell
   ``error``, skipped cells for the reference's reason, its roofline
   table and wall time;
31. the mesh at world size 1, on one ``nccl`` process group of one rank
   (a ``HashStore``, destroyed at the end): full-width qwen2-moe-a2.7b in
   bf16 on mesh (1, 1) ``("data", "model")`` under ``decode_rules``, the
   8 requests' prefills and 31 greedy steps through the step builders
   and ``_moe_serving``, bit for bit equal to the same steps without a
   mesh (tokens, logits, every cache leaf), with ``_moe_serving``'s calls
   (wrapped here), its all-gathers and psums and K1-K3 counted; full-width
   qwen2-1.5b in bf16 (B 8 x S 1024) through
   ``make_hierarchical_train_step`` on mesh (1, 1, 1) ``("pod", "data",
   "model")``, uncompressed bit for bit equal to ``make_train_step`` over 3
   steps, compressed (int8 error feedback) within ``EF_GAP_FRAC`` of the
   uncompressed run's fall over 5, each mode's step ms and peak memory;
   ``Trainer`` on mesh (1, 1) (qwen2-1.5b's 100m reduction, bf16) equal to
   the run without one, and its resume from a checkpoint saved without a
   mesh, restored through the state's shardings, within
   ``RESUME_LOSS_TOL``.

32. the cross-host planes (``repro_torch.core.{transport,routing}``) on
   the card's host, one process, no kernel: two port ``Domain``s (each its
   own registry and arenas, standing in for two hosts), a port ``Router``
   each on one port ``Bus``; (a) 30 ``POINT_CLOUD2`` messages at each of
   4 KiB, 64 KiB, 1 MiB and 16 MiB (``benchmarks/fig14_routing.py``'s
   ``PLANE_SIZES``) on each data plane (``serialized``, ``parts``,
   ``attach`` in ``copy`` and ``ref`` mode), each delivered exactly once
   with its bytes, no attach send falling back; publish-to-delivery
   p50/p99 per plane and size and fig14's two shape ratios, logged, not
   gated; (b) ``benchmarks/fig16_crosshost.py``'s churn on the attach
   plane (40 messages of 64 KiB, two receiver-bridge kills and one
   sender-bridge kill): lost 0, duplicates 0, every recovery in the bridge
   counters; (c) three domains in a cycle of buses: each message once per
   domain, none back in its origin; (d) (a)'s traced message flows,
   rebuilt by ``FlowAggregator`` across the bridge hop (a ``bridge_out`` in
   the sender's rings, a ``bridge_in`` in the receiver's), each hop's
   latency logged.

It prints a ``{"kernels": [...]}`` line (the backward kernels with
``"role": "backward"``) and ends with one JSON line
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
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.monotonic()

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


# device_breakdown's one entry when torch.profiler delivered no activity
EVENTS_KEY = "(whole call between CUDA events: the profiler delivered no activity)"


# cycles of the spin kernel that holds the stream in event_ms: about 0.1 s
# of the H100's clock, time for the host to queue the timed calls
HOLD_CYCLES = 200_000_000


def event_ms(fn, iters: int, flush=None) -> float:
    """Device time per call between CUDA events recorded just before and
    just after each call (after ``flush``, which stays outside).  A spin
    kernel holds the stream while the host queues the calls, so the device
    runs them back to back and no launch gap of the host falls inside a
    pair (a call that waits for the device, as a copy to the host does,
    lets the gaps back in)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def device_breakdown(fn, iters: int = 20, warm: int = 3, tries: int = 5,
                     flush=None) -> dict:
    """{kernel name: [device ms per call, launches per call]} from the CUDA
    activity ``torch.profiler`` records over ``iters`` calls.  ``flush``
    (e.g. a write of a buffer larger than L2) runs before each call; its
    activity, which it must launch as a fill, is left out.  The profiler
    can deliver fewer activities than were launched (seen on the H100: 14
    of 20 calls of a 5 us kernel), so a name's ms per call is its mean time
    per activity times its launches per call, rounded to a whole number (at
    least 1).  It can also deliver none at all for a window (seen on the
    H100: up to 3 windows in a row of a few us kernels), so such a window is
    profiled again with twice the calls; after ``tries`` such windows the
    call is timed between CUDA events instead (:func:`event_ms`), as the one
    entry ``EVENTS_KEY``, whose launches per call are unknown (None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    n_calls = iters
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n_calls):
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
                per_call = max(1, round(n / n_calls))
                by[k] = [us / 1e3 / n * per_call, per_call]
            return by
        log(f"profiler window of {n_calls} calls held no device activity; profiling again")
        n_calls *= 2
    log(f"torch.profiler recorded no device activity in {tries} windows; "
        "timing the call between CUDA events")
    return {EVENTS_KEY: [event_ms(fn, iters, flush), None]}


def device_ms(fn, iters: int = 20, warm: int = 3, tries: int = 5) -> float:
    """Device time per call (see :func:`device_breakdown`)."""
    return sum(ms for ms, _ in device_breakdown(fn, iters, warm, tries).values())


def log_breakdown(what: str, by: dict) -> None:
    log(f"{what}: device ms per call by kernel: "
        + "; ".join(f"{k[:80]} {ms:.5f} x{n if n is not None else '?'}" for k, (ms, n) in
                    sorted(by.items(), key=lambda kv: -kv[1][0])))


def timings(kernel, plain, library, *, plain_iters: int = 20, what: str | None = None,
            host_iters: int = 100) -> dict:
    """Device ms per call of the kernel, its plain version and the library
    call (None where there is none); ``plain_iters`` cuts the profiled
    calls of a plain version that issues thousands of launches per call,
    ``host_iters`` the back-to-back calls of the host timing (a kernel of
    milliseconds needs few).
    With ``what``, the kernel's window is logged by kernel name, and
    ``kernels_per_call`` counts its device activities per call (None where
    the profiler delivered none).  ``event_ms`` is the kernel's time per
    call between CUDA events, the fallback's timer, beside the profiler's."""
    by = device_breakdown(kernel)
    if what:
        log_breakdown(what, by)
    return {"ms": sum(ms for ms, _ in by.values()),
            "kernels_per_call": None if EVENTS_KEY in by else sum(n for _, n in by.values()),
            "plain_ms": device_ms(plain, iters=plain_iters, warm=1),
            "library_ms": None if library is None else device_ms(library),
            "wall_ms": cuda_ms(kernel), "host_ms": host_ms(kernel, iters=host_iters),
            "event_ms": event_ms(kernel, 20)}


def log_timings(what: str, t: dict, library: str | None) -> None:
    lib = f"{library} {t['library_ms']:.5f}" if library else "no library call"
    log(f"{what}: device ms per call: kernel {t['ms']:.5f}, plain {t['plain_ms']:.5f}, "
        f"{lib}, bound {t['bound_ms']:.5f} ({t['bound_by']}); kernel between CUDA events "
        f"{t['event_ms']:.5f}; "
        f"kernel wall per back-to-back call {t['wall_ms']:.5f} ms, host {t['host_ms']:.5f} ms")


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """The least time on the card (``repro_torch.launch.mesh.HW``: the H100
    SXM's published dense peaks, bf16 on the tensor cores, f32 on the CUDA
    cores) for ``nbytes`` moved and ``flops`` done in ``dtype``."""
    from repro_torch.launch.mesh import HW

    peak = HW.PEAK_BF16_FLOPS if dtype == "bfloat16" else HW.PEAK_F32_FLOPS
    tb, tf = nbytes / HW.HBM_BW, flops / peak
    return (1e3 * max(tb, tf), "bytes" if tb >= tf else "operations")


def cost_bound(cost: tuple, dtype: str) -> tuple[float, str]:
    """:func:`bound_ms` of a kernel's ``cost`` (FLOPs, bytes): the formula
    the dry run's count reads too."""
    return bound_ms(cost[1], cost[0], dtype)


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

    from _attention_edges import (DECODE_SHAPES, DECODE_SHAPES_GEMMA, DECODE_SHAPES_MOE,
                                  DECODE_SHAPES_ZAMBA2, GEMMA_G, GEMMA_HD, GEMMA_KV, MOE_G, MOE_HD,
                                  MOE_KV, ZAMBA_G, ZAMBA_HD, ZAMBA_KV, decode_edge_lens,
                                  flash_edge_cases, flash_edge_cases_gemma, flash_edge_cases_moe,
                                  flash_edge_cases_zamba2)

    from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                          decode_attention_cost,
                                                          decode_attention_ref)
    from repro_torch.kernels.flash_attention.ops import (flash_attention, flash_attention_cost,
                                                         flash_attention_ref)
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
        t["bound_ms"], t["bound_by"] = cost_bound(flash_attention_cost(b, h, kv, s, s, hd, 2),
                                                  "bfloat16")
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
    t["bound_ms"], t["bound_by"] = cost_bound(decode_attention_cost(b, h, kv, hd, n_valid, 2),
                                              "bfloat16")
    log_timings(f"decode_attention bf16 B=4 H=12 KV=2 S=512 hd=128 lens={lens}", t, "SDPA")
    report["decode_attention"] = {"max_abs_err": errs[("bfloat16", tuple(lens))],
                                  "shape": f"B=4 H=12 KV=2 S=512 hd=128 lens={lens} bf16", **t}
    # gemma-2b (hd 256, G = 8 over 1), qwen3-moe (hd 128, G = 16 over 4) and
    # zamba2-2.7b (hd 80, G = 1 over 32)
    for key, (g, kvn, hdn, edges, shapes, what) in {
            "hd256": (GEMMA_G, GEMMA_KV, GEMMA_HD, flash_edge_cases_gemma(), DECODE_SHAPES_GEMMA,
                      "gemma-2b"),
            "g16": (MOE_G, MOE_KV, MOE_HD, flash_edge_cases_moe(), DECODE_SHAPES_MOE,
                    "qwen3-moe-235b-a22b"),
            "hd80": (ZAMBA_G, ZAMBA_KV, ZAMBA_HD, flash_edge_cases_zamba2(),
                     DECODE_SHAPES_ZAMBA2, "zamba2-2.7b")}.items():
        flash_r, decode_r = phase_attention_shape(dev, rnd, dts, g=g, kv=kvn, hd=hdn,
                                                  flash_edges=edges, decode_shapes=shapes,
                                                  what=what)
        report["flash_attention"][key] = flash_r
        report["decode_attention"][key] = decode_r
    # whisper-small and llama-3.2-vision-90b: non-causal and cross attention
    report["flash_attention"]["cross"], report["decode_attention"]["cross"] = \
        phase_cross_shapes(dev, rnd, dts)
    report.update(phase_slstm_scan(dev, rnd, dts))
    report.update(phase_ragged_concat(dev, gen))
    report.update(phase_backward_kernels(dev, gen, rnd, dts))
    report.update(phase_slstm_bwd(dev, rnd, dts))
    return report


def phase_attention_shape(dev, rnd, dts, *, g: int, kv: int, hd: int, flash_edges: list,
                          decode_shapes: list, what: str) -> tuple[dict, dict]:
    """K2 and K3 at one served model's attention shape (G query heads over
    KV heads of ``hd``), in f32 and bf16 against their plain versions:
    every tile edge of ``flash_edges`` (causal or not) and the prefill
    path's S = 16, 100 and 384; every split edge of ``decode_shapes`` and
    decode's 4 slots at lengths 397/250/130/17 over a 512-position cache.
    Timed in bf16 beside SDPA (``enable_gqa``; with a mask for decode) and
    the bound.  Returns the bf16 timings, by shape."""
    import torch
    import torch.nn.functional as F

    from _attention_edges import decode_edge_lens

    from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                          decode_attention_cost,
                                                          decode_attention_ref,
                                                          decode_row_groups,
                                                          decode_split_plan)
    from repro_torch.kernels.flash_attention.ops import (flash_attention, flash_attention_cost,
                                                         flash_attention_ref)

    h = g * kv
    shape = f"hd={hd} G={g} KV={kv}"

    def qkv(b, sq, sk, dt):
        return (rnd(b, sq, h, hd, dt=dt).transpose(1, 2), rnd(b, sk, kv, hd, dt=dt).transpose(1, 2),
                rnd(b, sk, kv, hd, dt=dt).transpose(1, 2))

    worst = {}
    for dname, dt in dts.items():
        cases = [(sq, sk, b, c) for sq, sk, _, b, _ in flash_edges
                 for c in (True, False)] + [(s, s, 1, True) for s in (16, 100, 384)]
        for sq, sk, b, causal in cases:
            q, k, v = qkv(b, sq, sk, dt)
            e = check_close(f"flash {dname} {shape} B={b} Sq={sq} Sk={sk} "
                            f"causal={causal}", flash_attention(q, k, v, causal=causal),
                            flash_attention_ref(q, k, v, causal=causal), dname)
            worst[("flash", dname)] = max(worst.get(("flash", dname), 0.0), e)
        log(f"flash_attention {dname} {shape} ({what}): {len(cases)} cases (tile edges causal "
            f"or not, S = 16/100/384): max_abs_err {worst[('flash', dname)]:.3e}")
    flash = {}
    for s_ in (16, 100, 384):
        q, k, v = qkv(1, s_, s_, torch.bfloat16)
        qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
        t = timings(lambda: flash_attention(q, k, v, causal=True),
                    lambda: flash_attention_ref(q, k, v, causal=True),
                    lambda: F.scaled_dot_product_attention(qc, kc, vc, is_causal=True,
                                                           enable_gqa=True))
        t["bound_ms"], t["bound_by"] = cost_bound(
            flash_attention_cost(1, h, kv, s_, s_, hd, 2), "bfloat16")
        log_timings(f"flash_attention bf16 B=1 H={h} KV={kv} S={s_} hd={hd}", t, "SDPA")
        flash[f"S={s_}"] = {**{k_: v_ for k_, v_ in t.items() if k_ != "wall_ms"},
                            "max_abs_err": worst[("flash", "bfloat16")]}

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    groups = decode_row_groups(g)[0]
    path_lens = [397, 250, 130, 17]
    for dname, dt in dts.items():
        for b, kvv, s_ in decode_shapes:
            per, ns = decode_split_plan(s_, b, kvv, sms, groups)
            qd = rnd(b, 1, g * kvv, hd, dt=dt)[:, 0]
            kc4, vc4 = rnd(b, s_, kvv, hd, dt=dt), rnd(b, s_, kvv, hd, dt=dt)
            rows = decode_edge_lens(per, s_, b) + ([path_lens] if b == 4 else [])
            for lens in rows:
                lt = torch.tensor(lens, dtype=torch.int32, device=dev)
                o = decode_attention(qd, kc4.transpose(1, 2), vc4.transpose(1, 2), lt)
                e = check_close(f"decode {dname} {shape} B={b} KV={kvv} S={s_} lens={lens}",
                                o, decode_attention_ref(qd, kc4.transpose(1, 2),
                                                        vc4.transpose(1, 2), lt), dname)
                if 0 in lens and o[lt == 0].abs().max() != 0:
                    fail(f"decode {dname} {shape} lens={lens}: a length-0 row is not 0")
                worst[("decode", dname)] = max(worst.get(("decode", dname), 0.0), e)
            log(f"decode_attention {dname} {shape} B={b} KV={kvv} S={s_}: {groups} row "
                f"group(s), P={per}, {ns} split(s), {len(rows)} length rows: max_abs_err so far "
                f"{worst[('decode', dname)]:.3e}")
    b, s_ = 4, 512
    qd = rnd(b, 1, h, hd, dt=torch.bfloat16)[:, 0]
    kc4, vc4 = rnd(b, s_, kv, hd, dt=torch.bfloat16), rnd(b, s_, kv, hd, dt=torch.bfloat16)
    kt, vt = kc4.transpose(1, 2), vc4.transpose(1, 2)
    lt = torch.tensor(path_lens, dtype=torch.int32, device=dev)
    mask = (torch.arange(s_, device=dev)[None, :] < lt[:, None])[:, None, None, :]
    q4, kct, vct = qd[:, :, None], kt.contiguous(), vt.contiguous()
    t = timings(lambda: decode_attention(qd, kt, vt, lt),
                lambda: decode_attention_ref(qd, kt, vt, lt),
                lambda: F.scaled_dot_product_attention(q4, kct, vct, attn_mask=mask,
                                                       enable_gqa=True))
    n_valid = sum(path_lens)
    t["bound_ms"], t["bound_by"] = cost_bound(decode_attention_cost(b, h, kv, hd, n_valid, 2),
                                              "bfloat16")
    log_timings(f"decode_attention bf16 B=4 H={h} KV={kv} S=512 hd={hd} lens={path_lens}", t,
                "SDPA")
    decode = {k_: v_ for k_, v_ in t.items() if k_ != "wall_ms"}
    decode.update(shape=f"B=4 H={h} KV={kv} S=512 hd={hd} lens={path_lens} bf16",
                  max_abs_err=worst[("decode", "bfloat16")])
    return flash, decode


def phase_cross_shapes(dev, rnd, dts) -> tuple[dict, dict]:
    """K2 and K3 at the cross-attention families' shapes, which no earlier
    path runs (``CROSS_FLASH``, ``CROSS_DECODE`` in
    ``tests/_attention_edges.py``): K2 non-causal with Sq != Sk (whisper's
    encoder over 1500 frames, both families' prefill cross-attention over
    1500 frames or 4096 vision tokens), K3 with one query a request over the
    whole K/V (3 splits of 512 at S = 1500, 5 of 832 at 4096), in f32 and
    bf16 against their plain versions, K3 called three times in a row on
    one stream and then at its split edges (a ticket counter left non-zero
    fails).  Each timed in bf16 beside SDPA (``enable_gqa``, no mask: every
    key is valid) and its bound, with its host ms.  Returns the bf16
    timings by shape."""
    import torch
    import torch.nn.functional as F

    from _attention_edges import CROSS_DECODE, CROSS_FLASH, decode_edge_lens

    from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                          decode_attention_cost,
                                                          decode_attention_ref,
                                                          decode_row_groups,
                                                          decode_split_plan)
    from repro_torch.kernels.flash_attention.ops import (flash_attention, flash_attention_cost,
                                                         flash_attention_ref)

    flash, decode = {}, {}
    for b, h, kv, sq, sk, hd in CROSS_FLASH:
        shape = f"B={b} H={h} KV={kv} Sq={sq} Sk={sk} hd={hd} non-causal"
        errs = {}
        for dname, dt in dts.items():
            q = rnd(b, sq, h, hd, dt=dt).transpose(1, 2)
            k, v = (rnd(b, sk, kv, hd, dt=dt).transpose(1, 2) for _ in range(2))
            errs[dname] = check_close(f"flash {dname} {shape}",
                                      flash_attention(q, k, v, causal=False),
                                      flash_attention_ref(q, k, v, causal=False), dname)
        qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
        t = timings(lambda: flash_attention(q, k, v, causal=False),
                    lambda: flash_attention_ref(q, k, v, causal=False),
                    lambda: F.scaled_dot_product_attention(qc, kc, vc, enable_gqa=True),
                    plain_iters=5)
        t["bound_ms"], t["bound_by"] = cost_bound(
            flash_attention_cost(b, h, kv, sq, sk, hd, 2, causal=False), "bfloat16")
        log(f"flash_attention {shape}: max_abs_err f32 {errs['float32']:.3e}, bf16 "
            f"{errs['bfloat16']:.3e}")
        log_timings(f"flash_attention bf16 {shape}", t, "SDPA")
        flash[shape] = {**{k_: v_ for k_, v_ in t.items() if k_ != "wall_ms"},
                        "max_abs_err": errs["bfloat16"]}

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b, h, kv, s_, hd in CROSS_DECODE:
        per, ns = decode_split_plan(s_, b, kv, sms, decode_row_groups(h // kv)[0])
        shape = f"B={b} H={h} KV={kv} S={s_} hd={hd} all valid"
        errs = {}
        for dname, dt in dts.items():
            qd = rnd(b, 1, h, hd, dt=dt)[:, 0]
            kt, vt = (rnd(b, s_, kv, hd, dt=dt).transpose(1, 2) for _ in range(2))
            for lens in [[s_] * b] * 3 + decode_edge_lens(per, s_, b):
                lt = torch.tensor(lens, dtype=torch.int32, device=dev)
                e = check_close(f"decode {dname} {shape} P={per} lens={lens}",
                                decode_attention(qd, kt, vt, lt),
                                decode_attention_ref(qd, kt, vt, lt), dname)
                errs[dname] = max(errs.get(dname, 0.0), e)
        lt = torch.full((b,), s_, dtype=torch.int32, device=dev)
        q4, kct, vct = qd[:, :, None], kt.contiguous(), vt.contiguous()
        t = timings(lambda: decode_attention(qd, kt, vt, lt),
                    lambda: decode_attention_ref(qd, kt, vt, lt),
                    lambda: F.scaled_dot_product_attention(q4, kct, vct, enable_gqa=True))
        t["bound_ms"], t["bound_by"] = cost_bound(
            decode_attention_cost(b, h, kv, hd, b * s_, 2), "bfloat16")
        log(f"decode_attention {shape}: P={per}, {ns} splits; max_abs_err f32 "
            f"{errs['float32']:.3e}, bf16 {errs['bfloat16']:.3e}")
        log_timings(f"decode_attention bf16 {shape}", t, "SDPA")
        decode[shape] = {**{k_: v_ for k_, v_ in t.items() if k_ != "wall_ms"},
                         "max_abs_err": errs["bfloat16"], "splits": ns, "per_block": per}
    return flash, decode


def phase_rmsnorm(dev, gen, rnd, dts) -> dict:
    """K1 in every mode the paths call, at their widths: D = 1536 (qwen2),
    2048 (xlstm), 4096 (the mLSTM's inner norm) and 8192 (mLLaMA, the
    kernel's widest: 4 vectors a thread in bf16, 512 threads in f32), the
    smoke configs' 48 and the unaligned 52; R = 4 (decode's slots) to 384
    (prefill).  Then
    the views the model hands over: prefill's last position of (B, S, D),
    strided rows, and a view offset by one element (the scalar
    instantiation).  Timed in bf16 at D = 1536, R = 4 and 384 beside
    ``F.rms_norm`` (the norm alone on the pre-added input: PyTorch has no
    add + norm call), at D = 2048, 4096 and 8192, R = 4, and the host time of one
    call beside one ``torch.add`` of the same tensors."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm, fused_rmsnorm_cost, rmsnorm_ref

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
        for d in (1536, 2048, 4096, 8192, 48, 52):
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

    # qk_norm: the norm alone, no residual out, on rows of head_dim 128: a
    # qwen3-8b call's q (B*S*32 rows) and k (B*S*8 rows) at prefill and decode
    for dname, dt in dts.items():
        worst = 0.0
        for rows in (12288, 3072, 128, 32, 37):
            x, sc = rnd(rows, 128, dt=dt), torch.randn(128, generator=gen, device=dev)
            worst = max(worst, cmp(f"rmsnorm {dname} qk_norm R={rows} D=128",
                                   fused_rmsnorm(x, None, sc, want_residual=False),
                                   rmsnorm_ref(x, None, sc, want_residual=False), dname))
            errs[(dname, rows, 128, "qk_norm")] = worst
        log(f"rmsnorm {dname} qk_norm D=128 R=12288/3072/128/32/37: max_abs_err {worst:.3e}")
    qk_times = {}
    for rows in (12288, 128):
        x, sc = rnd(rows, 128, dt=torch.bfloat16), torch.randn(128, generator=gen, device=dev)
        sc16 = sc.to(torch.bfloat16)
        t = timings(lambda: fused_rmsnorm(x, None, sc, eps=1e-6, want_residual=False),
                    lambda: rmsnorm_ref(x, None, sc, eps=1e-6, want_residual=False),
                    lambda: F.rms_norm(x, (128,), sc16, 1e-6))
        # x read once, y written once, the f32 scale read once
        t["bound_ms"], t["bound_by"] = cost_bound(
            fused_rmsnorm_cost(rows, 128, 2, residual=False, want_residual=False), "bfloat16")
        log_timings(f"rmsnorm bf16 qk_norm R={rows} D=128 (norm alone, no residual out)", t,
                    "F.rms_norm")
        qk_times[f"qk_norm R={rows} D=128 bf16"] = {k: v for k, v in t.items() if k != "wall_ms"}

    times = {}
    for rows, d in ((4, 1536), (384, 1536), (4, 2048), (4, 4096), (4, 8192)):
        x, r = rnd(rows, d, dt=torch.bfloat16), rnd(rows, d, dt=torch.bfloat16)
        sc = torch.randn(d, generator=gen, device=dev)
        hsum = (x.float() + r.float()).to(torch.bfloat16)
        sc16 = sc.to(torch.bfloat16)
        t = timings(lambda: fused_rmsnorm(x, r, sc, eps=1e-6),
                    lambda: rmsnorm_ref(x, r, sc, eps=1e-6),
                    lambda: F.rms_norm(hsum, (d,), sc16, 1e-6))
        # x and r read once, y and h written once, the f32 scale read once
        t["bound_ms"], t["bound_by"] = cost_bound(fused_rmsnorm_cost(rows, d, 2), "bfloat16")
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
    shapes.update(qk_times)
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
                                                    slstm_scan, slstm_scan_cost,
                                                    slstm_scan_plan, slstm_scan_ref)

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
        # xg in w_hh's type; the f32 recurrent product on the CUDA cores
        return cost_bound(slstm_scan_cost(b, s, d, h, wbytes, wbytes), "float32")

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


# K5-bwd against its plain backward, both fed the kernel's own saved gates
# and states (K5 in save mode): the two run the same f32 arithmetic and
# differ in the order of the recurrent sums (dh_{t-1} sums 4 dh = 2048
# terms) and in expf/log1pf/tanhf against torch's, carried back through up
# to 1024 steps; dw_hh and db_ih sum B S terms.  Measured on the card
# (NVIDIA H100 80GB HBM3, 700 W, before the gates were saved): at most
# 3.05e-05 on db (values up to 130 at B 8 S 1024) and 2.7e-05 on dw (up to
# 35), the rest under 4e-06.  So each f32 output's max |kernel - plain| is
# held to 3e-5 of its largest value (at least 1): the repo's f32
# tolerance, relative to a tensor whose elements sum up to 8192 rows; the
# bf16 outputs (dxg and dw_hh in xg's and w_hh's dtype: one rounding of
# those f32 values, at most an ulp apart) elementwise at bf16's 2e-2.
SLSTM_BWD_TOL = 3e-5
SLSTM_BWD_NAMES = ("dxg", "dw_hh", "db_ih", "dh0", "dc0", "dn0", "dm0")
# (D, H) -> (B, S): xlstm-1.3b's width at B 1, 4, 8 and S 1, 16, 100, 384
# (the serving prompts) and 1024 (the training sequence), its 100m
# reduction's at fewer (phase 28 trains it at B 4 S 256)
SLSTM_BWD_CASES = {(2048, 4): ((1, 1), (4, 1), (8, 1), (1, 16), (4, 16), (8, 100), (1, 384),
                               (8, 384), (8, 1024)),
                   (512, 8): ((1, 1), (4, 16), (8, 100), (4, 256))}
SLSTM_BWD_REPEATS = 20           # calls at the training shape that must agree bit for bit


def slstm_inputs(rnd, dev, b, s, d, h, dt, state: bool) -> list:
    """xg, w_hh, b_ih, h0, c0, n0, m0 for the sLSTM scan: the zero state
    (m0 = -inf) or a random one."""
    import torch

    dh = d // h
    xg, w = rnd(b, s, 4 * d, dt=dt), rnd(h, dh, 4 * dh, dt=dt) * dh ** -0.5
    bias = rnd(4 * d, dt=torch.float32) * 0.1
    if state:
        st = [rnd(b, d, dt=torch.float32) * 0.5, rnd(b, d, dt=torch.float32),
              rnd(b, d, dt=torch.float32).abs() + 0.5, rnd(b, d, dt=torch.float32)]
    else:
        z = torch.zeros(b, d, device=dev)
        st = [z, z, z, torch.full((b, d), float("-inf"), device=dev)]
    return [xg, w, bias, *st]


def slstm_bwd_call(fn, args, hs, saved, *cot):
    """``fn`` (K5-bwd's wrapper or its plain version) at the forward's
    inputs ``args`` (xg, w_hh, b_ih, h0, c0, n0, m0), from its hs and its
    saved gates, c, n, m."""
    xg, w, _, *state = args
    return fn(w, *state, hs, *saved, *cot, x_dtype=xg.dtype)


def check_slstm_bwd(what: str, got, want) -> float:
    """K5-bwd's seven outputs against the plain backward's: each f32 one's
    max |kernel - plain| within ``SLSTM_BWD_TOL`` of its largest value (at
    least 1), those in bf16 elementwise at bf16's tolerance.  Returns the
    largest max |kernel - plain|."""
    import torch

    worst = 0.0
    for n, a, c in zip(SLSTM_BWD_NAMES, got, want):
        if a.dtype == torch.bfloat16:
            worst = max(worst, check_close(f"{what} {n}", a, c, "bfloat16"))
            continue
        if a.shape != c.shape or a.dtype != c.dtype or not torch.isfinite(a).all():
            fail(f"{what} {n}: {a.dtype} {tuple(a.shape)} (finite: "
                 f"{bool(torch.isfinite(a).all())}) against plain {c.dtype} {tuple(c.shape)}")
        e, scale = max_err(a, c), max(1.0, float(c.abs().max()) if c.numel() else 0.0)
        if e > SLSTM_BWD_TOL * scale:
            fail(f"{what} {n}: max |kernel - plain| {e:.3e} beyond {SLSTM_BWD_TOL} x {scale:.3g}")
        worst = max(worst, e)
    return worst


def slstm_bwd_bound(b, s, d, h, xbytes, wbytes) -> tuple[float, str]:
    """K5-bwd's least time (``slstm_scan_bwd_cost``: the two f32 products
    the call needs, on the CUDA cores).  Before the gates were saved the
    call also formed them again, a third such product."""
    from repro_torch.kernels.slstm_scan.ops import slstm_scan_bwd_cost

    return cost_bound(slstm_scan_bwd_cost(b, s, d, h, xbytes, wbytes), "float32")


def phase_slstm_bwd(dev, rnd, dts) -> dict:
    """K5 in save mode and K5-bwd on the card.  Save mode: at D = 2048, H =
    4, in both dtypes, hs and the final state must equal the serving
    launch's bit for bit, the saved last step the final (c, n, m), and the
    saved gates (xg + h_{t-1} w_hh) + b formed from hs within the f32
    tolerance.  K5-bwd: against the plain backward (``slstm_scan_bwd_ref``)
    on the kernel's own saved gates and states, at ``SLSTM_BWD_CASES`` in
    f32 and bf16, from the zero state (m0 = -inf) and from a random one,
    with cotangents on hs and on the final state, every call twice bit for
    bit, the kernel (cluster or grid) each shape ran logged; at the
    training shape ``SLSTM_BWD_REPEATS`` calls bit for bit (what catches a
    race in the exchange).  Timed (device ms by torch.profiler) at the
    training paths' shapes (both take the cluster kernel) beside the plain
    backward, the bound and the exchange alone (``chain_ms``: S rounds of
    the same bytes through the cluster's st.async and mbarrier waits); no
    PyTorch call computes the scan's backward, so there is no library
    time."""
    import torch

    from repro_torch.kernels.slstm_scan.ops import (_launch_fwd, cluster_sync_loop,
                                                    slstm_scan_bwd, slstm_scan_bwd_plan,
                                                    slstm_scan_bwd_ref)

    for dname, dt in dts.items():
        worst = 0.0
        for b, s in ((1, 16), (4, 100), (8, 384)):
            args = slstm_inputs(rnd, dev, b, s, 2048, 4, dt, False)
            hs0, st0, _ = _launch_fwd(*args, False)
            hs1, st1, saved = _launch_fwd(*args, True)
            if not (torch.equal(hs0, hs1) and all(map(torch.equal, st0, st1))):
                fail(f"slstm_scan {dname} B={b} S={s}: save mode changes hs or the final state")
            if not all(torch.equal(v[:, -1], f) for v, f in zip(saved[1:], st1[1:])):
                fail(f"slstm_scan {dname} B={b} S={s}: the saved last step is not the final "
                     f"(c, n, m)")
            xg, w, bias, h0 = args[:4]
            hprev = torch.cat([h0[:, None], hs1[:, :-1]], dim=1).view(b, s, 4, 512)
            rec = torch.einsum("bshd,hdk->bshk", hprev, w.float()).reshape(b, s, 4 * 2048)
            worst = max(worst, check_close(f"slstm_scan {dname} B={b} S={s} saved gates",
                                           saved[0], (xg.float() + rec) + bias, "float32"))
        log(f"slstm_scan {dname} save mode at B=1/4/8 S=16/100/384 D=2048 H=4: hs and the "
            f"final state bit for bit as without it; the saved last step is the final state; "
            f"the saved gates within {worst:.3e} of (xg + h_(t-1) w_hh) + b formed from hs")
    worst, n, logged = {}, 0, set()
    for dname, dt in dts.items():
        for (d, h), shapes in SLSTM_BWD_CASES.items():
            for b, s in shapes:
                p = slstm_scan_bwd_plan(b, d, h, w_dtype=dt)
                if (dname, d, h, b) not in logged:
                    logged.add((dname, d, h, b))
                    log(f"slstm_scan_bwd {dname} B={b} D={d} H={h}: {p.variant} kernel, "
                        f"{p.blocks} blocks of J={p.j}"
                        + (f", clusters of {p.cluster} over {p.rows} rows" if p.cluster else "")
                        + f", {p.smem} B shared memory a block, {p.active} resident at once")
                for state in (False, True):
                    args = slstm_inputs(rnd, dev, b, s, d, h, dt, state)
                    hs, _, saved = _launch_fwd(*args, True)
                    cot = [rnd(b, s, d, dt=torch.float32)] + \
                        [rnd(b, d, dt=torch.float32) for _ in range(4)]
                    got = slstm_bwd_call(slstm_scan_bwd, args, hs, saved, *cot)
                    what = f"slstm_scan_bwd {dname} B={b} S={s} D={d} H={h} " \
                           f"{'random' if state else 'zero'} state ({p.variant} kernel)"
                    e = check_slstm_bwd(what, got, slstm_bwd_call(slstm_scan_bwd_ref, args, hs,
                                                                  saved, *cot))
                    again = slstm_bwd_call(slstm_scan_bwd, args, hs, saved, *cot)
                    if not all(map(torch.equal, got, again)):
                        fail(f"{what}: a second call differs (not deterministic)")
                    if not state and any(torch.count_nonzero(g) for g in got[4:]):
                        fail(f"{what}: from the zero state dc0, dn0, dm0 must be 0")
                    worst[dname] = max(worst.get(dname, 0.0), e)
                    n += 1
        log(f"slstm_scan_bwd {dname}: {n} cases ((D, H): (B, S) {SLSTM_BWD_CASES}, zero and "
            f"random state, cotangents on hs and the final state): max_abs_err "
            f"{worst[dname]:.3e}, every call repeated bit for bit")
        n = 0
    times = {}
    for b, s, d, h, dt in ((8, 1024, 2048, 4, torch.bfloat16), (4, 256, 512, 8, torch.bfloat16)):
        dname = str(dt).split(".")[-1]
        args = slstm_inputs(rnd, dev, b, s, d, h, dt, False)
        hs, _, saved = _launch_fwd(*args, True)
        dhs = rnd(b, s, d, dt=torch.float32)
        what = f"slstm_scan_bwd {dname} B={b} S={s} D={d} H={h}"
        fn = lambda: slstm_bwd_call(slstm_scan_bwd, args, hs, saved, dhs)  # noqa: E731
        first = fn()
        check_slstm_bwd(f"{what} (timed)", first,
                        slstm_bwd_call(slstm_scan_bwd_ref, args, hs, saved, dhs))
        if (b, s) == (8, 1024):
            for i in range(SLSTM_BWD_REPEATS - 1):
                if not all(map(torch.equal, first, fn())):
                    fail(f"{what}: call {i + 2} of {SLSTM_BWD_REPEATS} differs from the first "
                         f"(a race in the exchange)")
            log(f"{what}: {SLSTM_BWD_REPEATS} calls bit for bit the same")
        t = timings(fn, lambda: slstm_bwd_call(slstm_scan_bwd_ref, args, hs, saved, dhs), None,
                    plain_iters=1, what=what, host_iters=10)
        xb = 2 if dt == torch.bfloat16 else 4
        t["bound_ms"], t["bound_by"] = slstm_bwd_bound(b, s, d, h, xb, xb)
        p = slstm_scan_bwd_plan(b, d, h, w_dtype=dt)
        t["variant"], t["cluster"], t["rows"], t["blocks"], t["j"] = \
            p.variant, p.cluster, p.rows, p.blocks, p.j
        t["chain_ms"] = device_ms(lambda: cluster_sync_loop(p.cluster, p.blocks // p.cluster,
                                                            p.rows * p.j, s, dev))
        log(f"{what}: {s} rounds of the same st.async exchange (cluster of {p.cluster}, "
            f"{p.rows * p.j} floats to each peer) and mbarrier waits alone (the chain's floor) "
            f"{t['chain_ms']:.5f} ms; the rest {t['ms'] - t['chain_ms']:.5f} ms, "
            f"{1e3 * (t['ms'] - t['chain_ms']) / s:.3f} us a step")
        log_timings(f"{what} [{p.variant} kernel: {p.blocks} blocks of J={p.j} (clusters of "
                    f"{p.cluster}, {p.rows} rows each), {p.smem} B shared memory a block]", t,
                    None)
        times[f"B={b} S={s} D={d} H={h} {dname}"] = t
    key = "B=8 S=1024 D=2048 H=4 bfloat16"
    return {"slstm_scan_bwd": {"max_abs_err": worst["bfloat16"],
                               "shape": f"{key} (xlstm-1.3b training)", **times[key],
                               "shapes": {k: {kk: vv for kk, vv in t.items() if kk != "wall_ms"}
                                          for k, t in times.items()}}}


def phase_ragged_concat(dev, gen) -> dict:
    """K4 at the concatenate node's size: the Top LiDAR's ~500k points and
    two sides' ~3k, 4 fields each (src/repro/apps/pointcloud.py:50), over
    the dtype sweep, with room to spare and with capacity < total; then
    timed beside ``torch.cat``, and required to be one kernel per call."""
    import torch

    from repro_torch.kernels.ragged_concat.ops import (ragged_concat, ragged_concat_cost,
                                                       ragged_concat_ref)

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
    if t["kernels_per_call"] is None:
        log("ragged_concat: kernels per call not measured (no profiler activity)")
    elif t["kernels_per_call"] != 1:
        fail(f"ragged_concat: {t['kernels_per_call']:g} kernels per call, not one")
    t["bound_ms"], t["bound_by"] = cost_bound(ragged_concat_cost(n, c, 4, sum(lens), cap),
                                              "float32")
    log_timings(f"ragged_concat f32 lens={lens} C={c} capacity={cap}", t, "torch.cat")
    return {"ragged_concat": {"max_abs_err": 0.0, "shape": f"N=3 lens={lens} C=4 f32", **t}}


# ---------------------------------------------------------------------------
# phases 4 and 6: full-width f32 model, kernel path vs plain path
# ---------------------------------------------------------------------------

# the kernels each family's path goes through, by wrapper
DENSE_KERNELS = ("rmsnorm", "flash_attention", "decode_attention")
PATH_KERNELS = {"qwen2-1.5b": DENSE_KERNELS, "xlstm-1.3b": ("rmsnorm", "slstm_scan"),
                "gemma-2b": DENSE_KERNELS, "llama3-8b": DENSE_KERNELS,
                "qwen3-8b": DENSE_KERNELS, "qwen2-moe-a2.7b": DENSE_KERNELS,
                "qwen3-moe-235b-a22b": DENSE_KERNELS, "zamba2-2.7b": DENSE_KERNELS,
                "whisper-small": ("flash_attention", "decode_attention"),
                "llama-3.2-vision-90b": DENSE_KERNELS}
# the dense siblings served after the fleet (phases 9-14), smallest first
SIBLINGS = ("gemma-2b", "llama3-8b", "qwen3-8b")
# the MoE family (phases 16-19), after its layer phase (15)
MOE_ARCHS = ("qwen2-moe-a2.7b", "qwen3-moe-235b-a22b")
# the Zamba2 family (phases 20-21)
ZAMBA_ARCHS = ("zamba2-2.7b",)
# the cross-attention families (phases 22-25), last, through Model
CROSS_ARCHS = ("whisper-small", "llama-3.2-vision-90b")
# a prompt longer than zamba2's chunk of 256 for the replay check of phase 20
REPLAY_PROMPT = 300
# depth cuts: qwen3-moe's 94 layers hold 470 GB in bf16; 4 of its identical
# layers run every module and kernel shape that 94 would.  mLLaMA's 100 (175
# GB in bf16) are 20 identical groups of [4 self + 1 cross]; 2 groups run
# every module and kernel shape (PERF.md section 4)
DEPTH = {"qwen3-moe-235b-a22b": 4, "llama-3.2-vision-90b": 10}
# a route that differs between the two f32 paths must be a near tie in the
# plain path: its k-th and (k+1)-th router probabilities this close
ROUTE_TIE = 1e-5


def arch_config(arch: str, dtype: str | None = None):
    """``arch``'s full config at its served depth (``DEPTH``), in ``dtype``
    when given."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch in DEPTH:
        log(f"{arch}: depth cut from {cfg.num_layers} to {DEPTH[arch]} layers, widths as "
            f"published")
        cfg = cfg.scaled(num_layers=DEPTH[arch])
    return cfg if dtype is None else cfg.scaled(param_dtype=dtype, compute_dtype=dtype)


class RouteLog:
    """The MoE layer's routes, recorded by wrapping the port's routing step
    (``repro_torch.models.mlp._route``) from here: every call appends its
    router probabilities and top-k experts.  ``close`` restores it."""

    def __init__(self):
        from repro_torch.models import mlp

        self.mlp, self.route, self.calls = mlp, mlp._route, []

        def recorded(x2d, router, k, e_valid):
            out = self.route(x2d, router, k, e_valid)
            self.calls.append((out[0], out[2]))
            return out

        mlp._route = recorded

    def take(self) -> list:
        calls, self.calls = self.calls, []
        return calls

    def close(self) -> None:
        self.mlp._route = self.route
        self.calls = []


def route_flips(fast: list, plain: list, k: int, what: str) -> int:
    """Tokens whose experts differ between the kernel path's and the plain
    path's routes, layer by layer; 0 when every route agrees.  At the first
    layer that differs, each differing token must be a near tie in the plain
    path (k-th and (k+1)-th probabilities within ``ROUTE_TIE``), else the
    run fails; later layers take that layer's output and are not held."""
    if len(fast) != len(plain):
        fail(f"{what}: {len(fast)} routed layers on the kernel path, {len(plain)} on plain")
    for layer, ((_, ef), (pp, ep)) in enumerate(zip(fast, plain)):
        differ = (ef.sort(-1).values != ep.sort(-1).values).any(-1)
        n = int(differ.sum())
        if n:
            top = pp[differ].topk(k + 1, dim=-1).values
            gaps = (top[:, k - 1] - top[:, k]).tolist()
            log(f"{what}: routes of {n} token(s) differ at layer {layer}; plain path's k-th "
                f"minus (k+1)-th probability {gaps} (near tie: <= {ROUTE_TIE})")
            if max(gaps) > ROUTE_TIE:
                fail(f"{what}: routes differ beyond a near tie at layer {layer}: gaps {gaps}")
            return n
    return 0


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
    """Kernel path against plain path in f32 at full width: 4 prefills of
    ragged prompts spliced into 4 slots, then 4 decode steps.  MoE archs
    (routing is discontinuous): each call's routes are recorded on both
    paths; a call whose routes all agree is held to ``MODEL_F32_REL_TOL``,
    one whose routes differ must differ only at near ties (``route_flips``)
    and is exempt, at most once in the 8 calls, after which the kernel path
    carries on from the plain path's cache."""
    import numpy as np
    import torch

    from repro_torch.models import Model

    cfg = arch_config(arch, "float32")
    fast, plain = Model(cfg, device=dev), Model(cfg, device=dev, plain=True)
    params = fast.init(SEED)
    rng = np.random.default_rng(SEED)
    routes = RouteLog() if cfg.family == "moe" else None
    exempt = []

    def both(what, fast_call, plain_call):
        """Run a call on both paths; True when the logits are to be held
        (no route differs)."""
        out_k = fast_call()
        rk = routes.take() if routes else []
        out_p = plain_call()
        rp = routes.take() if routes else []
        n = route_flips(rk, rp, cfg.top_k, f"f32 {arch} {what}") if routes else 0
        if n:
            exempt.append(what)
            log(f"f32 {arch} {what}: exempt from the logit bound (near-tie route flip; "
                f"{len(exempt)} of at most 1 calls)")
            if len(exempt) > 1:
                fail(f"f32 {arch}: more than one call with a route flip: {exempt}")
        elif routes:
            log(f"f32 {arch} {what}: routes agree in all {len(rk)} MoE layers")
        return out_k, out_p, not n

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
        what = f"prefill S={n}"
        (lk, k1), (lp, p1), held = both(what, lambda: fast.prefill(params, {"tokens": tt}),
                                        lambda: plain.prefill(params, {"tokens": tt}))
        if held:
            cmp(what, lk, lp)
        fast.splice_cache(ck, k1 if held else p1, slot, n)
        plain.splice_cache(cp, p1, slot, n)
        first.append(lp[0, -1].argmax())
        del k1, p1
    nxt = torch.stack(first)[:, None]
    for i in range(4):
        what = f"decode step {i + 1}, 4 slots at lengths {[n + i for n in lens]}"
        (lk, ck), (lp, cp), held = both(what, lambda: fast.decode_step(params, ck, nxt),
                                        lambda: plain.decode_step(params, cp, nxt))
        if held:
            cmp(what, lk, lp)
        else:
            for key in ("k", "v", "len"):
                ck[key].copy_(cp[key])
        nxt = lp[:, -1].argmax(-1, keepdim=True)
    want = [n + 4 for n in lens]
    if ck["len"].tolist() != want or cp["len"].tolist() != want:
        fail(f"f32 {arch}: cache len {ck['len'].tolist()} / {cp['len'].tolist()}, "
             f"expected {want}")
    if routes:
        routes.close()
        log(f"f32 {arch}: {8 - len(exempt)} of 8 calls held to the logit bound, exempt "
            f"(near-tie route flips): {exempt or 'none'}")
    del ck, cp, lk, lp
    if cfg.family == "zamba2":
        check_prefill_replay(dev, params, cfg, rng, arch)
    del params
    torch.cuda.empty_cache()


def check_prefill_replay(dev, params: dict, cfg, rng, arch: str) -> None:
    """Zamba2's parallel prefill (one chunked SSD pass) against its
    sequential replay (the prompt as decode steps from the zero state), both
    on the kernel path, on a prompt of ``REPLAY_PROMPT`` tokens: longer than
    the chunk of 256, so the inter-chunk scan and a padded chunk run at full
    width.  Every Mamba state leaf and the next step's logits from each
    cache must agree within ``MODEL_F32_REL_TOL`` of their scale."""
    import torch

    from repro_torch.models import zamba2_model as zm

    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, REPLAY_PROMPT)), device=dev)
    t0 = time.monotonic()
    with torch.inference_mode():
        lp, cp = zm.prefill(params, toks, cfg, max_seq=REPLAY_PROMPT + 1)
        ls, cs = zm.prefill_sequential(params, toks, cfg, max_seq=REPLAY_PROMPT + 1)
        nxt = lp[:, -1].argmax(-1, keepdim=True)
        step = {"parallel": zm.decode_step(params, cp, nxt, cfg)[0],
                "replay": zm.decode_step(params, cs, nxt, cfg)[0]}
    pairs = {f"mamba/{k}": (cp["mamba"][k], cs["mamba"][k]) for k in cp["mamba"]}
    pairs["next-step logits"] = (step["parallel"], step["replay"])
    for what, (a, b) in pairs.items():
        scale = float(b.abs().max())
        err = max_err(a, b)
        log(f"f32 {arch} prefill S={REPLAY_PROMPT}, parallel vs sequential replay, {what}: "
            f"max_abs_err {err:.3e} (scale {scale:.3e}, rel {err / scale:.3e}, bound "
            f"{MODEL_F32_REL_TOL})")
        if not torch.isfinite(a).all() or err > MODEL_F32_REL_TOL * scale:
            fail(f"f32 {arch}: parallel prefill differs from its sequential replay in {what}")
    log(f"f32 {arch}: replay check done in {time.monotonic() - t0:.1f} s")


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
    """K1 launches one prefill or decode step makes: every RMSNorm, its
    residual add fused in.  Dense: ln1 and ln2 of each layer and the final
    norm (2L + 1), and with ``qk_norm`` the q and k norms of each layer (2L
    more): gemma-2b 37, llama3-8b 65, qwen3-8b 145, qwen2-moe 49, qwen3-moe
    at 4 layers 17 (the MoE layer norms nothing); xLSTM: each block's
    pre-norm and inner norm, each sLSTM block's ln_s2 and the final norm
    (103 at full width); Zamba2: each Mamba2 block's pre-norm and inner
    norm, ln1 and ln2 at each invocation of the shared block, and the final
    norm (127 at full width)."""
    if cfg.family == "zamba2":
        return 2 * cfg.num_layers + 2 * (cfg.num_layers // cfg.attn_every) + 1
    if cfg.family == "xlstm":
        n_slstm = cfg.num_layers // cfg.slstm_every if cfg.slstm_every > 0 else 0
        return 2 * cfg.num_layers + n_slstm + 1
    return 2 * cfg.num_layers + 1 + (2 * cfg.num_layers if cfg.qk_norm else 0)


def attention_per_call(cfg) -> int:
    """Flash-attention launches a prefill, and decode-attention launches a
    decode step, make: one per layer (dense, MoE), one per invocation of
    the shared block (Zamba2: 9 at full width), none on xLSTM."""
    if cfg.family == "zamba2":
        return cfg.num_layers // cfg.attn_every
    return 0 if cfg.family == "xlstm" else cfg.num_layers


def zamba2_round_bytes(params: dict, cfg, cache: dict) -> dict:
    """The bytes a Zamba2 decode round must move, by part, without the K/V:
    every Mamba2 block's weights once, the shared block's weights once at
    each of its invocations (0.21 GB at full width, above the 50 MB L2),
    ``lm_head`` and the final norm (the embedding reads one row a slot),
    and the slots' Mamba states read and written."""
    ng = cfg.num_layers // cfg.attn_every
    size = lambda tree: sum(t.numel() * t.element_size() for t in _leaves(tree))  # noqa: E731
    return {"mamba": size(params["mamba"]) + size(params["ln_m"]),
            "shared": ng * size(params["shared"]),
            "head": size(params["lm_head"]) + size(params["final_norm"]),
            "state": 2 * size(cache["mamba"])}


def phase_serve_bf16(dev, arch: str) -> tuple[dict, dict]:
    import numpy as np
    import torch

    from repro_torch.launch.mesh import HW
    from repro_torch.launch.serve import make_requests, run, warmup
    from repro_torch.models import Model
    from repro_torch.runtime.server import InferenceServer

    ws = wrappers()
    names = PATH_KERNELS[arch]
    cfg = arch_config(arch)
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
    for stage, name in (("prefill", "flash_attention"), ("decode", "decode_attention")):
        calls, want = stages["calls"][stage], attention_per_call(cfg)
        if want and stages[stage][name] != calls * want:
            fail(f"{arch}: {stages[stage][name]} {name} launches in {calls} {stage} calls, "
                 f"expected {want} per call")
    if attention_per_call(cfg):
        log(f"{arch}: {attention_per_call(cfg)} flash_attention launches per prefill and "
            f"decode_attention launches per decode call")
    if cfg.family == "xlstm":
        for stage in ("prefill", "decode"):
            for name in names:
                if stages[stage][name] <= 0:
                    fail(f"{arch}: kernel {name} was not launched in {stage}")
        log(f"{arch}: state cache {state_bytes / 1e9:.3f} GB for {SLOTS} slots")
    if cfg.family == "moe":
        # a round reads the experts its SLOTS tokens route to, expected
        # E * (1 - (1 - k/E)^(SLOTS)) of E per layer, and every other weight
        e, k = cfg.num_experts, cfg.top_k
        expert_bytes = sum(t.numel() * t.element_size() for p in params["layers"]
                           for n, t in p["moe"].items() if n.startswith("e_"))
        active = e * (1 - (1 - k / e) ** SLOTS)
        read = weight_bytes - expert_bytes * (1 - active / e)
        log(f"{arch} decode-round bound {1e3 * read / HW.HBM_BW:.3f} ms ({read / 1e9:.3f} "
            f"GB: {SLOTS * k} routes a layer reach {active:.1f} of {e} experts in expectation, "
            f"{expert_bytes / 1e9:.3f} GB of experts in all) / 3.35 TB/s)")
        moe_bytes = (weight_bytes, expert_bytes, e)
    elif cfg.family == "zamba2":
        parts = zamba2_round_bytes(params, cfg, srv._cache)
        no_kv = sum(parts.values())
        log(f"{arch} decode-round bound without the K/V {1e3 * no_kv / HW.HBM_BW:.3f} ms "
            f"({no_kv / 1e9:.3f} GB: " + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in parts.items())
            + " GB) / 3.35 TB/s")
    else:
        bound_step = 1e3 * (weight_bytes + 2 * state_bytes) / HW.HBM_BW
        log(f"{arch} decode-round bound {bound_step:.3f} ms ((weights {weight_bytes / 1e9:.3f} "
            f"GB + 2 x state {state_bytes / 1e9:.3f} GB) / 3.35 TB/s)")
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
    if cfg.family == "zamba2":   # the valid K/V the profiled rounds read, at their lengths
        kv_row = 2 * cfg.num_kv_heads * cfg.head_dim * 2 * (cfg.num_layers // cfg.attn_every)
        kv_bytes = path_ms["kv_tokens"] * kv_row
        read = no_kv + kv_bytes
        log(f"{arch} decode-round bound for the profiled rounds: "
            f"{1e3 * read / HW.HBM_BW:.3f} ms ({read / 1e9:.3f} GB: the above and "
            f"{kv_bytes / 1e9:.3f} GB of valid K/V, {path_ms['kv_tokens']:.1f} cached positions "
            f"over the slots a round)")
    if cfg.family == "moe":      # the bound for the experts the profiled rounds reached
        weight_bytes, expert_bytes, e = moe_bytes
        read = weight_bytes - expert_bytes * (1 - path_ms["moe"]["active_experts"] / e)
        log(f"{arch} decode-round bound for the profiled rounds' routes: "
            f"{1e3 * read / HW.HBM_BW:.3f} ms ({read / 1e9:.3f} GB, "
            f"{path_ms['moe']['active_experts']:.2f} of {e} experts a layer)")

    plain_model = Model(cfg, device=dev, plain=True)
    plain_srv = serve(plain_model)
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
    # how far bf16 rounding moves one prefill's logits between the two paths,
    # beside the gap between the plain logits' two largest (a greedy token
    # flips where that gap is below the paths' difference)
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                                                 (1, PROMPT_MAX)), device=dev)
    routes = RouteLog() if cfg.family == "moe" else None
    lk = model.prefill(params, {"tokens": toks})[0][0, -1].float()
    rk = routes.take() if routes else []
    lp = plain_model.prefill(params, {"tokens": toks})[0][0, -1].float()
    top2 = lp.topk(2).values
    log(f"{arch} bf16 prefill logits at S={PROMPT_MAX}, kernel path vs plain path "
        f"(information): max abs {max_err(lk, lp):.4e}, logit scale "
        f"{float(lp.abs().max()):.4e}, plain top-2 gap {float(top2[0] - top2[1]):.4e}")
    if routes:      # bf16 rounding moves routes at near ties, and each move compounds
        rp = routes.take()
        routes.close()
        moved = [int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                 for (_, a), (_, b) in zip(rk, rp)]
        log(f"{arch} bf16 prefill at S={PROMPT_MAX} (information): tokens whose experts "
            f"differ between the paths, by layer: {moved}")
    del srv, plain_srv, params, model, plain_model
    torch.cuda.empty_cache()
    return {n: launches[n] for n in names}, path_ms


# ---------------------------------------------------------------------------
# phases 22-25: the cross-attention families through the Model API
# ---------------------------------------------------------------------------

# mLLaMA's cross layers' gates, set before every phase: they are zero at
# init, and tanh(0) = 0 would make every cross-attention and cross MLP add
# nothing, so no fault of the cross path could show
MLLAMA_GATES = {"gate_attn": 0.7, "gate_mlp": -0.5}
CROSS_BATCH = 4
# the f32 phases' prompt lengths, one batch each: across K2's 64-row tiles
CROSS_F32_PROMPTS = (100, 311)


def cross_model(dev, arch: str, dtype: str):
    """``arch`` (at its served depth) in ``dtype`` on the card, its random
    weights from ``SEED``, mLLaMA's gates set (``MLLAMA_GATES``)."""
    from repro_torch.models import Model

    cfg = arch_config(arch, dtype)
    model = Model(cfg, device=dev)
    params = model.init(SEED)
    n = sum(t.numel() for t in _leaves(params))
    log(f"{dtype} {arch}: {n / 1e9:.3f} B parameters, "
        f"{sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9:.3f} GB")
    if cfg.family == "mllama":
        for k, g in MLLAMA_GATES.items():
            params["cross_layers"][k].fill_(g)
        log(f"{dtype} {arch}: every cross layer's gate_attn set to {MLLAMA_GATES['gate_attn']} "
            f"and gate_mlp to {MLLAMA_GATES['gate_mlp']} (zero at init, where the cross "
            f"path adds nothing)")
    return cfg, model, params


def cross_input(cfg, b: int, gen) -> dict:
    """The input beside the tokens, drawn on the card from ``gen``: audio
    frames (whisper) or vision patch embeddings (mLLaMA), (b, P, d_model)."""
    import torch

    key, n = (("frames", cfg.encoder_positions) if cfg.family == "whisper"
              else ("vision", cfg.vision_tokens))
    return {key: torch.randn((b, n, cfg.d_model), generator=gen, device=gen.device,
                             dtype=torch.float32).to(cfg.cdt)}


def check_rel(what: str, a, b) -> None:
    """``a`` within ``MODEL_F32_REL_TOL`` of ``b``'s scale, and finite."""
    import torch

    if not torch.isfinite(a).all():
        fail(f"{what}: non-finite values")
    scale = float(b.abs().max())
    err = max_err(a, b)
    same = bool((a[:, -1].argmax(-1) == b[:, -1].argmax(-1)).all()) if a.ndim == 3 else None
    log(f"{what}: max_abs_err {err:.3e} (scale {scale:.3e}, rel {err / scale:.3e}, bound "
        f"{MODEL_F32_REL_TOL}){'' if same is None else f', argmax agree {same}'}")
    if err > MODEL_F32_REL_TOL * scale:
        fail(f"{what}: differs by {err:.3e}, beyond {MODEL_F32_REL_TOL} of {scale:.3e}")


def phase_cross_f32(dev, arch: str) -> None:
    """Kernel path against plain path in f32 at full width on one copy of
    the weights: two batches of 4 prompts (``CROSS_F32_PROMPTS`` tokens),
    each with its own frames or vision input, prefill logits and the cross
    K/V, then 4 decode steps.  Then, on the kernel path, prefill of n
    tokens plus one decode step against prefill of n + 1 tokens."""
    import torch

    from repro_torch.models import Model

    cfg, fast, params = cross_model(dev, arch, "float32")
    plain = Model(cfg, device=dev, plain=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    for n in CROSS_F32_PROMPTS:
        toks = torch.randint(0, cfg.vocab_size, (CROSS_BATCH, n), generator=gen, device=dev)
        batch = {"tokens": toks, **cross_input(cfg, CROSS_BATCH, gen)}
        lk, ck = fast.prefill(params, batch, max_seq=n + 8)
        lp, cp = plain.prefill(params, batch, max_seq=n + 8)
        check_rel(f"f32 {arch} prefill B={CROSS_BATCH} S={n}", lk, lp)
        for key in ("ck", "cv"):
            check_rel(f"f32 {arch} prefill B={CROSS_BATCH} S={n} cache {key}", ck[key], cp[key])
        nxt = lp[:, -1].argmax(-1, keepdim=True)
        for i in range(4):
            lk, ck = fast.decode_step(params, ck, nxt)
            lp, cp = plain.decode_step(params, cp, nxt)
            check_rel(f"f32 {arch} decode step {i + 1} at length {n + i + 1}", lk, lp)
            nxt = lp[:, -1].argmax(-1, keepdim=True)
        if ck["len"].tolist() != [n + 4] * CROSS_BATCH:
            fail(f"f32 {arch}: cache len {ck['len'].tolist()}, expected {n + 4}")
        del ck, cp, batch
    n = CROSS_F32_PROMPTS[0]
    toks = torch.randint(0, cfg.vocab_size, (CROSS_BATCH, n + 1), generator=gen, device=dev)
    extra = cross_input(cfg, CROSS_BATCH, gen)
    _, cache = fast.prefill(params, {"tokens": toks[:, :n], **extra}, max_seq=n + 1)
    stepped = fast.decode_step(params, cache, toks[:, n:])[0]
    whole = fast.prefill(params, {"tokens": toks, **extra})[0]
    check_rel(f"f32 {arch} prefill S={n} + one decode step against prefill S={n + 1}",
              stepped, whole)
    del params, cache, extra
    torch.cuda.empty_cache()


def cross_calls_per_stage(cfg) -> dict:
    """Each path kernel's launches a prefill and a decode step make.
    Whisper: K2 once per encoder layer and twice per decoder layer (self,
    cross: 36 at 12 + 12 layers), K3 twice per decoder layer (24), no K1
    (LayerNorm).  mLLaMA: K2 and K3 once a layer (self or cross: 10 at 10
    layers), K1 2L + 1 (21)."""
    L = cfg.num_layers
    if cfg.family == "whisper":
        return {"prefill": {"rmsnorm": 0, "flash_attention": cfg.encoder_layers + 2 * L,
                            "decode_attention": 0},
                "decode": {"rmsnorm": 0, "flash_attention": 0, "decode_attention": 2 * L}}
    return {"prefill": {"rmsnorm": 2 * L + 1, "flash_attention": L, "decode_attention": 0},
            "decode": {"rmsnorm": 2 * L + 1, "flash_attention": 0, "decode_attention": L}}


def generate(model, params: dict, batch: dict, max_new: int) -> dict:
    """Greedy generation of ``max_new`` tokens a row through ``Model``: one
    prefill, then ``max_new - 1`` decode steps.  Each token is read back to
    the host as a server does, which syncs: TTFT is the prefill (encoder
    included) up to its token on the host, each step's ms the same."""
    import torch

    torch.cuda.synchronize()
    t0 = time.monotonic()
    logits, cache = model.prefill(params, batch, max_seq=MAX_SEQ)
    nxt = logits[:, -1].argmax(-1, keepdim=True)
    out = [nxt.cpu()]
    ttft = time.monotonic() - t0
    steps = []
    for _ in range(max_new - 1):
        t1 = time.monotonic()
        logits, cache = model.decode_step(params, cache, nxt)
        nxt = logits[:, -1].argmax(-1, keepdim=True)
        out.append(nxt.cpu())
        steps.append(1e3 * (time.monotonic() - t1))
    return {"ttft_ms": 1e3 * ttft, "step_ms": steps, "wall_s": time.monotonic() - t0,
            "tokens": torch.cat(out, 1), "len": cache["len"].tolist()}


def cross_round_bytes(params: dict, cfg, lens: list) -> dict:
    """The bytes one decode step must move, by part: the weights it reads
    (the decoder's, or every layer's, without the cross layers' ``wk`` and
    ``wv``, whose K/V is cached; whisper's tied table as its unembedding,
    mLLaMA's ``lm_head``; the embedding reads one row a request), the cached
    cross K/V, and the valid self K/V at the step's lengths ``lens``."""
    size = lambda tree: sum(t.numel() * t.element_size() for t in _leaves(tree))  # noqa: E731
    if cfg.family == "whisper":
        layers = params["decoder"]["layers"]
        weights = (size(layers) - size(layers["cross_attn"]["wk"])
                   - size(layers["cross_attn"]["wv"]) + size(params["decoder"]["tok_embed"])
                   + size(params["decoder"]["final_ln"]))
        n_self, kv, cross_rows = cfg.num_layers, cfg.num_heads, cfg.encoder_positions
        n_cross = cfg.num_layers
    else:
        cross = params["cross_layers"]
        weights = (size(params) - size(params["tok_embed"]) - size(cross["attn"]["wk"])
                   - size(cross["attn"]["wv"]))
        n_cross = cfg.num_layers // cfg.cross_attn_every
        n_self, kv, cross_rows = cfg.num_layers - n_cross, cfg.num_kv_heads, cfg.vision_tokens
    el = 2 * kv * cfg.head_dim * cfg.cdt.itemsize          # one position's k and v
    return {"weights": weights, "cross_kv": n_cross * len(lens) * cross_rows * el,
            "self_kv": n_self * sum(lens) * el}


def phase_cross_bf16(dev, arch: str) -> tuple[dict, dict]:
    """8 requests in two batches of 4 through ``Model.prefill`` and greedy
    ``decode_step`` (the reference's entry point for this family: its
    server cannot take frames or a vision input), each batch one prompt
    length drawn from the seed in 16-384 and its own frames or vision
    input, ``MAX_SEQ`` positions, ``MAX_NEW`` tokens a request.  Every
    kernel's launch counter is set to 0 just before and read just after;
    each prefill and decode call must launch exactly the counts of
    ``cross_calls_per_stage``.  Then a profile of one prefill and 4 decode
    steps (each K3 call one kernel), the decode step's bytes bound, and
    the first batch's prefill logits on the kernel path beside the plain
    path's (information)."""
    import numpy as np
    import torch

    from repro_torch.launch.mesh import HW

    ws = wrappers()
    names = PATH_KERNELS[arch]
    cfg, model, params = cross_model(dev, arch, "bfloat16")
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def make_batch(n):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (CROSS_BATCH, n)), device=dev)
        return {"tokens": toks, **cross_input(cfg, CROSS_BATCH, gen)}

    generate(model, params, make_batch(PROMPT_MAX), 2)   # warm the allocator's pool
    lens = [int(rng.integers(PROMPT_MIN, PROMPT_MAX + 1)) for _ in range(N_REQUESTS // CROSS_BATCH)]
    batches = [make_batch(n) for n in lens]
    torch.cuda.reset_peak_memory_stats(dev)
    stage_names = ("rmsnorm", "flash_attention", "decode_attention")
    stages = count_by_stage(model, stage_names, ws)
    for w in ws.values():
        w.launches = 0
    runs = [generate(model, params, b, MAX_NEW) for b in batches]
    launches = {name: w.launches for name, w in ws.items()}
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    for name in names:
        if launches[name] <= 0:
            fail(f"{arch}: kernel {name} was launched {launches[name]} times on the main path")
    log(f"{arch} launches on the main path (counters zeroed just before): {launches}")
    want = cross_calls_per_stage(cfg)
    for stage in ("prefill", "decode"):
        calls = stages["calls"][stage]
        got = {n: stages[stage][n] for n in stage_names}
        if not calls or got != {n: calls * c for n, c in want[stage].items()}:
            fail(f"{arch}: {stage} launched {got} in {calls} calls, expected "
                 f"{want[stage]} per call")
        log(f"{arch}: {calls} {stage} calls, each {want[stage]}")
    for n, r in zip(lens, runs):
        if r["tokens"].shape != (CROSS_BATCH, MAX_NEW) or \
                not ((r["tokens"] >= 0) & (r["tokens"] < cfg.vocab_size)).all() or \
                r["len"] != [n + MAX_NEW - 1] * CROSS_BATCH:
            fail(f"{arch} batch at S={n}: tokens {tuple(r['tokens'].shape)}, lengths {r['len']}")
    wall = sum(r["wall_s"] for r in runs)
    steps = [ms for r in runs for ms in r["step_ms"]]
    log(f"{arch} bf16 {N_REQUESTS} requests in {len(runs)} batches of {CROSS_BATCH}, prompts "
        f"{lens}, {MAX_NEW} tokens each: {N_REQUESTS * MAX_NEW} tokens in {wall:.3f} s = "
        f"{N_REQUESTS * MAX_NEW / wall:.2f} tok/s; TTFT per batch (encoder or vision K/V "
        f"included) {[round(r['ttft_ms'], 3) for r in runs]} ms; decode step median "
        f"{sorted(steps)[len(steps) // 2]:.3f} ms, range {min(steps):.3f}-{max(steps):.3f} ms; "
        f"peak device memory {peak:.3f} GiB")
    mid = [lens[0] + MAX_NEW // 2] * CROSS_BATCH     # the first batch's middle step
    parts = cross_round_bytes(params, cfg, mid)
    read = sum(parts.values())
    log(f"{arch} decode-step bound {1e3 * read / HW.HBM_BW:.3f} ms ({read / 1e9:.3f} GB: "
        + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in parts.items())
        + f" GB at lengths {mid[0]}) / 3.35 TB/s")

    # where the time goes: one prefill, then 4 decode steps, profiled
    from torch.profiler import ProfilerActivity, profile

    path_ms = {}
    batch = batches[0]
    windows = []
    state = {}
    for label, n_rounds in (("admission round", 1), ("decode rounds", 4)):
        before = {k: w.launches for k, w in ws.items()}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            if label == "admission round":
                logits, state["cache"] = model.prefill(params, batch, max_seq=MAX_SEQ)
                state["nxt"] = logits[:, -1].argmax(-1, keepdim=True)
                state["nxt"].cpu()
            else:
                for _ in range(n_rounds):
                    logits, state["cache"] = model.decode_step(params, state["cache"],
                                                               state["nxt"])
                    state["nxt"] = logits[:, -1].argmax(-1, keepdim=True)
                    state["nxt"].cpu()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        calls = {k: w.launches - before[k] for k, w in ws.items() if k in names}
        windows.append(window_report(label, prof, wall, n_rounds, calls,
                                     {n: ws[n] for n in names}, path_ms,
                                     busy_rows=f"{CROSS_BATCH} requests"))
    lens_now = state["cache"]["len"].tolist()
    parts = cross_round_bytes(params, cfg, [n - 2 for n in lens_now])
    read = sum(parts.values())
    log(f"{arch} decode-step bound for the profiled steps: {1e3 * read / HW.HBM_BW:.3f} "
        f"ms ({read / 1e9:.3f} GB) against device busy {windows[1]['busy_ms']:.3f} ms and wall "
        f"{windows[1]['wall_ms']:.3f} ms a step")

    # how far bf16 rounding moves the first batch's prefill logits between
    # the two paths, beside the plain logits' top-2 gap (a greedy token
    # flips where that gap is below the paths' difference)
    from repro_torch.models import Model

    plain = Model(cfg, device=dev, plain=True)
    lk = model.prefill(params, batch, max_seq=MAX_SEQ)[0][:, -1].float()
    lp = plain.prefill(params, batch, max_seq=MAX_SEQ)[0][:, -1].float()
    top2 = lp.topk(2, dim=-1).values
    log(f"{arch} bf16 prefill logits at S={lens[0]}, kernel path vs plain path "
        f"(information): max abs {max_err(lk, lp):.4e}, logit scale "
        f"{float(lp.abs().max()):.4e}, plain top-2 gap min "
        f"{float((top2[:, 0] - top2[:, 1]).min()):.4e}, argmax agree "
        f"{int((lk.argmax(-1) == lp.argmax(-1)).sum())}/{CROSS_BATCH}")
    if not torch.isfinite(lk).all():
        fail(f"{arch} bf16 prefill: non-finite logits on the kernel path")
    del params, model, plain, batches, batch, state, lk, lp
    torch.cuda.empty_cache()
    return {n: launches[n] for n in names}, path_ms


# ---------------------------------------------------------------------------
# phase 15: the MoE layer at qwen2-moe's width
# ---------------------------------------------------------------------------

MOE_LAYER_TOKENS = 1024


def phase_moe_layer(dev) -> None:
    """``moe_ffn`` at qwen2-moe-a2.7b's layer width (d 2048, 60 experts of
    1408 top-4, 4 shared experts fused to 5632) on T = 1024 tokens, whose
    4096 (token, expert) pairs give the experts about 68 rows each: the
    capacity path at the config's factor of 1.25.  In f32 the capacity path
    at factor 4.0 (nothing dropped) must match the dropless path within
    3e-5 of the output's scale; the pairs dropped at 1.25 are counted.
    Each path's device ms (torch.profiler) and host wall ms per call, in
    f32 and bf16, beside the bound: every expert's weights and the shared
    ones read once (all 60 experts are routed to at this T), x read and
    the output written once; the GEMMs' operations over the dtype's peak."""
    import torch

    from repro_torch.models import mlp

    base = arch_config("qwen2-moe-a2.7b").scaled(num_layers=1)
    e, k, t = base.num_experts, base.top_k, MOE_LAYER_TOKENS
    for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        cfg = base.scaled(param_dtype=dname, compute_dtype=dname)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        p = mlp.init_moe(gen, cfg)
        x = torch.randn(1, t, cfg.d_model, generator=gen, device=dev).to(dt)
        args = (x[0], p["router"], p["e_gate"], p["e_up"], p["e_down"])
        if dname == "float32":
            drop = mlp._moe_local(*args, cfg=cfg, n_local=e, aux=False)[0]
            cap = mlp._moe_local_capacity(*args, cfg=cfg.scaled(moe_capacity_factor=4.0),
                                          n_local=e, aux=False)[0]
            scale = float(drop.abs().max())
            rel = max_err(cap, drop) / scale
            log(f"moe layer f32 T={t}: capacity path (factor 4.0, no drops) vs dropless: "
                f"max_abs_err {max_err(cap, drop):.3e}, output scale {scale:.3e}, rel "
                f"{rel:.3e} (bound 3e-5)")
            if not torch.isfinite(cap).all() or rel > 3e-5:
                fail(f"moe layer: capacity path differs from dropless by {rel:.3e} relative")
        se = mlp._dispatch(args[0], p["router"], cfg=cfg, n_local=e, offset=0, e_valid=None)[3]
        sizes = torch.bincount(se, minlength=e + 1)[:e]
        rows = -(-(int(cfg.moe_capacity_factor * t * k / e) + 1) // 128) * 128
        dropped = int((sizes - rows).clamp(min=0).sum())
        log(f"moe layer {dname} T={t}: at the config's factor {cfg.moe_capacity_factor} each "
            f"expert gets {rows} rows; {dropped} of {t * k} pairs dropped; rows per expert "
            f"{int(sizes.min())}-{int(sizes.max())}, {int((sizes > 0).sum())} of {e} experts "
            f"routed to")
        nbytes = sum(w.numel() * w.element_size() for w in _leaves(p)) + \
            2 * x.numel() * x.element_size()
        fs = cfg.d_ff_shared
        flops = 2 * t * cfg.d_model * (3 * k * cfg.d_ff + 3 * fs + e + 1)
        bound, by = bound_ms(nbytes, flops, dname)
        for path, c in (("capacity", cfg), ("dropless", cfg.scaled(moe_capacity_factor=0.0))):
            fn = lambda c=c: mlp.moe_ffn(p, x, cfg=c)  # noqa: E731
            by_kernel = device_breakdown(fn, iters=10)
            dev_ms = sum(ms for ms, _ in by_kernel.values())
            launches = sum(n or 0 for _, n in by_kernel.values())
            log(f"moe layer {dname} T={t} {path} path: device {dev_ms:.5f} ms per call "
                f"({launches:g} device activities), host wall {cuda_ms(fn, iters=10):.5f} ms; "
                f"bound {bound:.5f} ms ({by}: {nbytes / 1e9:.3f} GB, "
                f"{flops / 1e9:.1f} GFLOP)")
            log_breakdown(f"moe layer {dname} {path}", by_kernel)
        del p, x, args
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: the serving fleet
# ---------------------------------------------------------------------------

FLEET_ARCH, FLEET_REPLICAS, FLEET_REQUESTS = "qwen2-1.5b", 2, 16


# the serving flow's stages as phase 8 logs them
FLEET_STAGE_NAMES = {
    "enqueue_to_flush": "head enqueue -> flush",
    "flush_to_replica": "flush -> replica enqueue (zero-copy hand-off, wait for its round)",
    "replica_to_first_chunk": "replica enqueue -> first chunk (admission, prefill)",
    "stream": "stream (decode)", "e2e": "end to end"}


def phase_fleet(dev) -> tuple[dict, dict]:
    """Two fleet runs (no fault, then one replica killed) against one
    in-process server; returns the first run's launches summed over the
    replicas, and each run's serving stages (ms)."""
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
    launches, stages = None, {}
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
        fl = out["flows"]
        faults = fleet.flow_failures(fl, kill_one=kill)
        if faults:
            fail(f"fleet {what}: flow gates: " + "; ".join(faults))
        log(f"fleet {what}: serving flows from the trace rings: {fl['complete']} complete, "
            f"{fl['truncated']} truncated (replayed requests {fl['replayed']}); mean stage sum "
            f"{1e3 * fl['stage_sum_mean_s']:.3f} ms against the head's submit-to-complete "
            f"{1e3 * fl['head_mean_s']:.3f} ms (off by {fl['stage_sum_vs_head']:.4f}); flow "
            f"gates pass")
        log(f"fleet {what}: serving stages p50/p99/max ms: " + "; ".join(
            f"{FLEET_STAGE_NAMES.get(k, k)} {1e3 * v['p50']:.3f}/{1e3 * v['p99']:.3f}/"
            f"{1e3 * v['max']:.3f} (n {v['n']})" for k, v in fl["stats"].items()))
        stages[what] = {k: {q: v[q] * 1e3 for q in ("p50", "p99", "max")} | {"n": v["n"]}
                        for k, v in fl["stats"].items()}
        if launches is None:
            launches = {n: sum(m["launches"].get(n, 0) for m in metrics.values())
                        for n in names}
    return launches, stages


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
    kv_tokens = []
    for n_rounds in (1, rounds):
        if n_rounds == rounds and cfg.family == "zamba2":
            # the cached positions each round of the window attends to, on average
            kv_tokens.append(float(srv._cache["len"].sum()) + len(srv._active) * (rounds + 1) / 2)
        before = {k: w.launches for k, w in wrappers.items()}
        routes = RouteLog() if cfg.family == "moe" and n_rounds == rounds else None
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for _ in range(n_rounds):
                srv.step_rounds()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        windows.append((prof, wall, n_rounds,
                        {k: w.launches - before[k] for k, w in wrappers.items()}))
        if routes:
            calls = routes.take()
            routes.close()
            active = [int(top_e.unique().numel()) for _, top_e in calls]
            moe = {"active_experts": sum(active) / len(active), "layer_calls": len(active)}
            log(f"profile, decode rounds: {len(active)} MoE layer calls routed "
                f"{calls[0][1].numel()} pairs each to {min(active)}-{max(active)} "
                f"experts, mean {moe['active_experts']:.2f} of {cfg.num_experts}")
    srv.serve()

    path_ms = {}
    for label, window in zip(("admission round", "decode rounds"), windows):
        window_report(label, *window, wrappers, path_ms)
    if cfg.family == "moe":
        path_ms["moe"] = moe
    if kv_tokens:
        path_ms["kv_tokens"] = kv_tokens[0]
    return path_ms


def window_report(label: str, prof, wall: float, n: int, calls: dict, wrappers: dict,
                  path_ms: dict, busy_rows: str = f"{SLOTS} slots busy") -> dict:
    """Log one profiled window of ``n`` rounds (wall time, device busy and
    idle share, device activities, the top kernels) and each wrapper's
    device ms per launch into ``path_ms``; fails unless each
    decode-attention call was one kernel.  Returns the window's numbers."""
    acts = cuda_activity(prof)
    if not acts:
        # the profiler can deliver no activity at all for a window (see
        # device_breakdown): nothing on the device is measured, or checked
        log(f"profile, {label} ({n} round(s), {busy_rows}): wall {1e3 * wall / n:.3f} "
            "ms/round; torch.profiler delivered no device activity, device numbers not "
            "measured")
        nan = float("nan")
        return {"wall_ms": 1e3 * wall / n, "busy_ms": nan, "idle_share": nan, "activities": nan}
    dev_us = {}
    for e in acts:
        dev_us[e.key] = dev_us.get(e.key, 0.0) + e.self_device_time_total
    busy = sum(dev_us.values()) / 1e6
    out = {"wall_ms": 1e3 * wall / n, "busy_ms": 1e3 * busy / n, "idle_share": 1 - busy / wall,
           "activities": sum(e.count for e in acts) / n}
    log(f"profile, {label} ({n} round(s), {busy_rows}): wall {out['wall_ms']:.3f} ms/round, "
        f"device busy {out['busy_ms']:.3f} ms/round (idle share {out['idle_share']:.3f}), "
        f"{out['activities']:.0f} device activities/round")
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
        # 111 of 112), never more, and none only where no call was made
        if name == "decode_attention" and (kernels > calls[name]
                                           or (calls[name] > 0 and kernels == 0)):
            fail(f"{label}: {calls[name]} decode_attention calls ran {kernels} kernels; "
                 "each call must be one launch")
        if name == "decode_attention" and kernels < calls[name]:
            log(f"profile, {label}: the profiler delivered {kernels} of "
                f"{calls[name]} decode_attention activities")
        if calls[name]:
            path_ms.setdefault(name, {})[label] = us / 1e3 / calls[name]
            log(f"profile, {label}: {name} {calls[name]} launches, device "
                f"{us / 1e3 / calls[name]:.5f} ms per launch")
    return out


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
# training: the backward kernels (phase 3) and phases 26-28
# ---------------------------------------------------------------------------

# f32 full-width qwen2-1.5b gradients, kernel path against plain path: as for
# MODEL_F32_REL_TOL, the two differ only in the order of f32 sums inside K1,
# K2 and their backwards (~1e-6 relative a call), carried forward and back
# through 28 layers; 1e-3 of each leaf group's largest gradient leaves room
# for that while an indexing, masking or scaling fault is O(1).  The same
# bound holds full-width xlstm-1.3b (B 2 x S 256), whose gradients have
# stayed within 9.4e-05 of plain on the card (NVIDIA H100 80GB HBM3,
# 700 W), 13x qwen2's 7.3e-06: K5 and K5-bwd use CUDA's expf, log1pf and
# tanhf where plain torch uses its own, a few ulp apart at each step, and
# the recurrence carries those differences through 256 steps forward and
# 256 back in each of the 6 sLSTM blocks.  1e-3 leaves about 10x room
# above that reading, and stays far below the O(1) error of an indexing,
# masking or scaling fault.
GRAD_F32_REL_TOL = 1e-3
TRAIN_ARCH = "qwen2-1.5b"
TRAIN_F32_BS = (2, 256)                      # B, S of phase 26
TRAIN_BF16_BS = (8, 1024)                    # B, S of phase 27
TRAIN_STEPS, TRAIN_CKPT_AT = 8, 4
# phase 27, resumed run against uninterrupted run: the restore is exact (bf16
# params as their bits, f32 master, moments and step, the data cursor) and
# neither backward kernel uses atomics, so steps 5-8 start from the same
# state and batches and run the same sums; the resumed losses have equalled
# the uninterrupted run's bit for bit in every run on the card.  The four
# restore faults of RESUME_FAULTS, planted on the card (NVIDIA H100 80GB
# HBM3, 700 W), moved them by 4.3e-2 (master rebuilt from the bf16 params),
# 0.18 (the optimizer's step one ahead), 0.19 (the data cursor one ahead)
# and 1.03 (moments zeroed).  The bound sits below a tenth of the smallest
# fault and leaves room above 0 for a one-ulp flip, should a library
# kernel's sum order ever differ between the two trainers; every run
# plants the faults again and fails if one stays within it.
RESUME_LOSS_TOL = 1e-3
RESUME_FAULTS = ("moments zeroed", "master weights from the bf16 params",
                 "optimizer step one ahead", "data cursor one ahead")
# phase 28 at bf16, kernel path against plain path on step 1's loss and
# grad norm: bf16 keeps 8 significant bits (2^-9 relative per rounding), and
# the two paths round at different points (the norms' outputs, attention's p,
# its output); over a loss averaged across 1024 tokens these average down to
# ~1e-3 relative, and the grad norm (a root sum of squares over every leaf)
# to ~1e-2.  Bounds 1e-2 and 5e-2; a fault in a backward kernel moves the grad
# norm by O(1).  MoE routes that flip at near ties move both a little more,
# inside the same bounds.
FAMILY_LOSS_REL_TOL, FAMILY_GNORM_REL_TOL = 1e-2, 5e-2
FAMILY_TRAIN = ("qwen2-1.5b", "qwen2-moe-a2.7b", "zamba2-2.7b", "whisper-small",
                "llama-3.2-vision-90b", "xlstm-1.3b")
FAMILY_BS, FAMILY_STEPS = (4, 256), 3
# phase 27's xLSTM run: full-width xlstm-1.3b in bf16 through the Trainer,
# no checkpoint (the qwen2 run above covers save and resume)
XLSTM_ARCH = "xlstm-1.3b"
XLSTM_TRAIN_BS = (8, 1024)
XLSTM_TRAIN_STEPS = 6


def family_kernels(cfg) -> tuple:
    """The kernels (``train_wrappers`` names) a training step of the family
    launches: the norms and the attention kernels, or the norms and the
    sLSTM scan (xLSTM); whisper's LayerNorms take no K1."""
    if cfg.family == "xlstm":
        return ("rmsnorm", "rmsnorm_bwd", "slstm_scan", "slstm_scan_bwd")
    if cfg.family == "whisper":
        return ("flash_attention", "flash_attention_bwd")
    return ("rmsnorm", "rmsnorm_bwd", "flash_attention", "flash_attention_bwd")


def train_wrappers() -> dict:
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_bwd
    from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm, rmsnorm_bwd
    from repro_torch.kernels.slstm_scan.ops import slstm_scan, slstm_scan_bwd

    return {"rmsnorm": fused_rmsnorm, "rmsnorm_bwd": rmsnorm_bwd,
            "flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
            "slstm_scan": slstm_scan, "slstm_scan_bwd": slstm_scan_bwd}


def zero_counts(ws: dict) -> None:
    for w in ws.values():
        w.launches = 0


# K2's logsumexp output against torch.logsumexp of the f32 scores: the
# kernel sums exp2 of log2e-scaled scores in another order; values of ~1-10
LSE_TOL = 1e-4


def scores_lse(q, k, causal: bool, scale: float | None = None):
    """Each row's logsumexp of the scaled scores, in f32: what K2's forward
    writes through its optional ``lse`` pointer."""
    import torch

    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     k.float().repeat_interleave(q.shape[1] // k.shape[1], 1))
    s = s * (q.shape[-1] ** -0.5 if scale is None else scale)
    if causal:
        s = s.masked_fill(torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device).triu(1),
                          float("-inf"))
    return torch.logsumexp(s, -1)


def check_forward_lse(what: str, q, k, v, causal: bool, scale: float | None = None,
                      out=None):
    """K2's forward with its logsumexp output: the output must equal the
    same call's without it (and ``out``, where given) bit for bit, and the
    logsumexp ``scores_lse``.  Returns (output, lse)."""
    import torch

    from repro_torch.kernels.flash_attention.ops import _launch_fwd

    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    o = _launch_fwd(q, k, v, causal, scale, lse)
    if not torch.equal(o, _launch_fwd(q, k, v, causal, scale, None)) or \
            out is not None and not torch.equal(o, out):
        fail(f"{what}: the forward's output differs with its logsumexp output")
    check_close(f"{what} lse", lse, scores_lse(q, k, causal, scale), "float32", tol=LSE_TOL)
    return o, lse


def phase_backward_kernels(dev, gen, rnd, dts) -> dict:
    """K1-bwd and K2-bwd against their plain backwards on the card: K1-bwd
    in every forward mode at D = 48-8192 and R = 1-8192 (qwen2-1.5b's
    training rows: B * S = 512 and 8192 at D = 1536; the 100m reductions'
    D = 512), twice each (bit for
    bit the same); K2-bwd through the autograd Function at the tile edges
    (``tests/_attention_edges.py``, causal or not, hd 64/128, and at
    gemma's hd 256 G 8, qwen3-moe's hd 128 G 16 and zamba2's hd 80 G 1),
    the cross-attention shapes (Sq != Sk, non-causal) and the training
    paths' shapes (``TRAIN_FLASH``); K2's forward at each case also with
    its logsumexp output (``check_forward_lse``).  Timed beside their bound
    and the library's backward (autograd through ``F.rms_norm`` of the
    added input; through ``F.scaled_dot_product_attention``), and held
    against the plain backward at the timed shapes too."""
    import torch
    import torch.nn.functional as F

    from _attention_edges import (CROSS_FLASH, GEMMA_G, GEMMA_HD, GEMMA_KV, MOE_G, MOE_HD,
                                  MOE_KV, TRAIN_FLASH, ZAMBA_G, ZAMBA_HD, ZAMBA_KV,
                                  flash_edge_cases)

    from repro_torch.kernels.flash_attention.ops import (_launch_fwd, flash_attention,
                                                         flash_attention_bwd,
                                                         flash_attention_bwd_cost,
                                                         flash_attention_bwd_ref)
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_bwd, rmsnorm_bwd_cost, rmsnorm_bwd_ref

    report = {}
    modes = {"add": (True, False, True), "add-gemma": (True, True, True),
             "add-no-out": (True, False, False), "norm": (False, False, False),
             "norm-gemma": (False, True, True)}
    worst = {}
    for dname, dt in dts.items():
        for d in (48, 52, 128, 256, 512, 1536, 2048, 4096, 8192):
            for rows in (1, 37, 512, 8192 if d <= 2048 else 384):
                for mode, (with_r, gemma, want) in modes.items():
                    x = rnd(rows, d, dt=dt)
                    r = rnd(rows, d, dt=dt) if with_r else None
                    sc = torch.randn(d, generator=gen, device=dev)
                    dy = rnd(rows, d, dt=dt)
                    dh = rnd(rows, d, dt=dt) if with_r and want else None
                    dx, ds = rmsnorm_bwd(x, r, sc, dy, dh, gemma=gemma)
                    rx, rs = rmsnorm_bwd_ref(x, r, sc, dy, dh, gemma=gemma)
                    what = f"rmsnorm_bwd {dname} R={rows} D={d} {mode}"
                    e = check_close(f"{what} dx", dx, rx, dname)
                    # dscale sums up to 8192 rows: 10x the f32 tolerance
                    check_close(f"{what} dscale", ds, rs, "float32",
                                tol=TOL[dname] * (10 if dname == "float32" else 1))
                    dx2, ds2 = rmsnorm_bwd(x, r, sc, dy, dh, gemma=gemma)
                    if not (torch.equal(dx, dx2) and torch.equal(ds, ds2)):
                        fail(f"{what}: a second call differs (not deterministic)")
                    worst[dname] = max(worst.get(dname, 0.0), e)
        log(f"rmsnorm_bwd {dname} D=48..8192 R=1..8192 modes {'/'.join(modes)}: max_abs_err "
            f"{worst[dname]:.3e}, every call repeated bit for bit")
    times = {}
    for rows, d in ((8192, 1536), (512, 1536), (2048, 512)):
        x, r, dy, dh = (rnd(rows, d, dt=torch.bfloat16) for _ in range(4))
        sc = torch.randn(d, generator=gen, device=dev)
        xr = x.float().add(r.float()).to(torch.bfloat16).requires_grad_()
        sc16 = sc.to(torch.bfloat16).requires_grad_()
        y = F.rms_norm(xr, (d,), sc16, 1e-6)
        what = f"rmsnorm_bwd bf16 R={rows} D={d} (add, residual grad in)"
        for n, a, w in zip(("dx", "dscale"), rmsnorm_bwd(x, r, sc, dy, dh),
                           rmsnorm_bwd_ref(x, r, sc, dy, dh)):
            check_close(f"{what} (timed) {n}", a, w, "bfloat16")
        t = timings(lambda: rmsnorm_bwd(x, r, sc, dy, dh),
                    lambda: rmsnorm_bwd_ref(x, r, sc, dy, dh),
                    lambda: torch.autograd.grad(y, [xr, sc16], dy, retain_graph=True))
        t["bound_ms"], t["bound_by"] = cost_bound(rmsnorm_bwd_cost(rows, d, 2), "bfloat16")
        log_timings(what, t, "autograd of F.rms_norm")
        times[f"R={rows} D={d} bf16"] = t
    report["rmsnorm_bwd"] = {"max_abs_err": worst["bfloat16"], "shape": "R=8192 D=1536 bf16",
                             **times["R=8192 D=1536 bf16"], "shapes": times}

    def case(b, h, kv, sq, sk, hd, causal, dt):
        q = rnd(b, sq, h, hd, dt=dt).transpose(1, 2).requires_grad_()
        k = rnd(b, sk, kv, hd, dt=dt).transpose(1, 2).requires_grad_()
        v = rnd(b, sk, kv, hd, dt=dt).transpose(1, 2).requires_grad_()
        o = flash_attention(q, k, v, causal=causal)
        do = rnd(b, h, sq, hd, dt=dt)
        got = torch.autograd.grad(o, [q, k, v], do)
        want = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(), do,
                                       causal=causal)
        what = f"flash_attention_bwd {dt} B={b} H={h} KV={kv} Sq={sq} Sk={sk} hd={hd} " \
               f"causal={causal}"
        check_forward_lse(what, q.detach(), k.detach(), v.detach(), causal, out=o.detach())
        return max(check_close(f"{what} {n}", a, w, str(dt).split(".")[-1])
                   for n, a, w in zip(("dq", "dk", "dv"), got, want))

    worst = {}
    for dname, dt in dts.items():
        n = 0
        for sq, sk, g, b, kv in flash_edge_cases():
            for hd in (64, 128):
                for causal in (True, False):
                    worst[dname] = max(worst.get(dname, 0.0),
                                       case(b, g * kv, kv, sq, sk, hd, causal, dt))
                    n += 1
        for g, kv, hd in ((GEMMA_G, GEMMA_KV, GEMMA_HD), (MOE_G, MOE_KV, MOE_HD),
                          (ZAMBA_G, ZAMBA_KV, ZAMBA_HD)):
            for sq, sk in ((1, 1), (65, 65), (100, 130), (130, 77), (384, 384)):
                for causal in (True, False):
                    worst[dname] = max(worst[dname], case(1, g * kv, kv, sq, sk, hd, causal, dt))
                    n += 1
        for b, h, kv, sq, sk, hd in CROSS_FLASH:
            worst[dname] = max(worst[dname], case(b, h, kv, sq, sk, hd, False, dt))
            n += 1
        for b, h, kv, sq, sk, hd, causal in [(2, 12, 2, 256, 256, 128, True), *TRAIN_FLASH]:
            worst[dname] = max(worst[dname], case(b, h, kv, sq, sk, hd, causal, dt))
            n += 1
        log(f"flash_attention_bwd {dname}: {n} cases (tile edges causal or not at hd 64/128, "
            f"hd 256 G 8, hd 128 G 16, hd 80 G 1, cross shapes, B=2 S=256, the training paths' "
            f"shapes), each forward's logsumexp within {LSE_TOL} and its output unchanged: "
            f"max_abs_err {worst[dname]:.3e}")
    times = {}
    for b, s in (TRAIN_BF16_BS, (1, 384)):
        h, kv, hd = 12, 2, 128
        q = rnd(b, s, h, hd, dt=torch.bfloat16).transpose(1, 2)
        k, v = (rnd(b, s, kv, hd, dt=torch.bfloat16).transpose(1, 2) for _ in range(2))
        lse = torch.empty((b, h, s), device=dev)
        o = _launch_fwd(q, k, v, True, None, lse)
        do = rnd(b, h, s, hd, dt=torch.bfloat16)
        what = f"flash_attention_bwd bf16 B={b} H=12 KV=2 S={s} hd=128 causal"
        for n, a, w in zip(("dq", "dk", "dv"), flash_attention_bwd(q, k, v, o, do, lse),
                           flash_attention_bwd_ref(q, k, v, o, do, causal=True)):
            check_close(f"{what} (timed) {n}", a, w, "bfloat16")
        qc, kc, vc = (t.detach().contiguous().requires_grad_() for t in (q, k, v))
        oc = F.scaled_dot_product_attention(qc, kc, vc, is_causal=True, enable_gqa=True)
        t = timings(lambda: flash_attention_bwd(q, k, v, o, do, lse, causal=True),
                    lambda: flash_attention_bwd_ref(q, k, v, o, do, causal=True),
                    lambda: torch.autograd.grad(oc, [qc, kc, vc], do, retain_graph=True),
                    plain_iters=5)
        t["bound_ms"], t["bound_by"] = cost_bound(
            flash_attention_bwd_cost(b, h, kv, s, s, hd, 2), "bfloat16")
        log_timings(what, t, "autograd of SDPA")
        times[f"B={b} S={s}"] = t
    key = f"B={TRAIN_BF16_BS[0]} S={TRAIN_BF16_BS[1]}"
    report["flash_attention_bwd"] = {"max_abs_err": worst["bfloat16"],
                                     "shape": f"{key} H=12 KV=2 hd=128 causal bf16",
                                     **times[key], "shapes": times}
    return report


def leaf_group(path: str) -> str:
    for group, keys in (("slstm", ("slstm",)), ("mlstm", ("mlstm",)),
                        ("norms", ("ln1", "ln2", "final_norm", "ln_m", "ln_s", "ln_s2")),
                        ("attention", ("attn",)), ("mlp", ("mlp",)),
                        ("embedding", ("tok_embed", "lm_head"))):
        if any(f"'{k}'" in path for k in keys):
            return group
    return "other"


def train_step_counts(cfg, steps: int = 1) -> dict:
    """The kernel launches ``steps`` training steps imply: dense, the
    forward's 2L + 1 K1 and L K2 calls, the layers' 2L and L again where
    remat recomputes them; xLSTM, the forward's ``norms_per_call`` K1 calls
    and one K5 per sLSTM block, each mLSTM block's two norms again where
    remat recomputes it (the sLSTM blocks are not under remat); and one
    backward call for each forward call of the step."""
    L = cfg.num_layers
    again = cfg.remat != "none"
    if cfg.family == "xlstm":
        ns = L // cfg.slstm_every if cfg.slstm_every > 0 else 0
        fwd = norms_per_call(cfg)
        return {"rmsnorm": steps * (fwd + 2 * (L - ns) * again), "rmsnorm_bwd": steps * fwd,
                "flash_attention": 0, "flash_attention_bwd": 0,
                "slstm_scan": steps * ns, "slstm_scan_bwd": steps * ns}
    return {"rmsnorm": steps * (2 * L + 1 + 2 * L * again),
            "rmsnorm_bwd": steps * (2 * L + 1),
            "flash_attention": steps * (L + L * again),
            "flash_attention_bwd": steps * L, "slstm_scan": 0, "slstm_scan_bwd": 0}


def phase_train_f32(dev, arch: str) -> dict:
    """Phase 26: a full-width model in f32 (qwen2-1.5b: all 28 layers;
    xlstm-1.3b: all 48 blocks; B 2, S 256, remat ``block``): the loss and
    every gradient leaf, kernel path against ``plain=True`` on the same
    weights and tokens, the max relative error per leaf group, and the
    launches the remat policy implies."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.common import tree_items

    cfg = get_config(arch).scaled(param_dtype="float32", compute_dtype="float32")
    fast, plain = Model(cfg, device=dev), Model(cfg, device=dev, plain=True)
    params = fast.init(SEED)
    leaves = [p.requires_grad_() for _, p in tree_items(params)]
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    b, s = TRAIN_F32_BS
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), device=dev, generator=gen)}
    ws = train_wrappers()
    zero_counts(ws)
    loss_k = fast.loss(params, batch)
    grads_k = torch.autograd.grad(loss_k, leaves)
    torch.cuda.synchronize()
    counts = {n: w.launches for n, w in ws.items()}
    loss_p = plain.loss(params, batch)
    grads_p = torch.autograd.grad(loss_p, leaves)
    log(f"f32 {arch} train B={b} S={s} remat={cfg.remat}: loss kernel "
        f"{loss_k.item():.6f}, plain {loss_p.item():.6f}")
    if not torch.isfinite(loss_k) or abs(float(loss_k) - float(loss_p)) > \
            GRAD_F32_REL_TOL * abs(float(loss_p)):
        fail(f"f32 {arch} train: loss {float(loss_k)} vs plain {float(loss_p)}")
    rel = {}
    for (path, _), gk, gp in zip(tree_items(params), grads_k, grads_p):
        if not torch.isfinite(gk).all():
            fail(f"f32 {arch} train: non-finite gradient {path}")
        scale = float(gp.abs().max())
        if scale == 0:
            fail(f"f32 {arch} train: zero plain gradient {path}")
        group = leaf_group(path)
        rel[group] = max(rel.get(group, 0.0), max_err(gk, gp) / scale)
    log(f"f32 {arch} train: max relative gradient error by leaf group (each leaf's "
        f"max |kernel - plain| over its largest plain gradient): "
        + ", ".join(f"{g} {e:.3e}" for g, e in sorted(rel.items()))
        + f" (bound {GRAD_F32_REL_TOL})")
    if max(rel.values()) > GRAD_F32_REL_TOL:
        fail(f"f32 {arch} train: gradients differ beyond {GRAD_F32_REL_TOL}: {rel}")
    want = train_step_counts(cfg)
    log(f"f32 {arch} train: launches in one loss + backward {counts} (remat "
        f"{cfg.remat} implies {want})")
    if counts != want:
        fail(f"f32 {arch} train: launches {counts} != {want}")
    del params, leaves, grads_k, grads_p, fast, plain
    torch.cuda.empty_cache()
    return counts


def profile_train_step(step, state, batch, what: str = "bf16 train step") -> dict:
    """Device ms by kernel name in one training step (``torch.profiler``),
    grouped: attention forward and backward, the norm and its backward, the
    sLSTM scan and its backward, matrix products, the optimizer's
    elementwise passes, the rest."""
    by = device_breakdown(lambda: step(state, batch), iters=1, warm=0)
    if EVENTS_KEY in by:
        log(f"{what} device ms by group: not measured (no profiler activity); "
            f"whole step {by[EVENTS_KEY][0]:.2f} ms between CUDA events")
        return {"whole step (CUDA events)": by[EVENTS_KEY][0]}
    groups = {}
    for name, (ms, n) in by.items():
        low = name.lower()
        g = ("K5-bwd" if "slstm_scan_bwd" in low else
             "K5" if "slstm_scan" in low else
             "K2-bwd" if "bwd_dkdv" in low or "bwd_dq" in low or "bwd_delta" in low else
             "K2" if "flash_fwd" in low else
             "K1-bwd" if "rmsnorm_bwd" in low or "rmsnorm_dscale" in low else
             "K1" if "rmsnorm_fwd" in low else
             "matmul" if "gemm" in low or "sm90_" in low or "cutlass" in low or "nvjet" in low
             else "foreach (optimizer)" if "foreach" in low or "multi_tensor" in low
             else "other")
        ms0, n0 = groups.get(g, (0.0, 0))
        groups[g] = (ms0 + ms, n0 + n)
    total = sum(ms for ms, _ in groups.values())
    log(f"{what} device ms by group: " + "; ".join(
        f"{g} {ms:.2f} ({100 * ms / total:.1f}%, {n} kernels)"
        for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])))
    log_breakdown(f"{what} (top kernels)", dict(sorted(by.items(),
                                                               key=lambda kv: -kv[1][0])[:12]))
    return {g: ms for g, (ms, _) in groups.items()}


def run_train(dev, arch: str, tc, label: str) -> tuple[dict, list, dict]:
    """Phase 27's measured run: ``Trainer`` on full-width ``arch`` (bf16
    params with f32 master and moments) over the zero-copy data plane, as
    ``tc`` says.  The launches must be ``train_step_counts``' (the remat
    policy's count; K5 and K5-bwd once per sLSTM block a step) and the
    losses finite and falling.  Prints the step ms (median of steps 3 on),
    tokens/s, the model-FLOP share, peak device memory and the first and
    last losses, each line starting with ``label``, then one more step's
    device time by kernel group (the run's last state; not part of any
    result above).  Returns the launches, the metrics log and those
    measurements."""
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import HW
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.runtime.trainer import Trainer

    cfg = get_config(arch)
    b, s, steps = tc.batch, tc.seq_len, tc.total_steps
    ws = train_wrappers()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    tr = Trainer(Model(cfg, device=dev), tc)
    zero_counts(ws)
    tr.run()
    torch.cuda.synchronize()
    counts = {n: w.launches for n, w in ws.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    n_params = sum(t.numel() for t in _leaves(tr.state["params"]))
    log(f"bf16 {arch} train: {n_params / 1e9:.4f} B parameters (param_count "
        f"{cfg.param_count() / 1e9:.4f} B), B={b} S={s}, remat {cfg.remat}: {steps} steps in "
        f"{time.monotonic() - t0:.1f} s (state built, checkpoints' snapshots included)")
    recs = tr.metrics_log
    state, step_fn = tr.state, make_train_step(tr.model, tr.opt)
    tr.close()                                   # joins the last checkpoint's writer
    want = train_step_counts(cfg, steps)
    if counts != want:
        fail(f"bf16 {arch} train: launches {counts} != {want}")
    losses = [r["loss"] for r in recs]
    if not all(map(lambda x: x == x and abs(x) < 1e4, losses)) or not losses[-1] < losses[0]:
        fail(f"bf16 {arch} train: losses {losses} are not finite or do not fall")
    step_s = statistics.median(r["dt"] for r in recs[2:])
    tokens = b * s
    share = 6 * cfg.param_count() * tokens / (step_s * HW.PEAK_BF16_FLOPS)
    counted = meta_count(arch, "train", b, s)
    counted_share = counted.flops / (step_s * HW.PEAK_BF16_FLOPS)
    roof_s = counted.flops_bf16 / HW.PEAK_BF16_FLOPS + counted.flops_f32 / HW.PEAK_F32_FLOPS
    print(f"{label} step ms (median of steps 3-{steps}): {step_s * 1e3:.2f}", flush=True)
    print(f"{label} tokens/s: {tokens / step_s:.0f}", flush=True)
    print(f"{label} model-FLOP share (6 N tokens / (step s x 989e12)): {share:.4f}",
          flush=True)
    print(f"{label} model-FLOP share from the counted FLOPs ({counted.flops:.4e} a step, "
          f"{counted.flops_f32:.4e} of them f32; counted / (step s x 989e12)): "
          f"{counted_share:.4f}; the count's compute bound (bf16 at 989e12, f32 at 67e12) "
          f"{roof_s * 1e3:.2f} ms, {roof_s / step_s:.4f} of the step", flush=True)
    print(f"{label} peak device memory GB: {peak / 1e9:.2f}", flush=True)
    print(f"{label} the count's peak of live storages GB: {counted.memory['peak_bytes'] / 1e9:.2f}"
          f" beside max_memory_allocated {peak / 1e9:.2f} (gap "
          f"{(peak - counted.memory['peak_bytes']) / 1e9:+.2f})", flush=True)
    print(f"{label} loss step 1: {losses[0]:.6f}  step {steps}: {losses[-1]:.6f}", flush=True)
    log(f"bf16 {arch} train: launches over {steps} steps {counts} (as train_step_counts "
        f"says); losses {[round(x, 4) for x in losses]}; step s "
        f"{[round(r['dt'], 4) for r in recs]}; grad norms "
        f"{[round(r['grad_norm'], 4) for r in recs]}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    groups = profile_train_step(step_fn, state,
                                {"tokens": torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                                                         generator=gen)},
                                f"bf16 {arch} train step")
    return counts, recs, {"step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
                          "model_flop_share": share, "counted_flop_share": counted_share,
                          "counted_flops": counted.flops,
                          "counted_peak_gb": counted.memory["peak_bytes"] / 1e9,
                          "peak_gb": peak / 1e9, "batch": [b, s],
                          "losses": losses, "groups_ms": groups}


def phase_train_bf16(dev) -> tuple[dict, dict]:
    """Phase 27: full-width qwen2-1.5b through ``run_train`` (B 8 x S 1024,
    8 steps with a checkpoint at step 4); the step-8 checkpoint is then
    removed and a second ``Trainer`` on the same directory resumes at step
    5 from the one at step 4, and its losses for steps 5-8 must equal the
    uninterrupted run's within ``RESUME_LOSS_TOL``, while each planted
    restore fault of ``RESUME_FAULTS`` must move them beyond it."""
    import shutil

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_config(TRAIN_ARCH)
    b, s = TRAIN_BF16_BS
    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    tc = TrainerConfig(batch=b, seq_len=s, total_steps=TRAIN_STEPS, warmup=2,
                       ckpt_every=TRAIN_CKPT_AT, ckpt_dir=str(ckpt), ckpt_keep=2, log_every=1,
                       seed=SEED)
    counts, straight, measured = run_train(dev, TRAIN_ARCH, tc, "train")
    losses = measured["losses"]

    shutil.rmtree(ckpt / f"step_{TRAIN_STEPS:010d}")
    t0 = time.monotonic()
    tr2 = Trainer(Model(cfg, device=dev), tc)
    tr2.run()
    tr2.close()
    resumed = tr2.metrics_log
    log(f"bf16 {TRAIN_ARCH} train: resumed from step {TRAIN_CKPT_AT} and ran to "
        f"{TRAIN_STEPS} in {time.monotonic() - t0:.1f} s (restore included)")
    if [r["step"] for r in resumed] != list(range(TRAIN_CKPT_AT + 1, TRAIN_STEPS + 1)):
        fail(f"resumed run's steps {[r['step'] for r in resumed]}")
    diffs = [abs(a["loss"] - b_["loss"]) for a, b_ in zip(resumed, straight[TRAIN_CKPT_AT:])]
    log(f"bf16 {TRAIN_ARCH} train: resumed losses {[r['loss'] for r in resumed]} against "
        f"uninterrupted {losses[TRAIN_CKPT_AT:]}: max |diff| {max(diffs):.3e} (bound "
        f"{RESUME_LOSS_TOL})")
    if max(diffs) > RESUME_LOSS_TOL:
        fail(f"resumed losses differ from the uninterrupted run's by {max(diffs):.3e}")
    del tr2
    shutil.rmtree(ckpt / f"step_{TRAIN_STEPS:010d}")   # the resumed run's, saved at its end
    faults = {}
    for fault in RESUME_FAULTS:
        t0 = time.monotonic()
        got = resume_with_fault(cfg, tc, dev, fault)
        faults[fault] = max(abs(a - b_) for a, b_ in zip(got, losses[TRAIN_CKPT_AT:]))
        log(f"bf16 {TRAIN_ARCH} train: resumed with a planted fault, {fault}: losses {got}, "
            f"max |diff| {faults[fault]:.3e} ({time.monotonic() - t0:.1f} s, restore included)")
    if min(faults.values()) <= RESUME_LOSS_TOL:
        fail(f"a planted restore fault stays within the resume bound {RESUME_LOSS_TOL}: {faults}")
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts, measured


def phase_train_xlstm_bf16(dev) -> tuple[dict, dict]:
    """Phase 27, xLSTM: full-width xlstm-1.3b (48 blocks, [7 mLSTM : 1 sLSTM]
    x 6, d 2048, 4 heads, vocab 50,304) through ``run_train``
    (``XLSTM_TRAIN_BS``, ``XLSTM_TRAIN_STEPS`` steps, no checkpoint), with
    K5 and K5-bwd named in the step's device time."""
    import shutil

    import torch

    from repro_torch.runtime.trainer import TrainerConfig

    b, s = XLSTM_TRAIN_BS
    ckpt = ROOT / "build" / "train_ckpt_xlstm"      # stays empty: ckpt_every=0
    shutil.rmtree(ckpt, ignore_errors=True)
    tc = TrainerConfig(batch=b, seq_len=s, total_steps=XLSTM_TRAIN_STEPS, warmup=2,
                       ckpt_every=0, ckpt_dir=str(ckpt), log_every=1, seed=SEED)
    counts, _, measured = run_train(dev, XLSTM_ARCH, tc, "xlstm train")
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts, measured


def resume_with_fault(cfg, tc, dev, fault: str) -> list:
    """Steps 5-8's losses resumed from the step-4 checkpoint with one of
    ``RESUME_FAULTS`` planted just after the restore; no checkpoint is
    saved.  What the resume bound exists to catch."""
    import torch

    from repro_torch.models import Model
    from repro_torch.models.common import tree_items
    from repro_torch.runtime.trainer import Trainer

    tr = Trainer(Model(cfg, device=dev), tc)
    tr._init_or_restore()
    if tr.step_num != TRAIN_CKPT_AT:
        fail(f"resume with a fault: restored step {tr.step_num}, not {TRAIN_CKPT_AT}")
    st = tr.state
    with torch.no_grad():
        if fault == "moments zeroed":
            for t in [*_leaves(st["m"]), *_leaves(st["v"])]:
                t.zero_()
        elif fault == "master weights from the bf16 params":
            params = dict(tree_items(st["params"]))
            for path, w in tree_items(st["master"]):
                w.copy_(params[path])
        elif fault == "optimizer step one ahead":
            st["step"].add_(1)
        elif fault == "data cursor one ahead":
            tr._next_batch()
        else:
            raise ValueError(fault)
    losses = []
    for _ in range(TRAIN_STEPS - TRAIN_CKPT_AT):
        batch = {"tokens": torch.from_numpy(tr._next_batch()["tokens"]).to(dev)}
        st, m = tr._step_fn(st, batch)
        losses.append(float(m["loss"]))
    tr.close()
    return losses


def family_batch(cfg, gen) -> dict:
    import torch

    b, s = FAMILY_BS
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), device=gen.device,
                                     generator=gen)}
    if cfg.family in ("whisper", "mllama"):
        batch.update(cross_input(cfg, b, gen))
    return batch


def phase_train_families(dev) -> dict:
    """Phase 28: the 100m reduction of each family (head dim 64; xLSTM's
    d 512 over 8 heads, one sLSTM block) in bf16, 3 training steps
    (``make_train_step``, AdamW) on one random batch of 4 x 256 each, kernel
    path against plain path at step 1 (loss and grad norm, within
    ``FAMILY_*_REL_TOL``), every kernel of the family's step launched."""
    import torch

    from repro_torch.configs import model_100m
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import AdamW

    ws = train_wrappers()
    launches = {}
    for arch in FAMILY_TRAIN:
        cfg = model_100m(arch).scaled(param_dtype="bfloat16", compute_dtype="bfloat16")
        gen = torch.Generator(device=dev).manual_seed(SEED)
        batch = family_batch(cfg, gen)
        out = {}
        for name, plain in (("plain", True), ("kernel", False)):
            model = Model(cfg, device=dev, plain=plain)
            params = model.init(SEED)
            if cfg.family == "mllama":
                for k, g in MLLAMA_GATES.items():
                    params["cross_layers"][k].fill_(g)
            state = AdamW(lr=1e-4).init(params)
            step = make_train_step(model, AdamW(lr=1e-4))
            if not plain:
                zero_counts(ws)
            recs = []
            for _ in range(FAMILY_STEPS if not plain else 1):
                state, m = step(state, batch)
                recs.append((float(m["loss"]), float(m["grad_norm"])))
            if not plain:
                torch.cuda.synchronize()
                launches[f"{arch} train 100m"] = {n: w.launches for n, w in ws.items()}
            out[name] = recs
            del state, params, model
        (lk, gk), (lp, gp) = out["kernel"][0], out["plain"][0]
        ok = abs(lk - lp) <= FAMILY_LOSS_REL_TOL * abs(lp) and \
            abs(gk - gp) <= FAMILY_GNORM_REL_TOL * abs(gp)
        log(f"bf16 {arch} 100m train ({cfg.num_layers} layers, hd {cfg.head_dim}): step 1 loss "
            f"kernel {lk:.5f} plain {lp:.5f}, grad norm kernel {gk:.5f} plain {gp:.5f}; losses "
            f"{[round(x, 5) for x, _ in out['kernel']]}; launches "
            f"{launches[f'{arch} train 100m']}")
        if not ok or not all(x == x for x, _ in out["kernel"]):
            fail(f"{arch} 100m train: kernel path {out['kernel'][0]} vs plain {out['plain'][0]}")
        if not all(launches[f"{arch} train 100m"][n] > 0 for n in family_kernels(cfg)):
            fail(f"{arch} 100m train: a kernel was not launched: {launches[f'{arch} train 100m']}")
    return launches


class BackwardCalls:
    """Stands in for a backward kernel's wrapper (``rmsnorm_bwd``,
    ``flash_attention_bwd``, ``slstm_scan_bwd``) in its module while the training phases run
    (the autograd Functions call the module's name), recording each call's
    tensors as (dtype, shape, strides) with its other arguments.  Its
    ``launches`` is the wrapped function's, so the wrapper's own count
    moves as before."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.seen: dict = {}

    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.fn.launches = n

    def __call__(self, *args, **kw):
        key = (tuple((a.dtype, tuple(a.shape), a.stride()) if hasattr(a, "stride") else a
                     for a in args), tuple(sorted(kw.items())))
        self.seen[key] = self.seen.get(key, 0) + 1
        return self.fn(*args, **kw)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def phase_train_shapes(dev, calls: dict) -> dict:
    """Phase 29: every (dtype, shape, strides, mode) K1-bwd, K2-bwd and
    K5-bwd ran on in phases 26-28, again on unit-scale random inputs laid
    out as the path's (``as_strided`` over a fresh buffer) against the plain
    backward at ``TOL`` (dscale, a sum over up to 8192 rows, at 10x in f32;
    K5-bwd as in phase 3, its forward inputs fresh and dense from the zero
    state through K5 in save mode, its cotangents as the path passed them,
    None where it passed None), each call twice bit for bit, and K2's
    forward with its logsumexp output as in phase 3.  The paths' own
    gradients are too small to hold at an absolute tolerance (a mean over up
    to 8192 tokens), so the layouts are replayed, not the values."""
    import torch

    from repro_torch.kernels.flash_attention.ops import (flash_attention_bwd,
                                                         flash_attention_bwd_ref)
    from repro_torch.kernels.rmsnorm.ops import rmsnorm_bwd, rmsnorm_bwd_ref
    from repro_torch.kernels.slstm_scan.ops import (_launch_fwd, slstm_scan_bwd,
                                                    slstm_scan_bwd_ref)

    gen = torch.Generator(device=dev).manual_seed(SEED + 29)

    def fresh(spec):
        if spec is None:
            return None
        dt, shape, stride = spec
        n = 1 + sum((d - 1) * st for d, st in zip(shape, stride)) if all(shape) else 0
        return torch.randn(n, generator=gen, device=dev).to(dt).as_strided(shape, stride)

    def name(dt):
        return str(dt).split(".")[-1]

    out = {}
    worst = 0.0
    for (x, r, sc, dy, dh), kw in calls["rmsnorm_bwd"].seen:
        xt, rt, dyt, dht = fresh(x), fresh(r), fresh(dy), fresh(dh)
        sct = torch.randn(sc[1], generator=gen, device=dev)
        kw = dict(kw)
        got = rmsnorm_bwd(xt, rt, sct, dyt, dht, **kw)
        want = rmsnorm_bwd_ref(xt, rt, sct, dyt, dht, **kw)
        what = f"rmsnorm_bwd path shape {name(x[0])} x {x[1]} strides {x[2]} residual " \
               f"{r is not None} dh {dh is not None} {kw}"
        worst = max(worst, check_close(f"{what} dx", got[0], want[0], name(x[0])))
        check_close(f"{what} dscale", got[1], want[1], "float32",
                    tol=TOL[name(x[0])] * (10 if x[0] == torch.float32 else 1))
        again = rmsnorm_bwd(xt, rt, sct, dyt, dht, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{what}: a second call differs (not deterministic)")
    out["rmsnorm_bwd"] = {"path_shapes": len(calls["rmsnorm_bwd"].seen),
                          "path_max_abs_err": worst}
    log(f"rmsnorm_bwd at the {len(calls['rmsnorm_bwd'].seen)} layouts and modes phases 26-28 "
        f"ran, fresh inputs: max_abs_err {worst:.3e} (dx), every call repeated bit for bit")
    worst = 0.0
    for (q, k, v, o, do, _), kw in calls["flash_attention_bwd"].seen:
        qt, kt, vt = fresh(q), fresh(k), fresh(v)
        kw = dict(kw)
        what = f"flash_attention_bwd path shape {name(q[0])} q {q[1]} k {k[1]} strides " \
               f"{q[2]} {k[2]} {v[2]} do {do[2]} {kw}"
        ot, lse = check_forward_lse(what, qt, kt, vt, kw["causal"], kw["scale"])
        if ot.stride() != o[2]:
            fail(f"{what}: the forward's output strides {ot.stride()} differ from the path's")
        dot = fresh(do)
        got = flash_attention_bwd(qt, kt, vt, ot, dot, lse, **kw)
        want = flash_attention_bwd_ref(qt, kt, vt, ot, dot, **kw)
        worst = max(worst, *(check_close(f"{what} {n}", a, w, name(q[0]))
                             for n, a, w in zip(("dq", "dk", "dv"), got, want)))
        again = flash_attention_bwd(qt, kt, vt, ot, dot, lse, **kw)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{what}: a second call differs (not deterministic)")
    out["flash_attention_bwd"] = {"path_shapes": len(calls["flash_attention_bwd"].seen),
                                  "path_max_abs_err": worst}
    worst = 0.0
    for args, kw in calls["slstm_scan_bwd"].seen:
        w, rest = args[0], args[5:]               # rest: hs, gates, cs, ns, ms, dhs, dh .. dm
        xdt = dict(kw)["x_dtype"]
        b, s, d = rest[0][1]
        what = f"slstm_scan_bwd path shape xg {name(xdt)} {(b, s, 4 * d)} w_hh {name(w[0])} " \
               f"{w[1]} cotangents {['-' if a is None else 'y' for a in rest[5:]]}"
        fwd_args = slstm_inputs(lambda *sh, dt: torch.randn(sh, generator=gen, device=dev).to(dt),
                                dev, b, s, d, w[1][0], xdt, False)
        fwd_args[1] = fwd_args[1].to(w[0])
        hs, _, saved = _launch_fwd(*fwd_args, True)
        cot = [None if a is None else fresh(a).float() for a in rest[5:]]
        got = slstm_bwd_call(slstm_scan_bwd, fwd_args, hs, saved, *cot)
        worst = max(worst, check_slstm_bwd(what, got, slstm_bwd_call(
            slstm_scan_bwd_ref, fwd_args, hs, saved, *cot)))
        if not all(map(torch.equal, got, slstm_bwd_call(slstm_scan_bwd, fwd_args, hs, saved,
                                                        *cot))):
            fail(f"{what}: a second call differs (not deterministic)")
    out["slstm_scan_bwd"] = {"path_shapes": len(calls["slstm_scan_bwd"].seen),
                             "path_max_abs_err": worst}
    log(f"flash_attention_bwd at the {len(calls['flash_attention_bwd'].seen)} layouts and modes "
        f"phases 26-28 ran, fresh inputs: max_abs_err "
        f"{out['flash_attention_bwd']['path_max_abs_err']:.3e}, the forward's logsumexp "
        f"within {LSE_TOL}, every call repeated bit for bit")
    log(f"slstm_scan_bwd at the {len(calls['slstm_scan_bwd'].seen)} dtypes, shapes and "
        f"cotangents phases 26-28 ran, fresh inputs from the zero state through K5 in save "
        f"mode: max_abs_err {worst:.3e}, every call repeated bit for bit")
    return out


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 30: the step builders on the card, the cost count, the dry run
# ---------------------------------------------------------------------------

STEP_BS = (4, PROMPT_MAX)        # B prompts of the served prompts' longest length
STEP_DECODE = 8                  # greedy steps after the prefill, into MAX_SEQ positions
# A greedy token of the kernel path may differ from the plain path's only at
# a near tie of the plain path's bf16 logits: its top logit within this of
# the kernel path's token's (the bf16 logit bounds of the CPU parity tests,
# tests/test_torch_model.py and tests/test_torch_xlstm.py)
STEP_TIE = {TRAIN_ARCH: 0.06, XLSTM_ARCH: 0.045}
COUNT_XLSTM_BS = (1, PROMPT_MAX)  # xlstm-1.3b's prefill, counted on the card and on meta
DRYRUN_TIMEOUT_S = 600
LONG_500K_WHY = "500k decode needs sub-quadratic attention (SSM/hybrid only)"


class DryRun:
    """The dry run's whole grid (``python -m repro_torch.launch.dryrun
    --all``) in a child process started after the build, at low priority,
    on one thread and with no card (it counts on ``meta``), while the card
    runs phases 3-29; records and log in ``build/dryrun``.  :meth:`finish`
    waits for it; if the script ends first the child is killed."""

    def __init__(self):
        import atexit
        import os
        import shutil

        self.out = ROOT / "build" / "dryrun"
        shutil.rmtree(self.out, ignore_errors=True)
        self.out.mkdir(parents=True)
        self.log_path = self.out / "dryrun.log"
        self.log = open(self.log_path, "w")
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1",
               "CUDA_VISIBLE_DEVICES": ""}
        self.t0 = time.time()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--out", str(self.out)],
            stdout=self.log, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT),
            preexec_fn=lambda: os.nice(10))
        atexit.register(self.stop)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def finish(self) -> tuple[int, float]:
        """(exit code, the grid's wall seconds: start to its log's last write)."""
        import os

        try:
            code = self.proc.wait(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            self.stop()
            fail(f"the dry run's grid did not end within {DRYRUN_TIMEOUT_S} s")
        self.log.close()
        return code, os.path.getmtime(self.log_path) - self.t0


_META_COUNTS: dict = {}


def meta_count(arch: str, kind: str, b: int, s: int):
    """The cost count on ``meta`` of full-width ``arch``'s ``kind`` step (B
    ``b`` x S ``s``; decode over a cache of ``s`` positions, prefill into
    ``MAX_SEQ``), as the dry run counts a cell; cached."""
    key = (arch, kind, b, s)
    if key not in _META_COUNTS:
        import torch

        from repro_torch.configs import get_config
        from repro_torch.launch.cost_analysis import count
        from repro_torch.launch.dryrun import count_cell
        from repro_torch.launch.steps import make_decode_step, make_prefill_step
        from repro_torch.models import Model, Workload

        model = Model(get_config(arch), device="meta")
        params = model.abstract_params()
        tokens = torch.empty((b, 1 if kind == "decode" else s), dtype=torch.int32,
                             device="meta")
        if kind == "train":
            out = count_cell(model, Workload("chip_smoke", s, b, "train"))
        elif kind == "prefill":
            out = count(make_prefill_step(model, Workload("chip_smoke", MAX_SEQ, b, kind)),
                        params, {"tokens": tokens})
        else:
            cache = model.abstract_cache(b, s)
            out = count(make_decode_step(model), params, cache, tokens)
        _META_COUNTS[key] = out
    return _META_COUNTS[key]


def same_count(what: str, card, meta) -> None:
    """The count of a step on the card must equal its count on ``meta``
    exactly, in FLOPs and in bytes."""
    if (card.flops, card.bytes) != (meta.flops, meta.bytes):
        diff = {k: (card.ops.get(k), meta.ops.get(k)) for k in sorted(set(card.ops) | set(meta.ops))
                if card.ops.get(k) != meta.ops.get(k)}
        fail(f"{what}: counted on the card {card.flops:.6e} FLOPs, {card.bytes:.6e} bytes; on "
             f"meta {meta.flops:.6e}, {meta.bytes:.6e}; ops that differ {diff}")
    log(f"{what}: counted on the card = counted on meta: {card.flops:.6e} FLOPs, "
        f"{card.bytes:.6e} bytes ({sum(v['calls'] for v in card.ops.values())} ops; kernels "
        f"{card.kernels()}); peak of live storages {card.memory['peak_bytes'] / 1e9:.3f} GB "
        f"on the card, {meta.memory['peak_bytes'] / 1e9:.3f} GB on meta")


def step_builders(dev, arch: str) -> dict:
    """``make_prefill_step`` and ``make_decode_step`` on full-width ``arch``
    in bf16: ``STEP_BS`` prompts prefilled into ``MAX_SEQ`` positions, then
    ``STEP_DECODE`` greedy steps, each fed the kernel path's token; the
    plain path (``Model(..., plain=True)``) runs the same steps on the same
    tokens and its greedy token (the argmax of its logits, as the builder
    takes it) must equal the kernel path's but at a near tie
    (``STEP_TIE``).  The launch counters, set to 0 just before the kernel
    path's first step and read after its last, must show the path's
    kernels.  Then the prefill step and a decode step over caches filled to
    capacity are counted on the card, each against its count on ``meta``.
    Returns the launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.cost_analysis import count
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import Model, Workload

    cfg = get_config(arch)
    b, s = STEP_BS
    model, plain = Model(cfg, device=dev), Model(cfg, device=dev, plain=True)
    params = model.init(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), device=dev, generator=gen,
                                     dtype=torch.int32)}
    wl = Workload("chip_smoke", MAX_SEQ, b, "prefill")
    prefill, decode = make_prefill_step(model, wl), make_decode_step(model)
    ws = wrappers()
    zero_counts(ws)
    logits, cache = prefill(params, batch)
    launches_prefill = {n: w.launches for n, w in ws.items()}
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    p_logits, p_cache = make_prefill_step(plain, wl)(params, batch)
    flips, equal = [], 0

    def held(step: int, got: torch.Tensor, ref_logits: torch.Tensor) -> None:
        nonlocal equal
        ref = ref_logits[:, -1].float()
        want = ref.argmax(-1)
        for r in range(b):
            g, w = int(got[r, 0]), int(want[r])
            if g == w:
                equal += 1
                continue
            gap = float(ref[r, w] - ref[r, g])
            if gap > STEP_TIE[arch]:
                fail(f"{arch} step builders: step {step} row {r}: kernel path's token {g}, "
                     f"plain path's {w}, its logits {gap:.4f} apart (near tie: <= "
                     f"{STEP_TIE[arch]})")
            flips.append((step, r, round(gap, 5)))

    held(0, tok, p_logits)
    tokens = [tok]
    for step in range(1, STEP_DECODE + 1):
        nxt, cache = decode(params, cache, tokens[-1])
        p_logits, p_cache = plain.decode_step(params, p_cache, tokens[-1])
        held(step, nxt, p_logits)
        tokens.append(nxt)
    torch.cuda.synchronize()
    launches = {n: w.launches for n, w in ws.items()}
    want = PATH_KERNELS[arch]
    if not all(launches[n] > 0 for n in want):
        fail(f"{arch} step builders: launches {launches}: each of {want} must be launched")
    log(f"{arch} step builders (bf16, B={b} S={s}, {STEP_DECODE} greedy steps): greedy tokens "
        f"equal to the plain path's in {equal} of {b * (STEP_DECODE + 1)}, near-tie flips "
        f"(step, row, plain logit gap) {flips or 'none'}; launches: prefill "
        f"{launches_prefill}, prefill and decode {launches}")
    log(f"{arch} step builders: tokens {torch.cat(tokens, 1).tolist()}")

    if arch == TRAIN_ARCH:
        mb, ms = STEP_BS
        card = count(prefill, params, batch)
        same_count(f"{arch} prefill step B={mb} S={ms}", card, meta_count(arch, "prefill", mb, ms))
        cache["len"].fill_(MAX_SEQ - 1)        # every row's K3 reads the whole cache
        card = count(decode, params, cache, tokens[-1])
        same_count(f"{arch} decode step B={mb} over {MAX_SEQ} positions (filled)", card,
                   meta_count(arch, "decode", mb, MAX_SEQ))
    else:
        cb, cs = COUNT_XLSTM_BS
        card = count(make_prefill_step(model, Workload("chip_smoke", MAX_SEQ, cb, "prefill")),
                     params, {"tokens": batch["tokens"][:cb, :cs]})
        same_count(f"{arch} prefill step B={cb} S={cs}", card, meta_count(arch, "prefill", cb, cs))
    del model, plain, params, cache, p_cache, logits, p_logits
    torch.cuda.empty_cache()
    return launches


def train_count_on_card(dev) -> None:
    """Full-width qwen2-1.5b's train step (bf16 params, f32 master weights
    and moments, AdamW) at phase 27's B x S, counted on the card, against
    its count on ``meta``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.cost_analysis import count
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.optim import AdamW

    b, s = TRAIN_BF16_BS
    cfg = get_config(TRAIN_ARCH)
    model, opt = Model(cfg, device=dev), AdamW(lr=3e-4)
    state = opt.init(model.init(SEED))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), device=dev, generator=gen,
                                     dtype=torch.int32)}
    card = count(make_train_step(model, opt), state, batch)
    same_count(f"{TRAIN_ARCH} train step B={b} S={s}", card, meta_count(TRAIN_ARCH, "train", b, s))
    del model, state, batch
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 31: the mesh at world size 1
# ---------------------------------------------------------------------------

MESH_ARCH = "qwen2-moe-a2.7b"            # served through _moe_serving under decode_rules
MESH_EQ_STEPS, MESH_STEPS = 3, 5         # hierarchical steps: held bit for bit, run
MESH_EF_CHECKED = 2                      # compressed steps held exactly, leaf by leaf
MESH_LR = 3e-4                           # TrainerConfig's default learning rate
# the compressed run's loss at step i against the uncompressed run's, both from
# one init on one fixed batch: int8 with one scale a tensor zeroes the
# smallest grads of a step (18.5% of full-width qwen2-1.5b's step-1 grad
# elements, 95.6% of its tied embedding's, whose in-batch rows set the scale),
# and AdamW moves each element by about lr whatever its grad's size, so the
# compressed run falls more slowly.  A bound of 6% of the uncompressed run's
# fall, set from scripts/ef_loss_gap.py on the CPU (2.07-2.12% at qwen2-1.5b's
# 100m reduction, 3.30% at the smoke width with its 151,936-token vocabulary),
# was refuted on the card: the same script at full width (NVIDIA H100 80GB
# HBM3, 700 W; B 8 x S 1024, lr 3e-4, seeds 0-2) read 12.45% at most (seed 0,
# step 5: 0.3068 of a 2.464 fall), 8.2% at step 3, and the same with the error
# memory dropped (error feedback has no time to act in 5 steps).  The bound is
# twice that reading, plus 1e-3 for bf16 rounding of the loss.  It holds the
# run to learning at most a quarter slower; a sum that loses the grads keeps
# the loss at step 1's, a gap of the whole fall.  The sums themselves are held
# exactly: against numpy and JAX in tests/test_torch_grad_compress.py, and
# here, at full width, against a plain quantisation of the step's own grads
# (mesh_hierarchical); this bound is a sanity check of what they do.
EF_GAP_FRAC, EF_GAP_ABS = 0.25, 1e-3
MESH_TRAINER_STEPS, MESH_TRAINER_CKPT = 6, 3


def mesh_serving(dev, card: str) -> dict:
    """Full-width ``MESH_ARCH`` in bf16: the 8 requests of phases 5-25
    (``make_requests``, seed 0), each prompt through ``make_prefill_step``
    into its slot of a batch of 8, then 31 greedy steps of
    ``make_decode_step`` and one ``Model.decode_step`` for the last logits,
    without a mesh and then on mesh (1, 1) ``("data", "model")`` under
    ``decode_rules``: the tokens, the prefill and last logits and every
    cache leaf equal bit for bit.  ``mlp._moe_serving`` is wrapped here to
    count its calls (one a layer a model call) and the collectives'
    counter must show its all-gather and psum each call; the kernels'
    counts, zeroed just before the mesh run, must show K1, K2 and K3."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import make_requests
    from repro_torch.launch.steps import decode_rules, make_decode_step, make_prefill_step
    from repro_torch.models import Model, Workload, mlp
    from repro_torch.sharding import use_mesh
    from repro_torch.sharding.partition import COLLECTIVE_CALLS

    cfg = get_config(MESH_ARCH)
    model = Model(cfg, device=dev)
    params = model.init(SEED)
    mesh = make_mesh((1, 1), ("data", "model"))
    rules = decode_rules(cfg, mesh)
    reqs = make_requests(N_REQUESTS, vocab=cfg.vocab_size, prompt_min=PROMPT_MIN,
                         prompt_max=PROMPT_MAX, max_new=MAX_NEW, seed=SEED)
    prompts = [torch.as_tensor(r.tokens, dtype=torch.int32, device=dev) for r in reqs]
    prefill = make_prefill_step(model, Workload("chip_smoke", MAX_SEQ, 1, "prefill"))
    decode = make_decode_step(model)

    def generate() -> dict:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        cache = model.init_cache(len(prompts), MAX_SEQ)
        first = []
        for slot, p in enumerate(prompts):
            logits, single = prefill(params, {"tokens": p[None]})
            model.splice_cache(cache, single, slot, p.numel())
            first.append(logits[0, -1])
        first = torch.stack(first)
        toks = [first.argmax(-1).to(torch.int32)[:, None]]
        torch.cuda.synchronize()
        t1 = time.monotonic()
        for _ in range(MAX_NEW - 1):
            nxt, cache = decode(params, cache, toks[-1])
            toks.append(nxt)
        last, cache = model.decode_step(params, cache, toks[-1])
        torch.cuda.synchronize()
        t2 = time.monotonic()
        return {"tokens": torch.cat(toks, 1), "prefill_logits": first, "last_logits": last,
                "cache": cache, "prefill_ms": 1e3 * (t1 - t0),
                "step_ms": 1e3 * (t2 - t1) / MAX_NEW}

    plain = generate()
    calls = [0]
    orig = mlp._moe_serving

    def counted(*args, **kwargs):
        calls[0] += 1
        return orig(*args, **kwargs)

    ws = wrappers()
    before = dict(COLLECTIVE_CALLS)
    mlp._moe_serving = counted
    try:
        zero_counts(ws)
        with use_mesh(mesh, rules):
            meshed = generate()
        torch.cuda.synchronize()
    finally:
        mlp._moe_serving = orig
    launches = {n: w.launches for n, w in ws.items()}
    coll = {k: COLLECTIVE_CALLS[k] - before.get(k, 0) for k in ("all_gather", "psum")}
    want = cfg.num_layers * (N_REQUESTS + MAX_NEW)      # 8 prefills, 31 + 1 steps
    if calls[0] != want or min(coll.values()) < want:
        fail(f"{MESH_ARCH} on the mesh: _moe_serving ran {calls[0]} times and the collectives "
             f"{coll}; want {want} each")
    if not all(launches[n] > 0 for n in ("rmsnorm", "flash_attention", "decode_attention")):
        fail(f"{MESH_ARCH} on the mesh: launches {launches}: K1, K2 and K3 must be launched")
    diffs = {k: max_err(meshed[k], plain[k]) for k in ("prefill_logits", "last_logits")}
    same = {k: torch.equal(meshed[k], plain[k])
            for k in ("tokens", "prefill_logits", "last_logits")}
    same["cache"] = all(torch.equal(a, b) for a, b in zip(_leaves(meshed["cache"]),
                                                          _leaves(plain["cache"])))
    if not all(same.values()):
        fail(f"{MESH_ARCH} on the mesh differs from the run without one: equal {same}, "
             f"max |diff| {diffs}")
    out = {"prefill_ms": [plain["prefill_ms"], meshed["prefill_ms"]],
           "step_ms": [plain["step_ms"], meshed["step_ms"]], "moe_serving_calls": calls[0],
           "collectives": coll, "launches": launches, "layer": mesh_layer_cost(params, cfg, mesh,
                                                                               rules, dev)}
    log(f"bf16 {MESH_ARCH} on mesh (1, 1) under decode_rules {rules}: tokens, prefill and last "
        f"logits and every cache leaf bit for bit equal to the run without a mesh; "
        f"_moe_serving {calls[0]} calls, collectives {coll}, launches {launches}")
    print(f"mesh serving {MESH_ARCH} (8 requests, 8 prefills + {MAX_NEW} steps) prefill ms "
          f"(8 prompts) without / with the mesh: {plain['prefill_ms']:.2f} / "
          f"{meshed['prefill_ms']:.2f}; decode step ms {plain['step_ms']:.3f} / "
          f"{meshed['step_ms']:.3f} [{card}]", flush=True)
    lay = out["layer"]
    print(f"mesh serving {MESH_ARCH}: one MoE layer's decode call (B={N_REQUESTS}) without / "
          f"with the mesh: device ms {lay['plain_device_ms']:.3f} / {lay['mesh_device_ms']:.3f}, "
          f"host ms {lay['plain_host_ms']:.3f} / {lay['mesh_host_ms']:.3f}; alone, host ms: the "
          f"all-gather {lay['all_gather_host_ms']:.3f}, the psum {lay['psum_host_ms']:.3f} "
          f"[{card}]", flush=True)
    del model, params, plain, meshed
    torch.cuda.empty_cache()
    return out


def mesh_layer_cost(params: dict, cfg, mesh, rules, dev) -> dict:
    """What the mesh adds to one MoE layer's decode call: layer 0's MoE
    block on a decode-shaped input (``N_REQUESTS`` x 1 x D, seed
    ``SEED``), device ms (:func:`device_ms`) and host ms (back-to-back
    calls, :func:`host_ms_each`) of ``moe_ffn`` without a mesh and on
    ``mesh`` under ``rules`` (``_moe_serving``), and the host ms of the two
    collectives ``_moe_serving`` makes a call, alone: the all-gather of the
    tokens over ``data`` and the psum over ``("model", "data")``."""
    import torch

    from repro_torch.models import mlp
    from repro_torch.sharding import all_gather, psum, shard_map, use_mesh

    layer = params["layers"][0]["moe"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((N_REQUESTS, 1, cfg.d_model), generator=gen, device=dev, dtype=cfg.cdt)
    x2d = x.reshape(-1, cfg.d_model)

    def meshed():
        with use_mesh(mesh, rules):
            mlp.moe_ffn(layer, x, cfg=cfg)

    fns = {"plain": lambda: mlp.moe_ffn(layer, x, cfg=cfg), "mesh": meshed,
           "all_gather": shard_map(lambda: all_gather(x2d, ("data",), tiled=True), mesh=mesh),
           "psum": shard_map(lambda: psum(x2d, ("model", "data")), mesh=mesh)}
    with torch.no_grad():
        host = host_ms_each(fns, iters=50)
        return {f"{k}_host_ms": v for k, v in host.items()} | {
            f"{k}_device_ms": device_ms(fns[k], iters=10) for k in ("plain", "mesh")}


def plain_ef_sum(g, e):
    """One leaf's int8 error-feedback sum at pod size 1, written out:
    (what the step must hand the optimizer, the new error memory).  A leaf
    under 1 KiB is summed uncompressed and keeps its error."""
    if g.numel() * g.element_size() < 1024:
        return g, e
    x = g.float() + e
    scale = x.abs().max().clamp(min=1e-30) / 127
    q = (x / scale).round().clamp(-127, 127)
    return (q * scale).to(g.dtype), x - q * scale


def mesh_hierarchical(dev, card: str) -> dict:
    """Full-width ``TRAIN_ARCH`` in bf16 at ``TRAIN_BF16_BS`` on one fixed
    batch: ``MESH_EQ_STEPS`` steps of ``make_train_step``, then
    ``make_hierarchical_train_step`` on mesh (1, 1, 1) ``("pod", "data",
    "model")`` uncompressed (its first ``MESH_EQ_STEPS`` losses and the
    params after them bit for bit equal) and compressed, ``MESH_STEPS``
    steps each from the same init.  In the first ``MESH_EF_CHECKED``
    compressed steps (the error memory zero, then not) every leaf's grad
    handed to ``opt.update`` and every new error must equal
    :func:`plain_ef_sum` of the grad and error the step summed, bit for
    bit; the compressed losses must be finite, falling, apart from the
    uncompressed run's after step 1 and within ``EF_GAP_FRAC`` of its fall
    plus ``EF_GAP_ABS``.  Each run's step ms (median of steps 2 on, the
    checked steps left out) and peak memory."""
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.models.common import tree_items
    from repro_torch.optim import AdamW, grad_compress, init_error_state, \
        make_hierarchical_train_step

    cfg = get_config(TRAIN_ARCH)
    model, opt = Model(cfg, device=dev), AdamW(lr=MESH_LR)
    b, s = TRAIN_BF16_BS
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), device=dev, generator=gen,
                                     dtype=torch.int32)}
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
    held = {}
    checked = []                  # per checked step: leaves, grads differing, errors differing
    want = []                     # the checked step's plain (sum, error) a leaf

    def sum_leaf(g, e, axis_name):
        want.append(plain_ef_sum(g, e))
        return orig_sum(g, e, axis_name)

    def update(state, grads):
        """``opt.update``, first holding the grads against ``want``'s sums."""
        if want:
            got = [t for _, t in tree_items(grads)]
            checked.append([len(got), [i for i, (g, (w, _)) in enumerate(zip(got, want))
                                       if not torch.equal(g, w)]])
            want[:] = [(None, e) for _, e in want]
            del got
        return opt.update(state, grads)

    orig_sum, checking = grad_compress._sum_leaf, types.SimpleNamespace(update=update)

    def checked_step(step, state, err):
        """One compressed step with every leaf's sum and new error held
        against :func:`plain_ef_sum` of the grad and error it was given."""
        grad_compress._sum_leaf = sum_leaf
        try:
            out = step(state, err, batch)
        finally:
            grad_compress._sum_leaf = orig_sum
        errs = [e[0] for _, e in tree_items(out[1])]
        if len(want) != len(errs) or checked[-1][0] != len(errs):
            fail(f"hierarchical step (compressed): {len(want)} leaves summed, "
                 f"{checked[-1][0]} handed to the update, {len(errs)} errors")
        checked[-1].append([i for i, (e, (_, w)) in enumerate(zip(errs, want))
                            if not torch.equal(e, w)])
        want.clear()
        return out

    def run(mode: str, steps: int) -> dict:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        state = opt.init(model.init(SEED))
        err = init_error_state(state["params"]) if mode == "compressed" else None
        plain = make_train_step(model, opt)
        step = make_hierarchical_train_step(model, checking if mode == "compressed" else opt,
                                            mesh, compress=mode == "compressed")
        losses, secs = [], []
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            if mode == "plain":
                state, m = plain(state, batch)
            elif mode == "compressed" and i < MESH_EF_CHECKED:
                state, err, m = checked_step(step, state, err)
            else:
                state, err, m = step(state, err, batch)
            losses.append(float(m["loss"]))
            if i > 0 and not (mode == "compressed" and i < MESH_EF_CHECKED):
                secs.append(time.monotonic() - t0)
            if i + 1 == MESH_EQ_STEPS and mode == "plain":
                held.update({p: t.to("cpu", copy=True) for p, t in tree_items(state["params"])})
            elif i + 1 == MESH_EQ_STEPS and mode == "uncompressed":
                bad = [p for p, t in tree_items(state["params"])
                       if not torch.equal(t.detach().cpu(), held[p])]
                if bad:
                    fail(f"hierarchical step (uncompressed) params after {MESH_EQ_STEPS} steps "
                         f"differ from make_train_step's in {len(bad)} leaves, e.g. {bad[:3]}")
        peak = torch.cuda.max_memory_allocated(dev)
        del state, err
        return {"losses": losses, "step_s": secs, "peak_gb": peak / 1e9,
                "step_ms": 1e3 * statistics.median(secs)}

    runs = {"plain": run("plain", MESH_EQ_STEPS), "uncompressed": run("uncompressed", MESH_STEPS),
            "compressed": run("compressed", MESH_STEPS)}
    held.clear()
    ref, unc, com = (runs[k]["losses"] for k in ("plain", "uncompressed", "compressed"))
    if unc[:MESH_EQ_STEPS] != ref:
        fail(f"hierarchical step (uncompressed) losses {unc[:MESH_EQ_STEPS]} != make_train_step's "
             f"{ref}")
    if len(checked) != MESH_EF_CHECKED or any(bad_g or bad_e for _, bad_g, bad_e in checked):
        fail(f"hierarchical step (compressed): the sums handed to the update or the new errors "
             f"differ from a plain int8 quantisation of the step's grads and errors in steps "
             f"1-{MESH_EF_CHECKED} (leaves, grads differing, errors differing): {checked}")
    gaps = [abs(c - u) for c, u in zip(com, unc)]
    bounds = [EF_GAP_FRAC * (unc[0] - u) + EF_GAP_ABS for u in unc]
    if not all(x == x and abs(x) < 1e4 for x in com) or not com[-1] < com[0] or \
            any(g > bd for g, bd in zip(gaps, bounds)) or not min(gaps[1:]) > 0:
        fail(f"hierarchical step (compressed) losses {com} against uncompressed {unc}: gaps "
             f"{gaps}, bounds {bounds}")
    ef_ms = runs["compressed"]["step_ms"] - runs["uncompressed"]["step_ms"]
    log(f"bf16 {TRAIN_ARCH} hierarchical steps on mesh (1, 1, 1), B={b} S={s}: make_train_step "
        f"losses {ref}, uncompressed {unc} (first {MESH_EQ_STEPS} and params bit for bit "
        f"equal), compressed {com} (gaps {[round(g, 5) for g in gaps]}, bounds "
        f"{[round(x, 5) for x in bounds]}; steps 1-{MESH_EF_CHECKED}: the {checked[0][0]} "
        f"leaves' sums and errors bit for bit equal to a plain int8 quantisation); timed step s "
        + ", ".join(f"{k} {[round(x, 4) for x in r['step_s']]}" for k, r in runs.items()))
    for k, r in runs.items():
        print(f"mesh hierarchical {TRAIN_ARCH} {k}: step ms (median of {len(r['step_s'])} steps) "
              f"{r['step_ms']:.2f}, peak device memory GB {r['peak_gb']:.2f} [{card}]", flush=True)
    print(f"mesh hierarchical {TRAIN_ARCH}: error feedback and the int8 sum add "
          f"{ef_ms:.2f} ms a step [{card}]", flush=True)
    del model
    torch.cuda.empty_cache()
    return {k: {kk: r[kk] for kk in ("losses", "step_ms", "peak_gb")} for k, r in runs.items()} \
        | {"ef_ms": ef_ms, "gaps": gaps, "bounds": bounds}


def mesh_trainer(dev, card: str) -> dict:
    """``Trainer`` on qwen2-1.5b's 100m reduction in bf16 (B 8 x S 1024,
    in-process data), ``MESH_TRAINER_STEPS`` steps without a mesh (a
    checkpoint every ``MESH_TRAINER_CKPT``) and on mesh (1, 1) ``("data",
    "model")``: losses and params bit for bit equal; then a ``Trainer`` on
    the mesh resumes from the checkpoint saved without one at step
    ``MESH_TRAINER_CKPT``, restored through the state's shardings, and its
    losses must be the uninterrupted run's within ``RESUME_LOSS_TOL``
    (phase 27's gate)."""
    import shutil

    import torch

    from repro_torch.configs import model_100m
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.models.common import tree_items
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = model_100m(TRAIN_ARCH).scaled(param_dtype="bfloat16", compute_dtype="bfloat16")
    root = ROOT / "build" / "mesh_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    mesh = make_mesh((1, 1), ("data", "model"))

    def train(name: str, ckpt_every: int, mesh=None) -> Trainer:
        b, s = TRAIN_BF16_BS
        tc = TrainerConfig(batch=b, seq_len=s, total_steps=MESH_TRAINER_STEPS, warmup=2,
                           ckpt_every=ckpt_every, ckpt_dir=str(root / name), ckpt_keep=2,
                           zero_copy_data=False, log_every=100, seed=SEED)
        t = Trainer(Model(cfg, device=dev), tc, mesh=mesh)
        t.run()
        t.close()
        return t

    t0 = time.monotonic()
    plain = train("plain", MESH_TRAINER_CKPT)
    meshed = train("mesh", 0, mesh)
    losses = [r["loss"] for r in plain.metrics_log]
    if [r["loss"] for r in meshed.metrics_log] != losses or not all(
            torch.equal(a, b) for (_, a), (_, b) in zip(tree_items(plain.state["params"]),
                                                        tree_items(meshed.state["params"]))):
        fail(f"Trainer on mesh (1, 1): losses {[r['loss'] for r in meshed.metrics_log]} or its "
             f"params differ from the run without a mesh ({losses})")
    shutil.rmtree(root / "plain" / f"step_{MESH_TRAINER_STEPS:010d}")
    resumed = train("plain", 0, mesh)
    steps = [r["step"] for r in resumed.metrics_log]
    diffs = [abs(r["loss"] - x) for r, x in zip(resumed.metrics_log, losses[MESH_TRAINER_CKPT:])]
    if steps != list(range(MESH_TRAINER_CKPT + 1, MESH_TRAINER_STEPS + 1)) or \
            max(diffs) > RESUME_LOSS_TOL:
        fail(f"Trainer on mesh (1, 1) resumed from a checkpoint saved without a mesh: steps "
             f"{steps}, losses {[r['loss'] for r in resumed.metrics_log]} against "
             f"{losses[MESH_TRAINER_CKPT:]} (bound {RESUME_LOSS_TOL})")
    log(f"bf16 {cfg.name} Trainer: {MESH_TRAINER_STEPS} steps on mesh (1, 1) bit for bit equal to "
        f"the run without one (losses {losses}); resumed on the mesh from step "
        f"{MESH_TRAINER_CKPT} saved without one: max |diff| {max(diffs):.3e} (bound "
        f"{RESUME_LOSS_TOL}); {time.monotonic() - t0:.1f} s [{card}]")
    shutil.rmtree(root, ignore_errors=True)
    del plain, meshed, resumed
    torch.cuda.empty_cache()
    return {"losses": losses, "resume_max_diff": max(diffs)}


def phase_mesh(dev, card: str) -> dict:
    """Phase 31: one process group of one rank (``nccl``, a ``HashStore``),
    then :func:`mesh_serving`, :func:`mesh_hierarchical` and
    :func:`mesh_trainer` on ``DeviceMesh``es over it; the group is destroyed
    at the end, and a failure fails the run."""
    import torch
    import torch.distributed as dist

    log(f"phase 31 starts with {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        return {"serving": mesh_serving(dev, card), "hierarchical": mesh_hierarchical(dev, card),
                "trainer": mesh_trainer(dev, card)}
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# phase 32: the cross-host planes
# ---------------------------------------------------------------------------

# benchmarks/fig14_routing.py:65-67 (the data-plane sweep, messages a point)
PLANE_SIZES = {"4KB": 4 << 10, "64KB": 64 << 10, "1MB": 1 << 20, "16MB": 16 << 20}
PLANE_MSGS = 30
DATA_PLANES = (("serialized", "ref"), ("parts", "ref"), ("attach", "copy"), ("attach", "ref"))
XHOST_TOPIC = "xhost/pc2"
# benchmarks/fig16_crosshost.py:29-32 (the churn run: messages, bytes, pin lease)
CHURN_MSGS, CHURN_BYTES, CHURN_LEASE_S = 40, 64 << 10, 0.6
CYCLE_MSGS = 8
PLANES_TRACE_CAP = 1 << 16     # records a trace ring keeps: (a) writes about 1,500 a domain
PLANES_WAIT_S = 30.0           # a wait that outlasts this fails the phase


def plane_label(plane: str, mode: str) -> str:
    return f"attach-{mode}" if plane == "attach" else plane


def pctl_ms(xs: list) -> dict:
    """p50/p99/max of seconds ``xs``, in ms (the reference's fig14 rule)."""
    a = sorted(xs)
    return {"n": len(a), "p50": 1e3 * a[len(a) // 2],
            "p99": 1e3 * a[min(len(a) - 1, int(len(a) * 0.99))], "max": 1e3 * a[-1]}


def wait_for(cond, what: str, spin, timeout: float = PLANES_WAIT_S) -> None:
    """Call ``spin()`` until ``cond()``; fail the phase after ``timeout`` s."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            fail(f"phase 32: no {what} within {timeout} s")
        spin()


def settle(bridges, spin, idle: int = 20) -> None:
    """Spin until no bridge holds an unsettled attach send or a parked
    copy-in and ``idle`` rounds in a row moved nothing (a duplicate still
    on the bus would move)."""
    deadline, still = time.monotonic() + PLANES_WAIT_S, 0
    while still < idle:
        if time.monotonic() > deadline:
            fail(f"phase 32: the bridges did not settle within {PLANES_WAIT_S} s: "
                 f"{[b.stats() for b in bridges]}")
        moved = spin()
        busy = any(b._awaiting or b._pending for b in bridges)
        still = 0 if moved or busy else still + 1


def crossed_flows(names: list) -> list:
    """The message flows of domains ``names`` merged by trace id: a relayed
    message's flow has its publish, take and ``bridge_out`` in the sender's
    rings and its ``route``, ``bridge_in`` and delivery in the receiver's."""
    from repro_torch.obs.flows import Flow, FlowAggregator

    by_tid = {}
    for name in names:
        agg = FlowAggregator(name)
        for f in agg.collect():
            if not f.serving:
                by_tid.setdefault(f.trace_id, []).extend(f.records)
        agg.close()
    return [Flow(tid, sorted(recs, key=lambda r: (r[1], r[2], r[3])))
            for tid, recs in by_tid.items()]


def plane_pair(plane: str, mode: str, base) -> dict:
    """(a) and (d) on one data plane: two traced domains, a router each on
    one bus, ``PLANE_MSGS`` messages at each of ``PLANE_SIZES`` paced one at
    a time through one executor; each delivered exactly once with its
    bytes, no attach send falling back; publish-to-delivery by size; then
    the flows across the bridge hop."""
    import numpy as np

    from repro_torch.core import (POINT_CLOUD2, AgnocastQueueFull, Bus, Domain, EventExecutor,
                                  OutOfArenaMemory, Router)
    from repro_torch.core.transport import SubscriptionProbe
    from repro_torch.launch.fleet import _rings_overflowed
    from repro_torch.obs import trace as _trace

    label = plane_label(plane, mode)
    cap = (max(PLANE_SIZES.values()) + (1 << 20)) * 6
    bus = Bus().start()
    doms = [Domain.create(arena_capacity=cap) for _ in range(2)]
    routers, ex = [], None
    sizes, seen, bad, lat = {}, {}, [], {k: [] for k in PLANE_SIZES}
    try:
        for dom in doms:
            r = Router(dom, data_plane=plane, attach_mode=mode, pin_lease_s=5.0)
            r.add_remote("link", bus.path, depth=4)
            r.add_route("xhost/", "link")
            r.activate(POINT_CLOUD2, XHOST_TOPIC)
            routers.append(r)
        probe = SubscriptionProbe(bus.path)
        for r in routers:
            probe.wait(r.bridges["link"].bus)
        probe.close()
        ba, bb = (r.bridges["link"] for r in routers)
        pub = doms[0].create_publisher(POINT_CLOUD2, XHOST_TOPIC, depth=4)
        sub = doms[1].create_subscription(POINT_CLOUD2, XHOST_TOPIC)

        def on_msg(ptr):
            t = time.monotonic()
            i = int(ptr.msg.get("width"))
            key, n = sizes[i]
            lat[key].append(t - float(ptr.msg.get("stamp")))
            seen[i] = seen.get(i, 0) + 1
            data = np.asarray(ptr.data)
            if data.size != n or int(data[:8].view(np.uint64)[0]) != i or \
                    not np.array_equal(data[8:], base[8:n]):
                bad.append(i)

        ex = EventExecutor(name=f"phase32-{label}")
        ex.add_subscription(sub, on_msg)
        for r in routers:
            r.register(ex)

        def send(i: int, n: int) -> None:
            pl = base[:n].copy()
            pl[:8] = np.array([i], np.uint64).view(np.uint8)
            deadline, msg = time.monotonic() + PLANES_WAIT_S, None
            while True:
                if time.monotonic() > deadline:
                    fail(f"phase 32 {label}: message {i} not published within {PLANES_WAIT_S} s")
                if msg is None:
                    try:
                        m = pub.borrow_loaded_message()
                        try:
                            m.data.extend(pl)
                        except OutOfArenaMemory:
                            m.dealloc()
                            raise
                        msg = m
                    except OutOfArenaMemory:    # pinned entries still hold the arena
                        pub.reclaim()
                        ex.spin_once(0.02)
                        continue
                msg.set("width", i)
                msg.set("stamp", time.monotonic())
                pub.reclaim()
                try:
                    pub.publish(msg)            # a full ring leaves the loan valid
                    return
                except AgnocastQueueFull:
                    ex.spin_once(0.02)

        i = 0
        for key, n in PLANE_SIZES.items():
            for _ in range(PLANE_MSGS):
                sizes[i] = (key, n)
                send(i, n)
                want = i + 1
                ex.spin(until=lambda: sum(seen.values()) >= want, timeout=PLANES_WAIT_S)
                if sum(seen.values()) < want:
                    fail(f"phase 32 {label}: message {i} ({key}) not delivered within "
                         f"{PLANES_WAIT_S} s; bridges {ba.stats()} {bb.stats()}")
                i += 1
        # pumped directly too: in ref mode the last acks wait on the receiver
        # reclaiming its republications, which a quiet bus never prompts
        settle([ba, bb], lambda: ex.spin_once(0.002) + sum(r.spin_once(0.0) for r in routers))
        extra = {k: v for k, v in seen.items() if v != 1}
        if len(seen) != i or extra or bad:
            fail(f"phase 32 {label}: {len(seen)}/{i} messages delivered, not once: {extra}, "
                 f"bytes differ: {bad}")
        st = {"sender": ba.stats(), "receiver": bb.stats()}
        if ba.relayed_out != i or bb.dropped_dups or bb.copy_errors:
            fail(f"phase 32 {label}: bridges {st}")
        if plane == "attach" and (ba.attach_out != i or bb.attach_in != i or ba.attach_fallbacks
                                  or ba.ack_timeouts or bb.attach_nacks):
            fail(f"phase 32 {label}: an attach send fell back or was refused: {st}")
    finally:
        if ex is not None:
            ex.shutdown()
        for r in routers:
            r.close()
    names = [d.name for d in doms]
    try:
        over = {}
        for name in names:
            over.update(_rings_overflowed(name))
        if over:
            fail(f"phase 32 {label}: trace rings wrapped (written, kept): {over}")
        S = _trace.Stage
        hop, out_ms, in_ms, e2e = [], [], [], []
        for f in crossed_flows(names):
            pub_r, out_r, in_r = f.first(S.PUBLISH, 0), f.first(S.BRIDGE_OUT), f.first(S.BRIDGE_IN)
            cb = f.first(S.CB_START, 1)
            if None in (pub_r, out_r, in_r, cb):
                continue
            if not pub_r[1] <= out_r[1] <= in_r[1] <= cb[1] or out_r[2] != 1 or in_r[2] != 1:
                fail(f"phase 32 {label}: flow {f.trace_id:#x} out of order: {f.stage_times()}")
            hop.append((in_r[1] - out_r[1]) / 1e9)
            out_ms.append((out_r[1] - pub_r[1]) / 1e9)
            in_ms.append((cb[1] - in_r[1]) / 1e9)
            e2e.append((cb[1] - pub_r[1]) / 1e9)
        if len(hop) != i:
            fail(f"phase 32 {label}: {len(hop)} flows cross the bridge hop with bridge_out and "
                 f"bridge_in, {i} messages were relayed")
    finally:
        for d in doms:
            d.close()
        for name in names:
            tr = _trace._tracers.pop(name, None)
            if tr is not None:
                tr.close()
            _trace.purge(name)
        bus.stop()
    by_size = {k: pctl_ms(v) for k, v in lat.items()}
    log(f"phase 32 (a) {label}: {i} messages, each delivered once with its bytes; "
        f"publish-to-delivery p50/p99 ms: " + ", ".join(
            f"{k} {v['p50']:.3f}/{v['p99']:.3f}" for k, v in by_size.items())
        + f"; bridges: out {st['sender']}, in {st['receiver']}")
    flows = {"bridge_hop": pctl_ms(hop), "publish_to_bridge_out": pctl_ms(out_ms),
             "bridge_in_to_callback": pctl_ms(in_ms), "e2e": pctl_ms(e2e)}
    log(f"phase 32 (d) {label}: {len(hop)} traced flows across the bridge hop; p50/p99 ms: "
        + ", ".join(f"{k} {v['p50']:.3f}/{v['p99']:.3f}" for k, v in flows.items()))
    return {"by_size_ms": by_size, "flows_ms": flows}


def plane_churn() -> dict:
    """(b) ``benchmarks/fig16_crosshost.py``'s protocol on the port: two
    domains on the attach plane (``copy`` mode, a 0.6 s pin lease), 40
    messages of 64 KiB; the receiving bridge killed with a control frame
    unread at 1/4 and 3/4 (the sender's ack timeout re-sends it by value to
    the replacement), the sending bridge killed before it reads an ack at
    1/2 (its close re-sends by value; the receiver's dedup drops it)."""
    import numpy as np

    from repro_torch.core import POINT_CLOUD2, Bus, Domain, Router
    from repro_torch.core.transport import SubscriptionProbe

    bus = Bus().start()
    probe = SubscriptionProbe(bus.path)
    doms = [Domain.create(arena_capacity=64 << 20) for _ in range(2)]
    routers = []

    def mk(dom):
        r = Router(dom, data_plane="attach", attach_mode="copy", pin_lease_s=CHURN_LEASE_S)
        r.add_remote("link", bus.path, depth=8)
        r.add_route("xhost/", "link")
        r.activate(POINT_CLOUD2, XHOST_TOPIC)
        probe.wait(r.bridges["link"].bus)
        routers.append(r)
        return r

    counters = {"fallbacks": 0, "ack_timeouts": 0, "unresolved_at_close": 0}

    def respawn(router):
        old = router.bridges.pop("link")
        counters["fallbacks"] += old.attach_fallbacks
        counters["ack_timeouts"] += old.ack_timeouts
        counters["unresolved_at_close"] += sum(1 for aw in old._awaiting.values()
                                               if aw.need is None or aw.acks < aw.need)
        old.close()                      # a sender flushes its unresolved sends by value
        br = router.add_remote("link", bus.path, depth=8)
        br.attach(POINT_CLOUD2, XHOST_TOPIC)
        probe.wait(br.bus)

    try:
        ra, rb = mk(doms[0]), mk(doms[1])
        pub = doms[0].create_publisher(POINT_CLOUD2, XHOST_TOPIC, depth=8)
        sub = doms[1].create_subscription(POINT_CLOUD2, XHOST_TOPIC)
        payload = (np.arange(CHURN_BYTES, dtype=np.uint8) % 251)
        got, lat = [], []
        kill_recv, kill_send = {CHURN_MSGS // 4, (3 * CHURN_MSGS) // 4}, {CHURN_MSGS // 2}
        kills = {"recv": 0, "send": 0}

        def take():
            for ptr in sub.take():
                got.append(int(np.asarray(ptr.data)[0]))
                lat.append(time.monotonic() - float(ptr.msg.get("stamp")))
                ptr.release()

        for i in range(CHURN_MSGS):
            m = pub.borrow_loaded_message()
            pl = payload.copy()
            pl[0] = (i + 1) % 251            # the value byte names the message
            m.data.extend(pl)
            m.set("stamp", time.monotonic())
            pub.reclaim()
            pub.publish_blocking(m, timeout=10.0)
            if i in kill_recv:
                # the control frame is out and its FANOUT receipt back: it sits
                # unread in the doomed receiving bridge's socket
                br = ra.bridges["link"]
                sent = br.attach_out
                wait_for(lambda: br.attach_out > sent and all(aw.need is not None
                                                              for aw in br._awaiting.values()),
                         f"FANOUT receipt before receiver kill at {i}", lambda: ra.spin_once(0.01))
                respawn(rb)
                kills["recv"] += 1
            elif i in kill_send:
                ra.spin_once(0.01)           # the control frame out; the ack stays unread
                wait_for(lambda: len(got) > i, f"delivery before sender kill at {i}",
                         lambda: (rb.spin_once(0.02), take()))
                respawn(ra)
                kills["send"] += 1
            wait_for(lambda: len(got) > i, f"churn message {i}",
                     lambda: (ra.spin_once(0.02), rb.spin_once(0.02), take()))
        settle([ra.bridges["link"], rb.bridges["link"]],
               lambda: ra.spin_once(0.002) + rb.spin_once(0.002) + (take() or 0))
        take()
        counters["fallbacks"] += ra.bridges["link"].attach_fallbacks
        counters["ack_timeouts"] += ra.bridges["link"].ack_timeouts
    finally:
        for r in routers:
            r.close()
        for d in doms:
            d.close()
        probe.close()
        bus.stop()
    want = [(i + 1) % 251 for i in range(CHURN_MSGS)]
    lost = [v for v in want if v not in got]
    dups = len(got) - len(set(got))
    if lost or dups or kills != {"recv": 2, "send": 1} or \
            counters["fallbacks"] < kills["recv"] or \
            counters["unresolved_at_close"] < kills["send"]:
        fail(f"phase 32 (b): lost {lost}, duplicates {dups}, kills {kills}, counters {counters}")
    out = {"delivered": len(got), "lost": 0, "duplicates": 0, "kills": kills,
           "counters": counters, "latency_ms": pctl_ms(lat)}
    log(f"phase 32 (b) churn: {CHURN_MSGS} messages of {CHURN_BYTES >> 10} KiB on the attach "
        f"plane (copy, lease {CHURN_LEASE_S} s), kills {kills}: lost 0, duplicates 0; recovery "
        f"counters {counters}; publish-to-take p50/p99 ms {out['latency_ms']['p50']:.3f}/"
        f"{out['latency_ms']['p99']:.3f}")
    return out


def plane_cycle() -> dict:
    """(c) Three domains on a cycle of buses (A-B, B-C, C-A): each message
    from A reaches every domain's subscriber once (A's own once: no copy
    returns), and the loop prevention fired (copies back at the origin
    dropped, second-path copies deduplicated)."""
    import numpy as np

    from repro_torch.core import POINT_CLOUD2, Bus, Domain, Router
    from repro_torch.core.transport import SubscriptionProbe

    links = {"A": ("ab", "ca"), "B": ("ab", "bc"), "C": ("bc", "ca")}
    buses = {n: Bus().start() for n in ("ab", "bc", "ca")}
    doms = {k: Domain.create(arena_capacity=16 << 20) for k in links}
    routers = {}
    try:
        for k, dom in doms.items():
            r = Router(dom)
            for name in links[k]:
                r.add_remote(name, buses[name].path, depth=8)
                r.add_route("xhost/", name)
            r.activate(POINT_CLOUD2, XHOST_TOPIC)
            routers[k] = r
        for name, bus in buses.items():
            probe = SubscriptionProbe(bus.path)
            for k in links:
                if name in links[k]:
                    probe.wait(routers[k].bridges[name].bus)
            probe.close()
        subs = {k: d.create_subscription(POINT_CLOUD2, XHOST_TOPIC) for k, d in doms.items()}
        pub = doms["A"].create_publisher(POINT_CLOUD2, XHOST_TOPIC, depth=8)
        got = {k: [] for k in doms}

        def spin():
            moved = sum(r.spin_once(0.002) for r in routers.values())
            for k, sub in subs.items():
                for ptr in sub.take():
                    got[k].append(int(np.asarray(ptr.data)[0]))
                    ptr.release()
                    moved += 1
            return moved

        for i in range(CYCLE_MSGS):
            m = pub.borrow_loaded_message()
            m.data.extend(np.full(64 << 10, i, np.uint8))
            m.set("stamp", time.monotonic())
            pub.reclaim()
            pub.publish_blocking(m, timeout=10.0)
            wait_for(lambda: all(len(v) > i for v in got.values()), f"cycle message {i}", spin)
        settle([b for r in routers.values() for b in r.bridges.values()], spin)
        drops = {k: sum(b.dropped_loops for b in r.bridges.values()) for k, r in routers.items()}
        dups = sum(b.dropped_dups for r in routers.values() for b in r.bridges.values())
    finally:
        for r in routers.values():
            r.close()
        for d in doms.values():
            d.close()
        for b in buses.values():
            b.stop()
    if any(sorted(v) != list(range(CYCLE_MSGS)) for v in got.values()) or \
            not drops["A"] or not dups:
        fail(f"phase 32 (c): delivered {got}, loop drops {drops}, deduplicated {dups}")
    log(f"phase 32 (c) cycle of 3 domains: {CYCLE_MSGS} messages from A, each once in A, B and "
        f"C; copies dropped back at their origin {drops}, second-path copies deduplicated {dups}")
    return {"messages": CYCLE_MSGS, "loop_drops": drops, "dedup_drops": dups}


def phase_planes(card: str) -> dict:
    """Phase 32 (see the module docstring): (a) and (d) on each data plane,
    traced, then (b) and (c); runs on the host and launches no kernel."""
    import os

    import numpy as np

    env = {k: os.environ.get(k) for k in ("AGNOCAST_TRACE", "AGNOCAST_TRACE_CAP")}
    os.environ.update(AGNOCAST_TRACE="1", AGNOCAST_TRACE_CAP=str(PLANES_TRACE_CAP))
    base = (np.arange(max(PLANE_SIZES.values()), dtype=np.uint64) % 251).astype(np.uint8)
    try:
        planes = {plane_label(p, m): plane_pair(p, m, base) for p, m in DATA_PLANES}
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    big, small = list(PLANE_SIZES)[-1], list(PLANE_SIZES)[0]
    ratios = {
        "attach_ref_16MB_over_4KB": planes["attach-ref"]["by_size_ms"][big]["p50"]
        / planes["attach-ref"]["by_size_ms"][small]["p50"],
        "serialized_over_parts_16MB": planes["serialized"]["by_size_ms"][big]["p50"]
        / planes["parts"]["by_size_ms"][big]["p50"]}
    log(f"phase 32 (a) shape ratios of p50 ({card}; fig14 gates them at <= 2 and >= 1.5, "
        f"logged here): " + ", ".join(f"{k} {v:.3f}" for k, v in ratios.items()))
    return {"planes": planes, "ratios": ratios, "churn": plane_churn(), "cycle": plane_cycle()}


def finish_dryrun(dry: DryRun) -> None:
    """The dry run's grid: no cell ``error``, every skipped cell skipped for
    the reference's reason; its log, the roofline table and its wall time."""
    import json as _json

    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch import roofline
    from repro_torch.models import WORKLOADS

    code, wall = dry.finish()
    for line in dry.log_path.read_text().splitlines():
        log(line)
    recs = [_json.loads(p.read_text()) for p in sorted(dry.out.glob("*__*.json"))]
    by = {}
    for r in recs:
        by[r["status"]] = by.get(r["status"], 0) + 1
    bad = [(r["arch"], r["shape"], r.get("error")) for r in recs if r["status"] == "error"]
    skipped = [(r["arch"], r["shape"], r["why"]) for r in recs if r["status"] == "skipped"]
    if code != 0 or bad or len(recs) != len(ARCH_IDS) * len(WORKLOADS):
        fail(f"dry run: exit code {code}, {len(recs)} records, errors {bad}")
    if any(why != LONG_500K_WHY or shape != "long_500k" for _, shape, why in skipped):
        fail(f"dry run: skipped for another reason than the reference's: {skipped}")
    rows = roofline.main(str(dry.out))
    log(f"dry run: {len(recs)} cells ({by}), the whole grid in {wall:.1f} s wall on the card's "
        f"host (niced, beside phases 3-29); {len(rows)} roofline rows in "
        f"{dry.out / 'roofline_1.json'}")


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
    # backward kernels: no TPU kernel has one; each names the TPU kernel whose
    # function it differentiates
    "rmsnorm_bwd": ("cuda", "src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm/kernel.py:25"),
    "flash_attention_bwd": ("cuda", "src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/flash_attention/kernel.py:70"),
    "slstm_scan_bwd": ("cuda", "src/repro_torch/csrc/slstm_scan_bwd.cu",
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
    # the head-dim-256 instantiations: flash_fwd<float, 256>, flash_fwd_mma<256>
    # and decode_fwd<T, 256, G, RG> for every built G and row-group count
    hd256 = [(k, spill) for n in ("flash_attention", "decode_attention")
             for k, _, spill in ptxas.get(n, ()) if re.search(r"\b256\b", k)]
    spilled = [k for k, spill in hd256 if re.search(r"[1-9]\d* bytes spill", spill)]
    if len(hd256) != 16 or spilled:
        fail(f"head dim 256: {len(hd256)} instantiations reported (expected 2 flash + 14 "
             f"decode), spilling: {spilled}")
    log(f"head dim 256: {len(hd256)} instantiations of flash and decode attention, no spills")
    # G = 16 (qwen3-moe) runs two row groups of 8 through decode_fwd<T, 128, 8, 2>
    g16 = [(k, spill) for k, _, spill in ptxas.get("decode_attention", ())
           if re.search(r", 128, 8, 2>$", k)]
    spilled = [k for k, spill in g16 if re.search(r"[1-9]\d* bytes spill", spill)]
    if len(g16) != 2 or spilled:
        fail(f"G = 16: {len(g16)} decode_fwd<T, 128, 8, 2> instantiations reported (expected "
             f"2), spilling: {spilled}")
    log(f"G = 16 at hd 128: the 2 decode_fwd<T, 128, 8, 2> instantiations its row groups run "
        f"spill nothing")
    # the head-dim-80 instantiations (zamba2-2.7b): flash_fwd<float, 80>,
    # flash_fwd_mma<80> and decode_fwd<T, 80, G, RG> for every built G and RG
    hd80 = [(k, spill) for n in ("flash_attention", "decode_attention")
            for k, _, spill in ptxas.get(n, ()) if re.search(r"\b80\b", k)]
    spilled = [k for k, spill in hd80 if re.search(r"[1-9]\d* bytes spill", spill)]
    if len(hd80) != 16 or spilled:
        fail(f"head dim 80: {len(hd80)} instantiations reported (expected 2 flash + 14 "
             f"decode), spilling: {spilled}")
    log(f"head dim 80: {len(hd80)} instantiations of flash and decode attention, no spills")
    hmma = sass_counts("flash_attention", "HMMA")
    for fn, count in hmma.items():
        log(f"SASS flash_attention {fn}: {count} HMMA")
    mma_kernels = {fn: c for fn, c in hmma.items() if "flash_fwd_mma" in fn}
    if not mma_kernels or not all(mma_kernels.values()) or \
            not all(any(f"flash_fwd_mma<{hd}>" in fn for fn in mma_kernels) for hd in (80, 256)):
        fail(f"the bf16 flash-attention kernels (hd 80 and 256 included) have no tensor-core "
             f"instructions: {hmma}")
    # K2-bwd in bf16 at hd 64, 80 and 128: bwd_dkdv_mma<HD> and bwd_dq_mma<HD>
    hmma = sass_counts("flash_attention_bwd", "HMMA")
    for fn, count in hmma.items():
        log(f"SASS flash_attention_bwd {fn}: {count} HMMA")
    want = [f"bwd_{k}_mma<{hd}>" for k in ("dkdv", "dq") for hd in (64, 80, 128)]
    if not all(any(w in fn and c for fn, c in hmma.items()) for w in want):
        fail(f"the bf16 K2-bwd kernels ({', '.join(want)}) have no tensor-core instructions: "
             f"{hmma}")

    hmma = sass_counts("slstm_scan_bwd", "HMMA")
    log("SASS slstm_scan_bwd (f32 products on the CUDA cores): "
        + ", ".join(f"{fn} {count} HMMA" for fn, count in hmma.items()))
    # K5-bwd's cluster kernels hold up to 8 x 8 f32 sums and 8 x 16 bytes of
    # w a thread in registers (255 at most): a spill would land on the chain
    spilled = [k for k, _, spill in ptxas.get("slstm_scan_bwd", ())
               if "cluster" in k and re.search(r"[1-9]\d* bytes spill", spill)]
    if spilled:
        fail(f"slstm_scan_bwd: cluster instantiations that spill: {spilled}")

    dry = DryRun()      # the dry run's grid on the host's CPU, beside phases 3-29
    log(f"dry run: the whole grid started in a child process (pid {dry.proc.pid}), records "
        f"in {dry.out}")

    t0 = time.monotonic()
    report = phase_kernels(dev)
    log(f"phase 3 (kernels vs plain) done in {time.monotonic() - t0:.1f} s")
    launches, path_ms = {}, {}

    def model_phases(archs: tuple, first: int,
                     fns=(("f32 model", phase_model_f32), ("bf16 serving", phase_serve_bf16))
                     ) -> None:
        """Each arch's f32 model phase, then its bf16 serving phase."""
        steps = [(arch, what, fn) for arch in archs for what, fn in fns]
        for n, (arch, what, fn) in enumerate(steps, start=first):
            t0 = time.monotonic()
            out = fn(dev, arch)
            if out is not None:
                launches[arch], path_ms[arch] = out
            log(f"phase {n} ({what}, {arch}) done in {time.monotonic() - t0:.1f} s")

    model_phases(("qwen2-1.5b", "xlstm-1.3b"), 4)
    t0 = time.monotonic()
    launches[f"fleet {FLEET_ARCH}"], fleet_stages = phase_fleet(dev)
    log(f"phase 8 (serving fleet, {FLEET_ARCH}) done in {time.monotonic() - t0:.1f} s")
    model_phases(SIBLINGS, 9)
    t0 = time.monotonic()
    phase_moe_layer(dev)
    log(f"phase 15 (MoE layer, qwen2-moe-a2.7b width) done in {time.monotonic() - t0:.1f} s")
    model_phases(MOE_ARCHS, 16)
    model_phases(ZAMBA_ARCHS, 20)
    model_phases(CROSS_ARCHS, 22, (("f32 model", phase_cross_f32),
                                   ("bf16 generation", phase_cross_bf16)))
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rmsnorm import ops as norm_ops
    from repro_torch.kernels.slstm_scan import ops as scan_ops

    calls = {"rmsnorm_bwd": BackwardCalls(norm_ops, "rmsnorm_bwd"),
             "flash_attention_bwd": BackwardCalls(flash_ops, "flash_attention_bwd"),
             "slstm_scan_bwd": BackwardCalls(scan_ops, "slstm_scan_bwd")}
    with calls["rmsnorm_bwd"], calls["flash_attention_bwd"], calls["slstm_scan_bwd"]:
        for arch in (TRAIN_ARCH, XLSTM_ARCH):
            t0 = time.monotonic()
            launches[f"{arch} train f32"] = phase_train_f32(dev, arch)
            log(f"phase 26 (f32 training gradients, {arch}) done in "
                f"{time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        launches[f"{TRAIN_ARCH} train bf16"], train = phase_train_bf16(dev)
        log(f"phase 27 (bf16 training with the Trainer and a resume, {TRAIN_ARCH}) done in "
            f"{time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        launches[f"{XLSTM_ARCH} train bf16"], xtrain = phase_train_xlstm_bf16(dev)
        log(f"phase 27 (bf16 training with the Trainer, {XLSTM_ARCH}) done in "
            f"{time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        launches.update(phase_train_families(dev))
        log(f"phase 28 (training, every family at 100m) done in "
            f"{time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    for n, r in phase_train_shapes(dev, calls).items():
        report[n].update(r)
    log(f"phase 29 (the backward kernels at the training paths' layouts) done in "
        f"{time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    for arch in (TRAIN_ARCH, XLSTM_ARCH):
        launches[f"{arch} step builders"] = step_builders(dev, arch)
    train_count_on_card(dev)
    finish_dryrun(dry)
    log(f"phase 30 (the step builders, the count on the card against meta, the dry run) done "
        f"in {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    mesh = phase_mesh(dev, card)
    log(f"phase 31 (the mesh at world size 1: MoE serving, hierarchical steps, the Trainer) done "
        f"in {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    planes = phase_planes(card)
    log(f"phase 32 (the cross-host planes: data planes, churn, a cycle, flows across the "
        f"bridge hop) done in {time.monotonic() - t0:.1f} s")
    log(f"all phases done in {time.monotonic() - T_START:.1f} s")

    kernels = []
    for name, (route, source, replaces) in REPLACES.items():
        r = report[name]
        by_path = {a: c[name] for a, c in launches.items() if c.get(name)}
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "role": "backward" if name.endswith("_bwd") else "forward",
                        "launches": sum(by_path.values()), "launches_by_path": by_path,
                        "on_path": bool(by_path),
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": r["shape"], "wall_ms": r["wall_ms"],
                        "host_ms": r["host_ms"],
                        "path_device_ms_per_launch": {a: p[name] for a, p in path_ms.items()
                                                      if name in p},
                        **{k: r[k] for k in ("by_seq", "hd256", "g16", "hd80", "cross", "shapes",
                                             "variant", "cluster", "torch_add_host_ms",
                                             "path_shapes", "path_max_abs_err")
                           if k in r}})
    print(json.dumps({"kernels": kernels, "train_step_ms": train["step_ms"],
                      "train_step_device_ms_by_group": train["groups_ms"],
                      "xlstm_train": xtrain, "mesh": mesh, "fleet_stages_ms": fleet_stages,
                      "planes": planes}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
