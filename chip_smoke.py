#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: requires CUDA, prints the card's name and power limit, turns
   TF32 off for float32 matmuls.
2. Build: compiles the hand-written kernels (src/repro_torch/kernels/csrc)
   with nvcc, one process per source, and prints the build seconds and,
   for each kernel instantiation, its registers, static shared memory and
   spills from the compiler's report, and the tensor-core (HMMA)
   instructions of the flash, mLSTM and SSD libraries (it fails if a bf16
   tensor-core instantiation has none).
3. Kernels against their plain PyTorch versions on the card, at the serving
   paths' shapes and at the kernels' edges (attention: f32 to 2e-5, bf16 to
   2e-2; mLSTM twice that, the SSD scan four times, against its plain
   version run in f32 as the kernel computes; the bf16 mLSTM and SSD kernels
   also against their plain renderings, ``ref.mlstm_attention_sliced`` and
   ``ref.ssd_scan_grouped``, to 2e-2), each timed with CUDA events
   beside its plain version, its bound on this card and, where one PyTorch
   call computes the same function (scaled_dot_product_attention, timed as
   a yardstick only), that call and the kernel/SDPA ratio. The decode
   timings also record the choice behind the launcher's split plan (time
   by rows a split), the SSD timings that behind its heads a block, and one
   elementwise launch gives the floor of a timed call. The attention
   kernels are also checked and timed at kimi-k2's (D = 112, 64 q / 8 kv
   heads) and nemotron-4's (D = 192, 96 / 8) heads, and at
   seamless-m4t-large-v2's (16 q and kv heads of 64): flash over Sq != Sk
   keys (full and top-left causal, one-row and ragged tiles), the encoder
   (S = 4096, not causal; checked at B = 2, timed at B = 2 and 32), the
   cross-attention (128 rows over 4096 frames, B = 32), and decode over a
   4096-row cache at B = 2 and 32. Zamba2-7B's shapes are checked and
   timed with their bounds: flash at B = 8, S = 256, 32 q and kv heads of
   224; decode over a 320-row cache at B = 8 (full and per-row lengths);
   the SSD scan at B = 8, S = 256, H = 112, P = N = 64 with B and C per
   group (G = 2), as views of one conv output. The fused Mamba-2 decode
   step (``ops.mamba2_step``) against its plain version, the model's mixer,
   on the same inputs and state (f32 to 2e-5, bf16 to 8e-2; the conv state
   exactly) at Zamba2-7B's widths at B = 1, 8 and 32 and at Zamba2-1.2B's
   shared B and C, then timed at Zamba2-7B's widths at B = 1, 8 and 32
   beside its bound and the plain decode path (its two kernels apart, from
   torch.profiler, last of all, after phase 11).
   Every flash and decode case is also
   held to its error over each output row's rms (``SCALED_TOL``: at 4096
   keys the outputs are ~0.026, below the absolute tolerance), and at
   4096 keys the plain version that skips keys 64-127 must fail that gate.
4. Models: every registered arch reduced (qwen2, xLSTM, Zamba2,
   llama4-scout, kimi-k2, starcoder2, nemotron-4, yi, internvl2 and
   seamless-m4t, the last from 40 frames) in f32,
   prefill logits and 8 teacher-forced decode steps on the card (kernels)
   against the same port on the CPU (plain versions), to 1e-4.
5. Serving, one model after the other, each in bf16 with random weights
   from a seed, behind MLProxy (``repro_torch.launch.serve``): full-width
   qwen2-0.5b, xlstm-1.3b, zamba2-1.2b and starcoder2-15b, and
   llama4-scout-17b-a16e at full width with 8 of its 48 layers. The
   rate and SLO come from the median of five timed (2, 128) batches.
   Each model is served twice: directly, on one always-warm replica
   (``run_proxy_loop``; every request must come back with its tokens),
   then on the simulated serverless platform (``build_simulator``: cold
   starts, scaling, cost), every batch executed on the card; every
   arrival must complete with an average batch above 1. qwen2-0.5b is
   also served under the passthrough policy, the paper's baseline, and
   its cost and violations are printed beside MLProxy's. The engine runs
   each batch as two replayed CUDA graphs, its prefill's and its decode
   loop's, captured at warmup. Each serving run sets the launch counts to
   0 just before it and reads them just after: every batch must have
   replayed both graphs, and each model's kernels must have run once per
   layer (for Zamba2, once per Mamba layer and once per shared-block
   application) for every prefill and, for the attention models and
   Zamba2's fused Mamba-2 step, every decode step; the ``kernels`` line
   sums them over the runs. Then: the
   replayed graphs must give the eager per-token loop's tokens, for one
   batch and for two through the pooled cache; a pooled cache must give a
   batch the tokens a fresh cache gives it; for qwen2-0.5b, a decode past
   ``max_len`` must give tokens with no device assert, eager and
   replayed, and a replica that captures a new key must not wait for
   another replica's stream. Then a bucket-32 ``generate()`` under
   torch.profiler on the graphs (the port's kernels by name must equal the
   counted launches), the device time of the prefill graph apart from the
   decode-loop graph (CUDA events), the graph pool's size and the peak
   memory, and the same profile of the eager fused loop (a fresh cache a
   call, so no graph) on the same weights.
6. Live runtime: two replicas of full-width qwen2-0.5b (one copy of the
   weights, a CUDA stream each) behind the wall-clock ``AsyncProxyServer``
   (``repro_torch.runtime``): ``run_replay`` with Poisson arrivals at
   twice the one-replica rate for 20 s, MLProxy, ``EngineTarget`` running
   each batch on an executor thread. Every request must be conserved and
   complete with its 16 tokens, the average batch must be above 1 and
   both replicas must serve; it prints p95, violations and how many
   batches overlapped one on the other replica (every batch must replay
   its two graphs). Then 10 s behind
   ``FaultyTarget`` (crashes, partial batches, stragglers; 2 retries, a
   circuit breaker), which must conserve every request; then
   ``measure_engine`` on the idle card beside the live run's per-bucket
   latencies. Launch counts as in 5, summed over both replicas.
7. Wide: yi-34b (8 layers), nemotron-4-340b (2), kimi-k2-1t-a32b (1),
   internvl2-76b (4) and zamba2-7b (all 81, the published layout) at
   full width, one engine each (batch buckets 2 and
   32, prompt 128, 16 tokens): warmup captures the graphs, one
   ``generate()`` a bucket with exact launches, its tokens exactly the
   per-token eager loop's; the peak memory and the two graphs' device
   time at bucket 32. Then zamba2-7b alone at its benchmark cell's shapes
   (prompt 256, 64 tokens): the prefill and decode-loop graphs' device
   time at buckets 1, 8 and 32, and the loop's ms a decode step.
8. Encoder-decoder: seamless-m4t-large-v2 at full width, nothing cut
   (1.632 G params, bf16, weights from seed 0), through ``Model.prefill``
   on (B, 4096, 1024) random frames and 128-token prompts, then 15 greedy
   ``decode_step`` calls (16 tokens, a 144-row cache), at B = 2 and 32: the
   launch counts (72 flash a prefill, 48 decode a step), the prefill and
   the decode step in ms (CUDA events), the peak memory, a profile whose
   port kernels must equal the counted launches, and the greedy tokens
   against the same loop with the attention's plain versions on the card
   (the bf16 logits on the same inputs held to 0.1; the top-2 margins
   printed where a token differs); the loop again with every attention
   call held to its plain version on its own inputs (``SCALED_TOL``); at
   B = 2 the same loop in f32, every step's logits held to the plain
   versions' (fed the same tokens) to 1e-3.
9. Fleet controller (``core/fleet_controller.py``): 10,000 endpoints, 8
   buckets, 64-sample rings (20 MB), 300 ticks of ``record_upstream`` /
   ``record_e2e`` / ``record_dispatch`` / ``timeout_step`` and an
   ``aimd_step`` every 10 ticks on the card, twice; every decision
   (dispatch now, timeout, Max_BS) equal to the same ticks on the CPU,
   tick for tick; the card's µs a tick.

10. Training (``Model.loss``, ``launch/train.py``, ``optim/adamw.py``),
   which runs the kernels' plain versions, as the JAX package trains on
   its plain path (the kernels have no backward): each wrapper, given a
   CUDA input that requires grad, raises, under ``no_grad`` launches once,
   and inside ``ops.plain_versions()`` returns the plain result with a
   gradient and counts no launch; every registered arch reduced (f32, TF32
   off): ``Model.loss`` and every gradient leaf on the card with
   ``remat=True`` against the same port on the CPU without, to 1e-4 of each
   leaf's max |g|; then full-width qwen2-0.5b in bf16 (random weights from
   seed 0, ``remat=True``), batches of 8 x 512 from the port's
   ``TokenDataset``: every gradient leaf on the step-1 params and batch
   against the CPU's f32 (relative L2 error, ``TRAIN_GRAD_L2_TOL``); 10
   steps of ``make_train_step`` (warmup 2): ms a step (CUDA events, median
   of the last 8), tokens/s, achieved TFLOP/s against the 989 TFLOP/s bf16
   peak, peak memory, a profile of one step by kernel, the loss at step 1
   and step 10 (every loss finite, step 10 below step 1, step 1 within
   ``TRAIN_LOSS_TOL`` of the CPU's f32 loss and its grad norm within
   ``TRAIN_NORM_TOL`` of the CPU's); a checkpoint saved on the card after
   step 5 and restored into fresh tensors equals the saved params and
   AdamW state bit for bit and gives step 6 the uninterrupted run's loss
   to 1e-3; no kernel launch in the training.

11. Placement (``launch/mesh.py``, ``distributed/{sharding,elastic}.py``,
   ``models/moe.py``'s expert-parallel plans, ``launch/dryrun.py``), last,
   inside a ``try/finally`` that destroys the process group: an NCCL group
   of one rank and a (1, 1) ("data", "model") mesh on the card; full-width
   qwen2-0.5b's bf16 params saved and ``restore_elastic``-ed onto the mesh,
   every ``full_tensor()`` bit-equal to the saved leaf, and a bucket-32,
   16-token ``generate()`` from the restored blocks with exactly the
   original params' tokens and exact launches (added to the ``kernels``
   line); kimi-k2's MoE layer at full width (D 7168, 384 experts of 2048,
   top-8, bf16, seed 0; 33.8 GB) at B = 32 x 128 tokens (the
   weight-gather plan, as the world-1 mesh runs it; on 2 x 8 ranks the
   napkin rule would route tokens up to T = 73,727) and B = 32 x 1
   (token-route): ``moe_ffn`` under the
   world-1 mesh against the global path at capacity 1.25, and
   ``_local_dispatch_compute`` for 8 model ranks x 2 data ranks summed as
   the all-reduce sums them, against the global path at 8.0 (nothing
   drops) and against the same ranks on the CPU in f32 at 1.25 (bf16 gate
   2e-2; rows whose router logits tie within 1e-4 are left out, and
   counted), the global layer and one rank timed with CUDA events; then
   ``python -m repro_torch.launch.dryrun --arch kimi-k2-1t-a32b --shape
   decode_32k --no-save`` in a subprocess (the fake backend at 256 ranks),
   its roofline row and host seconds printed.

It prints a ``kernels`` JSON line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense; f32 off the tensor cores
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MLSTM_TOL = {k: 2 * v for k, v in TOL.items()}  # the signed denominator amplifies rounding
SSD_TOL = {k: 4 * v for k, v in TOL.items()}  # long products of decays amplify rounding
MODEL_TOL = 1e-4
#: the attention kernels' error against each output row's own scale: the
#: largest, over rows (query, head), of max |got - want| / rms(want) over
#: the row's D values. Over thousands of unit-variance keys the outputs
#: average out to ~sqrt(e / Sk) (0.026 at 4096 keys), where TOL's absolute
#: part is as large as a typical output and a kernel that skipped a 64-key
#: tile would pass it. A bf16 rounding of a row's largest values is a few
#: hundredths of its rms; a skipped tile of 4096 keys moves a row by ~0.12
#: of it typically (each long case also shows that its skipped-tile plain
#: version fails this gate)
SCALED_TOL = {"float32": 1e-3, "bfloat16": 0.1}
#: key (or cache) rows from which a case also checks the skipped-tile gate
LONG_KEYS = 1024
#: library -> name prefix of its bf16 tensor-core instantiations
TENSOR_CORE_KERNELS = {"flash_attention": "flash_mma_kernel",
                       "mlstm_attention": "mlstm_mma_kernel", "ssd_scan": "ssd_mma_kernel"}
#: phase 4: every registered arch, reduced, card against CPU
MODEL_ARCHS = ("qwen2-0.5b", "xlstm-1.3b", "zamba2-1.2b", "llama4-scout-17b-a16e",
               "kimi-k2-1t-a32b", "starcoder2-15b", "nemotron-4-340b", "yi-34b",
               "internvl2-76b", "seamless-m4t-large-v2")
#: phase 4: the encoder frames of the reduced encoder-decoder (more than
#: its attn_q_chunk of 16, fewer than the kernels' 64-row tiles)
MODEL_FRAMES = 40
#: arrivals of each simulated-platform run (duration = arrivals / rate)
SIM_ARRIVALS = {"qwen2-0.5b": 300, "xlstm-1.3b": 100, "zamba2-1.2b": 300,
                "starcoder2-15b": 100, "llama4-scout-17b-a16e": 100}
#: requests of each direct (one warm replica, no platform) run
DIRECT_REQUESTS = {"qwen2-0.5b": 60, "xlstm-1.3b": 30, "zamba2-1.2b": 60,
                   "starcoder2-15b": 30, "llama4-scout-17b-a16e": 30}
#: served at full width with fewer layers than published (the rest whole):
#: llama4-scout's 48 layers are 211 GB in bf16, 8 of them 39.4 GB
SERVE_DEPTH = {"llama4-scout-17b-a16e": 8}
#: phase 7: full width at a cut depth (zamba2-7b whole), one engine each
#: (bf16 weights: yi ~10.8 GB, nemotron ~32.7 GB, kimi ~38.8 GB, internvl2
#: ~11.0 GB, zamba2-7b ~14.7 GB)
WIDE_DEPTH = {"yi-34b": 8, "nemotron-4-340b": 2, "kimi-k2-1t-a32b": 1, "internvl2-76b": 4,
              "zamba2-7b": 81}
#: the model also served under the passthrough policy (the paper's baseline)
PASSTHROUGH_ARCH, PASSTHROUGH_ARRIVALS = "qwen2-0.5b", 100
#: the live runtime's replicas and wall seconds of arrivals (MLProxy, chaos)
LIVE_REPLICAS, LIVE_SECONDS, CHAOS_SECONDS = 2, 20.0, 10.0
#: phase 8: seamless-m4t-large-v2's batches, encoder frames, prompt, cache
#: rows and greedy tokens
ENCDEC_BATCHES, ENCDEC_FRAMES, ENCDEC_PROMPT, ENCDEC_MAX_LEN, ENCDEC_TOKENS = (
    (2, 32), 4096, 128, 144, 16)
#: f32 logits (prefill and decode steps), kernels against plain versions
#: fed the same tokens, at full width: both
#: paths run the same f32 GEMMs (TF32 off); they differ in the attention's
#: summation order (online softmax over 64-key tiles against one softmax
#: over the row), ~1e-6 relative an output, carried through 48 layers
ENCDEC_F32_TOL = 1e-3
#: bf16 logits, kernels against plain versions on the same inputs (the
#: prefill's and each step's up to a row's first differing greedy token):
#: both paths keep a bf16 residual stream, so the attention's rounding
#: differences pass through 48 layers to logits (up to ~5) that land on
#: bf16 steps of 1/32, where greedy ties are exact. A plain prefill that
#: skips one 64-key tile of the encoder's and the cross-attention's 4096
#: keys moves them little more (random weights: the residual stream hardly
#: sees attention outputs averaged over 4096 keys), so each attention call
#: is also held to its plain version on its own inputs
#: (``checked_attention``), and phase 3 holds the kernels at these shapes
#: on random inputs, where a skipped tile fails :data:`SCALED_TOL`
ENCDEC_BF16_TOL = 0.1
#: phase 9: endpoints, buckets, samples a ring, ticks, AIMD every so many
#: ticks, upstream and end-to-end observations a tick
FLEET_N, FLEET_BUCKETS, FLEET_WINDOW, FLEET_TICKS, FLEET_AIMD_EVERY = 10_000, 8, 64, 300, 10
FLEET_UPSTREAM, FLEET_E2E = 2_000, 1_000
#: phase 10: the trained arch at full width, its batch and sequence, the
#: steps, the schedule's warmup, the steps timed (the last ones), the step
#: after which a checkpoint is saved and restored
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_WARMUP, TRAIN_TIMED = (
    "qwen2-0.5b", 8, 512, 10, 2, 8)
TRAIN_CKPT_AFTER = 5
#: reduced archs, card against CPU: each gradient leaf to this share of its
#: largest |g| (the loss to 1e-5 of itself)
TRAIN_GRAD_TOL = 1e-4
#: full width: the card's bf16 step-1 loss against the CPU's f32 loss on the
#: same params and batch (both ~ln V = 11.93; 3.5e-4 measured)
TRAIN_LOSS_TOL = 2e-3
#: full width, the same params and batch: each gradient leaf of the card's
#: bf16 loss against the CPU's f32, ||g_card - g_cpu|| / ||g_cpu|| (5.4e-2
#: measured at worst, the tied embedding; 7.5e-3 the median leaf), and the
#: step-1 grad norm against the CPU's (1.0e-2 measured); a dropped or
#: mis-scaled gradient is off by about 1
TRAIN_GRAD_L2_TOL = 0.1
TRAIN_NORM_TOL = 0.02
#: the step after a restored checkpoint against the uninterrupted run's
TRAIN_RESTORE_TOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------- measuring
def device_ms(torch, fn, samples: int = 25) -> float:
    """Median device time of one ``fn()`` over ``samples`` runs.

    Before each run the stream is held busy by a sleep kernel, so the host
    enqueues both events and the launch before the device reaches them:
    the events then time the device, not the host's launch overhead.
    """
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def split_sweep(torch, dec, q, kc, vc, lens) -> str:
    """Device ms of the decode kernel at forced split sizes (rows a split):
    the record behind ``split_plan``'s choice."""
    s_max = kc.shape[1]
    times = [f"{sl}: {device_ms(torch, lambda: dec.decode_attention_fwd(q, kc, vc, lens, split_len=sl)):.5f}"
             for sl in (18, 24, 36, 48, 72, s_max)]
    return "ms by rows a split " + ", ".join(times)


def check_close(torch, got, want, tol: float, what: str) -> float:
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite output")
    err = (got - want).abs()
    bad = err > tol + tol * want.abs()
    max_err = float(err.max())
    if bool(bad.any()):
        raise AssertionError(f"{what}: max abs err {max_err:.3e} over tolerance {tol}")
    return max_err


def check_scaled(torch, got, want, limit: float, what: str) -> float:
    """:func:`scaled_err`, which must be at most ``limit``
    (:data:`SCALED_TOL`)."""
    err = scaled_err(torch, got, want)
    if err > limit:
        raise AssertionError(f"{what}: max abs err {err:.3e} of its row's rms, over {limit}")
    return err


def scaled_err(torch, got, want) -> float:
    """The largest, over output rows (the last axis), of max |got - want|
    over the row / rms(want) over the row; a row where ``want`` is all
    zeros must be zeros (else inf)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs().amax(-1)
    rms = want.pow(2).mean(-1).sqrt()
    zero = rms == 0
    if bool((diff[zero] > 0).any()):
        return float("inf")
    return float((diff[~zero] / rms[~zero]).max()) if bool((~zero).any()) else 0.0


def skip_tile(torch, x):
    """``x`` (B, S, H, D) without rows 64-127: the keys or cache rows a
    kernel that skipped its second 64-row tile would read."""
    return torch.cat([x[:, :64], x[:, 128:]], 1)


def skipped_tile_err(torch, want, dn: str, what: str, plain_skipped) -> float:
    """The scaled error of ``plain_skipped`` (the plain version over the
    rows :func:`skip_tile` keeps) against ``want``: it must fail
    :data:`SCALED_TOL`, or that gate could not tell such a kernel from a
    right one."""
    err = scaled_err(torch, plain_skipped, want)
    if err <= SCALED_TOL[dn]:
        raise AssertionError(f"{what}: skipping rows 64-127 moves the output by only {err:.3e} "
                             f"of its rms, within the gate {SCALED_TOL[dn]}")
    return err


def bound(nbytes: int, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ phases
def phase_build():
    from repro_torch.kernels import build

    t0 = time.monotonic()
    built = build.build()
    log(f"[build] {len(built)} kernels built in {time.monotonic() - t0:.1f} s "
        f"(nvcc {build.nvcc_path()})")
    for name, (secs, report) in built.items():
        log(f"[build] {name}: {secs:.1f} s")
        for kernel, regs, smem, spill in ptxas_summary(report):
            log(f"[build]   {kernel}: {regs} registers, {smem} B static smem, {spill} B spilled")
    # the bf16 flash, mLSTM and SSD kernels run on the tensor cores: count
    # their HMMA instructions
    for name, prefix in TENSOR_CORE_KERNELS.items():
        counts = sass_mma_counts(build.library_path(name))
        log(f"[build] tensor-core (HMMA) instructions in the {name} library (cuobjdump -sass): "
            + ", ".join(f"{k}: {n}" for k, n in sorted(counts.items()) if k.startswith(prefix)))
        mma = {k: n for k, n in counts.items() if k.startswith(prefix)}
        if not mma or not all(n > 0 for n in mma.values()):
            raise AssertionError(f"a bf16 {name} kernel issues no mma instruction: {counts}")


def kernel_name(mangled: str) -> str:
    """kernel<template args> from a mangled entry-function name."""
    import re

    m = re.search(r"\d([a-z_]+_kernel)I(.+?)EEv", mangled)
    if not m:
        return mangled
    args = [n or ("bf16" if bf else "float") for n, bf, _ in
            re.findall(r"Li(-?\d+)E|(13__nv_bfloat16)|(f)", m.group(2))]
    return f"{m.group(1)}<{','.join(args)}>"


def sass_mma_counts(library) -> dict:
    """HMMA (tensor-core mma) instructions of each kernel in a built
    library, from ``cuobjdump -sass``."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library)], check=True, capture_output=True,
                          text=True, timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            counts[name] = 0
        elif name and re.search(r"\bHMMA\.", line):
            counts[name] += 1
    return counts


def ptxas_summary(report: str):
    """(kernel<template args>, registers, static shared-memory bytes, spill
    bytes) of each entry function in an ``nvcc -Xptxas -v`` report."""
    import re

    rows, name, spill = [], None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append((kernel_name(name), int(m.group(1)), int(smem.group(1)) if smem else 0,
                         spill))
            name = None
    return rows


def phase_kernels(torch):
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as _dec
    from repro_torch.kernels import mlstm_attention as _ml
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ssd_scan as _ssd

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    rows = {}
    # ---- prefill: (B, S, Hq, Hkv, D, dtype, causal)
    flash_cases = [
        (1, 128, 14, 2, 64, torch.bfloat16, True),
        (32, 128, 14, 2, 64, torch.bfloat16, True),
        (2, 200, 14, 2, 64, torch.float32, True),
        (2, 200, 14, 2, 64, torch.float32, False),
        (2, 257, 4, 1, 32, torch.float32, True),
        (32, 128, 32, 32, 64, torch.bfloat16, True),  # Zamba2's shared block (G = 1)
        (8, 256, 32, 32, 224, torch.bfloat16, True),  # Zamba2-7B's, bucket 8
        (2, 256, 32, 32, 224, torch.float32, True),
    ]
    # kimi-k2's (D = 112, G = 8) and nemotron-4's (D = 192, G = 12) heads at
    # bucket 32 and prompt 128, and in f32
    for hq, d in ((64, 112), (96, 192)):
        flash_cases += [(32, 128, hq, 8, d, torch.bfloat16, True),
                        (2, 128, hq, 8, d, torch.float32, True),
                        (2, 77, hq, 8, d, torch.float32, False)]
    # the tensor-core (bf16) kernel's edges: one-row and ragged tiles, every
    # head dim, G = 1, 2 and 7, causal and full
    flash_cases += [(2, s, hq, hkv, d, torch.bfloat16, causal)
                    for s in (1, 24, 200, 257) for d in (16, 32, 112, 128, 192, 224)
                    for hq, hkv in ((4, 4), (4, 2), (14, 2)) for causal in (True, False)]
    # Sq query rows over Sk keys, as the TPU kernel takes them: one-row and
    # ragged tiles either way round, full and causal (top-left aligned), f32
    # and bf16; an eighth entry is Sk
    flash_cases += [(2, sq, hq, hkv, d, dtype, causal, sk)
                    for sq, sk in ((1, 130), (24, 257), (257, 24), (200, 64))
                    for d in (64, 112, 192) for hq, hkv in ((4, 4), (4, 2))
                    for dtype in (torch.float32, torch.bfloat16) for causal in (False, True)]
    # seamless-m4t-large-v2 (16 q and kv heads of 64), not causal: the
    # encoder at S = 4096 (B = 2: the plain version's f32 scores take 2.1 GB
    # there, 34 GB at B = 32) and the cross-attention, 128 prompt rows over
    # 4096 frames at B = 32
    flash_cases += [(2, 4096, 16, 16, 64, dtype, False) for dtype in (torch.float32, torch.bfloat16)]
    flash_cases += [(32, 128, 16, 16, 64, dtype, False, 4096)
                    for dtype in (torch.float32, torch.bfloat16)]
    max_err = 0.0
    for b, s, hq, hkv, d, dtype, causal, *sk in flash_cases:
        sk = sk[0] if sk else s
        q = randn((b, s, hq, d), dtype)
        k = randn((b, sk, hkv, d), dtype)
        v = randn((b, sk, hkv, d), dtype)
        dn = str(dtype).split(".")[-1]
        what = f"flash_attention {b}x{s}/{sk}x{hq}/{hkv}x{d} {dn} causal={causal}"
        got = ops.flash_attention(q, k, v, causal=causal)
        want = ref.flash_attention(q, k, v, causal=causal)
        err = check_close(torch, got, want, TOL[dn], what)
        scaled = check_scaled(torch, got, want, SCALED_TOL[dn], what)
        skipped = ""
        if sk >= LONG_KEYS:
            bad = skipped_tile_err(torch, want, dn, what, ref.flash_attention(
                q, skip_tile(torch, k), skip_tile(torch, v), causal=causal))
            skipped = f"; the plain version skipping keys 64-127: {bad:.3e} of the rms"
        max_err = max(max_err, err)
        log(f"[kernels] flash_attention B={b} Sq={s} Sk={sk} Hq={hq} Hkv={hkv} D={d} {dn} "
            f"causal={causal}: max abs err {err:.3e}, {scaled:.3e} of its row's rms "
            f"(gate {SCALED_TOL[dn]}){skipped}")
        del q, k, v, got, want
    # timed at the serving shape: B=32, prompt bucket 128, bf16, causal
    b, s, hq, hkv, d = 32, 128, 14, 2, 64
    q, k, v = (randn((b, s, h, d), torch.bfloat16) for h in (hq, hkv, hkv))
    g = hq // hkv
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ke, ve = kt.repeat_interleave(g, dim=1), vt.repeat_interleave(g, dim=1)
    ms = device_ms(torch, lambda: ops.flash_attention(q, k, v, causal=True))
    plain_ms = device_ms(torch, lambda: ref.flash_attention(q, k, v, causal=True))
    lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(qt, ke, ve, is_causal=True))
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    flops = 4 * b * hq * d * s * (s + 1) / 2
    bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
    rows["flash_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:78", max_abs_err=max_err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=lib_ms, shape=f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} bf16 causal",
        bytes=nbytes, flops=flops)
    log(f"[kernels] flash_attention timed ({rows['flash_attention']['shape']}): "
        f"kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, sdpa {lib_ms:.5f} ms, "
        f"bound {bound_ms:.5f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP); "
        f"kernel/sdpa {ms / lib_ms:.3f}")
    # seamless-m4t-large-v2's flash shapes, bf16, not causal, timed for the
    # record: the encoder at B = 2 and 32, the cross-attention at B = 32. At
    # the encoder's B = 32 the plain version is not run: its f32 scores and
    # probabilities would take 69 GB.
    h, d = 16, 64
    for what, b, sq, sk in (("encoder", 2, 4096, 4096), ("encoder", 32, 4096, 4096),
                            ("cross-attention", 32, 128, 4096)):
        q, k, v = (randn((b, n, h, d), torch.bfloat16) for n in (sq, sk, sk))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = device_ms(torch, lambda: ops.flash_attention(q, k, v, causal=False), samples=10)
        plain = ("not run (69 GB of f32 scores)" if what == "encoder" and b == 32 else
                 f"{device_ms(torch, lambda: ref.flash_attention(q, k, v, causal=False), samples=5):.5f} ms")
        lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), samples=10)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        flops = 4 * b * h * d * sq * sk
        bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
        log(f"[kernels] flash_attention timed at seamless-m4t's {what} (B={b} Sq={sq} Sk={sk} "
            f"Hq=Hkv={h} D={d} bf16 full): kernel {ms:.5f} ms, plain {plain}, sdpa "
            f"{lib_ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e12:.3f} TFLOP); kernel/sdpa {ms / lib_ms:.3f}; "
            f"{flops / ms / 1e9:.1f} TFLOP/s")
        del q, k, v, qt, kt, vt

    # ---- decode: (B, S_max, Hq, Hkv, D, dtype, lengths, rows a split or None
    # for the launcher's plan)
    s_max = 144
    decode_cases = [(b, s_max, 14, 2, 64, torch.bfloat16, length, None)
                    for b in (1, 32) for length in (1, 129, 144)] + [
        (32, s_max, 14, 2, 64, torch.float32, 129, None),
        (32, s_max, 14, 2, 64, torch.float32, "per-row", None),
        (4, 640, 4, 4, 32, torch.float32, 501, None),
        (32, s_max, 32, 32, 64, torch.bfloat16, 144, None),  # Zamba2's shared block (G = 1)
    ]
    # Zamba2-7B's: 32 q and kv heads of 224 over its 320-row cache at bucket
    # 8, full, per-row and spread lengths, the planned split and a forced
    # one; bucket 1; and in f32
    decode_cases += [(8, 320, 32, 32, 224, torch.bfloat16, n, sl)
                     for n in (320, "per-row", "spread") for sl in (None, 48)]
    decode_cases += [(1, 320, 32, 32, 224, torch.bfloat16, n, None) for n in (1, 257, 320)]
    decode_cases += [(8, 320, 32, 32, 224, torch.float32, n, None) for n in (320, "per-row")]
    # the split kernel's edges, bf16, buckets 1 and 32 at qwen2's G = 7 and
    # Zamba2's G = 1, with the planned split and forced ones: lengths 0, 1,
    # a split boundary +- 1, S_max, and per-row lengths that put the rows of
    # one batch in different splits
    for b in (1, 32):
        for hq, hkv in ((14, 2), (32, 32)):
            for sl in (None, 48):
                edge = sl or s_max
                decode_cases += [(b, s_max, hq, hkv, 64, torch.bfloat16, n, sl)
                                 for n in (0, 1, edge - 1, edge + 1, s_max, "spread")]
    # kimi-k2's and nemotron-4's heads (D = 112 and 192: a row's 16-byte chunks
    # are not a power of two) at buckets 1 and 32, lengths 0, 1, ragged and
    # full, the planned split and a forced one; and in f32 (f32 D = 192: two
    # chunks a lane)
    for hq, d in ((64, 112), (96, 192)):
        decode_cases += [(b, s_max, hq, 8, d, torch.bfloat16, n, None)
                         for b in (1, 32) for n in (0, 1, 129, 144, "spread")]
        decode_cases += [(1, s_max, hq, 8, d, torch.bfloat16, n, 48)
                         for n in (0, 1, 47, 49, "spread")]
        decode_cases += [(32, s_max, hq, 8, d, torch.float32, n, None) for n in (129, "per-row")]
        decode_cases += [(4, s_max, hq, 8, d, torch.float32, n, 48) for n in (1, 97, "spread")]
    # seamless-m4t-large-v2's two decode shapes, G = 1 over 16 heads of 64:
    # the cross-attention over all 4096 frames (B = 2 and 32; a planned
    # split and, at B = 32, a forced one) and the self-attention cache
    decode_cases += [(b, 4096, 16, 16, 64, dtype, 4096, None)
                     for b in (2, 32) for dtype in (torch.float32, torch.bfloat16)]
    decode_cases += [(32, 4096, 16, 16, 64, torch.bfloat16, n, sl)
                     for n in (1, 1500, "spread") for sl in (None, 1024)]
    decode_cases += [(32, s_max, 16, 16, 64, torch.bfloat16, n, None) for n in (129, 144)]
    max_err = 0.0
    for b, sm, hq, hkv, d, dtype, length, sl in decode_cases:
        q = randn((b, 1, hq, d), dtype)
        kc = randn((b, sm, hkv, d), dtype)
        vc = randn((b, sm, hkv, d), dtype)
        if length == "per-row":
            lens = torch.randint(1, sm + 1, (b,), generator=gen, device="cuda",
                                 dtype=torch.int32)
        elif length == "spread":  # 0 .. S_max across the batch
            lens = torch.tensor([(7 + 37 * i) % (sm + 1) for i in range(b)],
                                dtype=torch.int32, device="cuda")
        else:
            lens = torch.full((1,), length, dtype=torch.int32, device="cuda")
        dn = str(dtype).split(".")[-1]
        plan = _dec.split_plan(b, hkv, sm) if sl is None else (-(-sm // sl), sl)
        got = (ops.decode_attention(q, kc, vc, lens) if sl is None else
               _dec.decode_attention_fwd(q, kc, vc, lens, split_len=sl))
        # where a length is 0 the plain version averages every row; the kernel,
        # like the TPU kernel, gives zeros: held to the plain split-and-merge
        want = (ref.decode_attention(q, kc, vc, lens) if int(lens.min()) > 0 else
                ref.decode_attention_split(q, kc, vc, lens, plan[1]))
        what = f"decode_attention {b}x{sm}x{hq}/{hkv}x{d} {dn} len={length} splits={plan}"
        err = check_close(torch, got, want, TOL[dn], what)
        scaled = check_scaled(torch, got, want, SCALED_TOL[dn], what)
        skipped = ""
        if sm >= LONG_KEYS and isinstance(length, int) and length >= 128:
            bad = skipped_tile_err(torch, want, dn, what, ref.decode_attention(
                q, skip_tile(torch, kc), skip_tile(torch, vc), lens - 64))
            skipped = f"; the plain version skipping rows 64-127: {bad:.3e} of the rms"
        max_err = max(max_err, err)
        log(f"[kernels] decode_attention B={b} S_max={sm} Hq={hq} Hkv={hkv} D={d} {dn} "
            f"len={length} splits={plan}: max abs err {err:.3e}, {scaled:.3e} of its "
            f"row's rms (gate {SCALED_TOL[dn]}){skipped}")
    # rows past the length are never read: junk there changes nothing (bf16, split)
    q = randn((2, 1, 14, 64), torch.bfloat16)
    kc, vc = (randn((2, s_max, 2, 64), torch.bfloat16) for _ in range(2))
    lens = torch.full((1,), 40, dtype=torch.int32, device="cuda")
    before = _dec.decode_attention_fwd(q, kc, vc, lens, split_len=24)
    kc[:, 40:], vc[:, 40:] = 999.0, -999.0
    if not torch.equal(before, _dec.decode_attention_fwd(q, kc, vc, lens, split_len=24)):
        raise AssertionError("decode_attention read cache rows past the length")
    log("[kernels] decode_attention bf16, 6 splits of 24, length 40: junk past the length "
        "changes nothing")
    # timed at the serving shape: B=32, S_max=144, every row full, bf16
    b, hq, hkv, d, length = 32, 14, 2, 64, 144
    q = randn((b, 1, hq, d), torch.bfloat16)
    kc = randn((b, s_max, hkv, d), torch.bfloat16)
    vc = randn((b, s_max, hkv, d), torch.bfloat16)
    lens = torch.full((1,), length, dtype=torch.int32, device="cuda")
    g = hq // hkv
    qt = q.transpose(1, 2)
    ke = kc[:, :length].transpose(1, 2).repeat_interleave(g, dim=1)
    ve = vc[:, :length].transpose(1, 2).repeat_interleave(g, dim=1)
    ms = device_ms(torch, lambda: ops.decode_attention(q, kc, vc, lens))
    plain_ms = device_ms(torch, lambda: ref.decode_attention(q, kc, vc, lens))
    lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(qt, ke, ve))
    nbytes = 2 * (2 * q.numel() + 2 * b * length * hkv * d) + 4
    flops = 4 * b * hq * d * length
    bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
    rows["decode_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:65", max_abs_err=max_err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=lib_ms, shape=f"B={b} S_max={s_max} len={length} Hq={hq} Hkv={hkv} D={d} bf16",
        bytes=nbytes, flops=flops)
    log(f"[kernels] decode_attention timed ({rows['decode_attention']['shape']}): "
        f"kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, sdpa {lib_ms:.5f} ms, "
        f"bound {bound_ms:.5f} ms ({bound_by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP); "
        f"kernel/sdpa {ms / lib_ms:.3f}; splits {_dec.split_plan(b, hkv, s_max)}; "
        f"{split_sweep(torch, _dec, q, kc, vc, lens)}")
    # bucket 1, where the split matters most
    q1, kc1, vc1 = q[:1], kc[:1].clone(), vc[:1].clone()
    ms1 = device_ms(torch, lambda: ops.decode_attention(q1, kc1, vc1, lens))
    lib1 = device_ms(torch, lambda: F.scaled_dot_product_attention(qt[:1], ke[:1], ve[:1]))
    b1_ms, _ = bound(2 * (2 * q1.numel() + 2 * length * hkv * d) + 4, flops / b, "bfloat16")
    log(f"[kernels] decode_attention timed at bucket 1 (B=1 S_max={s_max} len={length} "
        f"Hq={hq} Hkv={hkv} D={d} bf16): kernel {ms1:.5f} ms, sdpa {lib1:.5f} ms, "
        f"bound {b1_ms:.5f} ms; kernel/sdpa {ms1 / lib1:.3f}; splits "
        f"{_dec.split_plan(1, hkv, s_max)}; {split_sweep(torch, _dec, q1, kc1, vc1, lens)}")

    # the attention kernels at Zamba2's shared-block shape, 32 q on 32 kv heads,
    # timed for the record (the kernels line keeps the qwen2 shapes above)
    b, h, d = 32, 32, 64
    q, k, v = (randn((b, 128, h, d), torch.bfloat16) for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ms = device_ms(torch, lambda: ops.flash_attention(q, k, v, causal=True))
    lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    bound_ms, _ = bound(2 * 4 * q.numel(), 4 * b * h * d * 128 * 129 / 2, "bfloat16")
    log(f"[kernels] flash_attention timed at Zamba2's shape (B={b} S=128 Hq=Hkv={h} D={d} "
        f"bf16 causal): kernel {ms:.5f} ms, sdpa {lib_ms:.5f} ms, bound {bound_ms:.5f} ms; "
        f"kernel/sdpa {ms / lib_ms:.3f}")
    lens = torch.full((1,), s_max, dtype=torch.int32, device="cuda")
    for b in (32, 1):
        q = randn((b, 1, h, d), torch.bfloat16)
        kc, vc = (randn((b, s_max, h, d), torch.bfloat16) for _ in range(2))
        qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
        ms = device_ms(torch, lambda: ops.decode_attention(q, kc, vc, lens))
        lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
        bound_ms, _ = bound(2 * (2 * q.numel() + 2 * kc.numel()) + 4, 4 * b * h * d * s_max,
                            "bfloat16")
        log(f"[kernels] decode_attention timed at Zamba2's shape (B={b} S_max={s_max} "
            f"len={s_max} Hq=Hkv={h} D={d} bf16): kernel {ms:.5f} ms, sdpa {lib_ms:.5f} ms, "
            f"bound {bound_ms:.5f} ms; kernel/sdpa {ms / lib_ms:.3f}; splits "
            f"{_dec.split_plan(b, h, s_max)}; {split_sweep(torch, _dec, q, kc, vc, lens)}")

    # and at Zamba2-7B's: bucket 8, prompt 256, 32 q and kv heads of 224;
    # decode over its 320-row cache (256 + 64), every row full
    b, s, h, d, s_cache = 8, 256, 32, 224, 320
    q, k, v = (randn((b, s, h, d), torch.bfloat16) for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    ms = device_ms(torch, lambda: ops.flash_attention(q, k, v, causal=True))
    plain_ms = device_ms(torch, lambda: ref.flash_attention(q, k, v, causal=True), samples=5)
    lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    bound_ms, bound_by = bound(2 * 4 * q.numel(), 4 * b * h * d * s * (s + 1) / 2, "bfloat16")
    log(f"[kernels] flash_attention timed at Zamba2-7B's shape (B={b} S={s} Hq=Hkv={h} D={d} "
        f"bf16 causal): kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, sdpa {lib_ms:.5f} ms, "
        f"bound {bound_ms:.5f} ms ({bound_by}); kernel/sdpa {ms / lib_ms:.3f}")
    lens = torch.full((1,), s_cache, dtype=torch.int32, device="cuda")
    q = randn((b, 1, h, d), torch.bfloat16)
    kc, vc = (randn((b, s_cache, h, d), torch.bfloat16) for _ in range(2))
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    ms = device_ms(torch, lambda: ops.decode_attention(q, kc, vc, lens))
    plain_ms = device_ms(torch, lambda: ref.decode_attention(q, kc, vc, lens))
    lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
    bound_ms, bound_by = bound(2 * (2 * q.numel() + 2 * kc.numel()) + 4,
                               4 * b * h * d * s_cache, "bfloat16")
    log(f"[kernels] decode_attention timed at Zamba2-7B's shape (B={b} S_max={s_cache} "
        f"len={s_cache} Hq=Hkv={h} D={d} bf16): kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
        f"sdpa {lib_ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by}); kernel/sdpa "
        f"{ms / lib_ms:.3f}; splits {_dec.split_plan(b, h, s_cache)}")
    # where splitting pays: one sequence over a long cache, qwen2's heads
    q = randn((1, 1, 14, 64), torch.bfloat16)
    kc, vc = (randn((1, 4096, 2, 64), torch.bfloat16) for _ in range(2))
    lens = torch.full((1,), 4096, dtype=torch.int32, device="cuda")
    ms = device_ms(torch, lambda: ops.decode_attention(q, kc, vc, lens))
    log(f"[kernels] decode_attention timed at B=1 S_max=4096 len=4096 Hq=14 Hkv=2 D=64 bf16: "
        f"kernel {ms:.5f} ms, splits {_dec.split_plan(1, 2, 4096)}; ms by rows a split "
        + ", ".join(f"{sl}: {device_ms(torch, lambda: _dec.decode_attention_fwd(q, kc, vc, lens, split_len=sl)):.5f}"
                    for sl in (512, 1024, 2048, 4096)))
    # the attention kernels at kimi-k2's (D = 112) and nemotron-4's (D = 192)
    # heads, bucket 32, prompt 128 / S_max 144, timed for the record
    for model, hq, hkv, d in (("kimi-k2", 64, 8, 112), ("nemotron-4", 96, 8, 192)):
        b, s, g = 32, 128, hq // hkv
        q, k, v = (randn((b, s, h, d), torch.bfloat16) for h in (hq, hkv, hkv))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ke, ve = kt.repeat_interleave(g, dim=1), vt.repeat_interleave(g, dim=1)
        ms = device_ms(torch, lambda: ops.flash_attention(q, k, v, causal=True))
        plain_ms = device_ms(torch, lambda: ref.flash_attention(q, k, v, causal=True))
        lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(qt, ke, ve,
                                                                         is_causal=True))
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        bound_ms, bound_by = bound(nbytes, 4 * b * hq * d * s * (s + 1) / 2, "bfloat16")
        log(f"[kernels] flash_attention timed at {model}'s heads (B={b} S={s} Hq={hq} "
            f"Hkv={hkv} D={d} bf16 causal): kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, sdpa "
            f"{lib_ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by}: {nbytes / 1e6:.1f} MB); "
            f"kernel/sdpa {ms / lib_ms:.3f}")
        q = randn((b, 1, hq, d), torch.bfloat16)
        kc, vc = (randn((b, s_max, hkv, d), torch.bfloat16) for _ in range(2))
        lens = torch.full((1,), s_max, dtype=torch.int32, device="cuda")
        qt = q.transpose(1, 2)
        ke, ve = (c.transpose(1, 2).repeat_interleave(g, dim=1) for c in (kc, vc))
        ms = device_ms(torch, lambda: ops.decode_attention(q, kc, vc, lens))
        plain_ms = device_ms(torch, lambda: ref.decode_attention(q, kc, vc, lens))
        lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(qt, ke, ve))
        nbytes = 2 * (2 * q.numel() + 2 * kc.numel()) + 4
        bound_ms, bound_by = bound(nbytes, 4 * b * hq * d * s_max, "bfloat16")
        log(f"[kernels] decode_attention timed at {model}'s heads (B={b} S_max={s_max} "
            f"len={s_max} Hq={hq} Hkv={hkv} D={d} bf16): kernel {ms:.5f} ms, plain "
            f"{plain_ms:.5f} ms, sdpa {lib_ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
            f"{nbytes / 1e6:.2f} MB); kernel/sdpa {ms / lib_ms:.3f}; splits "
            f"{_dec.split_plan(b, hkv, s_max)}")
    # seamless-m4t-large-v2's cross-attention at decode: one query a head
    # over all 4096 encoder frames, G = 1, buckets 2 and 32
    h, d, s_enc = 16, 64, 4096
    lens = torch.full((1,), s_enc, dtype=torch.int32, device="cuda")
    for b in (2, 32):
        q = randn((b, 1, h, d), torch.bfloat16)
        kc, vc = (randn((b, s_enc, h, d), torch.bfloat16) for _ in range(2))
        qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
        ms = device_ms(torch, lambda: ops.decode_attention(q, kc, vc, lens))
        plain_ms = device_ms(torch, lambda: ref.decode_attention(q, kc, vc, lens))
        lib_ms = device_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
        nbytes = 2 * (2 * q.numel() + 2 * kc.numel()) + 4
        bound_ms, bound_by = bound(nbytes, 4 * b * h * d * s_enc, "bfloat16")
        sweep = ", ".join(
            f"{sl}: {device_ms(torch, lambda: _dec.decode_attention_fwd(q, kc, vc, lens, split_len=sl)):.5f}"
            for sl in (512, 1024, 2048, 4096))
        log(f"[kernels] decode_attention timed at seamless-m4t's cross-attention (B={b} "
            f"S_max={s_enc} len={s_enc} Hq=Hkv={h} D={d} bf16): kernel {ms:.5f} ms, plain "
            f"{plain_ms:.5f} ms, sdpa {lib_ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
            f"{nbytes / 1e6:.1f} MB); kernel/sdpa {ms / lib_ms:.3f}; splits "
            f"{_dec.split_plan(b, h, s_enc)}; ms by rows a split {sweep}")
    one = torch.zeros(1, device="cuda")
    log(f"[kernels] launch floor: one elementwise kernel on 1 element "
        f"{device_ms(torch, lambda: one.add_(1)):.5f} ms")

    # ---- parallel mLSTM: (B, S, H, D, dtype); xLSTM-1.3B's head dim is 1024
    def mlstm_inputs(b, s, h, d, dtype):
        q, k, v = (randn((b, s, h, d), dtype) for _ in range(3))
        log_i = randn((b, s, h), torch.float32) * 0.5
        log_f = F.logsigmoid(randn((b, s, h), torch.float32) + 2.0)
        return q, k, v, log_i, log_f

    mlstm_cases = [
        (1, 128, 4, 1024, torch.bfloat16),
        (32, 128, 4, 1024, torch.bfloat16),
        (4, 40, 4, 1024, torch.float32),
        (2, 200, 4, 64, torch.float32),
        (2, 257, 2, 32, torch.float32),
    ]
    # the tensor-core (bf16) kernel's edges: one row, ragged and several
    # 64-row query tiles, one D-slice (64, 128) and a cluster of 8 (1024);
    # then every other D it dispatches: one slice of 32, clusters of 2 and 4
    mlstm_cases += [(2, s, 2, d, torch.bfloat16)
                    for s in (1, 17, 128, 200, 257) for d in (64, 128, 1024)]
    mlstm_cases += [(2, s, 2, d, torch.bfloat16) for s in (70, 200) for d in (32, 256, 512)]
    max_err = 0.0
    for b, s, h, d, dtype in mlstm_cases:
        args = mlstm_inputs(b, s, h, d, dtype)
        dn = str(dtype).split(".")[-1]
        got = ops.mlstm_attention(*args)
        err = check_close(torch, got, ref.mlstm_attention(*args),
                          MLSTM_TOL[dn], f"mlstm_attention {b}x{s}x{h}x{d} {dn}")
        max_err = max(max_err, err)
        msg = f"max abs err {err:.3e}"
        if dtype == torch.bfloat16:  # and the kernel's own arithmetic, rendered plainly
            rend = check_close(torch, got,
                               ref.mlstm_attention_sliced(*args, slice_cols=_ml.SLICE), TOL[dn],
                               f"mlstm_attention {b}x{s}x{h}x{d} {dn} vs its rendering")
            msg += f"; against the D-sliced hi/lo rendering {rend:.3e}"
        log(f"[kernels] mlstm_attention B={b} S={s} H={h} D={d} {dn}: {msg}")
    # timed at the serving shape: B=32, prompt bucket 128, bf16
    b, s, h, d = 32, 128, 4, 1024
    args = mlstm_inputs(b, s, h, d, torch.bfloat16)
    ms = device_ms(torch, lambda: ops.mlstm_attention(*args))
    plain_ms = device_ms(torch, lambda: ref.mlstm_attention(*args))
    nbytes = 2 * 4 * b * s * h * d + 4 * 2 * b * s * h  # q, k, v, y bf16; two f32 gates
    flops = 4 * b * h * d * s * (s + 1) / 2             # q.k and w.v over j <= i
    bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
    rows["mlstm_attention"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/mlstm_attention.cu",
        replaces="src/repro/kernels/mlstm_attention.py:82", max_abs_err=max_err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, shape=f"B={b} S={s} H={h} D={d} bf16")
    log(f"[kernels] mlstm_attention timed ({rows['mlstm_attention']['shape']}): "
        f"kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, no single library call, "
        f"bound {bound_ms:.5f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)")

    # ---- SSD scan: x, B and C as the model hands them over, views of one
    # conv output (B, S, H·P + 2·G·N); B and C shared (B, S, N) at G = 1,
    # per group (B, S, G, N) otherwise; (B, S, H, P, N, chunk, dtype[, G])
    def ssd_inputs(b, s, h, p, n, dtype, groups=1):
        conv = randn((b, s, h * p + 2 * groups * n), dtype)
        x = conv[..., :h * p].reshape(b, s, h, p)
        bm, cm = conv[..., h * p:h * p + groups * n], conv[..., h * p + groups * n:]
        if groups > 1:
            bm, cm = bm.unflatten(-1, (groups, n)), cm.unflatten(-1, (groups, n))
        dt = F.softplus(randn((b, s, h), torch.float32))
        a = -torch.linspace(1.0, 16.0, h, device="cuda")  # -exp(a_log) at init
        return x, dt, a, bm, cm

    ssd_cases = [
        (1, 128, 64, 64, 64, 128, torch.bfloat16),
        (32, 128, 64, 64, 64, 128, torch.bfloat16),  # Zamba2-1.2B's serving shape
        (32, 32, 64, 64, 64, 128, torch.bfloat16),   # prompt bucket 32: one partial chunk
        (2, 100, 4, 64, 64, 32, torch.bfloat16),     # ragged S over several chunks
        (2, 100, 4, 64, 64, 32, torch.float32),
        (2, 24, 8, 16, 16, 8, torch.float32),        # the reduced model's shape
        (1, 33, 2, 128, 128, 128, torch.float32),    # the largest P and N
        (2, 40, 3, 8, 32, 16, torch.bfloat16),       # P = 8: the CUDA-core kernel in bf16
    ]
    # the tensor-core (bf16) kernel's edges: P = N in {16, 64, 128}, chunks 32
    # and 128, one row, ragged S in one and in several chunks
    ssd_cases += [(2, s, 3, pn, pn, chunk, torch.bfloat16)
                  for pn in (16, 64, 128) for chunk in (32, 128) for s in (1, 70, 300)]
    # B and C per group: Zamba2-7B's serving shape (2 groups of 56 heads,
    # prompt 256 in two 128-row chunks), f32 in 32-row chunks as the f32
    # case above, and groups of 6 heads, which the plan's 4 or 8 heads a
    # block do not divide; each also against the kernel run group by group
    ssd_cases += [(8, 256, 112, 64, 64, 128, torch.bfloat16, 2),
                  (2, 100, 8, 64, 64, 32, torch.float32, 4),
                  (66, 128, 12, 64, 64, 128, torch.bfloat16, 2),
                  (2, 70, 12, 64, 64, 32, torch.bfloat16, 2)]
    # The kernel computes in f32, as the TPU kernel does, and is held to its
    # plain version run on the same values in f32 (rounded to the working
    # dtype once, at the end). Run in bf16, the plain version rounds its
    # (Q x Q) weights to bf16 first, as the JAX model's ssd_chunked does:
    # that error is larger than the kernel's and is reported, not gated.
    max_err = max_err_bf16_plain = 0.0
    for b, s, h, p, n, chunk, dtype, *groups in ssd_cases:
        groups = groups[0] if groups else 1
        args = ssd_inputs(b, s, h, p, n, dtype, groups)
        x, dt, a, bm, cm = args
        dn = str(dtype).split(".")[-1]
        got = ops.ssd_scan(*args, chunk=chunk)
        want = ref.ssd_scan(x.float(), dt, a, bm.float(), cm.float(), chunk=chunk).to(dtype)
        err = check_close(torch, got, want, SSD_TOL[dn],
                          f"ssd_scan {b}x{s}x{h}x{p}x{n} G={groups} chunk {chunk} {dn}")
        max_err = max(max_err, err)
        msg = f"max abs err {err:.3e}"
        if dtype != torch.float32 and p >= 16 and n >= 16:  # the tensor-core kernel
            rend = check_close(torch, got, ref.ssd_scan_grouped(*args, chunk=chunk), TOL[dn],
                               f"ssd_scan {b}x{s}x{h}x{p}x{n} G={groups} chunk {chunk} {dn} "
                               "vs its rendering")
            msg += f"; against the grouped hi/lo rendering {rend:.3e}"
        if groups > 1:  # the grouping alone: each group's heads through the shared-B/C path
            per = ref.by_group(lambda *t, chunk: ops.ssd_scan(*t, chunk=chunk), *args,
                               chunk=chunk)
            same = check_close(torch, got, per, TOL[dn], f"ssd_scan {b}x{s}x{h}x{p}x{n} "
                               f"G={groups} chunk {chunk} {dn} vs the kernel group by group")
            msg += f"; against the kernel run group by group {same:.3e}"
        if dtype != torch.float32:
            plain = ref.ssd_scan(*args, chunk=chunk).float()
            diff = (got.float() - plain).abs()
            over = int((diff > SSD_TOL[dn] * (1 + plain.abs())).sum())
            max_err_bf16_plain = max(max_err_bf16_plain, float(diff.max()))
            msg += (f"; against the plain version run in {dn}: max abs err "
                    f"{float(diff.max()):.3e}, {over} of {diff.numel()} over the tolerance")
        log(f"[kernels] ssd_scan B={b} S={s} H={h} P={p} N={n} G={groups} chunk={chunk} {dn}: "
            f"{msg}")
    # Zamba2-7B's 112 heads in f32 (2 groups, S = 256 in 32-row chunks): held
    # to the kernel run group by group (the shared-B/C path). Against the
    # plain version both are reported, not gated: the f32 kernel takes its
    # decays as exp of differences of f32 running sums (as the TPU kernel),
    # the plain version as segment sums, and over 3.7 M outputs a few differ
    # by more than SSD_TOL. Over 128-row chunks the plain version in f32
    # itself lies up to 2.3e-3 from its f64 run (these decays reach
    # exp(-1600) across a chunk).
    args = ssd_inputs(2, 256, 112, 64, 64, torch.float32, 2)
    got = ops.ssd_scan(*args, chunk=32)
    per = ref.by_group(lambda *t, chunk: ops.ssd_scan(*t, chunk=chunk), *args, chunk=32)
    same = check_close(torch, got, per, TOL["float32"], "ssd_scan 2x256x112x64x64 G=2 chunk 32 "
                       "float32 vs the kernel group by group")
    want = ref.ssd_scan(*args, chunk=32)

    def off_plain(y):
        diff = (y - want).abs()
        over = int((diff > SSD_TOL["float32"] * (1 + want.abs())).sum())
        return f"max abs err {float(diff.max()):.3e}, {over} of {diff.numel()} over SSD_TOL"
    log(f"[kernels] ssd_scan B=2 S=256 H=112 P=N=64 G=2 chunk=32 float32: against the kernel "
        f"run group by group {same:.3e}; against the plain version (reported): grouped "
        f"{off_plain(got)}, the shared-B/C path group by group {off_plain(per)}")
    # 2, 4 and 8 heads a block, as the plan picks them by batch size, H = 5
    # not a multiple of them: one chunk, and several with the states of the
    # block's heads carried in shared memory
    for b, s, chunk, heads in ((66, 128, 128, 4), (132, 128, 128, 8), (44, 70, 32, 2),
                               (66, 70, 32, 4)):
        q = min(chunk, max(s, 8))
        if _ssd.heads_per_block(b, 5, 64, 64, q, -(-s // q)) != heads:
            raise AssertionError(f"ssd_scan B={b} S={s} H=5: the plan does not take "
                                 f"{heads} heads a block")
        x, dt, a, bm, cm = ssd_inputs(b, s, 5, 64, 64, torch.bfloat16)
        got = ops.ssd_scan(x, dt, a, bm, cm, chunk=chunk)
        want = ref.ssd_scan(x.float(), dt, a, bm.float(), cm.float(), chunk=chunk)
        err = check_close(torch, got, want.to(x.dtype), SSD_TOL["bfloat16"],
                          f"ssd_scan S={s} chunk {chunk} H=5, {heads} heads a block")
        rend = check_close(torch, got, ref.ssd_scan_grouped(x, dt, a, bm, cm, chunk=chunk),
                           TOL["bfloat16"], f"ssd_scan S={s} chunk {chunk} H=5, {heads} heads "
                           "a block vs its rendering")
        max_err = max(max_err, err)
        log(f"[kernels] ssd_scan B={b} S={s} H=5 P=N=64 chunk={chunk} bf16, {heads} heads a "
            f"block: max abs err {err:.3e}; against the grouped hi/lo rendering {rend:.3e}")
    # timed at the serving shape: B=32, prompt bucket 128, bf16
    b, s, h, p, n, chunk = 32, 128, 64, 64, 64, 128
    args = ssd_inputs(b, s, h, p, n, torch.bfloat16)
    ms = device_ms(torch, lambda: ops.ssd_scan(*args, chunk=chunk))
    plain_ms = device_ms(torch, lambda: ref.ssd_scan(*args, chunk=chunk))
    nbytes = 2 * 2 * b * s * h * p + 4 * b * s * h + 2 * 2 * b * s * n + 4 * h
    # what the function needs, chunk by chunk: C.B^T over k <= q once per
    # batch row (B and C are shared by the heads); per head w.x over k <= q,
    # C.h^T where a state enters the chunk, the state update where one leaves
    flops = 0.0
    for c0 in range(0, s, chunk):
        q = min(chunk, s - c0)
        state = (c0 > 0) + (c0 + chunk < s)
        flops += 2 * q * (q + 1) / 2 * n + h * 2 * (q * (q + 1) / 2 * p + state * q * p * n)
    flops *= b
    bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
    rows["ssd_scan"] = dict(
        route="cuda", source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:72", max_abs_err=max_err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, shape=f"B={b} S={s} H={h} P={p} N={n} chunk={chunk} bf16",
        max_err_vs_bf16_plain=max_err_bf16_plain)
    log(f"[kernels] ssd_scan timed ({rows['ssd_scan']['shape']}): "
        f"kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, no single library call, "
        f"bound {bound_ms:.5f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP); "
        f"{_ssd.heads_per_block(b, h, p, n, chunk, 1)} heads a block")
    # prompt bucket 32 (one 32-row chunk) and bucket 1, for the record
    for bb, ss in ((32, 32), (1, 128)):
        xs, dts, as_, bms, cms = ssd_inputs(bb, ss, h, p, n, torch.bfloat16)
        t = device_ms(torch, lambda: ops.ssd_scan(xs, dts, as_, bms, cms, chunk=chunk))
        log(f"[kernels] ssd_scan timed at B={bb} S={ss} H={h} P={p} N={n} bf16: kernel "
            f"{t:.5f} ms, {_ssd.heads_per_block(bb, h, p, n, min(chunk, ss), 1)} heads a block")
    # Zamba2-7B's: bucket 8, prompt 256 (two chunks), 112 heads in 2 groups
    # of B and C; C·Bᵀ once per group, the rest per head, as above
    b, s, h, g = 8, 256, 112, 2
    x, dt, a, bm, cm = ssd_inputs(b, s, h, p, n, torch.bfloat16, g)
    ms = device_ms(torch, lambda: ops.ssd_scan(x, dt, a, bm, cm, chunk=chunk))
    plain_ms = device_ms(torch, lambda: ref.ssd_scan(x, dt, a, bm, cm, chunk=chunk), samples=5)
    shared_ms = device_ms(torch, lambda: ops.ssd_scan(x, dt, a, bm[:, :, 0], cm[:, :, 0],
                                                       chunk=chunk))
    nbytes = 2 * 2 * b * s * h * p + 4 * b * s * h + 2 * 2 * b * s * g * n + 4 * h
    flops = 0.0
    for c0 in range(0, s, chunk):
        q = min(chunk, s - c0)
        state = (c0 > 0) + (c0 + chunk < s)
        flops += g * 2 * q * (q + 1) / 2 * n + h * 2 * (q * (q + 1) / 2 * p + state * q * p * n)
    flops *= b
    bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
    log(f"[kernels] ssd_scan timed at Zamba2-7B's shape (B={b} S={s} H={h} P={p} N={n} G={g} "
        f"chunk={chunk} bf16): kernel {ms:.5f} ms (B and C shared: {shared_ms:.5f} ms), plain "
        f"{plain_ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.3f} GFLOP)")
    rows["mamba2_step"] = mamba2_step_kernels(torch)
    return rows


def mamba2_step_inputs(torch, b: int, h: int, p: int, n: int, groups: int, dtype, seed=0):
    """One Mamba-2 layer's decode-step arguments as the model hands them to
    ``ops.mamba2_step``: the in_proj output (B, 1, [z | x | B | C | dt]) as
    a column slice of a wider buffer, the layer's conv weight (width 4) and
    bias, dt_bias, a_log, D and the norm's scale (biases, D and scale
    random), and a nonzero state (h, conv). Returns (zx, weights, state)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    d_inner = h * p
    conv_dim = d_inner + 2 * groups * n
    width = d_inner + conv_dim + h
    zx = rand(b, 1, width + 24).to(dtype)[..., 8:8 + width]
    weights = (rand(4, conv_dim, scale=0.3).to(dtype), rand(conv_dim, scale=0.1).to(dtype),
               rand(h, scale=0.5) - 1.0, torch.log(torch.linspace(1.0, 16.0, h, device="cuda")),
               1.0 + rand(h, scale=0.5), (1.0 + rand(d_inner, scale=0.1)).to(dtype))
    return zx, weights, (rand(b, h, p, n, scale=0.5), rand(b, 3, conv_dim).to(dtype))


def mamba2_step_cost(b: int, h: int, p: int, n: int, groups: int, dtype_bytes: int = 2):
    """(bytes, flops) of one fused decode step: the f32 state read and
    written, the in_proj output read, the conv state read and written, the
    layer's weights read, the output written (each once); per state element
    a decay, an injection and a C·h product (5 flops)."""
    d_inner = h * p
    conv_dim = d_inner + 2 * groups * n
    nbytes = (2 * 4 * b * h * p * n + dtype_bytes * b * (d_inner + conv_dim + h)
              + 2 * dtype_bytes * b * 3 * conv_dim + dtype_bytes * (5 * conv_dim + d_inner)
              + 4 * 3 * h + dtype_bytes * b * d_inner)
    return nbytes, 5.0 * b * h * p * n


def mamba2_step_kernels(torch) -> dict:
    """The fused Mamba-2 decode step against its plain version (the model's
    mixer, ``ref.mamba2_step``) on the same inputs and states: the output and
    the state (f32 to TOL, bf16 to SSD_TOL), the conv state exactly; at
    Zamba2-7B's widths (112 heads of 64, state 64, 2 groups) at buckets 1, 8
    and 32 and Zamba2-1.2B's layout (64 heads, B and C shared) at 8. Then timed at
    Zamba2-7B's widths, bf16, buckets 1, 8 and 32, beside the plain decode
    path (``plain ms``); :func:`mamba2_step_apart` times its two kernels
    apart. Returns the kernel table's row (bucket 8)."""
    from repro_torch.kernels import mamba2_step as _m2
    from repro_torch.kernels import ops, ref

    max_err = 0.0
    for dn in ("float32", "bfloat16"):
        dtype = getattr(torch, dn)
        tol = TOL[dn] if dn == "float32" else SSD_TOL[dn]
        for b, h, groups in ((1, 112, 2), (8, 112, 2), (32, 112, 2), (8, 64, 1)):
            zx, w, state = mamba2_step_inputs(torch, b, h, 64, 64, groups, dtype, seed=b + h)
            got_state = tuple(u.clone() for u in state)
            want_state = tuple(u.clone() for u in state)
            what = f"mamba2_step B={b} H={h} P=N=64 G={groups} {dn}"
            got = ops.mamba2_step(zx, *w, *got_state, groups=groups, eps=1e-5)
            want = ref.mamba2_step(zx, *w, *want_state, groups=groups, eps=1e-5)
            torch.cuda.synchronize()
            err = check_close(torch, got, want, tol, what)
            state_err = check_close(torch, got_state[0], want_state[0], tol, what + " state")
            if not torch.equal(got_state[1], want_state[1]):
                raise AssertionError(f"{what}: conv state differs from the plain version's")
            max_err = max(max_err, err)
            log(f"[kernels] {what}: max abs err {err:.3e} (state {state_err:.3e}, conv state "
                f"equal), {_m2.splits(b, h, 64)} blocks a head")
    h, p, n, groups = 112, 64, 64, 2
    row = None
    for b in (1, 8, 32):
        zx, w, state = mamba2_step_inputs(torch, b, h, p, n, groups, torch.bfloat16)

        def fused():
            return ops.mamba2_step(zx, *w, *state, groups=groups, eps=1e-5)

        ms = device_ms(torch, fused)
        plain_ms = device_ms(torch, lambda: ref.mamba2_step(zx, *w, *state, groups=groups,
                                                            eps=1e-5))
        nbytes, flops = mamba2_step_cost(b, h, p, n, groups)
        bound_ms, bound_by = bound(nbytes, flops, "bfloat16")
        log(f"[kernels] mamba2_step timed at Zamba2-7B's widths (B={b} H={h} P={p} N={n} "
            f"G={groups} bf16, {_m2.splits(b, h, p)} blocks a head): both kernels {ms:.5f} ms, "
            f"plain {plain_ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
            f"{nbytes / 1e6:.2f} MB), {ms / bound_ms:.2f}x the bound")
        if b == 8:
            row = dict(route="cuda", source="src/repro_torch/kernels/csrc/mamba2_step.cu",
                       replaces="none (the JAX package's plain decode step)",
                       max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=None,
                       shape=f"B={b} H={h} P={p} N={n} G={groups} bf16")
    return row


def mamba2_step_apart(torch) -> None:
    """The fused decode step's two kernels apart, at Zamba2-7B's widths,
    bf16, buckets 1, 8 and 32: the median device ms of each over 25 calls,
    from torch.profiler. Run last, after every phase that checks a
    profile's launch counts."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    for b in (1, 8, 32):
        zx, w, state = mamba2_step_inputs(torch, b, 112, 64, 64, 2, torch.bfloat16)
        ops.mamba2_step(zx, *w, *state, groups=2, eps=1e-5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(25):
                ops.mamba2_step(zx, *w, *state, groups=2, eps=1e-5)
            torch.cuda.synchronize()
        apart = collections.defaultdict(list)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and "mamba_" in e.name:
                apart["norm" if "norm" in e.name else "step"].append(
                    e.time_range.elapsed_us() / 1e3)
        step_ms, norm_ms = (statistics.median(apart[k]) if apart[k] else float("nan")
                            for k in ("step", "norm"))
        log(f"[kernels] mamba2_step at Zamba2-7B's widths, B={b} bf16, profiled apart: step "
            f"kernel {step_ms:.5f} ms, gated norm {norm_ms:.5f} ms")


def expected_launches(cfg, prefills: int, steps: int) -> dict:
    """Each kernel's launches for ``prefills`` prefills and ``steps``
    decode steps of ``cfg``'s model: attention once per layer for the dense,
    MoE and VLM families; for xLSTM the mLSTM kernel once per mLSTM block and prefill
    (decode runs the plain recurrent cells); for the hybrid the SSD scan
    once per Mamba layer and prefill, the fused decode step once per Mamba
    layer and step, and attention once per application of the shared
    block; for the
    encoder-decoder flash once per encoder layer and twice per decoder
    layer (self, cross) and prefill, decode twice per decoder layer and
    step."""
    from repro_torch.kernels import ops
    from repro_torch.models import hybrid

    want = {name: 0 for name in ops.WRAPPERS}
    if cfg.family in ("dense", "moe", "vlm"):  # the decoder transformer
        want["flash_attention"] = cfg.num_layers * prefills
        want["decode_attention"] = cfg.num_layers * steps
    elif cfg.family == "encdec":
        want["flash_attention"] = (cfg.encoder_layers + 2 * cfg.num_layers) * prefills
        want["decode_attention"] = 2 * cfg.num_layers * steps
    elif cfg.family == "ssm":
        n_mlstm = cfg.num_layers - cfg.num_layers // (cfg.mlstm_per_slstm + 1)
        want["mlstm_attention"] = n_mlstm * prefills
    elif cfg.family == "hybrid":
        apps = hybrid.n_attn_apps(cfg)
        want["ssd_scan"] = cfg.num_layers * prefills
        want["mamba2_step"] = cfg.num_layers * steps
        want["flash_attention"] = apps * prefills
        want["decode_attention"] = apps * steps
    else:
        raise ValueError(f"no kernels known for family {cfg.family!r}")
    return want


def phase_model(torch, arch: str):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model

    cfg = get_config(arch).reduced()
    model = Model(cfg)
    params_cpu = model.init(torch.Generator().manual_seed(0))
    params_gpu = _tree_to(params_cpu, "cuda")
    rng = np.random.default_rng(0)
    b, s, steps = 2, 24, 8
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s), dtype=np.int64))
    forced = torch.from_numpy(rng.integers(0, cfg.vocab_size, (steps, b, 1), dtype=np.int64))
    frames = torch.from_numpy(
        rng.standard_normal((b, MODEL_FRAMES, cfg.d_model)).astype(np.float32))
    outs = {}
    for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        ops.reset_launches()
        cache = model.init_cache(b, s + steps, device=dev)
        inputs = (prompt.to(dev) if cfg.family != "encdec" else
                  {"frames": frames.to(dev), "tokens": prompt.to(dev)})
        logits, cache = model.prefill(params, inputs, cache)
        seq = [logits]
        for i in range(steps):
            logits, cache = model.decode_step(params, forced[i].to(dev), cache)
            seq.append(logits)
        outs[dev] = torch.cat(seq, dim=1).cpu()
    want = expected_launches(cfg, 1, steps)
    if ops.launches() != want:  # the card run went through the kernels
        raise AssertionError(f"{cfg.name}: kernel launches {ops.launches()} != {want}")
    err = check_close(torch, outs["cuda"], outs["cpu"], MODEL_TOL,
                      f"{cfg.name} card vs CPU logits")
    log(f"[model] {cfg.name} f32, prefill + {steps} decode steps, card (kernels) vs "
        f"CPU (plain): max abs logit err {err:.3e} (tolerance {MODEL_TOL}); "
        f"launches {ops.launches()}")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def counted_run(torch, engines, fn):
    """Run ``fn()`` (one serving path over ``engines``, one or more
    replicas) with every kernel's launch count set to 0 just before and
    read just after; fail unless the path made prefills and decode steps,
    replayed a prefill graph and a decode-loop graph for every batch, and
    launched each kernel exactly as often as those prefills and steps
    need, summed over the engines. Returns (fn's result, launches, wall
    seconds, prefills, decode steps)."""
    from repro_torch.kernels import ops

    prefills0 = sum(e.prefill_calls for e in engines)
    steps0 = sum(e.decode_steps for e in engines)
    replays0 = sum(e.graph_replays for e in engines)
    ops.reset_launches()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = ops.launches()
    prefills = sum(e.prefill_calls for e in engines) - prefills0
    steps = sum(e.decode_steps for e in engines) - steps0
    replays = sum(e.graph_replays for e in engines) - replays0
    if prefills == 0 or steps == 0:
        raise AssertionError("the serving run made no prefill or no decode step")
    if replays != 2 * prefills:  # every batch: its prefill graph, then its loop graph
        raise AssertionError(f"{replays} CUDA graph replays for {prefills} prefills: "
                             "a batch ran eagerly")
    want = expected_launches(engines[0].cfg, prefills, steps)
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != {want} for {prefills} "
                             f"prefills and {steps} decode steps")
    return out, launches, wall, prefills, steps


def add_counts(total: dict, counts: dict) -> None:
    for name, n in counts.items():  # summed: two models launch the attention kernels
        total[name] = total.get(name, 0) + n


def serving_config(arch: str):
    """``arch``'s published config, at :data:`SERVE_DEPTH`'s layers where it
    is cut (full width always)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch in SERVE_DEPTH:
        cfg = dataclasses.replace(cfg, num_layers=SERVE_DEPTH[arch])
    return cfg


def phase_serve(torch, arch: str) -> dict:
    """Serve full-width ``arch`` behind MLProxy, first directly on one
    replica (``run_proxy_loop``), then on the simulated serverless platform
    (``launch/serve.py``'s ``Simulator``); for qwen2-0.5b also under the
    passthrough policy, and the replica-stream and max_len checks. Returns
    the kernel launch counts of the serving runs alone, summed."""
    import numpy as np

    from repro_torch.core.config import OptimizerConfig
    from repro_torch.launch import serve
    from repro_torch.serving.engine import InferenceEngine, ReplicaPool

    cfg = serving_config(arch)
    # batch buckets 1..32, prompt buckets 32/128, max_len 144, 16 tokens
    ecfg = serve.engine_config(full_size=True, gen_len=16)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    pool = ReplicaPool(cfg, ecfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(pool.replicas[0].params))
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers, {n_params / 1e6:.1f} M params in "
        f"{cfg.param_dtype}, initialised on the card in {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    warm = pool.warmup()
    log(f"[serve] warmup of {len(warm)} (bucket, prompt) pairs in "
        f"{time.monotonic() - t0:.1f} s; second-run ms: "
        + ", ".join(f"{k}: {1e3 * v:.1f}" for k, v in sorted(warm.items())))
    engine = pool.replicas[0]
    samples = serve.time_samples(engine, 128)
    rate, slo_s = serve.offered_load(samples)
    log("[serve] offered load from the median of (2, 128) samples, ms: "
        + ", ".join(f"{1e3 * t:.1f}" for t in samples)
        + f" -> rate {rate:.3f}/s (virtual), SLO {1e3 * slo_s:.1f} ms")
    launches: dict = {}

    # the direct path: one always-warm replica behind ReplicaPoolTarget
    n_requests = DIRECT_REQUESTS[arch]
    result, counts, wall, prefills, steps = counted_run(
        torch, [engine], lambda: serve.run_proxy_loop(
            pool, n_requests=n_requests, rate=rate, prompt_len=128, seed=0,
            slo_s=slo_s, optimizer=OptimizerConfig(update_interval=5.0, initial_max_bs=2),
            bucketing="pow2"))
    add_counts(launches, counts)
    summary = serve.summarize(result)
    stats = result["stats"]
    log(f"[serve] direct: {summary['requests']} requests in {summary['batches']} batches, "
        f"avg batch {summary['avg_batch']:.2f}, p95 {1e3 * summary['p95_s']:.1f} ms "
        f"(virtual time), violation rate {stats['violation_rate']:.4f}, wall {wall:.1f} s; "
        "measured ms per batch bucket: "
        + ", ".join(f"{b}: {ms:.2f}" for b, ms in summary["ms_per_bucket"].items()))
    log(f"[serve] direct: {prefills} prefills, {steps} decode steps; kernel launches {counts}")
    if summary["completed"] != n_requests or stats["dispatched_requests"] != n_requests:
        raise AssertionError(f"submitted {n_requests}, completed {summary['completed']}, "
                             f"dispatched {stats['dispatched_requests']}")
    for r in result["requests"]:
        toks = np.asarray(r.payload)
        if toks.shape != (ecfg.gen_len,) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"request {r.req_id}: bad tokens {toks!r}")
    if not summary["avg_batch"] > 1.0:
        raise AssertionError(f"MLProxy formed no batches above 1 (avg {summary['avg_batch']})")

    # the paper's setting: the simulated serverless platform, each batch
    # executed on the card
    policies = [("mlproxy", SIM_ARRIVALS[arch])]
    if arch == PASSTHROUGH_ARCH:
        policies.append(("passthrough", PASSTHROUGH_ARRIVALS))
    sims = {}
    for policy, n_arrivals in policies:
        sim = serve.build_simulator(engine, rate=rate, duration=n_arrivals / rate,
                                    slo_s=slo_s, prompt_len=128, gen_len=ecfg.gen_len,
                                    timings=warm, policy=policy, seed=0)
        batches0 = engine.stats["batches"]
        res, counts, wall, prefills, steps = counted_run(torch, [engine], sim.run)
        add_counts(launches, counts)
        s = res.summary
        sims[policy] = s
        log(f"[sim] {cfg.name} {policy}, {n_arrivals / rate:.1f} s of arrivals: "
            f"{serve.sim_line(s)}; {engine.stats['batches'] - batches0:.0f} engine batches, "
            f"{prefills} prefills, {steps} decode steps, wall {wall:.1f} s; "
            f"kernel launches {counts}")
        if not s["submitted_requests"] or s["completed"] != s["submitted_requests"]:
            raise AssertionError(f"{policy}: {s['submitted_requests']:.0f} arrivals, "
                                 f"{s['completed']:.0f} completed")
        if s["lost_batches"] or s["outstanding_batches"] or s["duplicate_completions"]:
            raise AssertionError(f"{policy}: the platform's ledger does not balance: {s}")
        if policy == "mlproxy" and not s["avg_batch_size"] > 1.0:
            raise AssertionError(f"MLProxy formed no batches above 1 on the platform "
                                 f"(avg {s['avg_batch_size']})")
    if "passthrough" in sims:
        m, pt = sims["mlproxy"], sims["passthrough"]
        log(f"[sim] {cfg.name} MLProxy vs passthrough: cost_integral {m['cost_integral']:.2f} "
            f"vs {pt['cost_integral']:.2f} container-s, violations "
            f"{m['violation_pct']:.2f}% vs {pt['violation_pct']:.2f}%, p95 "
            f"{1e3 * m['p95']:.1f} vs {1e3 * pt['p95']:.1f} ms, cold starts "
            f"{m['cold_starts']:.0f} vs {pt['cold_starts']:.0f} "
            f"({m['submitted_requests']:.0f} and {pt['submitted_requests']:.0f} arrivals)")

    # full width: the replayed graphs give the eager per-token loop's
    # tokens, for one batch and for two through the pooled cache
    ref_engine = InferenceEngine(cfg, dataclasses.replace(ecfg, fused_decode=False),
                                 params=engine.params, device="cuda")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 128)).astype(np.int32)
    check_graph_tokens(torch, engine, ref_engine, prompts, "4 full-width prompts")
    rng = np.random.default_rng(3)
    first, second = (rng.integers(0, cfg.vocab_size, (3, 128)).astype(np.int32)
                     for _ in range(2))
    check_graph_tokens(torch, engine, ref_engine, first, "batch 1 of 2 in bucket 4")
    got = check_graph_tokens(torch, engine, ref_engine, second, "batch 2 of 2 in bucket 4")
    del ref_engine
    # the pooled cache after another batch gives a batch a fresh cache's tokens
    fresh = InferenceEngine(cfg, dataclasses.replace(ecfg, cache_pool=False),
                            params=engine.params, device="cuda")
    want_toks, _ = fresh.generate(second)
    if not np.array_equal(got, want_toks):
        raise AssertionError("a pooled cache changed the next batch's tokens")
    log("[serve] pooled cache (graphs) == fresh cache (eager) for a batch after a "
        "different batch")
    del fresh
    if arch == PASSTHROUGH_ARCH:
        check_max_len_overflow(torch, engine)
        check_replica_streams(torch, engine)
    log(f"[serve] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
        f"(torch.cuda.max_memory_allocated, this phase); {len(engine.graphs)} graphs "
        f"in replica 0's pool of {graph_pool_gb(torch, engine)}")
    graph = profile_generate(torch, engine, cfg, "graphs")
    split_ms = graph_split_ms(torch, engine)
    log(f"[profile] graphs, bucket 32 x 128 prompt: prefill graph {split_ms[0]:.3f} ms, "
        f"decode-loop graph {split_ms[1]:.3f} ms ({engine.ecfg.gen_len - 1} steps, "
        f"{split_ms[1] / (engine.ecfg.gen_len - 1):.3f} ms a step) on the device "
        "(CUDA events around the two replays, median of 5)")
    # the simulator holds the engine through its latency model, in a
    # reference cycle: only a collection frees the model's memory
    params = engine.params
    del pool, engine, sim
    gc.collect()
    torch.cuda.empty_cache()
    # the eager fused loop beside it, without graphs: a fresh cache a call
    # (no graph is bound to one), on the same weights
    eager = InferenceEngine(cfg, dataclasses.replace(ecfg, cache_pool=False), params=params,
                            device="cuda")
    base = profile_generate(torch, eager, cfg, "eager (fresh cache a call)")
    log(f"[profile] {cfg.name} bucket 32: graphs against eager: wall "
        f"{graph['wall_ms']:.2f} / {base['wall_ms']:.2f} ms ({base['wall_ms'] / graph['wall_ms']:.2f}x), "
        f"busy {graph['busy_ms']:.2f} / {base['busy_ms']:.2f} ms, idle share "
        f"{graph['idle']:.3f} / {base['idle']:.3f}")
    del eager, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def check_graph_tokens(torch, engine, ref_engine, prompts, what: str):
    """``engine.generate(prompts)`` must replay its two graphs and give
    exactly the eager per-token ``ref_engine``'s tokens. On a difference it
    first prints where: the step, the top-2 logit margin of the eager
    logits there, and the prefill logits of a captured graph against eager
    ones; then it fails. Returns the tokens."""
    import numpy as np

    replays = engine.graph_replays
    got, _ = engine.generate(prompts)
    want, _ = ref_engine.generate(prompts)
    if engine.graph_replays - replays != 2:
        raise AssertionError(f"{what}: {engine.graph_replays - replays} graph replays, not 2")
    if not np.array_equal(got, want):
        explain_token_difference(torch, engine, prompts, got, want)
        raise AssertionError(f"{what}: graph replay and per-token eager decode disagree")
    log(f"[serve] graph replay == per-token eager decode, {what}")
    return got


def explain_token_difference(torch, engine, prompts, got, want) -> None:
    """Print the first differing (row, step), the top-2 margin of eager
    teacher-forced logits there, and the prefill logits of a graph captured
    on this engine against eager ones (bf16 tolerance 2e-2)."""
    import numpy as np

    row, step = (int(i) for i in np.argwhere(got != want)[0])
    n, plen_raw = prompts.shape
    bucket = next(b for b in engine.ecfg.batch_buckets if n <= b)
    plen = next(p for p in engine.ecfg.prompt_buckets if plen_raw <= p)
    padded = np.zeros((bucket, plen), np.int32)
    padded[:n, plen - plen_raw:] = prompts
    tokens = torch.from_numpy(padded).cuda()
    model, params, rope = engine.model, engine.params, engine.rope

    def fresh():
        return model.init_cache(bucket, engine.ecfg.max_len, device="cuda")

    with torch.inference_mode(), torch.cuda.stream(engine.stream):
        cache = fresh()
        logits, _ = model.prefill(params, tokens, cache, rope=rope)
        eager_logits = logits
        for i in range(step):  # teacher-forced on the eager tokens
            forced = torch.zeros((bucket, 1), dtype=torch.int32, device="cuda")
            forced[:n, 0] = torch.from_numpy(want[:, i]).cuda()
            logits, _ = model.decode_step(params, forced, cache, rope=rope)
        top2 = logits[row, -1].topk(2).values
        graph_cache = fresh()
        g = engine._capture(lambda t: model.prefill(params, t, graph_cache, rope=rope)[0],
                            tokens.clone(), graph_cache)
        g.graph.replay()
        engine.stream.synchronize()
    diff = float((g.out - eager_logits).abs().max())
    log(f"[serve] token difference at row {row}, step {step}: graph {got[row, step]}, "
        f"eager {want[row, step]}; eager top-2 logit margin there "
        f"{float(top2[0] - top2[1]):.4e}; prefill logits, graph against eager: max abs "
        f"diff {diff:.3e} (bf16 tolerance 2e-2)")


def graph_pool_gb(torch, engine) -> str:
    """The bytes of the segments in ``engine``'s graph memory pool (from
    ``torch.cuda.memory_snapshot``)."""
    segments = torch.cuda.memory_snapshot()
    if not segments or "segment_pool_id" not in segments[0]:
        return "not measured (no pool ids in the memory snapshot)"
    pool = tuple(engine.graph_pool)
    size = sum(s["total_size"] for s in segments if tuple(s["segment_pool_id"]) == pool)
    return f"{size / 1e9:.3f} GB"


def graph_split_ms(torch, engine, bucket: int = 32, plen: int = 128, samples: int = 5):
    """Device ms of the prefill graph and of the decode-loop graph of
    ``(bucket, plen)``, each replayed alone between CUDA events (a sleep
    kernel first, so the host enqueues ahead of the device); medians."""
    steps = engine._gen_steps(engine.ecfg.gen_len, plen)
    prefill = engine.graphs[("prefill", bucket, plen)]
    loop = engine.graphs[("fused", bucket, steps)]
    times = []
    with torch.inference_mode(), torch.cuda.stream(engine.stream):
        for _ in range(samples):
            if engine.model.recurrent:  # prefill reads the state: start it afresh
                engine.model.reset_cache(prefill.cache)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            torch.cuda._sleep(2_000_000)
            ev[0].record()
            prefill.graph.replay()
            ev[1].record()
            loop.graph.replay()
            ev[2].record()
            ev[2].synchronize()
            times.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])))
    return statistics.median(t[0] for t in times), statistics.median(t[1] for t in times)


def check_max_len_overflow(torch, engine) -> None:
    """plen + gen_len - 1 > max_len at full width: the engine decodes past
    its cache's end as the JAX engine does (the write clamped onto the last
    row), with no device-side assert, in its first (eager) run and in its
    replayed graphs; until the cache is full it gives the tokens of an
    engine with room, and its graphs give the per-token loop's tokens."""
    import numpy as np

    from repro_torch.serving.engine import InferenceEngine

    cfg, ecfg = engine.cfg, engine.ecfg
    plen, gen = 128, ecfg.gen_len
    short = dataclasses.replace(ecfg, max_len=plen + gen // 2)  # 143 > 136
    over = InferenceEngine(cfg, short, params=engine.params, device="cuda")
    per_token = InferenceEngine(cfg, dataclasses.replace(short, fused_decode=False),
                                params=engine.params, device="cuda")
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, plen)).astype(np.int32)
    got, _ = over.generate(prompts)  # eager, then the keys' captures
    torch.cuda.synchronize()  # a device-side assert would surface here
    replayed, _ = over.generate(prompts)
    torch.cuda.synchronize()
    if over.graph_replays != 2 or not np.array_equal(replayed, got):
        raise AssertionError(f"max_len overflow: {over.graph_replays} graph replays; "
                             f"replayed {replayed} against eager {got}")
    room, _ = engine.generate(prompts)
    same = short.max_len - plen + 1  # tokens decoded before the cache is full
    if got.shape != (2, gen) or got.min() < 0 or got.max() >= cfg.vocab_size:
        raise AssertionError(f"max_len overflow: bad tokens {got!r}")
    if not np.array_equal(got[:, :same], room[:, :same]):
        raise AssertionError(f"max_len overflow: the first {same} tokens differ from an "
                             f"engine with room: {got} vs {room}")
    if not np.array_equal(per_token.generate(prompts)[0], got):
        raise AssertionError("max_len overflow: fused and per-token decode disagree")
    log(f"[serve] max_len {short.max_len} < plen + gen_len - 1 = {plen + gen - 1}: tokens "
        f"and no device assert, eager and replayed alike; the first {same} equal an engine "
        "with room's, graph replay == per-token eager")


def check_replica_streams(torch, engine) -> None:
    """Two replicas on one card overlap: with replica 0's stream held by a
    ~4 s sleep kernel, replica 1 first serves a key it has not seen (an
    eager run, then the key's two CUDA-graph captures), then replays it;
    both return well before the sleep ends, with the tokens the per-token
    eager loop gives."""
    import numpy as np

    from repro_torch.serving.engine import InferenceEngine, ReplicaPool

    pool = ReplicaPool(engine.cfg, engine.ecfg, n_replicas=2, params=engine.params,
                       device="cuda")
    r0, r1 = pool.replicas
    per_token = InferenceEngine(engine.cfg, dataclasses.replace(engine.ecfg, fused_decode=False),
                                params=engine.params, device="cuda")
    prompts = np.random.default_rng(5).integers(0, engine.cfg.vocab_size,
                                                (2, 128)).astype(np.int32)
    alone, _ = per_token.generate(prompts)
    sleep_ms = 4000.0
    cycles = int(sleep_ms * 1e8 / device_ms(torch, lambda: torch.cuda._sleep(100_000_000),
                                            samples=3))
    with torch.cuda.stream(r0.stream):
        torch.cuda._sleep(cycles)
    t0 = time.monotonic()
    captured, _ = r1.generate(prompts)
    captured_s = time.monotonic() - t0
    replayed, timing = r1.generate(prompts)
    returned_s = time.monotonic() - t0
    held = not r0.stream.query()
    r0.stream.synchronize()
    held_s = time.monotonic() - t0
    log(f"[serve] replica streams: replica 1's first generate() of a new key (eager, then "
        f"{len(r1.graphs)} captures) took {1e3 * captured_s:.1f} ms, its replay "
        f"{1e3 * (returned_s - captured_s):.1f} ms (measured {1e3 * timing['latency_s']:.1f} "
        f"ms) while replica 0's stream held a {sleep_ms:.0f} ms sleep (done after "
        f"{1e3 * held_s:.1f} ms)")
    if not held or returned_s > 0.5 * sleep_ms / 1e3:
        raise AssertionError(f"replica 1 waited for replica 0's stream ({returned_s:.3f} s, "
                             f"replica 0 still busy: {held})")
    if r1.graph_replays != 2 or len(r1.graphs) != 2:
        raise AssertionError(f"replica 1: {len(r1.graphs)} graphs, {r1.graph_replays} replays")
    if not (np.array_equal(captured, alone) and np.array_equal(replayed, alone)):
        raise AssertionError("replica 1 gave other tokens beside a busy replica 0")


#: name prefix of each port kernel's entry functions -> its wrapper (the
#: Mamba-2 decode step's second launch, its gated norm, is not counted: the
#: wrapper counts one launch a call)
KERNEL_PREFIXES = {"flash_": "flash_attention", "decode_": "decode_attention",
                   "mlstm_": "mlstm_attention", "ssd_": "ssd_scan",
                   "mamba_step_": "mamba2_step"}


def port_kernel(name: str):
    """The wrapper whose kernel a profiled device kernel is, or None."""
    import re

    m = re.search(r"\(anonymous namespace\)::([a-z_]+_kernel)\b", name)
    if not m or "at::" in name:
        return None
    return next((w for p, w in KERNEL_PREFIXES.items() if m.group(1).startswith(p)), None)


def profiled_kernels(torch, prof, counted: dict, what: str):
    """The device kernels of one profiled run: (their number, busy ms, the
    port's kernels seen by wrapper, table lines of the top 8 by device
    time plus the port's own wherever they rank), or None where the
    profiler recorded no device time. Fails if the port's kernels the
    profiler saw differ by name from ``counted``, the launches the
    wrappers counted in the same run."""
    import collections

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None
    by_name, count = collections.Counter(), collections.Counter()
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
        count[e.name] += 1
    seen = collections.Counter()
    for name, n in count.items():
        wrapper = port_kernel(name)
        if wrapper:
            seen[wrapper] += n
    if {k: n for k, n in counted.items() if n} != dict(seen):
        raise AssertionError(f"{what}: profiled port kernels {dict(seen)} != counted "
                             f"launches {counted}")
    top = by_name.most_common(8)
    top += [(n, ms) for n, ms in by_name.items() if port_kernel(n) and n not in dict(top)]
    lines = [f"  {ms:9.3f} ms  {count[name]:6d}x  {name[:90]}" for name, ms in top]
    return len(kernels), sum(by_name.values()), dict(seen), lines


def profile_generate(torch, engine, cfg, what: str) -> dict:
    """Where one full-width batch's time goes: torch.profiler over one
    generate() at the largest bucket; kernels per prefill-or-step, device
    busy time and idle share, kernel time by name. Fails if the port's
    kernels the profiler saw differ by name from the launches the wrappers
    counted (a replay adds what its graph recorded at capture). Returns
    the unprofiled wall ms, busy ms and idle share."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (32, 128)).astype(np.int32)
    for _ in range(2):  # a new engine's first use of the key, then a warm run
        _, timing = engine.generate(prompts)
    steps0 = engine.decode_steps
    counted0 = ops.launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        engine.generate(prompts)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.monotonic() - t0)
    counted = {k: n - counted0[k] for k, n in ops.launches().items()}
    steps = engine.decode_steps - steps0
    unprofiled_ms = 1e3 * timing["latency_s"]
    log(f"[profile] {cfg.name}, {what}: generate(32 x 128 prompt, {engine.ecfg.gen_len} "
        f"tokens): {unprofiled_ms:.2f} ms unprofiled, {wall_ms:.2f} ms under the profiler, "
        f"{steps} decode steps")
    found = profiled_kernels(torch, prof, counted, what)
    if found is None:
        log("[profile] torch.profiler recorded no device time: busy share not measured")
        return {"wall_ms": unprofiled_ms, "busy_ms": float("nan"), "idle": float("nan")}
    n, busy_ms, seen, lines = found
    idle = 1 - busy_ms / unprofiled_ms
    log(f"[profile] {n} device kernels ({n / (steps + 1):.0f} per "
        f"prefill-or-step), busy {busy_ms:.2f} ms of {wall_ms:.2f} ms: device idle share "
        f"{1 - busy_ms / wall_ms:.3f} (against the unprofiled {unprofiled_ms:.2f} ms: "
        f"{idle:.3f}); port kernels by name == counted launches: {seen}")
    for line in lines:
        log(f"[profile] {line}")
    return {"wall_ms": unprofiled_ms, "busy_ms": busy_ms, "idle": idle}


# ------------------------------------------------------------ live runtime
def recording_target(pool, **kw):
    """A ``ReplicaPoolTarget`` over ``pool`` that gives every request its
    own prompt (random tokens seeded by its id, so no two batches are
    alike) and logs, for each batch it serves, (replica, engine start, end,
    requests, prompts, tokens) on its own clock; the engine's start is the
    end less its measured ``latency_s``, so a wait for a replica's lock is
    not counted as overlap."""
    import numpy as np

    from repro_torch.serving.batcher import ReplicaPoolTarget

    vocab = pool.cfg.vocab_size

    class Recording(ReplicaPoolTarget):
        def _prompts(self, batch):
            return np.stack([np.random.default_rng(r.req_id).integers(
                0, vocab, self.prompt_len).astype(np.int32) for r in batch.requests])

        def __call__(self, batch, deadline=None):
            out, timing = super().__call__(batch, deadline=deadline)
            end = self.clock()
            self.log.append((timing["replica"], end - timing["latency_s"], end,
                             list(batch.requests), self._prompts(batch), np.array(out)))
            return out, timing

    target = Recording(pool, **kw)
    target.log = []
    return target


def overlapping(log) -> list:
    """The batches whose engine interval overlaps one on another replica."""
    return [entry for entry in log
            if any(e2[0] != entry[0] and e2[1] < entry[2] and entry[1] < e2[2]
                   for e2 in log)]


def replay_check(engine, log, tokens: int = 400) -> str:
    """Serve again, one batch at a time on ``engine``, about ``tokens``
    tokens' worth of the live run's batches, those served while the other
    replica was busy first, and fail unless each gives exactly the tokens
    it gave live."""
    import numpy as np

    ov = overlapping(log)
    seen = {id(e) for e in ov}
    picks, n_tok = [], 0
    for entry in ov + [e for e in log if id(e) not in seen]:
        if n_tok >= tokens:
            break
        picks.append(entry)
        n_tok += entry[5].size
    for replica, _, _, reqs, prompts, live in picks:
        again = engine.generate(prompts)[0]
        if not np.array_equal(again, live):
            bad = np.argwhere(again != live)
            raise AssertionError(
                f"live batch of {len(reqs)} on replica {replica} (requests "
                f"{[r.req_id for r in reqs]}) gave other tokens than the same prompts "
                f"served alone: {len(bad)} of {live.size} differ, first at {bad[0].tolist()}")
    return (f"{len(picks)} batches ({min(len(ov), len(picks))} overlapping one on the other "
            f"replica; {sum(e[0] == 0 for e in picks)} / {sum(e[0] == 1 for e in picks)} "
            f"served live by replica 0 / 1), {n_tok} tokens")


def pool_capacity(pool, prompt_len: int, n: int = 4):
    """How the pool's replicas share the host: ``n`` timed (2,
    ``prompt_len``) ``generate()`` calls for each replica, first all on
    replica 0 alone, then on every replica at once, a thread each, each
    replica with prompts of its own. Fails unless every call gives exactly
    the tokens replica 0 gave alone for the same prompts. Returns (batches
    a second alone, at once; the host thread's CPU seconds a
    ``generate()`` alone, at once). A thread that waits for a lock spends
    wall time but no CPU time."""
    import threading

    import numpy as np

    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, pool.cfg.vocab_size, (2, prompt_len)).astype(np.int32)
               for _ in pool.replicas]
    want = [pool.replicas[0].generate(p)[0] for p in prompts]
    bad = []
    total = n * len(pool.replicas)
    t0, c0 = time.monotonic(), time.thread_time()
    for k in range(total):
        if not np.array_equal(pool.replicas[0].generate(prompts[k % len(prompts)])[0],
                              want[k % len(prompts)]):
            bad.append(("alone", k))
    one, cpu_one = total / (time.monotonic() - t0), (time.thread_time() - c0) / total
    cpu = []

    def work(i, engine):
        c0 = time.thread_time()
        for k in range(n):
            if not np.array_equal(engine.generate(prompts[i])[0], want[i]):
                bad.append((f"replica {i} at once", k))
        cpu.append((time.thread_time() - c0) / n)

    threads = [threading.Thread(target=work, args=(i, e)) for i, e in enumerate(pool.replicas)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    both = total / (time.monotonic() - t0)
    if bad:
        raise AssertionError(f"pool capacity probe: tokens differ from replica 0 alone: {bad}")
    return one, both, cpu_one, statistics.mean(cpu)


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, reach = 0.0, None
    for s, e in sorted(intervals):
        if reach is None or s > reach:
            total, reach = total + e - s, e
        elif e > reach:
            total, reach = total + e - reach, e
    return total


#: the CUDA runtime calls by which the host launches a kernel or a graph
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch")


def profile_pool(torch, pool, prompt_len: int) -> None:
    """Where two replicas' threads lose: torch.profiler over one
    (2, ``prompt_len``) ``generate()`` on replica 0 of the idle pool, then
    one on each replica at once, a thread each. For each: wall, device busy
    (the union of kernel intervals over every stream), the device's idle
    share, and the host's kernel- and graph-launch calls (CUPTI's runtime records,
    which do not tell threads apart): their count, rate and the median gap
    between two of them."""
    import statistics as st
    import threading

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    prompts = np.random.default_rng(7).integers(
        0, pool.cfg.vocab_size, (2, prompt_len)).astype(np.int32)

    def both():
        threads = [threading.Thread(target=e.generate, args=(prompts,)) for e in pool.replicas]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    for what, fn in (("replica 0 alone", lambda: pool.replicas[0].generate(prompts)),
                     (f"{len(pool.replicas)} replicas at once", both)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.monotonic() - t0)
        events = prof.events()
        kernels = [(e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        calls = sorted(e.time_range.start for e in events
                       if e.device_type == torch.autograd.DeviceType.CPU
                       and e.name in LAUNCH_CALLS)
        if not kernels:
            log(f"[live] profile, {what}: no device time recorded: busy share not measured")
            continue
        busy_ms = union_length(kernels) / 1e3
        host = (f"{len(calls)}, {1e3 * len(calls) / wall_ms:.0f} a second, median gap "
                f"{st.median(np.diff(calls)):.2f} us" if len(calls) > 1 else "not recorded")
        log(f"[live] profile, {what}, (2, {prompt_len}) x {pool.engine_cfg.gen_len} tokens: "
            f"wall {wall_ms:.2f} ms, {len(kernels)} kernels, device busy {busy_ms:.2f} ms "
            f"(kernel time summed {sum(e - s for s, e in kernels) / 1e3:.2f} ms), idle share "
            f"{1 - busy_ms / wall_ms:.3f}; host launch calls: {host}")


def check_conserved(cons: dict, what: str) -> None:
    terminal = (cons["completed"] + cons["rejected"] + cons["shed"]
                + cons["timed_out"] + cons["failed"])
    if cons["lost"] or cons["outstanding"] or cons["submitted"] != terminal:
        raise AssertionError(f"{what}: requests not conserved: {cons}")


def phase_live(torch) -> dict:
    """The live wall-clock runtime in front of two replicas of full-width
    qwen2-0.5b on the card: ``run_replay`` (Poisson ``LoadGenerator`` ->
    ``AsyncProxyServer`` + MLProxy -> ``EngineTarget`` -> executor thread
    -> ``ReplicaPoolTarget`` -> ``ReplicaPool.generate``) on a
    ``WallClock`` (a ``FakeClock`` would jump while an executor thread
    runs), then the same behind ``FaultyTarget`` with retries and a
    breaker, then the idle-card calibration beside the live one. The rate
    is the offered-load rule (80% busy at batch 2) over the batches a
    second the two replicas' threads measurably serve, the SLO 10·t of
    replica 0 alone. Before the runs, a profile of one replica alone and of
    both at once; after the MLProxy run, a sample of its batches served
    again alone must give the same tokens. Returns the kernel launch
    counts of the two runs, summed."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.config import OptimizerConfig, SLAConfig
    from repro_torch.launch import serve
    from repro_torch.runtime import (BreakerConfig, Calibration, EngineTarget,
                                     FaultConfig, FaultyTarget, RuntimeConfig, WallClock,
                                     measure_engine, run_replay)
    from repro_torch.serving.engine import InferenceEngine, ReplicaPool
    from repro_torch.simulation.arrivals import PoissonProcess

    cfg = get_config("qwen2-0.5b")
    ecfg = serve.engine_config(full_size=True, gen_len=16)
    t0 = time.monotonic()
    pool = ReplicaPool(cfg, ecfg, n_replicas=LIVE_REPLICAS, seed=0, device="cuda")
    pool.warmup(128)
    engines = pool.replicas
    samples = serve.time_samples(engines[0], 128)
    _, slo_s = serve.offered_load(samples)
    log(f"[live] {cfg.name}, {LIVE_REPLICAS} replicas sharing one copy of the weights, "
        f"warm at prompt 128 in {time.monotonic() - t0:.1f} s; (2, 128) samples ms: "
        + ", ".join(f"{1e3 * t:.1f}" for t in samples)
        + f" -> SLO {1e3 * slo_s:.1f} ms (wall clock)")
    # the same engine outside the pool, on the same weights, beside replica 0
    solo = InferenceEngine(cfg, ecfg, params=engines[0].params, device="cuda")
    for _ in range(2):
        solo.generate(np.zeros((2, 128), np.int32))
    solo_samples = serve.time_samples(solo, 128)
    del solo
    log(f"[live] (2, 128) median: pool replica 0 {1e3 * statistics.median(samples):.1f} ms, "
        f"a standalone engine on the same weights {1e3 * statistics.median(solo_samples):.1f} ms")
    one, both, cpu_one, cpu_both = pool_capacity(pool, 128)
    # the offered-load rule (80% busy at batch 2) over what the pool measurably
    # serves with a thread a replica, not over twice one replica
    rate = 0.8 * 2 * both
    log(f"[live] pool capacity at (2, 128): one replica alone {one:.2f} batches/s, all "
        f"{LIVE_REPLICAS} at once, a thread each, {both:.2f} batches/s ({both / one:.2f}x) "
        f"-> rate {rate:.3f}/s; host CPU time a generate(): alone {1e3 * cpu_one:.1f} ms "
        f"of {1e3 / one:.1f} ms wall, at once {1e3 * cpu_both:.1f} ms of "
        f"{1e3 * LIVE_REPLICAS / both:.1f} ms wall (mean over threads); every call's tokens "
        f"exactly replica 0's alone")
    profile_pool(torch, pool, 128)
    after = serve.time_samples(engines[0], 128)
    log(f"[live] (2, 128) median on pool replica 0 after the threaded probes: "
        f"{1e3 * statistics.median(after):.1f} ms (before: {1e3 * statistics.median(samples):.1f})")
    sla = SLAConfig(slo_target=slo_s)
    kwargs = {"bucketing": "pow2",
              "optimizer": OptimizerConfig(update_interval=5.0, initial_max_bs=2)}
    launches: dict = {}

    # MLProxy on the wall clock
    clk = WallClock()
    target = recording_target(pool, prompt_len=128, gen_len=ecfg.gen_len)
    res, counts, wall, prefills, steps = counted_run(torch, engines, lambda: run_replay(
        policy="mlproxy", sla=sla, arrivals=PoissonProcess(rate=rate, duration=LIVE_SECONDS),
        duration=LIVE_SECONDS, target=EngineTarget(target, clock=clk), clock=clk, seed=0,
        policy_kwargs=kwargs))
    add_counts(launches, counts)
    s, cons = res.summary, res.conservation
    by_replica = [sum(1 for r, *_ in target.log if r == i) for i in range(LIVE_REPLICAS)]
    log(f"[live] MLProxy, {LIVE_SECONDS:.0f} s of arrivals: {cons['completed']} of "
        f"{cons['submitted']} completed, avg batch {s['avg_batch_size']:.2f}, p95 "
        f"{1e3 * s['p95']:.1f} ms (SLO {1e3 * slo_s:.1f}), violations "
        f"{s['violation_pct']:.2f}%, {len(target.log)} batches (per replica {by_replica}), "
        f"{len(overlapping(target.log))} overlapped a batch on the other replica; "
        f"wall {wall:.1f} s")
    log(f"[live] MLProxy: {prefills} prefills, {steps} decode steps; kernel launches {counts}")
    check_conserved(cons, "live MLProxy")
    if cons["completed"] != cons["submitted"]:
        raise AssertionError(f"live MLProxy: not every request completed: {cons}")
    served = [r for _, _, _, reqs, *_ in target.log for r in reqs]
    if len(served) != cons["completed"]:
        raise AssertionError(f"live MLProxy: {len(served)} requests served, "
                             f"{cons['completed']} completed")
    for r in served:
        toks = np.asarray(r.payload)
        if toks.shape != (ecfg.gen_len,) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"request {r.req_id}: bad tokens {toks!r}")
    if not s["avg_batch_size"] > 1.0:
        raise AssertionError(f"live MLProxy formed no batches above 1 "
                             f"(avg {s['avg_batch_size']})")
    if not all(by_replica):
        raise AssertionError(f"a replica served no batch: {by_replica}")
    log(f"[live] MLProxy: served alone again, exact: {replay_check(engines[0], target.log)}")

    # chaos: crashes, partial batches and stragglers, retried behind a breaker
    # (no preempt or timeout: they cancel the await, not the worker thread)
    clk = WallClock()
    inner = EngineTarget(recording_target(pool, prompt_len=128, gen_len=ecfg.gen_len),
                         clock=clk)
    chaos = FaultyTarget(inner, clk, FaultConfig(crash_prob=0.05, partial_prob=0.05,
                                                 straggler_prob=0.05, seed=0))
    res_c, counts, wall, prefills, steps = counted_run(torch, engines, lambda: run_replay(
        policy="mlproxy", sla=sla, arrivals=PoissonProcess(rate=rate, duration=CHAOS_SECONDS),
        duration=CHAOS_SECONDS, target=chaos, clock=clk, seed=0, policy_kwargs=kwargs,
        config=RuntimeConfig(max_retries=2, breaker=BreakerConfig())))
    add_counts(launches, counts)
    sc, cons_c = res_c.summary, res_c.conservation
    log(f"[live] chaos, {CHAOS_SECONDS:.0f} s of arrivals: {cons_c['completed']} of "
        f"{cons_c['submitted']} completed, {cons_c['failed']} failed, {cons_c['shed']} shed, "
        f"{cons_c['timed_out']} timed out; injected {chaos.injected}; retried batches "
        f"{cons_c['retried_batches']}, recovered {cons_c['recovered_batches']}, retry "
        f"budget exhausted {cons_c['retry_exhausted']}; breaker "
        f"{sc['endpoints']['ep']['breaker']}; avg batch {sc['avg_batch_size']:.2f}, p95 "
        f"{1e3 * sc['p95']:.1f} ms, violations {sc['violation_pct']:.2f}%; wall {wall:.1f} s")
    log(f"[live] chaos: {prefills} prefills, {steps} decode steps; kernel launches {counts}")
    check_conserved(cons_c, "live chaos")

    # the calibration bridge: idle card against the live run's bucket samples
    idle = {b.bucket: b for b in measure_engine(engines[0], prompt_len=128,
                                                gen_len=ecfg.gen_len).buckets}
    live = {b.bucket: b for b in Calibration.from_samples(res.bucket_samples).buckets}
    log("[live] calibration, bucket: idle mean ms (n) | live mean ms (n, p95) | live/idle")
    for b in sorted(set(idle) | set(live)):
        i, l_ = idle.get(b), live.get(b)
        ratio = f"{l_.mean_s / i.mean_s:.2f}" if i and l_ else "-"
        log(f"[live]   {b:2d}: " + (f"{1e3 * i.mean_s:.1f} ({i.n})" if i else "-") + " | "
            + (f"{1e3 * l_.mean_s:.1f} ({l_.n}, {1e3 * l_.p95_s:.1f})" if l_ else "-")
            + f" | {ratio}")
    del pool, engines, target, inner, chaos
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------- wide archs
def phase_wide(torch) -> dict:
    """The widest archs at full width and a cut depth (:data:`WIDE_DEPTH`),
    one engine at a time: batch buckets 2 and 32, prompt bucket 128, 16
    tokens. Warmup captures each key's two CUDA graphs; then one
    ``generate()`` a bucket, with the launch counts set to 0 just before and
    read just after (exact, both graphs replayed), its tokens exactly the
    per-token eager loop's, and the prefill and decode-loop graphs timed
    apart at bucket 32. Prints the peak memory; frees the weights before
    the next model. Returns the kernel launch counts of the ``generate()``
    calls, summed."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.serving.engine import EngineConfig, InferenceEngine

    ecfg = EngineConfig(batch_buckets=(2, 32), prompt_buckets=(128,), max_len=144, gen_len=16)
    launches: dict = {}
    for arch, depth in WIDE_DEPTH.items():
        t0 = time.monotonic()
        cfg = dataclasses.replace(get_config(arch), num_layers=depth)
        torch.cuda.reset_peak_memory_stats()
        engine = InferenceEngine(cfg, ecfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(engine.params))
        init_s = time.monotonic() - t0
        warm = engine.warmup()
        log(f"[wide] {cfg.name}: {depth} of {get_config(arch).num_layers} layers at full width "
            f"(d={cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.hd}), "
            f"{n_params / 1e9:.3f} G params in {cfg.param_dtype} "
            f"({2 * n_params / 1e9:.1f} GB), initialised in {init_s:.1f} s; warmup second-run ms: "
            + ", ".join(f"{k}: {1e3 * v:.1f}" for k, v in sorted(warm.items())))
        ref_engine = InferenceEngine(cfg, dataclasses.replace(ecfg, fused_decode=False),
                                     params=engine.params, device="cuda")
        rng = np.random.default_rng(8)
        for bucket in ecfg.batch_buckets:
            prompts = rng.integers(0, cfg.vocab_size, (bucket, 128)).astype(np.int32)
            (got, timing), counts, wall, prefills, steps = counted_run(
                torch, [engine], lambda: engine.generate(prompts))
            add_counts(launches, counts)
            want, _ = ref_engine.generate(prompts)
            if not np.array_equal(got, want):
                explain_token_difference(torch, engine, prompts, got, want)
                raise AssertionError(f"{cfg.name} bucket {bucket}: graph replay and per-token "
                                     "eager decode disagree")
            log(f"[wide] {cfg.name} bucket {bucket}: generate() {1e3 * timing['latency_s']:.2f} "
                f"ms on the graphs, {prefills} prefill, {steps} decode steps, kernel launches "
                f"{counts}; tokens == per-token eager")
        split_ms = graph_split_ms(torch, engine)
        log(f"[wide] {cfg.name}: peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
            f"GB; bucket 32 x 128: prefill graph {split_ms[0]:.3f} ms, decode-loop graph "
            f"{split_ms[1]:.3f} ms ({split_ms[1] / (ecfg.gen_len - 1):.3f} ms a step); "
            f"{time.monotonic() - t0:.1f} s")
        del engine, ref_engine
        gc.collect()
        torch.cuda.empty_cache()
    return launches

def phase_zamba2_steps(torch, buckets=(1, 8, 32)) -> None:
    """Zamba2-7B whole (81 layers, bf16, weights from seed 0) at the
    zamba2-7b-chat-burst cell's shapes (prompt 256, 64 tokens): the device
    ms of the prefill graph and of the decode-loop graph at each bucket,
    replayed alone (``graph_split_ms``), and the loop's ms a decode step."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import EngineConfig, InferenceEngine

    t0 = time.monotonic()
    plen, gen_len = 256, 64
    ecfg = EngineConfig(batch_buckets=tuple(buckets), prompt_buckets=(plen,),
                        max_len=plen + gen_len, gen_len=gen_len)
    engine = InferenceEngine(get_config("zamba2-7b"), ecfg, seed=0, device="cuda")
    engine.warmup()
    for bucket in buckets:
        prefill_ms, loop_ms = graph_split_ms(torch, engine, bucket=bucket, plen=plen)
        log(f"[zamba2-7b] bucket {bucket} x {plen}, {gen_len} tokens: prefill graph "
            f"{prefill_ms:.3f} ms, decode-loop graph {loop_ms:.3f} ms, "
            f"{loop_ms / (gen_len - 1):.3f} ms a decode step")
    log(f"[zamba2-7b] decode steps timed in {time.monotonic() - t0:.1f} s")
    del engine
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------- encoder-decoder
def plain_flash(torch, q, k, v, causal: bool):
    """``ref.flash_attention`` two batch rows at a time, so the encoder's
    f32 scores stay at 2.1 GB."""
    from repro_torch.kernels import ref

    return torch.cat([ref.flash_attention(q[i:i + 2], k[i:i + 2], v[i:i + 2], causal=causal)
                      for i in range(0, q.shape[0], 2)])


@contextlib.contextmanager
def plain_attention(torch, skip: bool = False):
    """Within the block the models' attention runs the kernels' plain
    versions on the card; the launch counts do not move. With ``skip`` the
    flash one drops keys 64-127 wherever there are at least
    :data:`LONG_KEYS` of them (the encoder and the cross-attention): what
    a kernel that skipped one tile would compute."""
    from repro_torch.kernels import ops, ref

    saved = ops.flash_attention, ops.decode_attention

    def flash(q, k, v, *, causal=True):
        if skip and k.shape[1] >= LONG_KEYS:
            k, v = skip_tile(torch, k), skip_tile(torch, v)
        return plain_flash(torch, q, k, v, causal)

    ops.flash_attention, ops.decode_attention = flash, ref.decode_attention
    try:
        yield
    finally:
        ops.flash_attention, ops.decode_attention = saved


@contextlib.contextmanager
def checked_attention(torch):
    """Within the block every attention call of the models runs its kernel
    (through its launcher: this run's launches are not counted) and then,
    on the same inputs, its plain version on the card: the kernel's output
    must be within :data:`SCALED_TOL` of it. Yields
    {call shape: [calls, largest scaled error, None or, for the first call
    over :data:`LONG_KEYS` keys or more, the plain version skipping keys
    (cache rows) 64-127 read against the plain version]}."""
    from repro_torch.kernels import decode_attention as _dec
    from repro_torch.kernels import flash_attention as _fa
    from repro_torch.kernels import ops, ref

    saved = ops.flash_attention, ops.decode_attention
    seen: dict = {}

    def note(kind, got, want, skipped):
        dn = str(got.dtype).split(".")[-1]
        err = check_scaled(torch, got, want, SCALED_TOL[dn], f"{kind} on the loop's inputs")
        row = seen.setdefault(kind, [0, 0.0, None])
        if row[0] == 0 and skipped is not None:
            row[2] = scaled_err(torch, skipped(), want)
        row[0] += 1
        row[1] = max(row[1], err)

    def flash(q, k, v, *, causal=True):
        got = _fa.flash_attention_fwd(q, k, v, causal=causal)
        note(f"flash Sq={q.shape[1]} Sk={k.shape[1]} causal={causal}", got,
             plain_flash(torch, q, k, v, causal),
             (lambda: plain_flash(torch, q, skip_tile(torch, k), skip_tile(torch, v), causal))
             if k.shape[1] >= LONG_KEYS else None)
        return got

    def decode(q, kc, vc, lens):
        got = _dec.decode_attention_fwd(
            q, kc, vc, torch.as_tensor(lens, device=q.device).to(torch.int32))
        note(f"decode S_max={kc.shape[1]}", got, ref.decode_attention(q, kc, vc, lens),
             (lambda: ref.decode_attention(q, skip_tile(torch, kc), skip_tile(torch, vc),
                                           lens - 64))
             if kc.shape[1] >= LONG_KEYS else None)
        return got

    ops.flash_attention, ops.decode_attention = flash, decode
    try:
        yield seen
    finally:
        ops.flash_attention, ops.decode_attention = saved


def encdec_greedy(torch, model, params, frames, tokens, n_tokens: int, max_len: int,
                  forced=None):
    """``Model.prefill`` on {frames, tokens}, then ``n_tokens - 1`` greedy
    ``decode_step`` calls (fed ``forced``'s tokens instead, where given) →
    (tokens (B, n_tokens) on the card, every step's logits (B, n_tokens,
    V), the prefill's and each step's device ms by CUDA events)."""
    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    cache = model.init_cache(tokens.shape[0], max_len, device="cuda")
    marks = [event()]
    logits, cache = model.prefill(params, {"frames": frames, "tokens": tokens}, cache)
    marks.append(event())
    seen = [logits]
    out = [logits[:, -1].argmax(-1)]
    for i in range(n_tokens - 1):
        fed = out[-1] if forced is None else forced[:, i]
        logits, cache = model.decode_step(params, fed[:, None], cache)
        seen.append(logits)
        out.append(logits[:, -1].argmax(-1))
        marks.append(event())
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return torch.stack(out, 1), torch.cat(seen, 1), ms[0], ms[1:]


def profile_encdec(torch, model, params, frames, tokens, timed_ms: float) -> None:
    """Where one prefill + 15 greedy steps' time goes: torch.profiler over
    the loop, device busy time against the timed (unprofiled) loop, and
    the kernels by device time; the port's kernels the profiler saw must
    be the launches the wrappers counted."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    what = f"seamless-m4t B={tokens.shape[0]} profiled loop"
    counted0 = ops.launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        encdec_greedy(torch, model, params, frames, tokens, ENCDEC_TOKENS, ENCDEC_MAX_LEN)
    counted = {k: n - counted0[k] for k, n in ops.launches().items()}
    found = profiled_kernels(torch, prof, counted, what)
    if found is None:
        log("[encdec] torch.profiler recorded no device time: busy share not measured")
        return
    n, busy_ms, seen, lines = found
    log(f"[encdec] profile, B={tokens.shape[0]} prefill + {ENCDEC_TOKENS - 1} steps: "
        f"{n} device kernels, busy {busy_ms:.2f} ms against the timed "
        f"{timed_ms:.2f} ms: idle share {1 - busy_ms / timed_ms:.3f}; port kernels by name "
        f"== counted launches: {seen}")
    for line in lines:
        log(f"[encdec] {line}")


def phase_encdec(torch) -> dict:
    """seamless-m4t-large-v2 at full width, nothing cut, bf16 weights from
    seed 0: ``Model.prefill`` over (B, 4096, 1024) random frames and a
    128-token prompt, then 15 greedy ``decode_step`` calls, at B = 2 and 32.
    Each loop runs four times: counted (launch counts set to 0 just
    before and read just after: 72 flash a prefill, 48 decode a step),
    timed (CUDA events), and with the attention's plain versions on the
    card: the bf16 logits on the same inputs held to :data:`ENCDEC_BF16_TOL`
    (the prefill's, and each step's up to the row's first differing greedy
    token, where the top-2 margins are printed); and checked, each
    attention call held to its plain version on its own inputs
    (:data:`SCALED_TOL`). At B = 2 also a plain prefill that skips one key
    tile (printed: the logits barely see it); and the same loop in f32: the
    plain versions fed the kernels' greedy tokens, every step's logits
    (the prefill's and 15 decode steps') held to the kernels' to
    :data:`ENCDEC_F32_TOL`. Returns the counted loops' launches, summed."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model

    t0 = time.monotonic()
    cfg = get_config("seamless-m4t-large-v2")
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[encdec] {cfg.name}: {cfg.encoder_layers} encoder + {cfg.num_layers} decoder "
        f"layers, d={cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.hd}, "
        f"vocab {cfg.vocab_size}: {n_params:,} params in {cfg.param_dtype} "
        f"({2 * n_params / 1e9:.2f} GB), initialised in {time.monotonic() - t0:.1f} s")
    if n_params != 1_632_256_000:
        raise AssertionError(f"{cfg.name}: {n_params} params, not the JAX tree's 1,632,256,000")
    rng = np.random.default_rng(0)
    steps = ENCDEC_TOKENS - 1
    want = expected_launches(cfg, 1, steps)
    launches: dict = {}
    for b in ENCDEC_BATCHES:
        torch.cuda.reset_peak_memory_stats()
        frames = torch.randn((b, ENCDEC_FRAMES, cfg.d_model), generator=gen,
                             device="cuda").to(cfg.dtype)
        tokens = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (b, ENCDEC_PROMPT), dtype=np.int64)).cuda()
        ops.reset_launches()
        got, logits, _, _ = encdec_greedy(torch, model, params, frames, tokens, ENCDEC_TOKENS,
                                          ENCDEC_MAX_LEN)
        counts = ops.launches()
        if counts != want:
            raise AssertionError(f"{cfg.name} B={b}: kernel launches {counts} != {want}")
        add_counts(launches, counts)
        if got.shape != (b, ENCDEC_TOKENS) or not bool(((got >= 0) & (got < cfg.vocab_size)).all()):
            raise AssertionError(f"{cfg.name} B={b}: tokens {tuple(got.shape)} out of range")
        again, _, prefill_ms, step_ms = encdec_greedy(torch, model, params, frames, tokens,
                                                      ENCDEC_TOKENS, ENCDEC_MAX_LEN)
        if not torch.equal(again, got):
            raise AssertionError(f"{cfg.name} B={b}: two kernel runs gave different tokens")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9  # the kernels' path alone
        if b == max(ENCDEC_BATCHES):
            profile_encdec(torch, model, params, frames, tokens, prefill_ms + sum(step_ms))
        with plain_attention(torch):
            plain, plain_logits, _, _ = encdec_greedy(torch, model, params, frames, tokens,
                                                      ENCDEC_TOKENS, ENCDEC_MAX_LEN)
        same = got == plain
        # each row's first differing greedy token (ENCDEC_TOKENS where none):
        # up to and including it, both paths were fed the same tokens
        first = [int((~r).nonzero()[0]) if not bool(r.all()) else ENCDEC_TOKENS for r in same]
        diff = (logits.float() - plain_logits.float()).abs().amax(-1)  # (B, tokens)
        common = (torch.arange(ENCDEC_TOKENS, device="cuda")[None, :]
                  <= torch.tensor(first, device="cuda")[:, None])
        bf16_err, prefill_err = float(diff[common].max()), float(diff[:, 0].max())
        log(f"[encdec] B={b}: prefill {prefill_ms:.3f} ms, decode step median "
            f"{statistics.median(step_ms):.3f} ms (min {min(step_ms):.3f}, max "
            f"{max(step_ms):.3f}; CUDA events), peak device memory {peak_gb:.2f} GB "
            f"(weights and all); kernel launches {counts}; "
            f"greedy tokens against the plain attention on the card: {int(same.sum())} of "
            f"{same.numel()} equal, {first.count(ENCDEC_TOKENS)} of {b} rows identical; bf16 "
            f"logits on the same inputs max abs diff {bf16_err:.3e} (prefill "
            f"{prefill_err:.3e}; bound {ENCDEC_BF16_TOL}; logits max |x| "
            f"{float(plain_logits[:, 0].abs().max()):.3f})")
        for r, t in enumerate(first):
            if t < ENCDEC_TOKENS:
                mk, mp = (float(x[0] - x[1]) for x in
                          (logits[r, t].float().topk(2).values,
                           plain_logits[r, t].float().topk(2).values))
                log(f"[encdec]   row {r}: first differing token {t} (kernels {int(got[r, t])}, "
                    f"plain {int(plain[r, t])}); top-2 logit margin there {mk:.4e} (kernels), "
                    f"{mp:.4e} (plain), logits max abs diff {float(diff[r, t]):.3e}")
        if bf16_err > ENCDEC_BF16_TOL:
            raise AssertionError(f"{cfg.name} B={b}: bf16 logits differ from the plain "
                                 f"attention's by {bf16_err:.3e}, over {ENCDEC_BF16_TOL}")
        if b == min(ENCDEC_BATCHES):
            with plain_attention(torch, skip=True):
                _, skipped, _, _ = encdec_greedy(torch, model, params, frames, tokens, 1,
                                                 ENCDEC_MAX_LEN)
            moved = float((skipped[:, 0].float() - plain_logits[:, 0].float()).abs().max())
            log(f"[encdec] B={b}: a plain prefill that skips keys 64-127 of the encoder's and "
                f"the cross-attention's 4096 moves the bf16 prefill logits by {moved:.3e} "
                f"(bound {ENCDEC_BF16_TOL}): within rounding's reach of the logits")
            del skipped
        with checked_attention(torch) as seen:
            checked, _, _, _ = encdec_greedy(torch, model, params, frames, tokens,
                                              ENCDEC_TOKENS, ENCDEC_MAX_LEN)
        calls = {w: sum(n for kind, (n, _, _) in seen.items() if kind.startswith(w))
                 for w in ("flash", "decode")}
        if calls != {"flash": want["flash_attention"], "decode": want["decode_attention"]}:
            raise AssertionError(f"{cfg.name} B={b}: checked {calls} attention calls, not the "
                                 f"loop's {want}")
        if not torch.equal(checked, got):
            raise AssertionError(f"{cfg.name} B={b}: the checked loop's tokens differ")
        log(f"[encdec] B={b}: every attention call of the loop held to its plain version on "
            f"its own inputs (max |err| / row rms, gate {SCALED_TOL['bfloat16']}): " + "; ".join(
                f"{kind}: {n} calls, largest {err:.3e}"
                + ("" if skip is None else f", the plain version skipping rows 64-127 {skip:.3e}")
                for kind, (n, err, skip) in seen.items()))
        del frames, tokens, got, again, plain, logits, plain_logits, diff, checked
        gc.collect()
        torch.cuda.empty_cache()

    # f32 at B = 2: every step's logits, kernels against plain versions fed
    # the kernels' tokens
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    model32 = Model(cfg32)
    params32 = _tree_to(params, torch.float32)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    frames = torch.randn((2, ENCDEC_FRAMES, cfg.d_model), generator=gen, device="cuda")
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, ENCDEC_PROMPT))).cuda()
    ops.reset_launches()
    got, logits, _, _ = encdec_greedy(torch, model32, params32, frames, tokens, ENCDEC_TOKENS,
                                      ENCDEC_MAX_LEN)
    counts = ops.launches()
    if counts != want:
        raise AssertionError(f"{cfg.name} f32 B=2: kernel launches {counts} != {want}")
    with plain_attention(torch):
        plain, plain_logits, _, _ = encdec_greedy(torch, model32, params32, frames, tokens,
                                                  ENCDEC_TOKENS, ENCDEC_MAX_LEN, forced=got[:, :-1])
    err = check_close(torch, logits, plain_logits, ENCDEC_F32_TOL,
                      f"{cfg.name} f32 prefill and decode logits")
    log(f"[encdec] f32 B=2, prefill + {steps} decode steps, kernels against plain versions on "
        f"the card fed the same tokens: max abs logit err {err:.3e} (prefill "
        f"{float((logits[:, 0] - plain_logits[:, 0]).abs().max()):.3e}; tolerance "
        f"{ENCDEC_F32_TOL}; logits max |x| {float(plain_logits.abs().max()):.3f}); the plain "
        f"versions' own greedy choice equal at {int((plain == got).sum())} of {got.numel()} "
        f"tokens; launches {counts}; phase {time.monotonic() - t0:.1f} s")
    add_counts(launches, counts)
    del params32, logits, plain_logits
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------ fleet controller
def phase_fleet(torch) -> None:
    """The vectorised fleet controller on the card against the CPU: the
    same observations (made in bulk from seed 0) and the same ticks; every
    tick's dispatch decisions and timeouts and every AIMD Max_BS must be
    equal. The card runs the ticks twice; the second is timed."""
    import numpy as np

    from repro_torch.core import fleet_controller as fc

    t0 = time.monotonic()
    n, nb, ticks = FLEET_N, FLEET_BUCKETS, FLEET_TICKS
    rng = np.random.default_rng(0)
    data = {  # distinct endpoints within a tick: a repeated one is not defined
        "ep_up": np.stack([rng.permutation(n)[:FLEET_UPSTREAM] for _ in range(ticks)]),
        "bucket": rng.integers(0, nb, (ticks, FLEET_UPSTREAM)),
        "lat": rng.lognormal(-2.0, 0.6, (ticks, FLEET_UPSTREAM)).astype(np.float32),
        "ep_e2e": np.stack([rng.permutation(n)[:FLEET_E2E] for _ in range(ticks)]),
        "lat_e2e": rng.lognormal(-1.2, 0.5, (ticks, FLEET_E2E)).astype(np.float32),
        "was_to": rng.random((ticks, FLEET_E2E)) < 0.3,
        "queue_len": rng.integers(0, 6, (ticks, n)).astype(np.int32),
        "frt": rng.uniform(0.0, 0.5, (ticks, n)).astype(np.float32),
        "slo": rng.uniform(0.2, 1.0, n).astype(np.float32),
    }

    def run(device):
        t = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
        state = fc.init_fleet(n, nb, window=FLEET_WINDOW, initial_max_bs=2.0, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        start = time.perf_counter()
        dispatch, timeouts, max_bs = [], [], []
        for i in range(ticks):
            state = fc.record_upstream(state, t["ep_up"][i], t["bucket"][i], t["lat"][i])
            state = fc.record_e2e(state, t["ep_e2e"][i], t["lat_e2e"][i])
            state = fc.record_dispatch(state, t["ep_e2e"][i], t["was_to"][i])
            now, to = fc.timeout_step(state, t["queue_len"][i], t["frt"][i], t["slo"])
            dispatch.append(now)
            timeouts.append(to)
            if i % FLEET_AIMD_EVERY == FLEET_AIMD_EVERY - 1:
                state = fc.aimd_step(state, t["slo"])
                max_bs.append(state.max_bs)
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - start
        return [torch.stack(x).cpu() for x in (dispatch, timeouts, max_bs)], state, secs

    cpu, _, cpu_s = run("cpu")
    for attempt in range(2):
        card, state, card_s = run("cuda")
        for name, a, b in zip(("dispatch_now", "timeout", "max_bs"), card, cpu):
            if not torch.equal(a, b):
                bad = (a != b).nonzero()
                raise AssertionError(f"fleet controller: {name} differs between the card and "
                                     f"the CPU at {bad.shape[0]} places, first (tick, "
                                     f"endpoint) {bad[0].tolist()}")
    # torch.sort puts NaN last on the card too (the percentile relies on it)
    ring = state.ring
    count = (~torch.isnan(ring)).sum(-1, keepdim=True)
    nan_last = torch.isnan(torch.sort(ring, dim=-1).values)
    if not torch.equal(nan_last, torch.arange(ring.shape[-1], device="cuda") >= count):
        raise AssertionError("torch.sort on the card does not put NaN last")
    dispatch, _, max_bs = card
    log(f"[fleet] {n:,} endpoints x {nb} buckets x {FLEET_WINDOW} samples "
        f"({ring.numel() * 4 / 1e6:.1f} MB ring, {state.e2e_ring.numel() * 4 / 1e6:.1f} MB e2e "
        f"ring), {ticks} ticks ({FLEET_UPSTREAM:,} upstream + {FLEET_E2E:,} end-to-end "
        f"observations a tick, AIMD every {FLEET_AIMD_EVERY}): dispatch now, timeouts and "
        f"Max_BS equal to the CPU's tick for tick (two card runs); {float(dispatch.float().mean()):.4f} "
        f"of decisions dispatch now; final Max_BS mean {float(max_bs[-1].mean()):.3f}, min "
        f"{float(max_bs[-1].min()):.1f}, max {float(max_bs[-1].max()):.1f}; filled ring slots "
        f"{float(count.sum()) / ring.numel():.3f}; a tick {1e6 * card_s / ticks:.1f} us on the "
        f"card (host wall, synchronised at the ends), {1e6 * cpu_s / ticks:.1f} us on the host "
        f"CPU; phase {time.monotonic() - t0:.1f} s")


def check_training_refuses_kernels(torch, names=None) -> None:
    """Each wrapper (or those in ``names``), given small f32 CUDA inputs
    that require grad, raises with grad mode on rather than return a result
    detached from autograd; under ``no_grad`` it launches its kernel once;
    inside ``plain_versions()`` it returns exactly its plain version's
    result, with a gradient, and counts no launch. The card tests call this
    too (``tests/test_torch_kernels_cuda.py``)."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator("cuda").manual_seed(0)
    F = torch.nn.functional

    def t(*shape):
        return torch.randn(shape, generator=gen, device="cuda").requires_grad_(True)

    conv = torch.randn((2, 24, 4 * 16 + 2 * 16), generator=gen, device="cuda")
    ssd = (conv[..., :64].reshape(2, 24, 4, 16), F.softplus(torch.randn(
        (2, 24, 4), generator=gen, device="cuda")), -torch.linspace(1.0, 16.0, 4, device="cuda"),
        conv[..., 64:80], conv[..., 80:])  # x, B and C views of one conv output
    inputs = {
        "flash_attention": ((t(2, 24, 4, 16), t(2, 24, 2, 16), t(2, 24, 2, 16)), {}),
        "decode_attention": ((t(2, 1, 4, 16), t(2, 24, 2, 16), t(2, 24, 2, 16), 20), {}),
        "mlstm_attention": ((t(2, 24, 4, 32), t(2, 24, 4, 32), t(2, 24, 4, 32),  # least D
                             (0.5 * torch.randn((2, 24, 4), generator=gen, device="cuda"))
                             .requires_grad_(True),
                             F.logsigmoid(torch.randn((2, 24, 4), generator=gen, device="cuda")
                                          + 2.0).requires_grad_(True)), {}),
        "ssd_scan": (tuple(u.detach().clone().requires_grad_(True) for u in ssd),
                     {"chunk": 8}),
        # the decode step: 4 heads of 16, state 16, 2 groups (zx 64 + 128 + 4
        # wide), its state (h, conv) last
        "mamba2_step": ((t(2, 1, 196), t(4, 128), t(128), t(4), t(4), t(4), t(64),
                         torch.randn((2, 4, 16, 16), generator=gen, device="cuda"),
                         torch.randn((2, 3, 128), generator=gen, device="cuda")),
                        {"groups": 2}),
    }
    #: trailing arguments a wrapper updates in place: each call gets fresh copies
    in_place = {"mamba2_step": 2}

    def fresh(name, args):
        k = in_place.get(name, 0)
        return (*args[:len(args) - k], *(u.clone() for u in args[len(args) - k:]))

    for name in names or ops.WRAPPERS:
        args, kw = inputs[name]
        wrapper, plain = ops.WRAPPERS[name], getattr(ref, name)
        try:
            wrapper(*fresh(name, args), **kw)
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            raise AssertionError(f"{name}: a requires-grad CUDA input did not raise")
        before = ops.launches()
        with torch.no_grad():
            wrapper(*fresh(name, args), **kw)
        torch.cuda.synchronize()
        if ops.launches()[name] != before[name] + 1:
            raise AssertionError(f"{name}: under no_grad the kernel did not launch once")
        before = ops.launches()
        with ops.plain_versions():
            got = wrapper(*fresh(name, args), **kw)
        if ops.launches() != before:
            raise AssertionError(f"{name}: plain_versions() launched kernels: {before} -> "
                                 f"{ops.launches()}")
        if got.grad_fn is None:
            raise AssertionError(f"{name}: the plain version inside plain_versions() "
                                 "lost its gradient")
        if not torch.equal(got, plain(*fresh(name, args), **kw)):
            raise AssertionError(f"{name}: inside plain_versions() the result is not the "
                                 "plain version's")
        got.square().sum().backward()
        if args[0].grad is None or not bool(torch.isfinite(args[0].grad).all()):
            raise AssertionError(f"{name}: no finite gradient through the plain version")
    log(f"[train] each of the {len(names or ops.WRAPPERS)} wrappers raises on a requires-grad "
        "CUDA input, launches its kernel once under no_grad and, inside plain_versions(), "
        "returns its plain version's result with a gradient and no launch")


def train_reduced(torch, arch: str) -> None:
    """``Model.loss`` and every gradient leaf of reduced ``arch`` (f32) on
    the card with ``remat=True`` (each layer under ``torch.utils.checkpoint``,
    recomputed on autograd's thread) against the same port on the CPU
    without it. The card tests call this too."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model, make_inputs
    from repro_torch.utils.tree import flatten_with_path, leaves, unflatten

    cfg = get_config(arch).reduced()
    params = Model(cfg).init(torch.Generator().manual_seed(0))
    batch = make_inputs(cfg, ShapeCell("train", 24, 2, "train"),
                        torch.Generator().manual_seed(1))["batch"]
    out = {}
    before = ops.launches()
    for dev, remat in (("cpu", False), ("cuda", True)):
        flat = [p.to(dev).requires_grad_(True) for p in leaves(params)]
        loss = Model(dataclasses.replace(cfg, remat=remat)).loss(
            unflatten(params, flat), {k: v.to(dev) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        out[dev] = loss.item(), [torch.zeros_like(p) if g is None else g
                                 for p, g in zip(flat, grads)]
    if ops.launches() != before:
        raise AssertionError(f"{cfg.name}: training launched kernels: {before} -> "
                             f"{ops.launches()}")
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["cuda"]
    if not abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu):
        raise AssertionError(f"{cfg.name}: card loss {l_gpu} != CPU loss {l_cpu}")
    worst, worst_name = 0.0, ""
    for (path, _), a, b in zip(flatten_with_path(params), g_gpu, g_cpu):
        scale = float(b.abs().max())
        err = float((a.cpu() - b).abs().max())
        rel = err / scale if scale > 0 else (0.0 if err == 0 else float("inf"))
        if rel > worst:
            worst, worst_name = rel, "__".join(path)
    if worst > TRAIN_GRAD_TOL:
        raise AssertionError(f"{cfg.name}: gradient {worst_name} off by {worst:.3e} of its "
                             f"max |g| on the card (tolerance {TRAIN_GRAD_TOL})")
    log(f"[train] {cfg.name} f32 loss {l_gpu:.6f} (CPU {l_cpu:.6f}); {len(g_gpu)} gradient "
        f"leaves, card with remat vs CPU without, worst {worst:.3e} of a leaf's max |g| "
        f"({worst_name or '-'}; tolerance {TRAIN_GRAD_TOL})")


def full_width_grads(torch, model, cpu_model, params, batch_np):
    """Every gradient leaf of the card's bf16 loss (``remat=True``) against
    the CPU's f32 loss without remat, on the same params and batch: each
    leaf's relative L2 error ``||g_card - g_cpu|| / ||g_cpu||``, and the
    CPU's global gradient norm (for step 1's ``grad_norm``), the card's and
    the CPU's loss. A gradient the card dropped or mis-scaled is off by
    about 1."""
    from repro_torch.launch.train import batch_to
    from repro_torch.optim import adamw
    from repro_torch.utils.tree import flatten_with_path, leaves, unflatten

    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    card_loss = model.loss(unflatten(params, flat), batch_to(batch_np, "cuda"))
    card = [g.float().cpu() for g in torch.autograd.grad(card_loss, flat)]
    del flat
    flat = [p.detach().float().cpu().requires_grad_(True) for p in leaves(params)]
    host_loss = cpu_model.loss(unflatten(params, flat), batch_to(batch_np, "cpu"))
    host = torch.autograd.grad(host_loss, flat)
    errs = {"__".join(path): float((a - b).norm() / b.norm())
            for (path, _), a, b in zip(flatten_with_path(params), card, host)}
    return errs, float(adamw.global_norm(list(host))), card_loss.item(), host_loss.item()


def train_flops(cfg, b: int, s: int) -> float:
    """Operations of one train step of a dense decoder with remat: the
    matmuls' 2 a weight a token forward, 4 backward and 2 more recomputing
    each layer (not the unembedding, which no checkpoint wraps); attention
    as the plain version computes it, the full S x S scores and their
    product with V (4 S D a head a token a layer), forward, backward and
    recomputed the same way."""
    d, hd, hq, hkv = cfg.d_model, cfg.hd, cfg.num_heads, cfg.num_kv_heads
    layer = d * hd * (hq + 2 * hkv) + hq * hd * d + d * cfg.d_ff * 3
    tokens = b * s
    attn = 4 * s * hq * hd * cfg.num_layers * tokens
    return (8 * cfg.num_layers * layer * tokens + 6 * d * cfg.vocab_size * tokens
            + 4 * attn)


def train_step_split(torch, model, cfg, opt_cfg, params, opt, batch) -> dict:
    """ms of one train step's parts between CUDA events recorded on the
    stream after each (device time and any gap where the host lags): the
    loss forward, the backward, the schedule and AdamW (the parts of
    ``launch/train.py::make_train_step``, run here one by one). The params
    and state it makes are dropped."""
    from repro_torch.optim import adamw
    from repro_torch.utils.tree import leaves, tree_map, unflatten

    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    params = tree_map(lambda p: p.detach().requires_grad_(p.is_floating_point()), params)
    flat = leaves(params)
    events[0].record()
    loss = model.loss(params, batch)
    events[1].record()
    grads = torch.autograd.grad(loss, flat)
    events[2].record()
    with torch.no_grad():
        lr = adamw.cosine_schedule(opt.step, warmup=TRAIN_WARMUP, total=TRAIN_STEPS)
        adamw.apply_updates(opt_cfg, tree_map(torch.Tensor.detach, params),
                            unflatten(params, list(grads)), opt, lr_scale=lr)
    events[3].record()
    events[3].synchronize()
    return {name: events[i].elapsed_time(events[i + 1])
            for i, name in enumerate(("forward", "backward", "adamw"))}


def phase_train(torch) -> None:
    """Training: the wrappers' refusal, reduced archs card vs CPU, then
    full-width qwen2-0.5b train steps, a checkpoint round trip and the
    loss against the CPU's f32 loss."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenDataset
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.kernels import ops
    from repro_torch.launch.train import batch_to, make_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.utils.tree import leaves

    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    check_training_refuses_kernels(torch)
    launches0 = ops.launches()
    for arch in MODEL_ARCHS:
        train_reduced(torch, arch)

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), remat=True)
    model = Model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0))
    opt_cfg = adamw.AdamWConfig()
    opt = adamw.init_state(opt_cfg, params)
    data = TokenDataset(DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                                   vocab_size=cfg.vocab_size, seed=0))
    step_fn = make_train_step(cfg, opt_cfg, total_steps=TRAIN_STEPS, warmup=TRAIN_WARMUP)
    # the card's gradients on the step-1 params and batch against the CPU's f32
    cpu_cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32",
                                  remat=False)
    t0 = time.monotonic()
    grad_errs, cpu_norm, card_loss, cpu_loss = full_width_grads(
        torch, model, Model(cpu_cfg), params, next(TokenDataset(data.config)))
    cpu_s = time.monotonic() - t0
    worst_leaf = max(grad_errs, key=grad_errs.get)
    log(f"[train] {cfg.name} full width, step-1 params and batch: {len(grad_errs)} gradient "
        f"leaves of the card's bf16 loss (remat) against the CPU's f32 (no remat; "
        f"{cpu_s:.1f} s on the host), relative L2 error worst {grad_errs[worst_leaf]:.3e} "
        f"({worst_leaf}; tolerance {TRAIN_GRAD_L2_TOL}), median "
        f"{statistics.median(grad_errs.values()):.3e}; loss {card_loss:.5f} on the card, "
        f"{cpu_loss:.5f} on the CPU; the CPU's global grad norm {cpu_norm:.4f}")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ckpt_dir = tempfile.mkdtemp(prefix=".chip_smoke_ckpt_", dir=ROOT)
    losses, norms, times, saved = [], [], [], None
    try:
        for step in range(1, TRAIN_STEPS + 1):
            batch = batch_to(next(data), "cuda")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            params, opt, metrics = step_fn(params, opt, batch)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            losses.append(metrics["loss"].item())
            norms.append(metrics["grad_norm"].item())
            if step == TRAIN_CKPT_AFTER:
                saved_leaves = [x.cpu() for x in leaves({"params": params, "opt": opt})]
                t0 = time.monotonic()
                ckpt.save_checkpoint(ckpt_dir, step, {"params": params, "opt": opt},
                                     metadata={"data": data.state(), "arch": cfg.name})
                saved = time.monotonic() - t0
                ckpt_gb = sum(e.stat().st_size for e in os.scandir(
                    os.path.join(ckpt_dir, f"step_{step}"))) / 1e9
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # restore step 5 into fresh tensors and take step 6 again
        t0 = time.monotonic()  # the live trees give only shapes, dtypes and the device
        step0, tree, meta = ckpt.restore_latest(ckpt_dir, {"params": params, "opt": opt})
        restored_s = time.monotonic() - t0
        resumed = TokenDataset(data.config)
        resumed.restore(meta["data"])
        restored = leaves(tree)
        differ = [i for i, (a, b) in enumerate(zip(restored, saved_leaves))
                  if a.dtype != b.dtype or a.device.type != "cuda" or not torch.equal(a.cpu(), b)]
        if len(restored) != len(saved_leaves):
            differ.append("count")
        _, _, m6 = step_fn(tree["params"], tree["opt"], batch_to(next(resumed), "cuda"))
        loss6 = m6["loss"].item()
        del tree, restored, saved_leaves
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    if step0 != TRAIN_CKPT_AFTER or differ:
        raise AssertionError(f"restored step {step0}: leaves {differ} of the params and "
                             "AdamW state differ from the saved step's")
    if not abs(loss6 - losses[TRAIN_CKPT_AFTER]) <= TRAIN_RESTORE_TOL:
        raise AssertionError(f"restored step {step0}: next loss {loss6} against the "
                             f"uninterrupted {losses[TRAIN_CKPT_AFTER]}")
    if not all(map(math.isfinite, losses + norms)):
        raise AssertionError(f"non-finite training loss or grad norm: {losses} {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: step 1 {losses[0]}, step "
                             f"{TRAIN_STEPS} {losses[-1]}")
    if not abs(losses[0] - cpu_loss) <= TRAIN_LOSS_TOL:
        raise AssertionError(f"step-1 loss {losses[0]} on the card (bf16) against the CPU's "
                             f"f32 {cpu_loss}: over {TRAIN_LOSS_TOL}")
    norm_err = abs(norms[0] - cpu_norm) / cpu_norm
    if not (grad_errs[worst_leaf] <= TRAIN_GRAD_L2_TOL and norm_err <= TRAIN_NORM_TOL):
        raise AssertionError(f"full-width gradients: leaf {worst_leaf} off by "
                             f"{grad_errs[worst_leaf]:.3e} (tolerance {TRAIN_GRAD_L2_TOL}); "
                             f"step-1 grad norm {norms[0]} against the CPU's {cpu_norm} "
                             f"({norm_err:.3e}, tolerance {TRAIN_NORM_TOL})")

    split = train_step_split(torch, model, cfg, opt_cfg, params, opt,
                             batch_to(next(data), "cuda"))
    # one more step under the profiler: device time by kernel and by op
    from torch.profiler import ProfilerActivity, profile

    batch = batch_to(next(data), "cuda")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        params, opt, _ = step_fn(params, opt, batch)
        end.record()
        torch.cuda.synchronize()
    profiled_ms = start.elapsed_time(end)
    profiled = profiled_kernels(torch, prof, {}, "one train step")  # no port kernel in it
    self_ms = [(e.key, getattr(e, "self_device_time_total", 0) / 1e3, e.count)
               for e in prof.key_averages() if e.key.startswith("aten::")]
    by_op = sorted((r for r in self_ms if r[1] > 0), key=lambda r: -r[1])
    if ops.launches() != launches0:
        raise AssertionError(f"training launched kernels: {launches0} -> {ops.launches()}")

    ms = statistics.median(times[-TRAIN_TIMED:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    tflops = flops / (ms / 1e3) / 1e12
    log(f"[train] {cfg.name} full width ({cfg.param_count() / 1e9:.3f} G params, bf16, "
        f"remat), batches {TRAIN_BATCH} x {TRAIN_SEQ} from TokenDataset, AdamW f32 state, "
        f"warmup {TRAIN_WARMUP} of {TRAIN_STEPS} steps: {ms:.2f} ms a step (median of the "
        f"last {TRAIN_TIMED}; all: {', '.join(f'{t:.2f}' for t in times)}), "
        f"{tokens / (ms / 1e3):,.0f} tokens/s, {flops / 1e12:.2f} TFLOP a step, "
        f"{tflops:.1f} TFLOP/s ({tflops / (PEAK_FLOPS['bfloat16'] / 1e12):.3f} of the "
        f"989 TFLOP/s bf16 peak), peak memory {peak_gb:.2f} GB")
    log(f"[train] loss step 1 {losses[0]:.5f} -> step {TRAIN_STEPS} {losses[-1]:.5f} "
        f"(all: {', '.join(f'{x:.4f}' for x in losses)}); grad norm "
        f"{', '.join(f'{x:.3f}' for x in norms)}; the CPU's f32 loss on the step-1 params "
        f"and batch {cpu_loss:.5f}, |diff| {abs(losses[0] - cpu_loss):.2e} (tolerance "
        f"{TRAIN_LOSS_TOL}); step-1 grad norm against the CPU's {cpu_norm:.4f}: relative "
        f"{norm_err:.3e} (tolerance {TRAIN_NORM_TOL})")
    log(f"[train] checkpoint after step {TRAIN_CKPT_AFTER} (params + AdamW state, "
        f"{ckpt_gb:.2f} GB, saved in {saved:.1f} s, restored into "
        f"fresh tensors in {restored_s:.1f} s): every leaf, AdamW's step, mu and nu included, "
        f"bit-equal to the saved step's; step {TRAIN_CKPT_AFTER + 1} loss {loss6:.6f} "
        f"against the uninterrupted {losses[TRAIN_CKPT_AFTER]:.6f} (tolerance "
        f"{TRAIN_RESTORE_TOL}); kernel launches in the phase: 0")
    if profiled is None:
        log("[profile] one train step: the profiler recorded no device time")
    else:
        n_kernels, busy, _, lines = profiled
        log(f"[profile] one train step: {n_kernels} kernels, device busy {busy:.2f} ms against "
            f"the same step's {profiled_ms:.2f} ms (CUDA events, under the profiler; idle "
            f"share {1 - busy / profiled_ms:.3f}); by kernel:\n"
            + "\n".join(lines))
        log("[profile] by aten op (self device ms, calls): "
            + "; ".join(f"{k} {t:.2f} x{n}" for k, t, n in by_op[:14]))
    log(f"[train] one step split (CUDA events between the parts): loss forward "
        f"{split['forward']:.2f} ms, backward {split['backward']:.2f} ms, schedule + AdamW "
        f"{split['adamw']:.2f} ms")
    log(f"[train] phase {time.monotonic() - t_phase:.1f} s")


# --------------------------------------------------------------- placement
#: kimi-k2's MoE layer in phase 11: (B, S) → the plan its 8 model x 2 data ranks
#: emulate. The napkin rule picks token-route for both on such a mesh (the
#: tokens' bytes stay below a rank's 4.2 GB of experts up to T = 73,727); the
#: weight-gather plan is what ``moe_ffn`` runs on the world-1 mesh (no DP axis)
PLACEMENT_MOE_CELLS = ((32, 128, "weight-gather"), (32, 1, "token-route"))
PLACEMENT_MODEL_RANKS = 8
PLACEMENT_DATA_RANKS = 2
#: router logit margin (k-th minus (k+1)-th) under which two f32 GEMMs of
#: other shapes or devices may pick different experts (a tie, ~5e-6 of
#: rounding apart, not a fault)
ROUTING_TIE = 1e-4


def tie_rows(torch, cfg, x_rows, router, cap=None) -> "torch.Tensor":
    """Rows of ``x_rows`` (one dispatch's tokens) that a routing tie can
    change, as a bool mask on the host: each row whose k-th and (k+1)-th
    router logits lie within :data:`ROUTING_TIE`, and, under a capacity
    ``cap``, the rows holding the slots around the capacity edge of every
    expert such a row may join or leave (a tie moves the later tokens of
    that expert by one slot). A comparison leaves them out; at most 1% of
    the rows may be."""
    k = cfg.num_experts_per_tok
    top = torch.topk((x_rows.float() @ router.float()).cpu(), k + 1, dim=-1)
    tie = (top.values[:, k - 1] - top.values[:, k]) < ROUTING_TIE
    out = tie.clone()
    if cap is not None and bool(tie.any()):
        chosen = top.indices[:, :k]
        for e, n in collections.Counter(top.indices[tie].flatten().tolist()).items():
            rows = (chosen == e).any(dim=-1).nonzero().flatten()  # token order = slot order
            out[rows[max(cap - n, 0):cap + n]] = True
    if int(out.sum()) > len(out) // 100:
        raise AssertionError(f"{int(out.sum())} of {len(out)} rows near a routing tie")
    return out


def rank_sums(torch, moe, cfg, jobs, p, device) -> list:
    """For each job (xf (T, D), plan, capacity): ``_local_dispatch_compute``
    for each of the model ranks (their experts) and the data ranks (the
    weight-gather plan's token columns; the token-route plan's F-shards),
    on ``device`` in the weights' dtype there (f32 on the CPU), the ranks'
    partials summed in f32 as the all-reduce sums them. Each rank's
    experts are moved and cast once for all the jobs."""
    e_loc = cfg.num_experts // PLACEMENT_MODEL_RANKS
    f_loc = cfg.expert_d_ff // PLACEMENT_DATA_RANKS
    dt = p["wi"].dtype if device.type == "cuda" else torch.float32
    ys = [torch.zeros((xf.shape[0], cfg.d_model), dtype=torch.float32, device=device)
          for xf, _, _ in jobs]
    router = p["router"].to(device)
    for m in range(PLACEMENT_MODEL_RANKS):
        wi = p["wi"][m * e_loc:(m + 1) * e_loc].to(device=device, dtype=dt)
        wo = p["wo"][m * e_loc:(m + 1) * e_loc].to(device=device, dtype=dt)
        for (xf, plan, cap), y in zip(jobs, ys):
            t = xf.shape[0]
            for c in range(PLACEMENT_DATA_RANKS):
                if plan == "weight-gather":
                    rows = slice(c * t // PLACEMENT_DATA_RANKS,
                                 (c + 1) * t // PLACEMENT_DATA_RANKS)
                    x_in, wi_c, wo_c = xf[rows], wi, wo
                else:
                    rows, x_in = slice(0, t), xf
                    wi_c = wi[..., c * f_loc:(c + 1) * f_loc]
                    wo_c = wo[:, c * f_loc:(c + 1) * f_loc]
                part, _ = moe._local_dispatch_compute(
                    x_in.to(device=device, dtype=dt), router, wi_c, wo_c, e_loc=e_loc,
                    e_lo=m * e_loc, top_k=cfg.num_experts_per_tok, cap=cap,
                    activation=cfg.activation, return_aux=False)
                y[rows] += part.float()
        del wi, wo
    return ys


def placement_moe(torch, card: str, cfg=None, dev: str = "cuda") -> None:
    """Phase 11 (c): kimi-k2's full-width MoE layer (or ``cfg``'s), global
    path against the world-1 expert-parallel path and the per-rank plans,
    on ``dev`` (the CPU only to rehearse the phase's logic)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.constraint import ambient_mesh
    from repro_torch.models import moe

    cfg = cfg or get_config("kimi-k2-1t-a32b")
    dev = torch.device(dev)
    dn = "bfloat16"
    t0 = time.monotonic()
    gen = torch.Generator(dev).manual_seed(0)
    p = moe.init_moe(gen, cfg.d_model, cfg.num_experts, cfg.expert_d_ff, cfg.activation,
                     cfg.dtype)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in p.values())
    log(f"[placement] kimi-k2 MoE layer: D={cfg.d_model}, E={cfg.num_experts}, "
        f"F={cfg.expert_d_ff}, top-{cfg.num_experts_per_tok}, {cfg.activation} gated, "
        f"{n_bytes / 1e9:.2f} GB of weights from seed 0 in {time.monotonic() - t0:.1f} s")
    p_cpu = {k: v.cpu() for k, v in p.items()}  # bf16 on the host: the f32 reference's source
    mesh = ambient_mesh()
    cells = []
    for b, s, plan in PLACEMENT_MOE_CELLS:
        t = b * s
        n_wio = p["wi"].numel() + p["wo"].numel()
        # the plan moe_ffn runs on the world-1 mesh (no DP axis: weight-gather),
        # and the plan the napkin rule picks on the emulated (2 data, 8 model) one
        world1 = moe.choose_plan(t, n_wio, 2, cfg.d_model, 1, 1)
        rule = moe.choose_plan(t, n_wio, 2, cfg.d_model, PLACEMENT_MODEL_RANKS,
                               PLACEMENT_DATA_RANKS)
        if world1 != "weight-gather":
            raise AssertionError(f"T={t}: the world-1 mesh picks {world1}")
        x = torch.randn((b, s, cfg.d_model), generator=torch.Generator(dev).manual_seed(t),
                        device=dev).to(cfg.dtype)
        xf = x.reshape(t, cfg.d_model)
        kw = dict(top_k=cfg.num_experts_per_tok, activation=cfg.activation, return_aux=True)
        # (1) the world-1 NCCL path against the global path, at the config's capacity
        y_glob, aux_glob = moe._moe_global(p, x, capacity_factor=cfg.capacity_factor, **kw)
        y_mesh, aux_mesh = moe.moe_ffn(p, x, capacity_factor=cfg.capacity_factor, **kw)
        if mesh is None:
            raise AssertionError("no ambient mesh in phase 11")
        glob_cap = moe.expert_capacity(t, cfg.num_experts, cfg.num_experts_per_tok,
                                       cfg.capacity_factor)
        ties_mesh = tie_rows(torch, cfg, xf, p["router"], glob_cap).to(dev)
        err_mesh = check_close(torch, y_mesh.reshape(t, -1)[~ties_mesh],
                               y_glob.reshape(t, -1)[~ties_mesh], TOL[dn],
                               f"T={t} world-1 mesh vs global")
        err_aux = check_close(torch, aux_mesh, aux_glob, TOL["float32"], f"T={t} aux loss")
        # (2) the per-rank plans summed, against the global path where nothing drops
        cols = PLACEMENT_DATA_RANKS if plan == "weight-gather" else 1
        cap8 = moe.expert_capacity(t // cols, cfg.num_experts, cfg.num_experts_per_tok, 8.0)
        y_free, _ = moe._moe_global(p, x, capacity_factor=8.0, **kw)
        y_ranks8 = rank_sums(torch, moe, cfg, [(xf, plan, cap8)], p, dev)[0].to(cfg.dtype)
        col = t // cols
        ties = torch.cat([tie_rows(torch, cfg, xf[c * col:(c + 1) * col], p["router"])
                          for c in range(cols)])
        keep = ~ties.to(dev)
        err_free = check_close(torch, y_ranks8.reshape(t, -1)[keep],
                               y_free.reshape(t, -1)[keep], TOL[dn],
                               f"T={t} {plan} ranks at capacity 8.0 vs global")
        # (3) the per-rank plans at the config's capacity on the card; the CPU's
        # f32 ranks for every cell follow in one pass over the experts
        cap = moe.expert_capacity(t // cols, cfg.num_experts, cfg.num_experts_per_tok,
                                  cfg.capacity_factor)
        y_card = rank_sums(torch, moe, cfg, [(xf, plan, cap)], p, dev)[0].to(cfg.dtype)
        ties_cpu = torch.cat([tie_rows(torch, cfg, xf[c * col:(c + 1) * col], p["router"], cap)
                              for c in range(cols)])
        dropped = float((y_free.float() - y_glob.float()).abs().max())
        # (4) times: the global layer against one rank's local compute
        e_loc = cfg.num_experts // PLACEMENT_MODEL_RANKS
        x0 = xf[: t // cols]
        wi0, wo0 = p["wi"][:e_loc], p["wo"][:e_loc]
        if plan == "token-route":
            wi0 = wi0[..., : cfg.expert_d_ff // PLACEMENT_DATA_RANKS].contiguous()
            wo0 = wo0[:, : cfg.expert_d_ff // PLACEMENT_DATA_RANKS].contiguous()
        glob_ms = device_ms(torch, lambda: moe._moe_global(
            p, x, capacity_factor=cfg.capacity_factor, **kw), samples=10)
        rank_ms = device_ms(torch, lambda: moe._local_dispatch_compute(
            x0, p["router"], wi0, wo0, e_loc=e_loc, e_lo=0, top_k=cfg.num_experts_per_tok,
            cap=cap, activation=cfg.activation, return_aux=False), samples=10)
        cells.append({"what": f"B={b} S={s} (T={t}, {plan} emulated; the napkin rule picks "
                              f"{rule} on (2, 8), {world1} on the world-1 mesh)",
                      "job": (xf.cpu(), plan, cap), "y_card": y_card.cpu(),
                      "keep": ~ties_cpu, "line": (
            f"world-1 mesh vs global {err_mesh:.3e} (aux {err_aux:.3e}, "
            f"{int(ties_mesh.sum())} tied rows left out); {PLACEMENT_MODEL_RANKS} model x "
            f"{PLACEMENT_DATA_RANKS} data ranks summed vs global at capacity 8.0 "
            f"{err_free:.3e} ({int(ties.sum())} tied rows left out); drops at "
            f"{cfg.capacity_factor} move the global output by {dropped:.3e}; global layer "
            f"{glob_ms:.3f} ms, one rank's local compute {rank_ms:.3f} ms ({card})")})
        del x, xf, y_glob, y_mesh, y_free, y_ranks8, y_card, wi0, wo0
    t_cpu = time.monotonic()
    y_cpus = rank_sums(torch, moe, cfg, [c["job"] for c in cells], p_cpu, torch.device("cpu"))
    cpu_s = time.monotonic() - t_cpu
    for c, y_cpu in zip(cells, y_cpus):
        keep = c["keep"]
        err_cpu = check_close(torch, c["y_card"][keep], y_cpu[keep], TOL[dn],
                              f"{c['what']}: ranks at {cfg.capacity_factor}, card vs CPU f32")
        log(f"[placement] kimi-k2 MoE {c['what']}: {c['line']}; at capacity "
            f"{cfg.capacity_factor} the card's ranks vs the CPU's in f32 {err_cpu:.3e} "
            f"({int((~keep).sum())} rows near a tie left out)")
    log(f"[placement] the CPU's f32 ranks, both cells: {cpu_s:.1f} s on the host of {card}")
    del p, p_cpu
    gc.collect()
    torch.cuda.empty_cache()


def placement_restore(torch, mesh, card: str, cfg=None) -> dict:
    """Phase 11 (b): full-width qwen2-0.5b (or ``cfg``) saved, restored onto
    the mesh and served from the restored blocks, on the mesh's device.
    Returns the kernel launch counts."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.distributed.checkpoint import save_checkpoint
    from repro_torch.distributed.elastic import restore_elastic
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    from repro_torch.utils.tree import flatten_with_path, tree_map

    cfg = cfg or get_config("qwen2-0.5b")
    ecfg = EngineConfig(batch_buckets=(32,), prompt_buckets=(128,), max_len=144, gen_len=16)
    engine = InferenceEngine(cfg, ecfg, seed=0, device=mesh.device_type)
    directory = tempfile.mkdtemp(prefix=".chip_smoke_ckpt_", dir=ROOT)
    try:
        t0 = time.monotonic()
        save_checkpoint(directory, 0, engine.params)
        save_s = time.monotonic() - t0
        like = tree_map(torch.empty_like, engine.params)
        t0 = time.monotonic()
        step, restored, _ = restore_elastic(directory, like, mesh, cfg)
        torch.cuda.synchronize()
        restore_s = time.monotonic() - t0
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    saved = dict(flatten_with_path(engine.params))
    for path, leaf in flatten_with_path(restored):
        full = leaf.full_tensor()
        if full.dtype != saved[path].dtype or not torch.equal(full, saved[path]):
            raise AssertionError(f"restored leaf {'/'.join(path)} differs from the saved one")
    local = tree_map(lambda d: d.to_local(), restored)
    served = InferenceEngine(cfg, ecfg, params=local, device=mesh.device_type)
    engine.warmup()
    served.warmup()
    prompts = np.random.default_rng(11).integers(0, cfg.vocab_size, (32, 128)).astype(np.int32)
    want, _ = engine.generate(prompts)
    (got, timing), counts, _, prefills, steps = counted_run(
        torch, [served], lambda: served.generate(prompts))
    if not np.array_equal(got, want):
        raise AssertionError("tokens from the restored params differ from the original's")
    log(f"[placement] qwen2-0.5b: {len(saved)} leaves saved in {save_s:.1f} s, restored onto "
        f"the {tuple(mesh.shape)} mesh (step {step}) in {restore_s:.1f} s, every full_tensor() "
        f"bit-equal; bucket-32 generate() from the restored blocks "
        f"{1e3 * timing['latency_s']:.2f} ms, {prefills} prefill + {steps} decode steps, "
        f"launches {counts}, tokens == the original params' ({card})")
    del engine, served, restored, local, like
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def placement_dryrun(card: str) -> None:
    """Phase 11 (d): the dry-run entry point on this installation, in a
    subprocess (the fake backend at 256 ranks)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "kimi-k2-1t-a32b",
         "--shape", "decode_32k", "--no-save"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    wall = time.monotonic() - t0
    if out.returncode != 0:
        raise AssertionError(f"dry-run failed: {out.stderr[-2000:]}")
    rows = [line for line in out.stdout.splitlines()
            if line.startswith("kimi-k2-1t-a32b") or "host seconds" in line
            or "memory_analysis" in line or "collectives:" in line]
    if not any(line.startswith("kimi-k2-1t-a32b") and " ok " in line for line in rows):
        raise AssertionError(f"no roofline row in the dry-run's output: {out.stdout[-2000:]}")
    log("[placement] dry-run kimi-k2-1t-a32b x decode_32k x (16, 16) on this host "
        f"(host-only figures, H100 SXM constants; {wall:.1f} s with the interpreter's start; "
        f"this machine: {card}):\n  " + "\n  ".join(rows))


def phase_placement(torch) -> dict:
    """Phase 11: an NCCL process group of one rank and a (1, 1) mesh; an
    elastic restore of full-width qwen2-0.5b served from the restored
    blocks; kimi-k2's MoE layer through the expert-parallel plans; the
    dry-run entry point. The process group is destroyed whatever happens.
    Returns the kernel launch counts of (b)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.distributed.constraint import use_mesh
    from repro_torch.launch.mesh import make_mesh

    t_phase = time.monotonic()
    card = card_line()
    gc.collect()
    torch.cuda.empty_cache()
    store = tempfile.mkdtemp(prefix=".chip_smoke_ckpt_pg_", dir=ROOT)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        if mesh.device_type != "cuda" or dist.get_backend() != "nccl":
            raise AssertionError(f"mesh on {mesh.device_type} over {dist.get_backend()}")
        log(f"[placement] NCCL process group of 1 rank, mesh {tuple(mesh.shape)} "
            f"{mesh.mesh_dim_names} on {mesh.device_type}")
        counts = placement_restore(torch, mesh, card)
        with use_mesh(mesh):
            placement_moe(torch, card)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    placement_dryrun(card)
    log(f"[placement] phase {time.monotonic() - t_phase:.1f} s ({card})")
    return counts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.monotonic()
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[device] {kind} (count {torch.cuda.device_count()}); nvidia-smi: {card}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    rows = phase_kernels(torch)
    for arch in MODEL_ARCHS:
        phase_model(torch, arch)
    launches = {name: 0 for name in rows}
    for arch in SIM_ARRIVALS:  # each run counts only its own model's kernels
        t0 = time.monotonic()
        add_counts(launches, phase_serve(torch, arch))
        log(f"[serve] {arch} phase {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    add_counts(launches, phase_live(torch))
    log(f"[live] phase {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    add_counts(launches, phase_wide(torch))
    log(f"[wide] phase {time.monotonic() - t0:.1f} s")
    phase_zamba2_steps(torch)
    t0 = time.monotonic()
    add_counts(launches, phase_encdec(torch))
    log(f"[encdec] phase {time.monotonic() - t0:.1f} s")
    phase_fleet(torch)
    phase_train(torch)
    add_counts(launches, phase_placement(torch))
    mamba2_step_apart(torch)
    missing = [name for name in rows if not launches.get(name)]
    if missing:
        raise AssertionError(f"kernels never launched on a serving path: {missing}")

    kernels = []
    for name, row in rows.items():
        kernels.append({"name": name, "route": row["route"], "source": row["source"],
                        "replaces": row["replaces"], "launches": launches[name],
                        "max_abs_err": row["max_abs_err"], "max_err": row["max_abs_err"],
                        "ms": row["ms"], "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"], "shape": row["shape"],
                        "max_err_vs_bf16_plain": row.get("max_err_vs_bf16_plain")})
    log(f"[done] all phases passed in {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
