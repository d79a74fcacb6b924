#!/usr/bin/env python3
"""Drives the port's serving path on one CUDA card and checks it.

    python3 chip_smoke.py [--seed N]

Run from the root of the repo.  It needs one NVIDIA GPU (it exits non-zero
without one) and imports nothing of JAX or of the JAX package.  Phases, each
printing its own lines; any failure exits non-zero:

1. the card: its name, and its name and power limit as nvidia-smi gives them;
2. build: compiles the frontend kernel from csrc/frontend.cu and prints the
   seconds and the compiler's register/spill report;
3. the kernel against its plain version on the card, TF32 off, under the Q6
   gate (frontend/gate.py);
4. the main path at the flagship MixedNet's full width (random weights from
   the seed, moved through models/convert.py): 64 streams of 10 s synthetic
   PCM -> frontend kernel -> stream_scan -> moving average -> cooldown accept
   counts over the 101 default cutoffs; the launch count is set to 0 before
   it and read after it, and the streamed probabilities are held against the
   non-streaming forward pass;
5. times: the kernel, its plain version and the whole path, with CUDA
   events after a warm-up, beside the kernel's bound on this card;
6. a JSON line of the kernels, then the last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from microwakeword_tpu_torch import _build
from microwakeword_tpu_torch.evaluate import roc, streaming_eval
from microwakeword_tpu_torch.frontend import constants as FC
from microwakeword_tpu_torch.frontend import gate, kernel, plain
from microwakeword_tpu_torch.inference import Model
from microwakeword_tpu_torch.models import build_model, convert, presets
from microwakeword_tpu_torch.models.mixednet import stream_phase

STREAMS = 64
CLIP_S = 10
STEP_MS = 10
IGNORE_SLICES_AFTER_ACCEPT = 25
SLIDING_WINDOW = 5
STREAM_ATOL = 2e-4  # streamed vs non-streaming probabilities (tests/test_models.py)
CLIP_ATOL = 1e-5  # one stream alone vs the same stream in the batch

# Published H100 SXM peaks (dense): FP32 on the CUDA cores, HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# FP32 operations per feature cell after the mel product: sqrt and / 8 (2),
# the EMA (3) and plain._agc_output's elementwise operations (24).
CELL_FLOPS = 2 + 3 + 24


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(fn):
    """One call of ``fn`` under torch.profiler: (wall ms, summed device
    kernel ms, the five kernels with the most device time)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = [(e.key[:60], e.self_device_time_total / 1e3, e.count) for e in kernels[:5]]
    return wall_ms, device_ms, top


def synthetic_pcm(rng: np.random.Generator, streams: int, samples: int) -> np.ndarray:
    """Seeded noise at a per-stream level plus 0.4 s tone bursts, int16."""
    t = np.arange(samples) / FC.SAMPLE_RATE
    level = rng.uniform(100.0, 3000.0, (streams, 1))
    audio = rng.standard_normal((streams, samples)) * level
    for s in range(streams):
        for start in rng.uniform(0.0, samples / FC.SAMPLE_RATE - 0.4, 4):
            on = (t >= start) & (t < start + 0.4)
            freq, amp = rng.uniform(200.0, 4000.0), rng.uniform(2000.0, 12000.0)
            audio[s, on] += amp * np.sin(2 * np.pi * freq * t[on])
    return np.clip(np.round(audio), -32768, 32767).astype(np.int16)


def flagship_state(seed: int) -> tuple:
    """The flagship bundle and a random state, through the flax layout:
    Glorot kernels from a torch.Generator, BN statistics from numpy."""
    bundle = build_model("mixednet", presets.flagship_config())
    module = bundle.init(torch.Generator().manual_seed(seed), device="cpu")
    variables = convert.state_to_flax({k: v.numpy() for k, v in module.state_dict().items()})
    rng = np.random.default_rng(seed)
    for leaf in variables["batch_stats"].values():
        stats = leaf["BatchNorm_0"]
        stats["mean"] = rng.normal(0.0, 0.2, stats["mean"].shape).astype(np.float32)
        # small variances widen the probabilities, so that accepts fire
        stats["var"] = rng.uniform(0.02, 0.2, stats["var"].shape).astype(np.float32)
    return bundle, convert.flax_to_state(variables)


def frontend_bound_ms(batch: int, samples: int, frames: int, audio_bytes: int):
    """Least time for the micro-frontend's function on this card: the larger
    of the FP32 operations it needs over the FP32 peak and its bytes (PCM in
    once, features out once) over the memory rate.

    Per hop it needs the window (480 multiplies), a 512-point real FFT
    (2.5 N log2 N operations), the energy of 257 bins (3 each), the mel
    filters' nonzero taps (2 each: every bin feeds at most 2 channels) and
    CELL_FLOPS per feature cell, far less than the kernel's dense DFT.
    """
    fft = 2.5 * FC.FFT_SIZE * np.log2(FC.FFT_SIZE)
    mel_taps = np.count_nonzero(FC.mel_filterbank_matrix())
    per_hop = (FC.WINDOW_SAMPLES + fft + 3 * FC.N_FFT_BINS + 2 * mel_taps
               + CELL_FLOPS * FC.NUM_CHANNELS)
    flops = batch * frames * per_hop
    nbytes = batch * samples * audio_bytes + batch * frames * FC.NUM_CHANNELS * 4
    ops_ms, bytes_ms = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def dense_dft_ms(batch: int, frames: int) -> float:
    """The kernel's own dense DFT + mel FLOPs (2*480*257 + 257*40 MACs per
    hop) over the FP32 peak: a utilization figure for its algorithm, not a
    bound on the function."""
    macs = 2 * FC.WINDOW_SAMPLES * FC.N_FFT_BINS + FC.N_FFT_BINS * FC.NUM_CHANNELS
    return batch * frames * 2 * macs / PEAK_FP32_FLOPS * 1e3


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. the card
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"phase 1 card: {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi, flush=True)

    # 2. build the kernel
    t0 = time.perf_counter()
    path, report = _build.build("frontend")
    print(f"phase 2 build csrc/frontend.cu: {path.name}")
    for ln in report.splitlines():
        if "registers" in ln or "spill" in ln:
            print(f"  {ln.strip()}")
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s", flush=True)

    # 3. kernel against plain on the card
    rng = np.random.default_rng(args.seed)
    pcm_np = synthetic_pcm(rng, STREAMS, CLIP_S * FC.SAMPLE_RATE)
    pcm = torch.from_numpy(pcm_np).to(dev)
    floats = rng.uniform(-0.9, 0.9, (2, 8000)).astype(np.float32)
    floats[0, :4] = [0.5 / 32768, 1.5 / 32768, -2.5 / 32768, 1.2]  # halves, clip
    cases = [
        ("10ms multi-tile", 10, rng.integers(-25000, 25000, (3, 48480)).astype(np.int16)),
        ("20ms multi-tile", 20, rng.integers(-25000, 25000, (3, 48480)).astype(np.int16)),
        ("10ms ragged tail", 10, rng.integers(-8000, 8000, (2, 480 + 160 * 40 + 77)).astype(np.int16)),
        ("20ms ragged tail", 20, rng.integers(-8000, 8000, (2, 480 + 320 * 40 + 201)).astype(np.int16)),
        ("N < 480", 10, rng.integers(-8000, 8000, (2, 300)).astype(np.int16)),
        ("float input", 10, floats),
        ("main path shape", STEP_MS, pcm_np),
    ]
    print(f"phase 3 tolerance: Q6 gate (|du| <= 1 or one Q6 level per cell, "
          f">= {gate.MIN_EXACT_SHARE:.1%} of cells exact)")
    max_abs = 0.0
    with torch.inference_mode():
        for label, step, audio in cases:
            x = torch.from_numpy(audio).to(dev)
            got = kernel.frontend_batch(x, step_ms=step)
            torch.cuda.synchronize()
            want = plain.frontend_batch(x, step_ms=step)
            check(got.shape == want.shape, f"{label}: shape {tuple(got.shape)}")
            res = gate.assert_q6_gate(got.cpu().numpy(), want.cpu().numpy())
            max_abs = max(max_abs, res.max_abs)
            print(f"phase 3 frontend {label} {tuple(got.shape)}: max|d|={res.max_abs} "
                  f"exact_share={res.exact_share:.6f} q6_flips={res.q6_flips}", flush=True)

    # 4. the main path at full width
    bundle, state = flagship_state(args.seed)
    model = Model.from_torch(bundle, state)  # device=None: the card
    check(model.device.type == "cuda", "the model is not on the card")
    kernel.frontend_batch.launches = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        feats = kernel.frontend_batch(pcm, step_ms=STEP_MS)
        probs = bundle.stream_scan(model.module, feats)
        counts, hours = streaming_eval.ambient_accept_counts(
            [probs[..., 0]], roc.DEFAULT_CUTOFFS, IGNORE_SLICES_AFTER_ACCEPT,
            SLIDING_WINDOW, stride=bundle.stride, step_s=STEP_MS / 1000,
        )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.frontend_batch.launches
    check(launches > 0, "the frontend kernel was not launched on the main path")
    frames = FC.num_frames(pcm.shape[1], FC.hop_samples(STEP_MS))
    steps = frames // bundle.stride
    check(feats.shape == (STREAMS, frames, FC.NUM_CHANNELS), f"features {tuple(feats.shape)}")
    check(probs.shape == (STREAMS, steps, 1), f"probs {tuple(probs.shape)}")
    p = probs.float()
    check(bool(torch.isfinite(p).all()), "non-finite probabilities")
    check(bool(((p >= 0) & (p <= 1)).all()), "probabilities outside [0, 1]")
    t_in, r = bundle.spectrogram_length, stream_phase(bundle.config)
    worst = 0.0
    with torch.inference_mode():
        for step in (steps - 1, steps - 2, steps - 3):
            end = (step + 1) * bundle.stride  # the step's window, shifted by r
            full = bundle.forward(model.module, feats[:, end - t_in + r : end + r])
            worst = max(worst, float((full - probs[:, step]).abs().max()))
    check(worst <= STREAM_ATOL, f"streamed vs forward max|d| {worst} > {STREAM_ATOL}")
    clip = model.predict_clip(pcm_np[0], step_ms=STEP_MS)
    clip_err = float(np.abs(clip - probs[0, :, 0].cpu().numpy()).max())
    check(clip.shape == (steps,) and clip_err <= CLIP_ATOL, f"predict_clip max|d| {clip_err}")
    check(counts.shape == (len(roc.DEFAULT_CUTOFFS),) and hours > 0, "accept counts")
    print(f"phase 4 main path: {STREAMS} streams x {CLIP_S} s = {STREAMS * CLIP_S} audio-s, "
          f"{steps} steps of {bundle.stride} frames, wall {wall:.3f} s ({smi})")
    print(f"phase 4 frontend launches: {launches}; probs in [{float(p.min()):.4f}, {float(p.max()):.4f}]; "
          f"streamed vs forward max|d|={worst:.3e}; predict_clip max|d|={clip_err:.3e}")
    print(f"phase 4 accepts at cutoffs 0.5/0.8/0.9: {counts[50]:.0f}/{counts[80]:.0f}/"
          f"{counts[90]:.0f} over {hours * 3600:.1f} s", flush=True)

    # 5. times at the main path's shape
    with torch.inference_mode():
        kernel_ms = cuda_ms(lambda: kernel.frontend_batch(pcm, step_ms=STEP_MS), 20)
        plain_ms = cuda_ms(lambda: plain.frontend_batch(pcm, step_ms=STEP_MS), 5)
        scan_ms = cuda_ms(lambda: bundle.stream_scan(model.module, feats), 3)
        accept_ms = cuda_ms(lambda: streaming_eval.ambient_accept_counts(
            [probs[..., 0]], roc.DEFAULT_CUTOFFS, IGNORE_SLICES_AFTER_ACCEPT,
            SLIDING_WINDOW, stride=bundle.stride, step_s=STEP_MS / 1000), 3)

        def whole_path():
            f = kernel.frontend_batch(pcm, step_ms=STEP_MS)
            pr = bundle.stream_scan(model.module, f)
            streaming_eval.ambient_accept_counts(
                [pr[..., 0]], roc.DEFAULT_CUTOFFS, IGNORE_SLICES_AFTER_ACCEPT,
                SLIDING_WINDOW, stride=bundle.stride, step_s=STEP_MS / 1000)

        path_ms = cuda_ms(whole_path, 3)
    bound_ms, bound_by = frontend_bound_ms(STREAMS, pcm.shape[1], frames, pcm.element_size())
    dense_ms = dense_dft_ms(STREAMS, frames)
    print(f"phase 5 frontend [{STREAMS}, {pcm.shape[1]}] int16: kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; roofline share "
          f"{bound_ms / kernel_ms:.4f}); the kernel's dense DFT at the FP32 peak "
          f"{dense_ms:.4f} ms (share {dense_ms / kernel_ms:.4f}); library: none, "
          f"no single PyTorch call computes the micro-frontend ({smi})")
    print(f"phase 5 path: frontend {kernel_ms:.3f} ms + stream_scan {scan_ms:.3f} ms + "
          f"accept counts {accept_ms:.3f} ms; whole path {path_ms:.3f} ms for "
          f"{STREAMS * CLIP_S} audio-s ({smi})", flush=True)
    with torch.inference_mode():
        wall_ms, device_ms, top = device_profile(whole_path)
    print(f"phase 5 profile of the whole path: wall {wall_ms:.3f} ms under the profiler, "
          f"device kernels {device_ms:.3f} ms, busy share under the profiler "
          f"{device_ms / wall_ms:.4f}"
          + ("" if device_ms else " (the profiler saw no device time: not measured)"))
    for key, ms, count in top:
        print(f"  {ms:9.3f} ms  x{count:<6d} {key}")

    # 6. the kernels line, then the last line
    kernels = [dict(
        name="frontend", route="cuda", source="microwakeword_tpu_torch/csrc/frontend.cu",
        replaces="microwakeword_tpu/frontend/pallas.py:76", launches=launches,
        max_abs_err=max_abs, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None,
    )]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
