#!/usr/bin/env python3
"""Drives the port's serving, training, export, sweep, host I/O and host frontend paths on one CUDA card.

    python3 chip_smoke.py [--seed N]

Run from the root of the repo.  It needs one NVIDIA GPU (it exits non-zero
without one) and imports nothing of JAX or of the JAX package.  Phases, each
printing its own lines; any failure exits non-zero:

1. the card: its name, and its name and power limit as nvidia-smi gives them;
2. build: compiles the frontend kernel from csrc/frontend.cu and prints the
   seconds and the compiler's register/spill report; meanwhile, on two more
   threads, g++ builds the C++ streaming runtime from native/src/mww_runtime.cc
   and the host I/O library from native/src/mww_native.cc (their seconds are
   printed too);
3. the kernel against its plain version on the card, TF32 off, under the Q6
   gate (frontend/gate.py);
4. the main path at the flagship MixedNet's full width (random weights from
   the seed, moved through models/convert.py): 64 streams of 10 s synthetic
   PCM -> frontend kernel -> stream_scan -> moving average -> cooldown accept
   counts over the 101 default cutoffs; the launch counts of the frontend
   kernel and of the counting kernel (csrc/accepts.cu, one launch) are set
   to 0 before it and read after it, and the streamed probabilities are
   held against the non-streaming forward pass;
5. times: the kernel (whole and each launch on its own), its plain version,
   a cuFFT yardstick of the filterbank stage and the whole path, with CUDA
   events after a warm-up, beside the kernel's bound on this card, at the
   serving shape, the flagship's raw-audio training window, serving at
   20 ms and 8 clips of 10 minutes; the kernel and its plain version are
   timed alike (events around back-to-back calls, host work included), and
   the kernel and its launches also on the device alone, with the wrapper's
   host time per call; the counting kernel on phase 4's moving-averaged
   probabilities, [64, 328] x 101 cutoffs, held bit for bit against the
   plain loop on the CPU, then timed against the plain loop on the card
   (events around back-to-back calls) and on the device alone with its
   host time per call, beside its bound from its bytes;
6. training at the flagship's full width: a synthetic ragged store from the
   seed (about 5.6 M training frames, positives with energy in the high
   channels, negatives in the low ones, positive-band bursts in two
   validation ambient tracks), then the CLI's ``run()`` with the notebook's
   recipe (batch 128, SpecAugment 5 x 2, class weights 1/20, sampling
   weights 2/10) over two phases of 200 and 100 steps, eval every 100;
   checks that the loss falls below half its step-0 value, the last train
   accuracy and the last eval's validation accuracy exceed 0.9, the
   artifacts exist and the streamed AUC is finite, and that checkpoint
   selection ranked the evals and run() scored the selected weights
   (check_selection), and what run() wrote under logs/ (TensorBoard
   scalars where tensorboardX imports; nothing, and a line saying so,
   where it does not); then, for the trained model, ms per step by CUDA
   events over 50 steps, a torch.profiler window of 20 steps (busy share, kernels per
   step, the five largest kernels), each layer of the step alone under the
   profiler (sampler, forward, backward, Adam, step metrics: kernels and
   the operators with the most host time), 10 steps under
   ``torch.cuda.set_sync_debug_mode("error")`` and the peak memory;
7. the step on the card against the step on the CPU from the seed's initial
   weights on one batch: in float64, the step-0 loss, the updated BatchNorm
   statistics, the step-0 gradient and the flat parameters after 5 steps,
   each to 1e-9; in float32 (TF32 off), the step-0 loss and the statistics,
   with the gradient and the 5-step parameters printed against float64;
8. the dataset build: synthetic WAV clips from the seed (WAVS: gated
   2-2.4 kHz tones as positives, low-band noise and tones as negatives,
   background noise, decaying impulses as RIRs, ambient tracks) through the
   port's save_clip, then ``build_dataset`` on the card with augmentation:
   validation, testing and ambient stores; checks the frontend's launches and
   holds stored spectrograms against the plain frontend on the same augmented
   audio under the Q6 gate;
9. raw-audio training at full width through ``run()``: two clips-type
   providers with pools of 2,000 augmented 3.2 s clips on the card, phase 8's
   stores for validation and testing, phase 6's recipe and schedule; checks
   the training as phase 6 does and that the frontend kernel ran exactly 3
   launches per train step; holds one step's in-step features against the
   plain frontend on the same gathered windows (Q6 gate); times the step as
   phase 6 does, with the frontend kernel's device time per step; run() gets
   ``--export_native 0 --export_stablehlo 0`` here and in phase 10, so that
   the launch checks and times count the steps alone (phases 13 and 16 check
   the exports);
10. mixed training with pool refresh through ``run()``: clips-type
   positives and phase 6's mmap negatives, the pool refreshed every 50 steps
   (blocking); checks the launches, the swaps and the training; times the
   mixed step, and the step while a PoolRefresher builds, then checks that
   a swap changes the pool tensor in place at the same shape;
11. Inception serving at full width (``default_inception_config``, random
   weights from the seed moved through models/convert.py): the same 64
   streams of 10 s PCM -> the frontend kernel at 20 ms hops (launch count set
   to 0 before and read after: exactly 3) -> stream_scan over 499 steps ->
   moving average -> cooldown accept counts; streamed probabilities held
   against the non-streaming forward; the path timed with CUDA events and
   the scan's first SERVING_PROFILED_STEPS steps profiled;
12. Inception training at full width through ``run()`` under deterministic
   cuDNN on phase 6's store and recipe (dropout 0.2, 20 ms hops: 102 input
   frames), with test splits
   cut to INCEPTION_TEST (streamed evaluation runs one step per frame);
   checks as phase 6 (the loss falls, accuracies, artifacts, selection), then
   the step's ms by CUDA events, kernels per step under the profiler and 10
   steps under ``set_sync_debug_mode("error")`` (the dropout draw too);
13. export and the C++ runtime, for phase 6's flagship and phase 12's
   Inception, whose ``run()`` wrote native/model.mww and model_quant.mww
   (``--export_native`` defaults to 1): both files exist; the float file in
   the runtime matches the port's stream_scan on the card (TF32 off) on the
   test ambient tracks to rtol 2e-4 / atol 2e-5, and the int8 file the float
   one to 0.08; the streamed ROC AUC of the float and int8 files through the
   runtime beside the port's; the runtime's host CPU ms per audio-second;
14. population training and the sweep CLI at the flagship's full width on
   phase 6's store: ``sweep.run()`` trains 8 members (seeds 0-7, learning
   rates 0.001 and 0.0005, share_batch) with phase 6's recipe for 300 steps,
   eval every 100; checks the leaderboard's 8 rows, that each member's
   best_weights.pt loads and gives finite probabilities, that the members
   differ and that member 0's loss falls below half its step-0 value; a
   private-batch population of 4 on the card against a population of one
   with member 2's seed (5 steps, in float64 to 5e-6, in float32 printed;
   TF32 off); member-steps per second
   by CUDA events of the solo step and of populations of 8 and 32
   (share_batch) and 8 (private batches), kernels per step and the busy
   share under the profiler, 10 steps under the sync check, the peak
   memory; an Inception share_batch population of 4 with dropout for 20
   steps (finite losses, members differ);
15. host streaming: ``train()`` with ``corpus_residency: host`` for 200
   steps (the loss and train accuracy checked as phase 6 does); the same
   draws through the host producer and the resident gather give bit-equal
   batches on the card; the host-mode step timed beside the resident step;
   10 host-mode steps under the sync check (only a wait on a pinned
   buffer's copy event is allowed, and counted); ``corpus_residency: auto``
   with ``MWW_CORPUS_HBM_BUDGET`` below the corpus's bytes picks host and
   prints the notice; (the sweep CLI of phase 14 exports nothing, so it
   takes no export flag);
16. the exported programs on the card, for phase 6's flagship and phase
   12's Inception, whose ``run()`` wrote torch_export/model.mwwt
   (``--export_stablehlo`` defaults to 1): loaded on the card (TF32 off),
   ``forward`` at batches 1 and 7 against the module (1e-5), 500 exported
   ``stream_step``s of a test ambient track against ``stream_scan`` (2e-4),
   ``Model.from_exported(...).predict_clip`` on one 10 s stream (exactly 3
   frontend launches) against ``Model.from_torch``'s; ms per exported step
   beside the eager step by CUDA events, kernels per step under the
   profiler;
17. the native host I/O (native/src/mww_native.cc, built by g++ in phase
   2): phase 8's WAVs decoded natively against scipy (exact), a 60 s
   44.1 kHz signal resampled to 16 kHz against scipy (2e-4), the VAD
   against its NumPy version (1e-6); host ms per audio-second of decode and
   resampling, native and scipy.  TFLite is not driven on the card: its
   machine has no TensorFlow (tests/test_torch_tflite.py and
   tests/test_torch_cli.py hold it on the CPU);
18. data-parallel training (parallel/): (a) the flagship at full width on
    phase 9's raw-audio pools, batch 128, trained for 20 steps through the
    data-parallel step in a NCCL process group of one rank on this card,
    against the solo step from the same seed and weights (TF32 off,
    deterministic cuDNN): losses, parameters and BatchNorm statistics within
    1e-6 (equality expected), 3 frontend launches per step; the world-1 step
    and the solo step timed in turns by CUDA events, with kernels and
    collectives per step; (b) two ranks on this one card over gloo (a
    one-card stand-in, passed as the backend by name), the flagship on phase
    6's store, batch 128 (64 per rank), replicated corpus, 20 steps against
    the solo step (deterministic cuDNN): held in float64 to the JAX
    package's bounds (loss rtol 1e-5, parameters 2e-5), in float32 to loss
    rtol 2e-3 and parameters 1e-3, which a control run with BatchNorm
    statistics per rank must exceed; the two-rank step timed; then a sharded
    corpus, whose two ranks' clips are disjoint and together the whole
    corpus; (c) pool refresh over a NCCL group of one rank on phase 9's full
    pools, a blocking refresh every 10 of 30 steps: 3 swaps, 3 frontend
    launches per step (the count set to 0 before the run and read after),
    the pool tensor changed in place at its shape, the swaps' broadcast ms;
    (d) pool refresh over two gloo ranks sharing the card, pools of 200
    clips per provider, a blocking refresh every 5 of 20 steps: rank 0
    alone builds, the ranks swap at the same steps to pools with equal
    digests, and end with equal parameters;
19. the host frontends (frontend/fixedpoint.py and reference.py) on the
    card against the same functions on the CPU, on the golden clips of
    tests/golden/frontend.npz at 10 and 20 ms: the integer-exact frontend
    bit for bit, the float one under the Q6 gate, with the share of exact
    cells; chunked calls on the card equal the whole clip; ms per
    audio-second on the card and on the CPU;
20. a JSON line of the kernels, then the last line
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import hashlib
import importlib.util
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
from scipy.signal import resample_poly

from microwakeword_tpu_torch import _build, build_dataset, native, sweep
from microwakeword_tpu_torch import model_train_eval as CLI
from microwakeword_tpu_torch.audio import io as audio_io
from microwakeword_tpu_torch.audio import vad
from microwakeword_tpu_torch.audio.augmentation import Augmentation
from microwakeword_tpu_torch.audio.clips import Clips
from microwakeword_tpu_torch.audio.io import save_clip
from microwakeword_tpu_torch.audio.spectrograms import features_to_uint16
from microwakeword_tpu_torch.config import derive_config
from microwakeword_tpu_torch.data import host_stream, sampler
from microwakeword_tpu_torch.data.ragged_store import RaggedSpectrogramStore
from microwakeword_tpu_torch.data.refresh import PoolRefresher
from microwakeword_tpu_torch.data.store import FeatureHandler
from microwakeword_tpu_torch.evaluate import accepts_kernel, roc, streaming_eval
from microwakeword_tpu_torch.export.torch_export import ExportedModel
from microwakeword_tpu_torch.frontend import constants as FC
from microwakeword_tpu_torch.frontend import fixedpoint, gate, kernel, plain, reference
from microwakeword_tpu_torch.frontend.ab import cuda_ms, queued_ms
from microwakeword_tpu_torch.inference import Model
from microwakeword_tpu_torch.models import build_model, convert, presets
from microwakeword_tpu_torch.models.mixednet import stream_phase
from microwakeword_tpu_torch.native import StreamingRuntime
from microwakeword_tpu_torch.parallel import corpus as dp_corpus
from microwakeword_tpu_torch.parallel import mesh as dp_mesh
from microwakeword_tpu_torch.parallel import population
from microwakeword_tpu_torch.parallel.train_step import make_sharded_train_step
from microwakeword_tpu_torch.train import loop as training
from microwakeword_tpu_torch.train import metrics as M

STREAMS = 64
CLIP_S = 10
STEP_MS = 10
IGNORE_SLICES_AFTER_ACCEPT = 25
SLIDING_WINDOW = 5
STREAM_ATOL = 2e-4  # streamed vs non-streaming probabilities (tests/test_models.py)
CLIP_ATOL = 1e-5  # one stream alone vs the same stream in the batch
# The flagship's raw-audio training batch (batch_size 128): 204 frames at 10 ms.
TRAIN_WINDOW = (128, 32960)
# Whole clips as the dataset builder passes them: 8 of 10 minutes, 1,875 tiles.
LONG_CLIPS = (8, 600 * FC.SAMPLE_RATE)

# Published H100 SXM peaks (dense): FP32 on the CUDA cores, HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# The __global__ functions of csrc/frontend.cu: launches A, S and B.
FRONTEND_KERNELS = ("filterbank_kernel", "carry_scan_kernel", "ema_agc_kernel")

# FP32 operations per feature cell after the mel product: sqrt and / 8 (2),
# the EMA (3) and plain._agc_output's elementwise operations (24).
CELL_FLOPS = 2 + 3 + 24

# Phase 6: the synthetic store, (clips, least frames, most frames) per split.
STORE = {
    "pos": {"training": (4000, 150, 250), "validation": (500, 150, 250), "testing": (100, 150, 250)},
    "neg": {"training": (16000, 100, 500), "validation": (500, 100, 500), "testing": (100, 100, 500),
            "validation_ambient": (20, 6000, 6000), "testing_ambient": (4, 6000, 6000)},
}
# The first AMBIENT_BURSTS[0] validation_ambient tracks carry
# AMBIENT_BURSTS[1] bursts of AMBIENT_BURSTS[2] frames with a positive clip's
# energy, so a confident model has false accepts there and checkpoint
# selection ranks the evals instead of freezing at the first.
AMBIENT_BURSTS = (2, 10, 120)
FLAGSHIP_FLAGS = ["mixednet", "--pointwise_filters", "64,64,64,64", "--repeat_in_block", "1,1,1,1",
                  "--mixconv_kernel_sizes", "[5], [7,11], [9,15], [23]",
                  "--residual_connection", "0,0,0,0", "--first_conv_filters", "32",
                  "--first_conv_kernel_size", "5", "--stride", "3"]
TIMED_STEPS, PROFILED_STEPS, SYNC_CHECKED_STEPS = 50, 20, 10
# Phase 7, the card against the CPU from the seed's initial weights on one
# batch.  The step runs in float64 on both devices, where a wrong forward,
# backward or update cannot hide inside rounding: the step-0 loss, the
# BatchNorm statistics it updates, its gradient and the parameters after 5
# steps are held to PARITY_F64.  The float32 step (TF32 off), the one that
# trains, is held on its step-0 loss and statistics, a forward that differs
# only by the order of float32 sums; its gradient and 5-step parameters are
# printed beside the float64 ones as context.
PARITY_STEPS = 5
PARITY_F64 = 1e-9  # relative for the loss and the gradient's norm, else absolute
PARITY_LOSS_RTOL = 1e-5
PARITY_STATS_RTOL, PARITY_STATS_ATOL = 1e-5, 1e-6
# Phases 8-10, the raw-audio path, on synthetic WAV clips from the seed:
# directory: (clips, least seconds, most seconds).  *_train feed the
# clips-type providers, *_eval phase 8's validation and testing stores.
WAVS = {"pos_train": (100, 1.0, 1.5), "neg_train": (100, 1.0, 1.5), "pos_eval": (200, 1.0, 1.5),
        "neg_eval": (200, 1.0, 1.5), "background": (8, 10.0, 10.0), "rir": (8, 0.3, 0.3),
        "ambient_val": (4, 60.0, 60.0), "ambient_test": (2, 60.0, 60.0)}
POOL_SIZE = 2000  # augmented clips per clips-type provider: the JAX package's pack_pool_size
AUGMENTATION_S = 3.2  # augmentation_duration_s: every augmented clip is 3.2 s
BACKGROUND_SNR_DB = (0.0, 10.0)  # the JAX package's default is (-10, 10)
BUILD_BATCH = 32  # clips per frontend call in build_dataset (batched_spectrograms)
RAW_STEPS = [400, 200]  # phase 9: twice phase 6's schedule
MIXED_STEPS, REFRESH_STEPS = [100], 50  # phase 10: two blocking swaps
INCEPTION_STEP_MS = 20  # the Inception family's default hop (models/presets.py)
# Phase 11 profiles this many streaming steps: the profiler's own processing of
# the whole scan's 110,000 kernels and their host events takes about a minute.
SERVING_PROFILED_STEPS = 50
# Phase 12's test splits, cut from phase 6's (the streamed evaluation runs one
# Inception step per frame): (clips, least frames, most frames) per split.
INCEPTION_TEST = {"pos": {"testing": (10, 150, 250)},
                  "neg": {"testing": (10, 100, 500), "testing_ambient": (1, 1500, 1500)}}
# Phase 13: the C++ runtime against the port's stream_scan
# (tests/test_native_runtime.py's tolerance).
RUNTIME_RTOL, RUNTIME_ATOL = 2e-4, 2e-5
INT8_ENVELOPE = 0.08  # the int8 file against the float one (tests/test_native_quant.py)
# Phase 14: the sweep (8 members, seeds 0-7, two learning rates, share_batch),
# the card's private-batch check (members, the member checked, steps;
# tests/test_population.py's member-vs-solo tolerance), the populations timed
# (share_batch, members) and Inception's population (members, steps).
SWEEP_MEMBERS, SWEEP_LRS = 8, "0.001,0.0005"
POP_PARITY, POP_ATOL = (4, 2, 5), 5e-6
POP_TIMED = [(True, 8), (True, 32), (False, 8)]
POP_TIMED_STEPS = 20
INCEPTION_POP = (4, 20)
# Phase 15: host streaming, 200 steps (eval every 100) through train().
HOST_STEPS = [200]
# Phase 16: the exported programs on the card
EXPORTED_ATOL = 1e-5  # forward of the loaded program vs the module (one card, one dtype)
EXPORTED_STEPS = 500  # streamed steps of a test ambient track, held to STREAM_ATOL
EXPORTED_TIMED_STEPS = 100
EXPORTED_PROFILED_STEPS = 20
# Phase 17: the native host I/O
DP_STEPS = 20  # phase 18: steps of each data-parallel run held against solo
DP_TIMED_STEPS = 30
DP_WORLD1_ATOL = 1e-6  # NCCL world 1 against solo: every share is 1.0, equality expected
# tests/test_parallel.py's bounds for the JAX package's sharded step, held in
# float64.  In float32 Adam's first updates (signs of near-zero gradients) and
# the fast variance amplify the order of the sums over 20 steps, past these
# bounds; float32 is held to wider ones that the control of phase 18(b)
# (BatchNorm statistics per rank) must exceed
DP_LOSS_RTOL, DP_PARAM_ATOL = 1e-5, 2e-5
DP_F32_LOSS_RTOL, DP_F32_PARAM_ATOL = 2e-3, 1e-3
RESAMPLE_ATOL = 2e-4  # native vs scipy resampling (tests/test_native.py)
VAD_ATOL = 1e-6  # native (float32) vs NumPy (float64) VAD (tests/test_native.py)
RESAMPLE_S, RESAMPLE_RATE = 60, 44100  # seconds of 44.1 kHz audio resampled to 16 kHz
REFRESH_DP = (10, 30)  # phase 18(c): a blocking refresh every 10 of 30 steps, phase 9's pools
REFRESH_GLOO = (200, 5, 20)  # phase 18(d): clips per provider, refresh every 5 of 20 steps
HOST_FRONTEND_STEPS = (10, 20)  # phase 19: the hops of the golden features
HOST_FRONTEND_WINDOWS = 40  # phase 19: frames fed one window at a time

def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def device_profile(fn):
    """One call of ``fn`` under torch.profiler: (wall ms, summed device
    kernel ms, the five kernels with the most device time, kernel launches,
    device ms of the frontend kernel's launches)."""
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
    frontend_ms = sum(e.self_device_time_total for e in kernels
                      if any(k in e.key for k in FRONTEND_KERNELS)) / 1e3
    return wall_ms, device_ms, top, sum(e.count for e in kernels), frontend_ms


def host_profile(fn, calls: int):
    """``calls`` calls of ``fn`` under torch.profiler, host side only: the
    three operators with the most self CPU time, (name, ms per call, calls
    per call)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:3]
    return [(e.key[:40], e.self_cpu_time_total / 1e3 / calls, e.count / calls) for e in ops]


def write_store(root: str, rng: np.random.Generator, store: dict | None = None) -> int:
    """The phase 6 store (``store``, by default STORE) under ``root``; returns
    the training frames.  Positives carry energy in the high channels,
    negatives in the low ones (tests/test_train.py's pattern);
    validation_ambient has AMBIENT_BURSTS."""
    training_frames = 0
    for name, splits in (store or STORE).items():
        for split, (count, lo, hi) in splits.items():
            lengths = rng.integers(lo, hi + 1, count)
            data = rng.integers(0, 80, (int(lengths.sum()), 40), dtype=np.uint16)
            data[:, 20:] += 300 if name == "pos" else 0
            data[:, :20] += 0 if name == "pos" else 300
            if split == "validation_ambient":
                tracks, bursts, span = AMBIENT_BURSTS
                for start in (np.cumsum(lengths) - lengths)[:tracks]:
                    for k in range(1, bursts + 1):
                        s = start + k * lo // (bursts + 1)
                        data[s : s + span, 20:] += 300
                        data[s : s + span, :20] -= 300
            RaggedSpectrogramStore.create(os.path.join(root, name, split, "w_mmap"),
                                          np.split(data, np.cumsum(lengths)[:-1]))
            training_frames += len(data) if split == "training" else 0
    return training_frames


def recipe(root: str, seed: int) -> dict:
    """The notebook's training recipe (notebooks/basic_training_notebook.ipynb)
    over two phases."""
    feature = dict(penalty_weight=1.0, type="mmap")
    return {
        "train_dir": os.path.join(root, "run"), "window_step_ms": 10, "clip_duration_ms": 1500,
        "seed": seed, "training_steps": [200, 100], "learning_rates": [0.001, 0.0001],
        "batch_size": 128, "steps_per_call": 1, "eval_step_interval": 100,
        "time_mask_max_size": [5], "time_mask_count": [2], "freq_mask_max_size": [5],
        "freq_mask_count": [2], "positive_class_weight": [1], "negative_class_weight": [20],
        "minimization_metric": "ambient_false_positives_per_hour",
        "maximization_metric": "average_viable_recall", "target_minimization": 0.5,
        "features": [
            dict(feature, features_dir=os.path.join(root, "pos"), truth=True, sampling_weight=2.0,
                 truncation_strategy="truncate_start"),
            dict(feature, features_dir=os.path.join(root, "neg"), truth=False, sampling_weight=10.0,
                 truncation_strategy="random"),
        ],
    }


def phase_training(dev: torch.device, smi: str, seed: int, root: str):
    """Phase 6, its store under ``root``; returns (bundle, corpus, first
    phase) for phase 7."""
    t0 = time.perf_counter()
    frames = write_store(root, np.random.default_rng(seed))
    print(f"phase 6 store: {frames:,} training frames ({frames * 80 / 1e6:.1f} MB of uint16), "
          f"written in {time.perf_counter() - t0:.1f} s", flush=True)
    flags = CLI.build_parser().parse_args(
        ["--training_config", os.path.join(root, "unused.yaml"), "--test_tf_nonstreaming", "1",
         "--device", dev.type]
        + FLAGSHIP_FLAGS)
    config = derive_config(recipe(root, seed), CLI.model_config_from_flags(flags))
    length, batch = config["spectrogram_length"], config["batch_size"]
    check(length == 204, f"flagship input frames {length}")
    bundle = build_model("mixednet", config["model_config"])
    phase = {k: v for k, v in training.resolve_schedules(config)[0].items() if k != "steps"}

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = CLI.run(flags, config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    history = out["history"]
    run_dir = config["train_dir"]
    # the step-0 loss of the recipe: the seed's initial model, one step
    handler = FeatureHandler(config)
    packed = handler.pack_training(dev)
    init = bundle.init(torch.Generator().manual_seed(seed), device=dev)
    first = training.make_train_step(bundle, init, packed, batch, length,
                                     generator=torch.Generator(device=dev).manual_seed(seed))
    loss0 = float(first.step(**phase)["loss"])
    del first, init
    for name in ("best_weights.pt", "metrics.jsonl", os.path.join("streaming", "streaming_roc.txt")):
        check(os.path.exists(os.path.join(run_dir, name)), f"{name} was not written")
    last = history[-1]["train"]
    auc = out["streaming_roc"]["auc"]
    print(f"phase 6 run(): {sum(p['steps'] for p in training.resolve_schedules(config))} steps "
          f"of batch {batch} x {length} frames, wall {wall:.2f} s with evals and the streamed "
          f"ROC; peak memory {peak / 2**20:.1f} MiB ({smi})")
    for rec in history:
        v = rec["validation"]
        print(f"  step {rec['step']}: train loss {rec['train']['loss']:.5f} accuracy "
              f"{rec['train']['accuracy']:.4f}; validation accuracy {v['accuracy']:.4f} "
              f"auc {v['auc']:.5f} faph {v['ambient_false_positives_per_hour']:.3f} "
              f"avr {v['average_viable_recall']:.4f}; {rec['steps_per_sec']:.1f} steps/s "
              f"(host clock, to the eval's sync)")
    print(f"phase 6 streamed test ROC AUC {auc:.5f}; test accuracy "
          f"{out['accuracy']['accuracy']:.4f}; step-0 loss {loss0:.5f}", flush=True)
    check(last["loss"] < 0.5 * loss0, f"loss {last['loss']} did not fall below half of {loss0}")
    check(last["accuracy"] > 0.9, f"last train accuracy {last['accuracy']}")
    # eval mode, on running statistics: 0.99 ** 300 of the initial ones remain
    val_acc = history[-1]["validation"]["accuracy"]
    check(val_acc > 0.9, f"validation accuracy {val_acc} at the last eval")
    check(math.isfinite(auc), f"streamed AUC {auc}")
    check_selection(bundle, config, handler, out, dev, "phase 6")
    print_summaries("phase 6", run_dir)
    state = {k: v.cpu() for k, v in training.load_weights(
        bundle, os.path.join(run_dir, "best_weights.pt"), dev).state_dict().items()}

    # the trained model's step: CUDA events, the profiler, the sync check
    model = bundle.load(state, device=dev)
    train_step = training.make_train_step(bundle, model, packed, batch, length,
                                          generator=torch.Generator(device=dev).manual_seed(seed + 1))
    m = measure_step(train_step, phase)
    print(f"phase 6 step (flagship, batch {batch}, SpecAugment on, TF32 off): {m['step_ms']:.4f} ms "
          f"per step by CUDA events over {TIMED_STEPS} steps ({1e3 / m['step_ms']:.1f} steps/s; host "
          f"clock {m['host_ms']:.4f} ms) ({smi})")
    print_profile("phase 6", m)
    for name, (wall, device, kernels, host_top) in step_breakdown(train_step, phase).items():
        print(f"phase 6 layer {name}: {wall:.4f} ms per call under the profiler, device "
              f"{device:.4f} ms, {kernels:.1f} kernels; most host time: " + "; ".join(
                  f"{op} {ms:.4f} ms x{n:.0f}" for op, ms, n in host_top))
    print(f"phase 6 sync check: {SYNC_CHECKED_STEPS} steps under set_sync_debug_mode('error') "
          f"raised nothing", flush=True)
    return bundle, packed, phase, config, out


def print_summaries(label: str, run_dir: str) -> None:
    """What run() wrote under logs/: the TensorBoard scalars where
    tensorboardX imports (an optional logger), nothing where it does not."""
    logs = os.path.join(run_dir, "logs")
    if importlib.util.find_spec("tensorboardX") is None:
        check(not os.path.exists(logs), f"{logs} exists without tensorboardX")
        print(f"{label} TensorBoard: tensorboardX does not import on this machine, so run() wrote "
              "no summaries (metrics.jsonl holds every eval's record)", flush=True)
        return
    events = {split: glob.glob(os.path.join(logs, split, "events.*")) for split in
              ("train", "validation")}
    check(all(events.values()), f"event files under {logs}: {events}")
    print(f"{label} TensorBoard: event files under logs/train and logs/validation", flush=True)


def measure_step(train_step, phase: dict) -> dict:
    """A train step's times: 10 warm-up steps, ms per step by CUDA events
    over TIMED_STEPS (and by the host clock), PROFILED_STEPS under
    torch.profiler (wall, device ms, the largest kernels, kernels and the
    frontend kernel's device ms per step), then SYNC_CHECKED_STEPS under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    for _ in range(10):
        train_step.step(**phase)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(TIMED_STEPS):
        train_step.step(**phase)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS

    def profiled_steps():
        for _ in range(PROFILED_STEPS):
            train_step.step(**phase)

    wall_ms, device_ms, top, launches, frontend_ms = device_profile(profiled_steps)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(SYNC_CHECKED_STEPS):
            metrics = train_step.step(**phase)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(math.isfinite(float(metrics["loss"])), "loss after the sync check")
    return dict(step_ms=start.elapsed_time(end) / TIMED_STEPS, host_ms=host_ms, wall_ms=wall_ms,
                device_ms=device_ms, top=top, kernels=launches / PROFILED_STEPS,
                frontend_ms=frontend_ms / PROFILED_STEPS)


def print_profile(label: str, m: dict) -> None:
    print(f"{label} profile of {PROFILED_STEPS} steps: wall {m['wall_ms']:.3f} ms under the profiler, "
          f"device kernels {m['device_ms']:.3f} ms, busy share {m['device_ms'] / m['wall_ms']:.4f}, "
          f"{m['kernels']:.1f} kernels per step"
          + ("" if m["device_ms"] else " (the profiler saw no device time: not measured)"))
    for key, ms, count in m["top"]:
        print(f"  {ms:9.3f} ms  x{count:<6d} {key}")


def check_selection(bundle, config: dict, handler, out: dict, dev: torch.device,
                    label: str) -> None:
    """A run's checkpoint selection and what run() scored with it:
    best_weights.pt holds the eval that the two-step rule picks from the
    evals' records, which do not all tie; run()'s non-streaming test accuracy
    is that of these weights, which rank the test clips (AUC); and the
    streamed ROC's false-rejection rates are those of one batched scan of the
    test positives (streaming is causal, so zero padding at the end changes
    no step kept), to one positive for rounding at a cutoff."""
    run_dir, length = config["train_dir"], config["spectrogram_length"]
    chosen, best_min, best_max = None, 10000.0, 0.0
    for rec in out["history"]:
        v = rec["validation"]
        current = (v["ambient_false_positives_per_hour"], v["average_viable_recall"])
        if M.is_new_best(*current, best_min, best_max, config["target_minimization"]):
            chosen, (best_min, best_max) = rec["step"], current
    check(any(r["validation"]["ambient_false_positives_per_hour"] > 0
              or r["validation"]["average_viable_recall"] < 1 for r in out["history"]),
          "selection saturated at every eval")
    best = torch.load(os.path.join(run_dir, "best_weights.pt"), weights_only=True)
    crumbs = glob.glob(os.path.join(run_dir, "train", f"*_weights_{chosen}.pt"))
    check(len(crumbs) == 1, f"the breadcrumb of step {chosen}: {crumbs}")
    crumb = torch.load(crumbs[0], weights_only=True)
    check(all(torch.equal(best[k], crumb[k]) for k in crumb), f"best_weights.pt is not step {chosen}")

    selected = bundle.load(best, device=dev)
    test_x, test_y, _ = handler.get_data("testing", batch_size=config["batch_size"],
                                         features_length=length, truncation_strategy="truncate_start")
    probs = training.make_eval_fn(bundle)(selected, test_x)
    test_acc = float(np.mean((probs > 0.5) == (test_y > 0.5)))
    test_auc = float(M.binary_metrics(torch.from_numpy(probs),
                                      torch.from_numpy(test_y.astype(np.float32)))["auc"])
    check(out["accuracy"]["accuracy"] == test_acc,
          f"run()'s test accuracy {out['accuracy']['accuracy']}, the selected weights' {test_acc}")
    check(test_auc >= 0.99, f"the selected weights' test AUC {test_auc}")

    tracks, labels, _ = handler.get_data("testing", batch_size=config["batch_size"],
                                         features_length=length, truncation_strategy="none")
    positives = [t for t, y in zip(tracks, labels) if y > 0.5]
    steps = [len(t) // bundle.stride for t in positives]
    x = np.zeros((len(positives), max(steps) * bundle.stride, positives[0].shape[1]), np.float32)
    for i, t in enumerate(positives):
        x[i, : steps[i] * bundle.stride] = t[: steps[i] * bundle.stride]
    scanned = bundle.stream_scan(selected, torch.from_numpy(x).to(dev))[..., 0].cpu()
    peaks = []
    for i, n in enumerate(steps):
        ma = roc.moving_average(scanned[i, IGNORE_SLICES_AFTER_ACCEPT:n], SLIDING_WINDOW)
        if ma.numel():
            peaks.append(float(ma.max()))
    frr_ref = 1.0 - (np.asarray(peaks)[:, None] > roc.DEFAULT_CUTOFFS[None, :]).mean(axis=0)
    frr = out["streaming_roc"]["frr_at_cutoffs"]
    frr_err = float(np.abs(frr - frr_ref).max())
    mid = int(np.searchsorted(roc.DEFAULT_CUTOFFS, np.median(peaks))) - 1  # below the median peak
    print(f"{label} selection: step {chosen} of {[r['step'] for r in out['history']]} (faph "
          f"{best_min:.3f}, avr {best_max:.4f}); its test accuracy {test_acc:.4f}, test AUC "
          f"{test_auc:.5f}; streamed FRR at cutoff {roc.DEFAULT_CUTOFFS[mid]:.2f} {frr[mid]:.4f} "
          f"(a batched scan: {frr_ref[mid]:.4f}), at 0.50 {frr[50]:.4f}; max|d| over the "
          f"cutoffs {frr_err:.4f} (tolerance {1 / len(peaks):.4f})", flush=True)
    check(len(peaks) == out["streaming_roc"]["positive_count"], "streamed positives counted")
    check(frr_err <= 1.0 / len(peaks), f"streamed FRR against a batched scan: {frr_err}")


def step_breakdown(step, phase: dict, calls: int = 20) -> dict:
    """Each layer of the train step run alone ``calls`` times under the
    profiler: {layer: (wall ms per call, device ms per call, kernels per
    call)}.  The layers are the step's own code, in its order; Adam updates
    ``step``'s weights as the step does."""
    masks, opt = step._split_phase(phase)
    bundle, model = step.bundle, step.model
    feats, labels, pen = sampler.sample_batch(step.packed, step.generator, step.batch_size,
                                              step.features_length, **masks)
    weights = pen * torch.where(labels > 0.5, opt["positive_class_weight"],
                                opt["negative_class_weight"])

    def loss():
        return training.weighted_bce(bundle.forward_train(model, feats), labels, weights)

    def adam():
        with torch.no_grad():
            step._adam(opt["learning_rate"])

    probs = bundle.forward_train(model, feats).detach()
    layers = {
        "sampler": lambda: sampler.sample_batch(step.packed, step.generator, step.batch_size,
                                                step.features_length, **masks),
        "forward + loss": loss,
        "forward + loss + backward": lambda: torch.autograd.grad(loss(), step.params),
        "Adam": adam,
        "step metrics": lambda: M.binary_metrics(probs, labels),
    }
    out = {}
    for name, fn in layers.items():
        for _ in range(3):
            fn()
        def run(fn=fn):  # keeps no result: a kept graph would hold its activations
            for _ in range(calls):
                fn()

        wall_ms, device_ms, _, launches, _ = device_profile(run)
        out[name] = (wall_ms / calls, device_ms / calls, launches / calls, host_profile(fn, calls))
    return out


def parity_run(bundle, state: dict, batch: tuple, phase: dict, where, dtype) -> tuple:
    """PARITY_STEPS steps of the train step on one gathered batch from
    ``state``, in ``dtype`` on ``where``: (step-0 loss, BatchNorm statistics
    after step 0, step-0 gradient, flat parameters after the last step), the
    tensors copied to the CPU in float64."""
    model = bundle.load(state, device=where).to(dtype)
    step = training.make_train_step(bundle, model, None, len(batch[2]), batch[0].shape[1])
    tensors = tuple(t.to(where) for t in batch)

    def f64(t):
        return t.detach().to("cpu", torch.float64, copy=True)

    loss0 = float(step.step_on_batch(*tensors, **phase)["loss"])
    stats = {k: f64(v) for k, v in model.state_dict().items() if k.endswith((".mean", ".var"))}
    grad = f64(step.grad)
    for _ in range(PARITY_STEPS - 1):
        step.step_on_batch(*tensors, **phase)
    return loss0, stats, grad, f64(step.flat)


def phase_parity(bundle, packed, phase: dict, dev: torch.device, smi: str, seed: int):
    """Phase 7: the step on the card against the step on the CPU, in float64
    and in float32."""
    length, batch = bundle.spectrogram_length, 128
    state = bundle.init(torch.Generator().manual_seed(seed), device="cpu").state_dict()
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    rows, valid, labels, weights = sampler.sample_batch_indices(packed, gen, batch, length)
    on_cpu = tuple(t.cpu() for t in (packed.frames[rows], valid, labels, weights))
    plain_phase = dict(phase, time_mask_count=0, freq_mask_count=0)  # no draws: one batch
    flat_0 = torch.cat([v.reshape(-1) for k, v in state.items()
                        if not k.endswith((".mean", ".var"))]).double()
    print(f"phase 7 card vs CPU, flagship from the seed's initial weights, one batch of {batch}, "
          f"{PARITY_STEPS} steps at lr {plain_phase['learning_rate']} ({smi}):")
    out = {}
    for dtype in (torch.float64, torch.float32):
        (loss_c, stats_c, grad_c, flat_c), (loss_p, stats_p, grad_p, flat_p) = (
            parity_run(bundle, state, on_cpu, plain_phase, where, dtype) for where in (dev, "cpu"))
        loss_rel = abs(loss_c - loss_p) / abs(loss_p)
        stats_err = max(float((stats_c[k] - stats_p[k]).abs().max()) for k in stats_p)
        grad_rel = float((grad_c - grad_p).norm() / grad_p.norm())
        diff = (flat_c - flat_p).abs()
        update_rel = float(diff.norm() / (flat_p - flat_0).norm())
        out[dtype] = (grad_c, grad_p, flat_c, flat_p)
        print(f"  {str(dtype)[6:]}: step-0 loss {loss_c:.10f} vs {loss_p:.10f}, rel {loss_rel:.2e}; "
              f"BatchNorm statistics max|d| {stats_err:.2e}; step-0 gradient |d| / |g| "
              f"{grad_rel:.2e}; parameters after {PARITY_STEPS} steps max|d| {float(diff.max()):.2e}, "
              f"|d| / |update| {update_rel:.2e}", flush=True)
        if dtype == torch.float64:
            check(loss_rel <= PARITY_F64, f"float64 step-0 loss rel {loss_rel}")
            check(stats_err <= PARITY_F64, f"float64 BatchNorm statistics max|d| {stats_err}")
            check(grad_rel <= PARITY_F64, f"float64 step-0 gradient rel {grad_rel}")
            check(float(diff.max()) <= PARITY_F64,
                  f"float64 parameters after {PARITY_STEPS} steps max|d| {float(diff.max())}")
        else:
            check(loss_rel <= PARITY_LOSS_RTOL, f"float32 step-0 loss rel {loss_rel}")
            for k in stats_p:
                check(torch.allclose(stats_c[k], stats_p[k], rtol=PARITY_STATS_RTOL,
                                     atol=PARITY_STATS_ATOL), f"float32 {k} after step 0")
    grad64 = out[torch.float64][1]
    g_c, g_p, f_c, f_p = out[torch.float32]
    f64_flat = out[torch.float64][3]
    print(f"  context, float32 against the float64 step on the CPU: step-0 gradient |d| / |g| card "
          f"{float((g_c - grad64).norm() / grad64.norm()):.2e}, CPU "
          f"{float((g_p - grad64).norm() / grad64.norm()):.2e}; parameters after {PARITY_STEPS} "
          f"steps max|d| card {float((f_c - f64_flat).abs().max()):.2e}, CPU "
          f"{float((f_p - f64_flat).abs().max()):.2e} (tolerances: float64 {PARITY_F64}; float32 "
          f"loss rel {PARITY_LOSS_RTOL}, statistics rtol {PARITY_STATS_RTOL} atol "
          f"{PARITY_STATS_ATOL})", flush=True)


def gate_mask(rng: np.random.Generator, samples: int) -> np.ndarray:
    """An envelope that swells and fades 5-10 times a second, max(sin, 0)^2:
    the frontend's noise suppression removes steady sounds, so the classes
    differ in what comes and goes; a smooth envelope spreads no clicks into
    the other class's band."""
    t = np.arange(samples) / FC.SAMPLE_RATE
    return np.maximum(np.sin(2 * np.pi * rng.uniform(5.0, 10.0) * t + rng.uniform(0, 2 * np.pi)), 0) ** 2


def gated_tone(rng: np.random.Generator, samples: int, lo: float, hi: float) -> np.ndarray:
    """A tone of a frequency in [lo, hi) Hz under a gate_mask."""
    t = np.arange(samples) / FC.SAMPLE_RATE
    return (rng.uniform(0.2, 0.6) * gate_mask(rng, samples)
            * np.sin(2 * np.pi * rng.uniform(lo, hi) * t))


def low_noise(rng: np.random.Generator, samples: int, level: float) -> np.ndarray:
    """White noise of RMS ``level`` with everything above 800 Hz removed."""
    spectrum = np.fft.rfft(rng.standard_normal(samples))
    spectrum[np.fft.rfftfreq(samples, 1 / FC.SAMPLE_RATE) > 800.0] = 0
    noise = np.fft.irfft(spectrum, samples)
    return level * noise / max(float(noise.std()), 1e-12)


def write_wavs(root: str, rng: np.random.Generator) -> float:
    """The WAVS clips under ``root``/<name>/ through the port's save_clip;
    returns their seconds.  Positives: gated 2-2.4 kHz tones.  Negatives:
    gated 150-800 Hz tones or gated low-band noise.  Background: white noise.
    RIRs: decaying noise impulses.  Ambient: low-band noise with gated low
    tones; the first validation track also carries AMBIENT_BURSTS[1] positive
    bursts, so a confident model has false accepts there."""
    seconds = 0.0
    for name, (count, lo, hi) in WAVS.items():
        os.makedirs(os.path.join(root, name))
        for i in range(count):
            n = int(rng.uniform(lo, hi) * FC.SAMPLE_RATE)
            if name.startswith("pos"):
                audio = gated_tone(rng, n, 2000.0, 2400.0)
            elif name.startswith("neg"):
                audio = (gated_tone(rng, n, 150.0, 800.0) if i % 2 else
                         low_noise(rng, n, 0.3) * gate_mask(rng, n))
            elif name == "background":
                audio = 0.1 * rng.standard_normal(n)
            elif name == "rir":
                audio = np.exp(-np.arange(n) / (0.05 * FC.SAMPLE_RATE)) * rng.standard_normal(n)
                audio[0] = 1.0
            else:  # ambient
                audio = low_noise(rng, n, 0.05)
                for start in rng.integers(0, n - FC.SAMPLE_RATE, 30):
                    audio[start : start + FC.SAMPLE_RATE] += gated_tone(rng, FC.SAMPLE_RATE, 150, 800)
                if name == "ambient_val" and i == 0:
                    for start in rng.integers(0, n - FC.SAMPLE_RATE, AMBIENT_BURSTS[1]):
                        audio[start : start + FC.SAMPLE_RATE] += gated_tone(rng, FC.SAMPLE_RATE,
                                                                             2000, 2400)
            peak = np.abs(audio).max()
            audio = audio * min(1.0, 0.95 / peak) if peak > 0 else audio
            save_clip(audio.astype(np.float32), os.path.join(root, name, f"{name}{i}.wav"))
            seconds += n / FC.SAMPLE_RATE
    return seconds


def augmentation_settings(wav_root: str, seed: int) -> dict:
    """Augmentation with the JAX package's default probabilities over the
    phase's background noise and RIRs, AUGMENTATION_S long.  The background
    is mixed at BACKGROUND_SNR_DB: a 1 s tone in 3.2 s drowned 10 dB below
    white noise leaves positives that 300 steps of the recipe, whose class
    weights ask for a posterior above 20/21, do not learn to accept."""
    return {"augmentation_duration_s": AUGMENTATION_S, "seed": seed,
            "background_paths": [os.path.join(wav_root, "background")],
            "impulse_paths": [os.path.join(wav_root, "rir")],
            "background_min_snr_db": BACKGROUND_SNR_DB[0],
            "background_max_snr_db": BACKGROUND_SNR_DB[1]}


def dataset_docs(wav_root: str, out_root: str, seed: int) -> list[dict]:
    """build_dataset's documents: pos/ and neg/ validation and testing
    stores from the *_eval clips (halves of one split), augmented; the
    ambient tracks under neg/, not augmented."""
    docs = [{"output_dir": os.path.join(out_root, name), "name": name,
             "clips": {"input_directory": os.path.join(wav_root, f"{name}_eval"),
                       "random_split_seed": seed, "split_count": 0.5, "seed": seed + i},
             "augmentation": augmentation_settings(wav_root, seed + 10 + i),
             "spectrogram_generation": {"step_ms": 10},
             "splits": {"validation": {"split": "validation"}, "testing": {"split": "test"}}}
            for i, name in enumerate(("pos", "neg"))]
    docs += [{"output_dir": os.path.join(out_root, "neg"), "name": name,
              "clips": {"input_directory": os.path.join(wav_root, name)},
              "spectrogram_generation": {"step_ms": 10}, "splits": {mode: {"split": None}}}
             for mode, name in (("validation_ambient", "ambient_val"), ("testing_ambient", "ambient_test"))]
    return docs


def phase_dataset(dev: torch.device, smi: str, seed: int, root: str) -> dict:
    """Phase 8: synthetic WAVs from the seed, then build_dataset on the card.
    Checks the frontend's launches (3 per batch of at most BUILD_BATCH clips)
    and holds the first BUILD_BATCH stored validation positives against the
    plain frontend on the same augmented audio, each clip alone, under the
    Q6 gate.  Returns {"launches", "wav_root", "stores"}."""
    wav_root, stores = os.path.join(root, "wav"), os.path.join(root, "stores")
    t0 = time.perf_counter()
    seconds = write_wavs(wav_root, np.random.default_rng(seed + 100))
    print(f"phase 8 WAVs: {sum(c for c, _, _ in WAVS.values())} clips, {seconds:.1f} s of audio, "
          f"written in {time.perf_counter() - t0:.1f} s", flush=True)
    docs = dataset_docs(wav_root, stores, seed)
    kernel.frontend_batch.launches = 0
    t0 = time.perf_counter()
    results = [build_dataset.build_feature_dir(doc, dev, log=lambda *a: None) for doc in docs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.frontend_batch.launches
    calls = sum(-(-count // BUILD_BATCH) for res in results for count, _ in res.values())
    check(launches == kernel.LAUNCHES_PER_CALL * calls > 0,
          f"build_dataset launched the frontend kernel {launches} times for {calls} batches")
    print(f"phase 8 build_dataset on the card: {wall:.2f} s; stores " + "; ".join(
        f"{doc['name']}/{mode} {count} clips {frames} frames" for doc, res in zip(docs, results)
        for mode, (count, frames) in res.items()) + f"; frontend launches {launches} ({smi})")

    doc = docs[0]
    clips = Clips(**doc["clips"])
    audio = Augmentation(**doc["augmentation"]).augment_generator(
        clips.audio_generator(split="validation"))
    store = RaggedSpectrogramStore(os.path.join(stores, "pos", "validation", "pos_mmap"))
    got, want = [], []
    with torch.inference_mode():
        for i, clip in zip(range(BUILD_BATCH), audio):
            feats = plain.frontend_batch(torch.from_numpy(np.asarray(clip, np.float32))[None].to(dev))
            want.append(features_to_uint16(feats[0].cpu().numpy()))
            got.append(np.asarray(store[i]))
    check([g.shape for g in got] == [w.shape for w in want], "stored spectrogram lengths")
    res = gate.assert_q6_gate(np.concatenate(got) * FC.FEATURE_SCALE,
                              np.concatenate(want) * FC.FEATURE_SCALE)
    print(f"phase 8 stored validation positives against the plain frontend ({BUILD_BATCH} clips, "
          f"{res.cells} cells): max|d|={res.max_abs} exact_share={res.exact_share:.6f} "
          f"q6_flips={res.q6_flips}", flush=True)
    return {"launches": launches, "wav_root": wav_root, "stores": stores}


def clips_feature(wav_root: str, name: str, truth: bool, weight: float, strategy: str,
                  seed: int) -> dict:
    """A clips-type feature set over ``name``_train/ with a POOL_SIZE pool."""
    return {"type": "clips", "truth": truth, "sampling_weight": weight, "penalty_weight": 1.0,
            "truncation_strategy": strategy, "pack_pool_size": POOL_SIZE,
            "clips_settings": {"input_directory": os.path.join(wav_root, f"{name}_train"), "seed": seed},
            "augmentation_settings": augmentation_settings(wav_root, seed + 1),
            "spectrogram_generation_settings": {"step_ms": 10}}


def mmap_feature(features_dir: str, truth: bool, weight: float, strategy: str) -> dict:
    return {"type": "mmap", "features_dir": features_dir, "truth": truth, "sampling_weight": weight,
            "penalty_weight": 1.0, "truncation_strategy": strategy}


def audio_run(dev: torch.device, root: str, seed: int, label: str, steps: list, features: list,
              extra_flags: list, **options):
    """``run()`` of the notebook's recipe with ``raw_audio_training``; the
    frontend launch count is set to 0 just before and read just after.
    Returns (flags, config, out, wall s, peak bytes, launches)."""
    flags = CLI.build_parser().parse_args(
        ["--training_config", os.path.join(root, "unused.yaml"), "--device", dev.type]
        + extra_flags + FLAGSHIP_FLAGS)
    config = dict(recipe(root, seed), train_dir=os.path.join(root, label), training_steps=steps,
                  learning_rates=[0.001, 0.0001][: len(steps)], raw_audio_training=True,
                  features=features, **options)
    config = derive_config(config, CLI.model_config_from_flags(flags))
    check(config["spectrogram_length"] == 204, f"flagship input frames {config['spectrogram_length']}")
    torch.cuda.reset_peak_memory_stats()
    kernel.frontend_batch.launches = 0
    t0 = time.perf_counter()
    out = CLI.run(flags, config)
    torch.cuda.synchronize()
    launches = kernel.frontend_batch.launches
    wall = time.perf_counter() - t0
    return flags, config, out, wall, torch.cuda.max_memory_allocated(), launches


def print_history(label: str, history: list) -> None:
    for rec in history:
        v = rec["validation"]
        print(f"  step {rec['step']}: train loss {rec['train']['loss']:.5f} accuracy "
              f"{rec['train']['accuracy']:.4f}; validation accuracy {v.get('accuracy', float('nan')):.4f} "
              f"faph {v.get('ambient_false_positives_per_hour', float('nan')):.3f}; pool swaps "
              f"{rec.get('pool_swaps', 0)}; {rec['steps_per_sec']:.1f} steps/s "
              f"(host clock, to the eval's sync)")


def phase_raw_audio(dev: torch.device, smi: str, seed: int, root: str, built: dict) -> dict:
    """Phase 9: raw-audio training at full width through run(): two
    clips-type providers (pools of POOL_SIZE augmented clips on the card)
    and phase 8's stores as validation- and testing-only mmap dirs.  Checks
    the training as phase 6 does and that run() launched the frontend kernel
    exactly 3 times per step; then, for the trained model, holds one step's
    in-step features against the plain frontend on the same gathered windows
    and times the step (measure_step)."""
    wav_root, stores = built["wav_root"], built["stores"]
    features = [clips_feature(wav_root, "pos", True, 2.0, "truncate_start", seed + 20),
                clips_feature(wav_root, "neg", False, 10.0, "random", seed + 30),
                mmap_feature(os.path.join(stores, "pos"), True, 2.0, "truncate_start"),
                mmap_feature(os.path.join(stores, "neg"), False, 10.0, "random")]
    flags, config, out, wall, peak, launches = audio_run(
        dev, root, seed, "raw_audio", RAW_STEPS, features,
        ["--test_tf_nonstreaming", "1", "--export_native", "0", "--export_stablehlo", "0"])
    steps = sum(RAW_STEPS)
    history, length, batch = out["history"], config["spectrogram_length"], config["batch_size"]
    check(launches == kernel.LAUNCHES_PER_CALL * steps,
          f"run() launched the frontend kernel {launches} times in {steps} steps")
    print(f"phase 9 run(): {steps} raw-audio steps of batch {batch} x {length} frames (pools of "
          f"{POOL_SIZE} clips x 2 providers, {AUGMENTATION_S} s each), wall {wall:.2f} s with the "
          f"pack, evals and the streamed ROC; frontend launches {launches}; peak memory "
          f"{peak / 2**20:.1f} MiB ({smi})")
    print_history("phase 9", history)
    for name in ("best_weights.pt", "metrics.jsonl", os.path.join("streaming", "streaming_roc.txt")):
        check(os.path.exists(os.path.join(config["train_dir"], name)), f"{name} was not written")

    bundle = build_model("mixednet", config["model_config"])
    phase = {k: v for k, v in training.resolve_schedules(config)[0].items() if k != "steps"}
    t0 = time.perf_counter()
    packed = FeatureHandler(config, dev).pack_training_audio(dev, step_ms=config["window_step_ms"])
    pack_s = time.perf_counter() - t0
    check(isinstance(packed, sampler.PackedAudioData), f"packed {type(packed).__name__}")
    init = bundle.init(torch.Generator().manual_seed(seed), device=dev)
    loss0 = float(training.make_train_step(
        bundle, init, packed, batch, length,
        generator=torch.Generator(device=dev).manual_seed(seed)).step(**phase)["loss"])
    del init
    last, auc = history[-1]["train"], out["streaming_roc"]["auc"]
    val_acc = history[-1]["validation"]["accuracy"]
    print(f"phase 9 pack of the audio pools: {pack_s:.2f} s ({packed.chunks.shape[0]:,} chunk rows, "
          f"{packed.chunks.numel() * 2 / 1e6:.1f} MB of int16); streamed test ROC AUC {auc:.5f}; "
          f"test accuracy {out['accuracy']['accuracy']:.4f}; step-0 loss {loss0:.5f}", flush=True)
    check(last["loss"] < 0.5 * loss0, f"loss {last['loss']} did not fall below half of {loss0}")
    check(last["accuracy"] > 0.9, f"last train accuracy {last['accuracy']}")
    check(val_acc > 0.9, f"validation accuracy {val_acc} at the last eval")
    check(math.isfinite(auc), f"streamed AUC {auc}")

    model = training.load_weights(bundle, os.path.join(config["train_dir"], "best_weights.pt"), dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    train_step = training.make_train_step(bundle, model, packed, batch, length, generator=gen)
    # one step's features: the step's own draw, then the kernel and the plain version
    state = gen.get_state()
    with torch.inference_mode():
        pcm, _, _ = sampler.draw_audio_windows(packed, gen, batch, length)
        got = sampler.audio_features(pcm, packed.hop_samples, length)
        want = plain.frontend_batch(pcm, config["window_step_ms"])
        gen.set_state(state)
        in_step, _, _ = sampler.sample_audio_feature_batch(packed, gen, batch, length)
    check(torch.equal(in_step, got), "the step's features are not the kernel's on its windows")
    res = gate.assert_q6_gate(got.cpu().numpy(), want.cpu().numpy())
    print(f"phase 9 in-step features {tuple(got.shape)} from int16 windows {tuple(pcm.shape)} "
          f"against the plain frontend: max|d|={res.max_abs} exact_share={res.exact_share:.6f} "
          f"q6_flips={res.q6_flips}", flush=True)
    m = measure_step(train_step, phase)
    audio_s = batch * pcm.shape[1] / FC.SAMPLE_RATE
    print(f"phase 9 raw-audio step (flagship, batch {batch}, SpecAugment on, TF32 off): "
          f"{m['step_ms']:.4f} ms per step by CUDA events over {TIMED_STEPS} steps "
          f"({1e3 / m['step_ms']:.1f} steps/s, {audio_s * 1e3 / m['step_ms']:.0f} audio-s trained "
          f"per s at {audio_s:.2f} audio-s per step; host clock {m['host_ms']:.4f} ms); frontend "
          f"kernel {m['frontend_ms']:.4f} ms of device time per step, "
          f"{m['frontend_ms'] / max(m['device_ms'] / PROFILED_STEPS, 1e-12):.4f} of the step's device "
          f"time, {m['frontend_ms'] / m['step_ms']:.4f} of the step ({smi})")
    print_profile("phase 9", m)
    print(f"phase 9 sync check: {SYNC_CHECKED_STEPS} steps under set_sync_debug_mode('error') "
          f"raised nothing", flush=True)
    # the pools wait in host memory for phase 18, off the card's peak readings
    return dict(m, launches=launches, steps=steps, max_abs=res.max_abs,
                packed=packed_to(packed, "cpu"), config=config)


def phase_mixed(dev: torch.device, smi: str, seed: int, root: str, built: dict,
                spectrogram_root: str) -> dict:
    """Phase 10: mixed training with pool refresh through run(): clips-type
    positives (a POOL_SIZE pool) and phase 6's mmap negatives, phase 8's
    positive store for validation, the pool refreshed every REFRESH_STEPS
    steps (blocking, so the swaps happen).  Checks the launches (3 per step:
    the audio sub-batch), the swaps and the training; then, on a fresh pack,
    times the mixed step (measure_step), starts a PoolRefresher, times the
    step while it builds, and checks that a swap changes the pool tensor's
    contents in place, at the same shape."""
    features = [clips_feature(built["wav_root"], "pos", True, 2.0, "truncate_start", seed + 40),
                mmap_feature(os.path.join(spectrogram_root, "neg"), False, 10.0, "random"),
                mmap_feature(os.path.join(built["stores"], "pos"), True, 2.0, "truncate_start")]
    flags, config, out, wall, peak, launches = audio_run(
        dev, root, seed, "mixed", MIXED_STEPS, features,
        ["--test_streaming", "0", "--export_native", "0", "--export_stablehlo", "0"],
        eval_step_interval=REFRESH_STEPS, pool_refresh_steps=REFRESH_STEPS,
        pool_refresh_blocking=True)
    steps, history = sum(MIXED_STEPS), out["history"]
    print(f"phase 10 run(): {steps} mixed steps, wall {wall:.2f} s with the pack, the blocking pool "
          f"refreshes and evals; frontend launches {launches}; peak memory {peak / 2**20:.1f} MiB ({smi})")
    print_history("phase 10", history)
    check(launches == kernel.LAUNCHES_PER_CALL * steps,
          f"run() launched the frontend kernel {launches} times in {steps} steps")
    check(history[-1]["pool_swaps"] >= 1, f"pool swaps {history[-1]['pool_swaps']}")
    check(math.isfinite(history[-1]["train"]["loss"]), "mixed training loss")
    check(history[-1]["train"]["accuracy"] > 0.9, f"last train accuracy {history[-1]['train']}")

    handler = FeatureHandler(config, dev)
    t0 = time.perf_counter()
    packed = handler.pack_training_audio(dev, step_ms=config["window_step_ms"])
    pack_s = time.perf_counter() - t0
    check(isinstance(packed, sampler.PackedMixedData), f"packed {type(packed).__name__}")
    batch, length = config["batch_size"], config["spectrogram_length"]
    b_audio, b_spec = sampler.mixed_batch_sizes(batch, packed.audio_fraction)
    phase = {k: v for k, v in training.resolve_schedules(config)[0].items() if k != "steps"}
    bundle = build_model("mixednet", config["model_config"])
    model = training.load_weights(bundle, os.path.join(config["train_dir"], "best_weights.pt"), dev)
    train_step = training.make_train_step(bundle, model, packed, batch, length,
                                          generator=torch.Generator(device=dev).manual_seed(seed + 4))
    m = measure_step(train_step, phase)
    print(f"phase 10 mixed step ({b_audio} raw-audio + {b_spec} spectrogram rows, pack {pack_s:.2f} s): "
          f"{m['step_ms']:.4f} ms per step by CUDA events over {TIMED_STEPS} steps (host clock "
          f"{m['host_ms']:.4f} ms); frontend kernel {m['frontend_ms']:.4f} ms of device time per "
          f"step ({smi})")
    print_profile("phase 10", m)

    chunks = packed.audio.chunks
    before, ptr = chunks.clone(), chunks.data_ptr()
    refresher = PoolRefresher(handler, packed, REFRESH_STEPS).start()
    try:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TIMED_STEPS):
            train_step.step(**phase)
        end.record()
        torch.cuda.synchronize()
        refreshing_ms = start.elapsed_time(end) / TIMED_STEPS
        t0 = time.perf_counter()
        swapped = refresher.maybe_swap(packed, REFRESH_STEPS, block=True)
        swap_s = time.perf_counter() - t0
    finally:
        refresher.stop()
    check(swapped and refresher.swap_count == 1, "the refresher did not swap")
    check(packed.audio.chunks.data_ptr() == ptr and packed.audio.chunks.shape == before.shape,
          "the swap moved or reshaped the pool tensor")
    changed = float((packed.audio.chunks != before).float().mean())
    check(changed > 0.5, f"the swap changed {changed:.4f} of the pool's samples")
    metrics = train_step.step(**phase)
    check(math.isfinite(float(metrics["loss"])), "loss after the swap")
    print(f"phase 10 pool refresh: {TIMED_STEPS} mixed steps while the worker built a pool, "
          f"{refreshing_ms:.4f} ms per step by CUDA events; blocking swap {swap_s:.2f} s (the rest of "
          f"the build and the copy); pool tensor {tuple(before.shape)} int16 kept in place, "
          f"{changed:.4f} of its samples changed", flush=True)
    return dict(m, launches=launches, steps=steps, refreshing_ms=refreshing_ms)


def inception_state(seed: int) -> tuple:
    """The default Inception bundle and a random state, through the flax
    layout: Glorot kernels from a torch.Generator, BN statistics from numpy
    (variances near 1: small ones compound over Inception's depth)."""
    bundle = build_model("inception", presets.default_inception_config())
    module = bundle.init(torch.Generator().manual_seed(seed), device="cpu")
    variables = convert.state_to_flax({k: v.numpy() for k, v in module.state_dict().items()})
    rng = np.random.default_rng(seed)

    def randomize(tree: dict) -> None:
        for key, value in tree.items():
            if isinstance(value, dict):
                randomize(value)
            elif key == "mean":
                tree[key] = rng.normal(0.0, 0.2, value.shape).astype(np.float32)
            elif key == "var":
                tree[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)

    randomize(variables["batch_stats"])
    return bundle, convert.flax_to_state(variables)


def accepts_phase(label: str, probs: torch.Tensor) -> dict:
    """The counting kernel on the moving average of ``probs`` [streams,
    steps] (the tracks that ``ambient_accept_counts`` counts) against the
    plain loop: bit for bit against the loop on the CPU, then timed against
    the loop on the card, on the device alone and beside its bound (its
    bytes: the tracks in, the int64 counts out)."""
    ma = roc.moving_average(probs, SLIDING_WINDOW)
    args = (roc.DEFAULT_CUTOFFS, IGNORE_SLICES_AFTER_ACCEPT)
    got = roc.count_accepts(ma, *args)
    want = roc.count_accepts(ma.cpu(), *args)
    check(torch.equal(got.cpu(), want), f"{label}: the counting kernel's counts differ from the "
                                        f"plain loop's on the CPU at {list(ma.shape)}")
    tm = dict(kernel=cuda_ms(lambda: roc.count_accepts(ma, *args), 20),
              plain=cuda_ms(lambda: roc.count_accepts_plain(ma, *args), 3))
    tm["device"], tm["host_us"] = queued_ms(lambda: roc.count_accepts(ma, *args), 50)
    nbytes = ma.numel() * ma.element_size() + got.numel() * got.element_size()
    tm["bound"] = nbytes / PEAK_BYTES_PER_S * 1e3
    print(f"{label} counting kernel {list(ma.shape)} x {len(roc.DEFAULT_CUTOFFS)} cutoffs, cooldown "
          f"{IGNORE_SLICES_AFTER_ACCEPT}: equal to the CPU loop ({int(want.sum())} accepts); kernel "
          f"{tm['kernel']:.4f} ms, plain loop on the card {tm['plain']:.4f} ms (both: events around "
          f"back-to-back calls); kernel on the device alone {tm['device']:.4f} ms, wrapper host time "
          f"{tm['host_us']:.1f} us per call; bound {tm['bound']:.5f} ms ({nbytes:,} bytes; "
          f"roofline share {tm['bound'] / tm['device']:.4f} of the device time); library: none",
          flush=True)
    return tm


def phase_inception_serving(dev: torch.device, smi: str, seed: int, pcm: torch.Tensor) -> dict:
    """Phase 11: Inception serving at full width: ``pcm`` -> the frontend
    kernel at 20 ms hops -> stream_scan at stride 1 -> accept counts; the
    launch count is set to 0 before the path and read after it (exactly 3),
    the counting kernel's likewise (exactly 1); the streamed probabilities
    against the non-streaming forward; the counting kernel against the plain
    loop at [64, 495] (``accepts_phase``); the whole
    path and its parts timed with CUDA events, and the scan's first
    SERVING_PROFILED_STEPS steps profiled."""
    bundle, state = inception_state(seed)
    model = Model.from_torch(bundle, state, device=dev)
    step_s = INCEPTION_STEP_MS / 1000

    def accepts(probs):
        return streaming_eval.ambient_accept_counts(
            [probs[..., 0]], roc.DEFAULT_CUTOFFS, IGNORE_SLICES_AFTER_ACCEPT, SLIDING_WINDOW,
            stride=bundle.stride, step_s=step_s)

    kernel.frontend_batch.launches = 0
    accepts_kernel.count_accepts.launches = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        feats = kernel.frontend_batch(pcm, step_ms=INCEPTION_STEP_MS)
        probs = bundle.stream_scan(model.module, feats)
        counts, hours = accepts(probs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.frontend_batch.launches
    check(launches == kernel.LAUNCHES_PER_CALL,
          f"Inception serving launched the frontend kernel {launches} times")
    accept_launches = accepts_kernel.count_accepts.launches
    check(accept_launches == 1,
          f"Inception serving launched the counting kernel {accept_launches} times")
    frames = FC.num_frames(pcm.shape[1], FC.hop_samples(INCEPTION_STEP_MS))
    check(feats.shape == (pcm.shape[0], frames, FC.NUM_CHANNELS), f"features {tuple(feats.shape)}")
    check(probs.shape == (pcm.shape[0], frames, 1), f"probs {tuple(probs.shape)}")
    p = probs.float()
    check(bool(torch.isfinite(p).all()) and bool(((p >= 0) & (p <= 1)).all()), "probabilities")
    t_in = bundle.spectrogram_length
    worst = 0.0
    with torch.inference_mode():
        for end in (frames, frames - 1, frames - 2):  # stride 1: the step ending at frame e
            full = bundle.forward(model.module, feats[:, end - t_in : end])
            worst = max(worst, float((full - probs[:, end - 1]).abs().max()))
    check(worst <= STREAM_ATOL, f"Inception streamed vs forward max|d| {worst} > {STREAM_ATOL}")
    check(counts.shape == (len(roc.DEFAULT_CUTOFFS),) and hours > 0, "accept counts")

    def whole_path():
        f = kernel.frontend_batch(pcm, step_ms=INCEPTION_STEP_MS)
        accepts(bundle.stream_scan(model.module, f))

    with torch.inference_mode():
        acc = accepts_phase("phase 11", probs[..., 0])
        frontend_ms = cuda_ms(lambda: kernel.frontend_batch(pcm, step_ms=INCEPTION_STEP_MS), 20)
        scan_ms = cuda_ms(lambda: bundle.stream_scan(model.module, feats), 1)
        accept_ms = cuda_ms(lambda: accepts(probs), 3)
        path_ms = cuda_ms(whole_path, 1)
        prof_wall, prof_device, top, prof_kernels, _ = device_profile(
            lambda: bundle.stream_scan(model.module, feats[:, :SERVING_PROFILED_STEPS]))
    audio_s = pcm.shape[0] * pcm.shape[1] / FC.SAMPLE_RATE
    n_params = sum(w.numel() for w in model.module.parameters())
    print(f"phase 11 Inception serving: {pcm.shape[0]} streams x {pcm.shape[1] / FC.SAMPLE_RATE:.0f} "
          f"s at {INCEPTION_STEP_MS} ms hops, {frames} steps of 1 frame, {n_params:,} "
          f"parameters; wall {wall:.3f} s; frontend launches "
          f"{launches}, counting kernel launches {accept_launches}; probs in [{float(p.min()):.4f}, {float(p.max()):.4f}]; streamed vs forward "
          f"max|d|={worst:.3e}; accepts at 0.5/0.8/0.9: {counts[50]:.0f}/{counts[80]:.0f}/"
          f"{counts[90]:.0f} over {hours * 3600:.1f} s ({smi})")
    print(f"phase 11 path: frontend {frontend_ms:.3f} ms + stream_scan {scan_ms:.3f} ms + accept "
          f"counts {accept_ms:.3f} ms; whole path {path_ms:.3f} ms for {audio_s:.0f} audio-s "
          f"(CUDA events; {path_ms / frames:.4f} ms per step); profile of the scan's first "
          f"{SERVING_PROFILED_STEPS} steps: wall {prof_wall:.3f} ms, device kernels "
          f"{prof_device:.3f} ms, busy share {prof_device / prof_wall:.4f}, "
          f"{prof_kernels / SERVING_PROFILED_STEPS:.1f} kernels per step ({smi})", flush=True)
    for key, ms, count in top:
        print(f"  {ms:9.3f} ms  x{count:<6d} {key}")
    return dict(launches=launches, path_ms=path_ms, scan_ms=scan_ms, frontend_ms=frontend_ms,
                max_abs=worst, accept_launches=accept_launches, accepts=acc)


def phase_inception_training(dev: torch.device, smi: str, seed: int, root: str,
                             spectrograms: str) -> dict:
    """Phase 12: Inception at full width through run() on phase 6's store and
    recipe at 20 ms hops (102 input frames); the training and validation
    splits are phase 6's (linked), the test splits are INCEPTION_TEST.  Checks
    the training as phase 6 does (loss, accuracies, artifacts, selection),
    then times the trained model's step (measure_step: the dropout draw runs
    under the sync check).  Returns {"bundle", "config", "out", "m"}."""
    inc_root = os.path.join(root, "inception")
    for name in STORE:
        os.makedirs(os.path.join(inc_root, name))
        for split in ("training", "validation", "validation_ambient"):
            if os.path.isdir(os.path.join(spectrograms, name, split)):
                os.symlink(os.path.join(spectrograms, name, split),
                           os.path.join(inc_root, name, split))
    write_store(inc_root, np.random.default_rng(seed + 50), INCEPTION_TEST)
    flags = CLI.build_parser().parse_args(
        ["--training_config", os.path.join(root, "unused.yaml"), "--test_tf_nonstreaming", "1",
         "--test_native_quantized", "1", "--device", dev.type, "inception"])
    config = derive_config(dict(recipe(inc_root, seed), window_step_ms=INCEPTION_STEP_MS),
                           CLI.model_config_from_flags(flags))
    length, batch = config["spectrogram_length"], config["batch_size"]
    check(length == 102, f"Inception input frames {length}")
    bundle = build_model("inception", config["model_config"])
    check(bundle.config.dropout == 0.2, f"dropout {bundle.config.dropout}")
    phase = {k: v for k, v in training.resolve_schedules(config)[0].items() if k != "steps"}

    torch.cuda.reset_peak_memory_stats()
    # deterministic cuDNN: one tree reads one last-batch accuracy (cuDNN's
    # run-to-run order moved it across the 0.9 check on unchanged code)
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        out = CLI.run(flags, config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = False
    peak = torch.cuda.max_memory_allocated()
    history, run_dir = out["history"], config["train_dir"]
    handler = FeatureHandler(config)
    packed = handler.pack_training(dev)
    init = bundle.init(torch.Generator().manual_seed(seed), device=dev)
    loss0 = float(training.make_train_step(
        bundle, init, packed, batch, length,
        generator=torch.Generator(device=dev).manual_seed(seed)).step(**phase)["loss"])
    del init
    for name in ("best_weights.pt", "metrics.jsonl", os.path.join("streaming", "streaming_roc.txt"),
                 os.path.join("native", "model.mww"), os.path.join("native", "model_quant.mww"),
                 os.path.join("native", "quantized_streaming_roc.txt")):
        check(os.path.exists(os.path.join(run_dir, name)), f"{name} was not written")
    print(f"phase 12 run(): Inception, {sum(p['steps'] for p in training.resolve_schedules(config))} "
          f"steps of batch {batch} x {length} frames under deterministic cuDNN, wall {wall:.2f} s "
          f"with evals, the streamed ROC, the export and the int8 file's ROC; peak memory "
          f"{peak / 2**20:.1f} MiB ({smi})")
    print_history("phase 12", history)
    last, auc = history[-1]["train"], out["streaming_roc"]["auc"]
    val_acc = history[-1]["validation"]["accuracy"]
    print(f"phase 12 streamed test ROC AUC {auc:.5f}; int8 .mww through the runtime "
          f"{out['native_quantized_roc']['auc']:.5f}; test accuracy "
          f"{out['accuracy']['accuracy']:.4f}; step-0 loss {loss0:.5f}", flush=True)
    check(last["loss"] < 0.5 * loss0, f"loss {last['loss']} did not fall below half of {loss0}")
    check(last["accuracy"] > 0.9, f"last train accuracy {last['accuracy']}")
    check(val_acc > 0.9, f"validation accuracy {val_acc} at the last eval")
    check(math.isfinite(auc), f"streamed AUC {auc}")
    check_selection(bundle, config, handler, out, dev, "phase 12")

    model = training.load_weights(bundle, os.path.join(run_dir, "best_weights.pt"), dev)
    train_step = training.make_train_step(
        bundle, model, packed, batch, length,
        generator=torch.Generator(device=dev).manual_seed(seed + 1))
    m = measure_step(train_step, phase)
    print(f"phase 12 step (Inception, batch {batch}, SpecAugment and dropout on, TF32 off): "
          f"{m['step_ms']:.4f} ms per step by CUDA events over {TIMED_STEPS} steps "
          f"({1e3 / m['step_ms']:.1f} steps/s; host clock {m['host_ms']:.4f} ms) ({smi})")
    print_profile("phase 12", m)
    print(f"phase 12 sync check: {SYNC_CHECKED_STEPS} steps under set_sync_debug_mode('error') "
          f"raised nothing", flush=True)
    return dict(bundle=bundle, config=config, out=out, m=m)


def phase_export(dev: torch.device, smi: str, runs: list) -> dict:
    """Phase 13: for each (label, bundle, config, run() result) the two
    ``.mww`` files run() wrote exist; the float file in the C++ runtime
    matches the port's stream_scan on the card (TF32 off) on the test ambient
    tracks to RUNTIME_RTOL / RUNTIME_ATOL, and the int8 file the float one to
    INT8_ENVELOPE; the streamed ROC AUC of the float and int8 files through
    the runtime beside the port's; the runtime's host CPU ms per
    audio-second.  Returns {label: numbers}."""
    results = {}
    for label, bundle, config, out in runs:
        paths = out["native"]
        check(paths is not None and paths["int8"] is not None, f"{label}: run() exported {paths}")
        check(all(os.path.exists(p) for p in paths.values()), f"{label}: .mww files {paths}")
        handler = FeatureHandler(config, dev)
        model = training.load_weights(bundle, os.path.join(config["train_dir"], "best_weights.pt"),
                                      dev)
        tracks, _, _ = handler.get_data("testing_ambient", config["batch_size"],
                                        config["spectrogram_length"], "none")
        runtime, runtime_int8 = StreamingRuntime(paths["float"]), StreamingRuntime(paths["int8"])
        t = min(len(track) for track in tracks) // bundle.stride * bundle.stride
        x = np.stack([track[:t] for track in tracks]).astype(np.float32)  # one batched scan
        want = bundle.stream_scan(model, torch.from_numpy(x).to(dev))[..., 0].cpu().numpy()
        worst, worst_int8, host_s = 0.0, 0.0, 0.0
        for track, scanned in zip(x, want):
            runtime.reset()
            t0 = time.perf_counter()
            got = runtime.predict_spectrogram(track)
            host_s += time.perf_counter() - t0
            check(got.shape == scanned.shape, f"{label}: runtime {got.shape} vs scan {scanned.shape}")
            d = np.abs(got.astype(np.float64) - scanned)
            worst = max(worst, float(d.max()))
            check(bool(np.allclose(got, scanned, rtol=RUNTIME_RTOL, atol=RUNTIME_ATOL)),
                  f"{label}: runtime vs stream_scan max|d| {float(d.max())}")
            runtime_int8.reset()
            worst_int8 = max(worst_int8, float(np.abs(runtime_int8.predict_spectrogram(track)
                                                      - got).max()))
        frames = x.shape[0] * t
        check(worst_int8 < INT8_ENVELOPE, f"{label}: int8 vs float file max|d| {worst_int8}")
        audio_s = frames * config["window_step_ms"] / 1000
        native_dir = os.path.dirname(paths["float"])
        rocs = {kind: CLI.native_streaming_roc(bundle, model, handler, config, path, native_dir,
                                               f"{kind}_runtime_streaming_roc.txt")["auc"]
                for kind, path in (("float", paths["float"]), ("int8", paths["int8"]))}
        if out.get("native_quantized_roc") is not None:
            check(rocs["int8"] == out["native_quantized_roc"]["auc"],
                  f"{label}: int8 ROC {rocs['int8']} vs run()'s {out['native_quantized_roc']['auc']}")
        sizes = {kind: os.path.getsize(path) for kind, path in paths.items()}
        print(f"phase 13 {label}: float .mww {sizes['float']:,} B, int8 {sizes['int8']:,} B; runtime "
              f"vs stream_scan on the card over {len(tracks)} test ambient tracks ({frames} frames): "
              f"max|d| {worst:.3e} (rtol {RUNTIME_RTOL}, atol {RUNTIME_ATOL}); int8 vs float file "
              f"in the runtime max|d| {worst_int8:.4f}; streamed ROC AUC: "
              f"port {out['streaming_roc']['auc']:.5f}, float .mww {rocs['float']:.5f}, int8 .mww "
              f"{rocs['int8']:.5f}; runtime host CPU time {host_s * 1e3 / audio_s:.4f} ms per "
              f"audio-second ({audio_s:.0f} audio-s; host clock, not the card) ({smi})", flush=True)
        results[label] = dict(max_abs=worst, int8_max_abs=worst_int8,
                              auc_port=out["streaming_roc"]["auc"],
                              auc_float=rocs["float"], auc_int8=rocs["int8"],
                              host_ms_per_audio_s=host_s * 1e3 / audio_s, **sizes)
    return results


def events_ms(fn, steps: int, warmup: int = 5) -> tuple[float, float]:
    """ms per call of ``fn`` by CUDA events over ``steps`` calls after
    ``warmup``, and by the host clock."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / steps, (time.perf_counter() - t0) * 1e3 / steps


def make_population(bundle, packed, members: int, share: bool, dev: torch.device, seed: int):
    """A population step of ``members`` of the seed's consecutive seeds on
    ``packed`` and its [N] hyperparameters (lr 0.001, class weights 1/20)."""
    seeds = [seed + i for i in range(members)]
    gens = [torch.Generator(device=dev).manual_seed(population.member_seed(1234, s)) for s in seeds]
    pop = population.make_population_train_step(
        bundle, packed, 128, bundle.spectrogram_length,
        population.init_population(bundle, seeds, dev), gens, share_batch=share)
    hyper = tuple(torch.full((members,), v, device=dev) for v in (0.001, 1.0, 20.0))
    return pop, hyper


def population_parity(bundle, packed, members: int, which: int, steps: int, sa: dict,
                      dev: torch.device, dtype) -> float:
    """``steps`` private-batch steps of a population of ``members`` (seeds
    0.., learning rates 0.001 / 0.0005 in turn, class weights 1/20) in
    ``dtype``, and of a population of one with member ``which``'s seed: the
    max |d| of that member's parameters and statistics."""
    lrs = [0.001, 0.0005] * (members // 2)

    def run(seeds, rates):
        gens = [torch.Generator(device=dev).manual_seed(population.member_seed(1234, s))
                for s in seeds]
        stacked = {k: v.to(dtype) for k, v in population.init_population(bundle, seeds, dev).items()}
        pop = population.make_population_train_step(bundle, packed, 128, bundle.spectrogram_length,
                                                    stacked, gens)
        hyper = (torch.tensor(rates, device=dev), torch.ones(len(seeds), device=dev),
                 torch.full((len(seeds),), 20.0, device=dev))
        for _ in range(steps):
            pop.step(*hyper, **sa)
        return pop.state()

    many, one = run(list(range(members)), lrs), run([which], [lrs[which]])
    return max(float((many[k][which] - one[k][0]).abs().max()) for k in one)


def phase_population(dev: torch.device, smi: str, seed: int, root: str, spectrograms: str) -> dict:
    """Phase 14: the sweep CLI's run() at the flagship's full width on phase
    6's store (SWEEP_MEMBERS members, seeds 0-7, learning rates SWEEP_LRS,
    share_batch, phase 6's recipe and 300 steps, eval every 100): checks the
    leaderboard, the members' weights, that they differ and that member 0's
    loss falls below half its step-0 value; a private-batch population on
    the card against a population of one (float64 held, float32 printed, as
    phase 7 holds the step; TF32 off); member-steps per second
    of the solo step and the POP_TIMED populations by CUDA events, kernels
    and the busy share under the profiler, the sync check and the peak
    memory; Inception's share_batch population with dropout."""
    flags = sweep.build_parser().parse_args(
        ["--training_config", os.path.join(root, "unused.yaml"), "--n_models", str(SWEEP_MEMBERS),
         "--seeds", ",".join(str(seed + i) for i in range(SWEEP_MEMBERS)), "--learning_rates",
         SWEEP_LRS, "--share_batch", "1", "--device", dev.type] + FLAGSHIP_FLAGS)
    config = derive_config(dict(recipe(spectrograms, seed), train_dir=os.path.join(root, "sweep")),
                           CLI.model_config_from_flags(flags))
    length, batch = config["spectrogram_length"], config["batch_size"]
    bundle = build_model("mixednet", config["model_config"])
    phase = {k: v for k, v in training.resolve_schedules(config)[0].items() if k != "steps"}
    t0 = time.perf_counter()
    out = sweep.run(flags, config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run_dir, history = config["train_dir"], out["history"]
    with open(os.path.join(run_dir, "leaderboard.json")) as f:
        leaderboard = json.load(f)
    check(len(leaderboard) == SWEEP_MEMBERS, f"{len(leaderboard)} leaderboard rows")
    handler = FeatureHandler(config)
    val_x, _, _ = handler.get_data("validation", batch_size=batch, features_length=length,
                                   truncation_strategy="truncate_start")
    eval_probs = training.make_eval_fn(bundle)
    for i in range(SWEEP_MEMBERS):
        model = training.load_weights(
            bundle, os.path.join(run_dir, f"member_{i:02d}", "best_weights.pt"), dev)
        probs = eval_probs(model, val_x[:256])
        check(probs.shape == (len(val_x[:256]),) and bool(np.isfinite(probs).all()),
              f"member {i} probabilities")
    final = out["variables"]
    spread = min(float((final[k][i] - final[k][i + 1]).abs().max()) for k in final
                 for i in range(SWEEP_MEMBERS - 1) if k.endswith("weight"))
    check(spread > 1e-4, f"members' final weights differ by {spread}")
    first = training.make_train_step(
        bundle, bundle.init(torch.Generator().manual_seed(seed), device=dev),
        handler.pack_training(dev), batch, length,
        generator=torch.Generator(device=dev).manual_seed(population.member_seed(1234, seed)))
    loss0 = float(first.step(**phase)["loss"])
    packed = first.packed
    del first
    print(f"phase 14 sweep.run(): {SWEEP_MEMBERS} members x {out['sweep']['steps']} steps of batch "
          f"{batch} x {length} frames (share_batch), wall {wall:.2f} s with {len(history)} "
          f"evals of every member ({smi})")
    for rec in history:
        print(f"  step {rec['step']}: loss {np.array2string(rec['loss'], precision=4)} accuracy "
              f"{np.array2string(rec['accuracy'], precision=3)}")
    for row in leaderboard[:3]:
        print(f"  leaderboard: member {row['member']} seed {row['seed']} lr "
              f"{row['learning_rate']:.4g} best step {row['best_step']} faph "
              f"{row['minimization']:.3f} avr {row['maximization']:.4f}")
    last0 = float(history[-1]["loss"][0])
    print(f"phase 14 member 0 loss {last0:.5f} at step {history[-1]['step']}, step-0 loss "
          f"{loss0:.5f}; least max|d| between consecutive members' weights {spread:.3e}", flush=True)
    check(last0 < 0.5 * loss0, f"member 0 loss {last0} did not fall below half of {loss0}")

    # the card: a private-batch member against a population of one, in
    # float64 (held to POP_ATOL) and in float32 (printed)
    members, which, steps = POP_PARITY
    sa = {k: phase[k] for k in ("time_mask_max_size", "time_mask_count", "freq_mask_max_size",
                                "freq_mask_count")}
    err = {dtype: population_parity(bundle, packed, members, which, steps, sa, dev, dtype)
           for dtype in (torch.float64, torch.float32)}
    print(f"phase 14 private batches: member {which} of {members} against a population of one "
          f"with its seed after {steps} steps, parameters and statistics max|d| float64 "
          f"{err[torch.float64]:.3e} (tolerance {POP_ATOL}), float32 {err[torch.float32]:.3e} "
          f"(context; TF32 off)", flush=True)
    check(err[torch.float64] <= POP_ATOL,
          f"member {which} against a population of one: {err[torch.float64]}")

    # member-steps per second: the solo step, then the populations
    rates = {}
    solo = training.make_train_step(bundle, bundle.init(torch.Generator().manual_seed(seed), dev),
                                    packed, batch, length,
                                    generator=torch.Generator(device=dev).manual_seed(seed))
    ms, host = events_ms(lambda: solo.step(**phase), POP_TIMED_STEPS)
    rates["solo"] = dict(ms=ms, host_ms=host, member_steps_per_s=1e3 / ms)
    _, device_ms, _, launches, _ = device_profile(
        lambda: [solo.step(**phase) for _ in range(PROFILED_STEPS)])
    rates["solo"].update(kernels=launches / PROFILED_STEPS)
    del solo
    peak = 0
    for share, n in POP_TIMED:
        label = f"{'share' if share else 'private'} {n}"
        pop, hyper = make_population(bundle, packed, n, share, dev, seed)
        torch.cuda.reset_peak_memory_stats()
        ms, host = events_ms(lambda: pop.step(*hyper, **sa), POP_TIMED_STEPS)
        peak = max(peak, torch.cuda.max_memory_allocated())
        wall_ms, device_ms, top, launches, _ = device_profile(
            lambda: [pop.step(*hyper, **sa) for _ in range(PROFILED_STEPS)])
        rates[label] = dict(ms=ms, host_ms=host, member_steps_per_s=n * 1e3 / ms,
                            kernels=launches / PROFILED_STEPS, device_ms=device_ms / PROFILED_STEPS,
                            busy=device_ms / wall_ms if wall_ms else 0.0, top=top)
        if n == 8:
            torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(SYNC_CHECKED_STEPS):
                    metrics = pop.step(*hyper, **sa)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            check(bool(torch.isfinite(metrics["loss"]).all()), f"{label}: loss after the sync check")
        del pop
    for label, r in rates.items():
        extra = "" if label == "solo" else (
            f", device {r['device_ms']:.4f} ms per step, busy share {r['busy']:.4f}")
        print(f"phase 14 {label}: {r['ms']:.4f} ms per step by CUDA events over {POP_TIMED_STEPS} "
              f"steps (host clock {r['host_ms']:.4f}), {r['member_steps_per_s']:.1f} member-steps/s "
              f"({r['member_steps_per_s'] / rates['solo']['member_steps_per_s']:.2f}x the solo "
              f"step), {r['kernels']:.1f} kernels per step{extra} ({smi})")
        for key, ms_k, count in r.get("top", [])[:3]:
            print(f"  {ms_k:9.3f} ms  x{count:<6d} {key}")
    print(f"phase 14 sync check: {SYNC_CHECKED_STEPS} steps of each 8-member population under "
          f"set_sync_debug_mode('error') raised nothing; peak memory of the timed populations "
          f"{peak / 2**20:.1f} MiB", flush=True)

    # Inception: a share_batch population with dropout
    members, steps = INCEPTION_POP
    inception = build_model("inception", presets.default_inception_config())
    check(inception.config.dropout == 0.2, f"dropout {inception.config.dropout}")
    pop, hyper = make_population(inception, packed, members, True, dev, seed)
    last = {}

    def inception_step():
        last["metrics"] = pop.step(*hyper, **sa)

    ms, _ = events_ms(inception_step, steps - 1, warmup=1)
    losses = last["metrics"]["loss"]
    state = pop.state()
    diff = min(float((state[k][i] - state[k][i + 1]).abs().max()) for k in state
               for i in range(members - 1) if k.endswith("weight"))
    _, _, _, launches, _ = device_profile(inception_step)
    print(f"phase 14 Inception share_batch population of {members}, dropout "
          f"{inception.config.dropout}: {steps} steps, {ms:.4f} ms per step by CUDA events after "
          f"the first ({members * 1e3 / ms:.1f} member-steps/s), {launches} kernels per step, "
          f"losses {np.array2string(losses.cpu().numpy(), precision=4)}, least max|d| between "
          f"members {diff:.3e} ({smi})", flush=True)
    check(bool(torch.isfinite(losses).all()), "Inception population losses")
    check(diff > 1e-4, f"Inception members differ by {diff}")
    return dict(rates=rates, wall=wall, parity=err, peak=peak)


def phase_host_stream(dev: torch.device, smi: str, seed: int, root: str, spectrograms: str) -> dict:
    """Phase 15: host streaming at full width on phase 6's store:
    ``train()`` with ``corpus_residency: host`` (HOST_STEPS, eval every 100;
    the loss and train accuracy checked as phase 6 does; validation accuracy
    printed, since eval-mode BatchNorm needs 300 steps, phase 6); the same
    draws through the host producer and the resident gather on the card,
    bit for bit; the host-mode step timed beside the resident one; 10 host
    steps under the sync check; ``auto`` over the env budget picks host."""
    flags = CLI.build_parser().parse_args(
        ["--training_config", os.path.join(root, "unused.yaml"), "--device", dev.type]
        + FLAGSHIP_FLAGS)
    config = derive_config(dict(recipe(spectrograms, seed), train_dir=os.path.join(root, "host"),
                                training_steps=HOST_STEPS, learning_rates=[0.001],
                                corpus_residency="host"), CLI.model_config_from_flags(flags))
    length, batch = config["spectrogram_length"], config["batch_size"]
    bundle = build_model("mixednet", config["model_config"])
    phase = {k: v for k, v in training.resolve_schedules(config)[0].items() if k != "steps"}
    handler = FeatureHandler(config)
    t0 = time.perf_counter()
    _, history = training.train(bundle, config, handler, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    arrays = sampler.pack_training_arrays(handler.providers, device=dev)
    data = host_stream.HostStreamedData(arrays)

    def host_step(seed_offset: int = 0):
        """A TrainStep from the seed's weights and a producer as train()
        makes them."""
        step = training.make_train_step(
            bundle, bundle.init(torch.Generator().manual_seed(seed), device=dev), None, batch,
            length, generator=torch.Generator(device=dev).manual_seed(seed))
        producer = host_stream.HostBatchProducer(data, batch, length, 1, dev,
                                                 torch.Generator().manual_seed(seed + seed_offset))
        return step, producer

    step, producer = host_step()
    loss0 = float(step.step_on_batch(*producer(), **phase)["loss"])
    print(f"phase 15 train() with corpus_residency: host, {sum(HOST_STEPS)} steps of batch {batch} x "
          f"{length} frames, wall {wall:.2f} s with evals; corpus {data.nbytes / 1e6:.1f} MB in host "
          f"RAM ({smi})")
    for rec in history:
        v = rec["validation"]
        print(f"  step {rec['step']}: train loss {rec['train']['loss']:.5f} accuracy "
              f"{rec['train']['accuracy']:.4f}; validation accuracy {v['accuracy']:.4f}; "
              f"{rec['steps_per_sec']:.1f} steps/s (host clock, to the eval's sync)")
    last = history[-1]["train"]
    print(f"phase 15 step-0 loss {loss0:.5f}", flush=True)
    check(last["loss"] < 0.5 * loss0, f"loss {last['loss']} did not fall below half of {loss0}")
    check(last["accuracy"] > 0.9, f"last train accuracy {last['accuracy']}")

    # the same draws: the host producer against the resident gather on the card
    resident = sampler.upload_training_arrays(arrays, dev)
    draws = torch.Generator().manual_seed(seed + 7)
    producer = host_stream.HostBatchProducer(data, batch, length, 1, dev,
                                             torch.Generator().manual_seed(seed + 7))
    for _ in range(3):
        got = producer()
        u = sampler.window_uniforms(data.meta, draws, batch).to(dev)
        off, n, start, labels, weights = sampler.windows_from_uniforms(resident, u, length)
        windows, valid = sampler.gather_windows(resident.frames, off, n, start, length)
        for name, g, w in zip(("windows", "valid", "labels", "weights"), got,
                              (windows, valid, labels, weights)):
            check(g.device == w.device and torch.equal(g, w), f"host {name} against resident")
    print("phase 15 the same draws: host producer and resident gather bit-equal on the card "
          "(3 batches: windows, valid, labels, weights)", flush=True)

    # the host-mode step beside the resident one
    resident_step = training.make_train_step(
        bundle, bundle.init(torch.Generator().manual_seed(seed), device=dev), resident, batch,
        length, generator=torch.Generator(device=dev).manual_seed(seed))
    step, producer = host_step()
    times = {"resident": events_ms(lambda: resident_step.step(**phase), TIMED_STEPS),
             "host": events_ms(lambda: step.step_on_batch(*producer(), **phase), TIMED_STEPS)}
    draw_ms = events_ms(lambda: producer(), TIMED_STEPS)[1]
    for label, (ms, host_ms) in times.items():
        print(f"phase 15 {label} step: {ms:.4f} ms per step by CUDA events over {TIMED_STEPS} steps "
              f"(host clock {host_ms:.4f} ms) ({smi})")
    print(f"phase 15 the producer alone (draw, gather, copy): {draw_ms:.4f} host ms per batch; "
          f"waits on a buffer's copy so far {producer.waits}", flush=True)
    waits = producer.waits
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(SYNC_CHECKED_STEPS):
            metrics = step.step_on_batch(*producer(), **phase)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(math.isfinite(float(metrics["loss"])), "loss after the sync check")
    print(f"phase 15 sync check: {SYNC_CHECKED_STEPS} host-mode steps under "
          f"set_sync_debug_mode('error') raised nothing; {producer.waits - waits} waits on a "
          f"pinned buffer's copy event", flush=True)

    # auto over the budget picks host
    nbytes = host_stream.corpus_nbytes(arrays)
    auto = dict(config, corpus_residency="auto", training_steps=[2],
                train_dir=os.path.join(root, "host_auto"))
    os.environ["MWW_CORPUS_HBM_BUDGET"] = str(nbytes - 1)
    captured = io.StringIO()
    try:
        with contextlib.redirect_stdout(captured):
            training.train(bundle, auto, FeatureHandler(auto), device=dev)
    finally:
        del os.environ["MWW_CORPUS_HBM_BUDGET"]
    notice = [ln for ln in captured.getvalue().splitlines() if "streaming it from host RAM" in ln]
    check(len(notice) == 1, "corpus_residency: auto over the budget printed no notice")
    print(f"phase 15 auto with MWW_CORPUS_HBM_BUDGET={nbytes - 1} (corpus {nbytes} B): "
          f"{notice[0]}", flush=True)
    return dict(wall=wall, times=times, draw_ms=draw_ms)


def phase_exported(dev: torch.device, smi: str, runs: list, pcm_np: np.ndarray) -> dict:
    """Phase 16: for each (label, bundle, config, run() result, hop ms) the
    ``torch_export/model.mwwt`` that run() wrote (``--export_stablehlo``
    defaults to 1), loaded on the card (TF32 off): ``forward`` at batches 1
    and 7 against ``bundle.forward`` to EXPORTED_ATOL; ``stream_step`` over
    the first EXPORTED_STEPS steps of a test ambient track against
    ``stream_scan`` to STREAM_ATOL; ``Model.from_exported(...).predict_clip``
    on one 10 s stream (the frontend kernel's launch count set to 0 before
    and read after: exactly 3) against ``Model.from_torch``'s; ms per
    exported ``stream_step`` beside the eager step by CUDA events, and
    kernels per step under the profiler.  Returns {label: numbers}."""
    results = {}
    for label, bundle, config, out, step_ms in runs:
        path = out["exported"]
        check(path is not None and os.path.exists(path), f"{label}: run() exported {path}")
        model = training.load_weights(bundle, os.path.join(config["train_dir"], "best_weights.pt"),
                                      dev)
        t0 = time.perf_counter()
        exported = ExportedModel(path, dev)
        load_s = time.perf_counter() - t0
        rng = np.random.default_rng(7)
        fwd_err = 0.0
        with torch.no_grad():
            for b in (1, 7):
                x = torch.from_numpy(rng.uniform(0, 26, (b, bundle.spectrogram_length, 40))
                                     .astype(np.float32)).to(dev)
                got = exported.forward(x)
                check(got.shape == (b, 1), f"{label}: exported forward {tuple(got.shape)}")
                fwd_err = max(fwd_err, float((got - bundle.forward(model, x)).abs().max()))
        check(fwd_err <= EXPORTED_ATOL, f"{label}: exported forward max|d| {fwd_err}")

        tracks, _, _ = FeatureHandler(config, dev).get_data(
            "testing_ambient", config["batch_size"], config["spectrogram_length"], "none")
        track = max(tracks, key=len)
        steps = min(EXPORTED_STEPS, len(track) // bundle.stride)
        x = torch.from_numpy(np.asarray(track[: steps * bundle.stride], np.float32))[None].to(dev)
        with torch.no_grad():
            want = bundle.stream_scan(model, x).reshape(-1)
            cache, got = exported.stream_init(), []
            for i in range(steps):
                p, cache = exported.stream_step(cache, x[:, i * bundle.stride : (i + 1) * bundle.stride])
                got.append(p[0, 0])
            step_err = float((torch.stack(got) - want).abs().max())
        check(step_err <= STREAM_ATOL, f"{label}: exported stream_step vs stream_scan {step_err}")

        clip = pcm_np[0]
        kernel.frontend_batch.launches = 0
        probs = Model.from_exported(path, dev).predict_clip(clip, step_ms)
        launches = kernel.frontend_batch.launches
        check(launches == kernel.LAUNCHES_PER_CALL,
              f"{label}: from_exported predict_clip launched the frontend kernel {launches} times")
        ref = Model.from_torch(bundle, model.state_dict(), dev).predict_clip(clip, step_ms)
        clip_err = float(np.abs(probs - ref).max())
        check(probs.shape == ref.shape and len(probs) > 0 and clip_err <= CLIP_ATOL,
              f"{label}: from_exported vs from_torch predict_clip max|d| {clip_err}")

        frames = x[:, : bundle.stride]
        loops = {"exported": exported.stream_step,
                 "eager": lambda c, f: bundle.stream_step(model, c, f)}
        times, kernels = {}, {}
        with torch.no_grad():
            for kind, step in loops.items():
                state = {"cache": exported.stream_init()}

                def one(step=step, state=state):
                    _, state["cache"] = step(state["cache"], frames)

                times[kind] = events_ms(one, EXPORTED_TIMED_STEPS)
                prof = device_profile(lambda one=one: [one() for _ in range(EXPORTED_PROFILED_STEPS)])
                kernels[kind] = (prof[3] / EXPORTED_PROFILED_STEPS, prof[1] / EXPORTED_PROFILED_STEPS,
                                 prof[1] / prof[0] if prof[0] else 0.0)
        print(f"phase 16 {label}: model.mwwt {os.path.getsize(path):,} B loaded on the card in "
              f"{load_s:.2f} s; forward at batches 1 and 7 vs the module max|d| {fwd_err:.3e} "
              f"(atol {EXPORTED_ATOL}); {steps} exported stream_steps of a test ambient track vs "
              f"stream_scan max|d| {step_err:.3e} (atol {STREAM_ATOL}); Model.from_exported "
              f"predict_clip on one {len(clip) / FC.SAMPLE_RATE:.0f} s stream at {step_ms} ms: "
              f"{len(probs)} steps, frontend launches {launches}, vs from_torch max|d| "
              f"{clip_err:.3e} ({smi})", flush=True)
        for kind in loops:
            ms, host_ms = times[kind]
            n, dev_ms, busy = kernels[kind]
            print(f"phase 16 {label} {kind} stream_step: {ms:.4f} ms per step by CUDA events over "
                  f"{EXPORTED_TIMED_STEPS} steps (host clock {host_ms:.4f} ms); {n:.1f} kernels "
                  f"and {dev_ms:.4f} device ms per step, busy share {busy:.4f} under the profiler "
                  f"({EXPORTED_PROFILED_STEPS} steps) ({smi})", flush=True)
        results[label] = dict(forward_max_abs=fwd_err, step_max_abs=step_err, clip_max_abs=clip_err,
                              launches=launches, step_ms={k: v[0] for k, v in times.items()},
                              kernels_per_step={k: v[0] for k, v in kernels.items()})
    return results


def phase_native_io(smi: str, native_build: dict, wav_root: str, seed: int) -> dict:
    """Phase 17: the host I/O library (native/src/mww_native.cc, built by
    g++ in phase 2): phase 8's WAVs decoded natively against scipy (16 kHz
    int16: exact); a RESAMPLE_S s RESAMPLE_RATE Hz signal resampled to 16 kHz
    natively against scipy.signal.resample_poly (RESAMPLE_ATOL); the VAD
    against its NumPy version on phase 8's positives (VAD_ATOL, equal
    lengths); host ms per audio-second of decode and of resampling, native
    and scipy (the host's clock, not the card).  TFLite is not driven here:
    the card's machine has no TensorFlow; tests/test_torch_tflite.py and
    tests/test_torch_cli.py hold the TFLite export on the CPU."""
    paths = sorted(glob.glob(os.path.join(wav_root, "*", "*.wav")))
    decode = {"native": 0.0, "scipy": 0.0}
    decode_err, audio_s = 0.0, 0.0
    for path in paths:
        t0 = time.perf_counter()
        got = audio_io.load_audio(path)
        decode["native"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        want = audio_io.load_audio_plain(path)
        decode["scipy"] += time.perf_counter() - t0
        check(got.shape == want.shape, f"{path}: native {got.shape} vs scipy {want.shape}")
        decode_err = max(decode_err, float(np.abs(got - want).max()))
        audio_s += len(got) / FC.SAMPLE_RATE
    check(decode_err == 0.0, f"native WAV decode vs scipy max|d| {decode_err}")

    rng = np.random.default_rng(seed + 200)
    t = np.arange(RESAMPLE_S * RESAMPLE_RATE) / RESAMPLE_RATE
    signal = (0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * rng.standard_normal(len(t))).astype(
        np.float32)
    g = math.gcd(FC.SAMPLE_RATE, RESAMPLE_RATE)
    up, down = FC.SAMPLE_RATE // g, RESAMPLE_RATE // g
    resample = {}
    t0 = time.perf_counter()
    got = native.resample_poly(signal, up, down)
    resample["native"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = resample_poly(signal, up, down).astype(np.float32)
    resample["scipy"] = time.perf_counter() - t0
    check(got.shape == want.shape, f"resample {got.shape} vs scipy {want.shape}")
    resample_err = float(np.abs(got - want).max())
    check(resample_err <= RESAMPLE_ATOL, f"native resample vs scipy max|d| {resample_err}")

    vad_err, kept, total = 0.0, 0, 0
    for path in paths[:50]:
        audio = audio_io.load_audio(path)
        got, want = vad.remove_silence(audio), vad.remove_silence_plain(audio)
        check(got.shape == want.shape, f"{path}: VAD kept {got.shape} vs NumPy {want.shape}")
        if len(got):
            vad_err = max(vad_err, float(np.abs(got - want).max()))
        kept, total = kept + len(got), total + len(audio)
    check(vad_err <= VAD_ATOL, f"native VAD vs NumPy max|d| {vad_err}")
    print(f"phase 17 g++ build of native/src/mww_native.cc: {native_build['path'].name} in "
          f"{native_build['s']:.2f} s (host, beside nvcc in phase 2)")
    print(f"phase 17 decode of {len(paths)} WAVs ({audio_s:.1f} audio-s) native vs scipy max|d| "
          f"{decode_err}; host ms per audio-second: native {decode['native'] * 1e3 / audio_s:.4f}, "
          f"scipy {decode['scipy'] * 1e3 / audio_s:.4f}; resample {RESAMPLE_S} s at "
          f"{RESAMPLE_RATE} Hz to 16 kHz ({up}/{down}) native vs scipy max|d| {resample_err:.3e} "
          f"(atol {RESAMPLE_ATOL}); host ms per audio-second: native "
          f"{resample['native'] * 1e3 / RESAMPLE_S:.4f}, scipy "
          f"{resample['scipy'] * 1e3 / RESAMPLE_S:.4f}; VAD on {min(len(paths), 50)} clips vs "
          f"NumPy max|d| {vad_err:.3e} (atol {VAD_ATOL}), kept {kept} of {total} samples "
          f"(host clock, not the card) ({smi})")
    print("phase 17 TFLite is not driven on the card: its machine has no TensorFlow; "
          "tests/test_torch_tflite.py and tests/test_torch_cli.py hold the TFLite export and "
          "the ESPHome manifest on the CPU", flush=True)
    return dict(decode_ms_per_audio_s={k: v * 1e3 / audio_s for k, v in decode.items()},
                resample_ms_per_audio_s={k: v * 1e3 / RESAMPLE_S for k, v in resample.items()},
                build_s=native_build["s"], resample_max_abs=resample_err, vad_max_abs=vad_err)


def dp_run(bundle, packed, phase: dict, dev, seed: int, mesh, dtype=torch.float32,
           per_rank_stats: bool = False) -> tuple:
    """DP_STEPS steps from the seed's weights and generator, batch 128: the
    solo step (``mesh`` None) or this rank's data-parallel step, with
    ``per_rank_stats`` its BatchNorms normalising by this rank's rows alone
    (the control of phase 18(b)).  Returns (losses, state in float64 on the
    CPU, the step)."""
    model = bundle.init(torch.Generator().manual_seed(seed), device=dev).to(dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    length = bundle.spectrogram_length
    step = (training.make_train_step(bundle, model, packed, 128, length, generator=gen)
            if mesh is None else
            make_sharded_train_step(bundle, model, packed, 128, length, mesh, generator=gen))
    if per_rank_stats:
        for bn in step.batch_norms:
            bn.stats_reduce = None
    losses = [float(step.step(**phase)["loss"]) for _ in range(DP_STEPS)]
    state = {k: v.detach().to("cpu", torch.float64, copy=True)
             for k, v in model.state_dict().items()}
    return losses, state, step


def packed_to(obj, device):
    """A packed corpus (a sampler dataclass, its parts included) with every
    tensor moved to ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: packed_to(getattr(obj, f.name), device)
                                           for f in dataclasses.fields(obj)})
    return obj


def max_diff(a: dict, b: dict, stats: bool) -> float:
    """max |a - b| over the parameters (``stats`` False) or the BatchNorm
    statistics."""
    return max(float((a[k] - b[k]).abs().max()) for k in a
               if k.endswith((".mean", ".var")) == stats)


def clip_digests(arrays: dict) -> list:
    """sha1 of each real clip's frames in a pack (padding clips excluded)."""
    frames = np.asarray(arrays["frames"])
    real = int(np.sum(np.asarray(arrays["provider_clip_count"])[
        np.asarray(arrays["provider_logits"]) > -1e29]))
    return [hashlib.sha1(frames[o : o + n].tobytes()).hexdigest()
            for o, n in zip(np.asarray(arrays["clip_offset"])[:real],
                            np.asarray(arrays["clip_length"])[:real])]


# phase 18(b)'s runs on each rank: (dtype, BatchNorm statistics per rank)
DP_GLOO_RUNS = ((torch.float64, False), (torch.float32, False), (torch.float32, True))


def dp_gloo_rank(spectrograms: str, seed: int, device: str) -> dict:
    """Phase 18(b) on one of two ranks sharing the card ``device`` over
    gloo: the replicated data-parallel runs of DP_GLOO_RUNS, the float32
    step's time, then this rank's clips of a sharded corpus."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    mesh = dp_mesh.create_mesh(2, device)
    config = recipe(spectrograms, seed)
    phase = {k: v for k, v in training.resolve_schedules(config)[0].items() if k != "steps"}
    bundle = build_model("mixednet", presets.flagship_config())
    handler = FeatureHandler(config, mesh.device)
    packed, sharded = dp_corpus.pack_for_mesh(
        handler.providers, dict(config, corpus_sharding="replicate"), mesh)
    out = {"backend": mesh.backend, "sharded": sharded}
    for dtype, per_rank in DP_GLOO_RUNS:
        losses, state, step = dp_run(bundle, packed, phase, mesh.device, seed, mesh, dtype,
                                     per_rank)
        out[(str(dtype), per_rank)] = (losses, state)
        if dtype == torch.float32 and not per_rank:
            before = mesh.collectives
            out["step_ms"], out["host_ms"] = events_ms(lambda: step.step(**phase), DP_TIMED_STEPS)
            out["collectives_per_step"] = (mesh.collectives - before) / (DP_TIMED_STEPS + 5)
    del packed, step
    shard = dp_corpus.pack_shard(handler.providers, mesh)
    out["clips"] = clip_digests({k: v.cpu().numpy() for k, v in vars(shard).items()
                                 if isinstance(v, torch.Tensor)})
    return out


def dp_gaps(ranks: list, solo: dict, key) -> tuple[float, float, float]:
    """The largest gap over the ranks between run ``key`` and the solo run:
    (loss max rel, parameters max|d|, statistics max|d|)."""
    losses, state = solo
    gaps = []
    for r in ranks:
        got_losses, got = r[key]
        gaps.append((max(abs(a - b) / abs(b) for a, b in zip(got_losses, losses)),
                     max_diff(got, state, False), max_diff(got, state, True)))
    return tuple(max(g[i] for g in gaps) for i in range(3))


def phase_dp_world1(dev: torch.device, smi: str, seed: int, raw: dict) -> dict:
    """Phase 18(a) and its times: NCCL world 1 on phase 9's raw-audio
    pools, which wait in host memory between the phases."""
    config = raw["config"]
    bundle = build_model("mixednet", config["model_config"])
    phase = {k: v for k, v in training.resolve_schedules(config)[0].items() if k != "steps"}
    packed = packed_to(raw["packed"], dev)
    torch.backends.cudnn.deterministic = True
    mesh = dp_mesh.init_mesh(1, 0, dev, init_method=f"tcp://localhost:{dp_mesh.free_port()}")
    try:
        check(mesh.backend == "nccl", f"world-1 backend {mesh.backend}")
        solo_losses, solo, solo_step = dp_run(bundle, packed, phase, dev, seed, None)
        kernel.frontend_batch.launches = 0
        dp_losses, dp, dp_step = dp_run(bundle, packed, phase, dev, seed, mesh)
        launches = kernel.frontend_batch.launches
        torch.backends.cudnn.deterministic = False
        d_loss = max(abs(a - b) for a, b in zip(dp_losses, solo_losses))
        d_param, d_stats = max_diff(dp, solo, False), max_diff(dp, solo, True)
        check(launches == kernel.LAUNCHES_PER_CALL * DP_STEPS,
              f"the world-1 run launched the frontend kernel {launches} times in {DP_STEPS} steps")
        check(max(d_loss, d_param, d_stats) <= DP_WORLD1_ATOL,
              f"NCCL world 1 against solo: loss {d_loss}, parameters {d_param}, "
              f"statistics {d_stats} > {DP_WORLD1_ATOL}")
        print(f"phase 18(a) NCCL world 1, raw audio, flagship batch 128, {DP_STEPS} steps "
              f"against the solo step (TF32 off, deterministic cuDNN): max|d| loss {d_loss:.3e}, "
              f"parameters {d_param:.3e}, BatchNorm statistics {d_stats:.3e}; frontend launches "
              f"{launches} ({launches / DP_STEPS:.1f} per step)", flush=True)
        # in turns: solo, world 1, world 1, solo
        times = [events_ms(lambda s=s: s.step(**phase), DP_TIMED_STEPS)[0]
                 for s in (solo_step, dp_step, dp_step, solo_step)]
        before = mesh.collectives
        dp_step.step(**phase)
        collectives = mesh.collectives - before
        kernels = {}
        for name, s in (("solo", solo_step), ("world 1", dp_step)):
            kernels[name] = device_profile(lambda s=s: [s.step(**phase) for _ in range(10)])[3] / 10
        n_bn = len(dp_step.batch_norms)
    finally:
        torch.backends.cudnn.deterministic = False
        torch.distributed.destroy_process_group()
    raw_solo_ms, world1_ms = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
    print(f"phase 18(a) time: NCCL world-1 raw-audio step {world1_ms:.4f} ms against the solo step "
          f"{raw_solo_ms:.4f} ms by CUDA events over {DP_TIMED_STEPS} steps, in turns "
          f"({', '.join(f'{t:.4f}' for t in times)}; phase 9's solo step "
          f"{raw['step_ms']:.4f} ms); kernels per step {kernels['world 1']:.1f} (solo "
          f"{kernels['solo']:.1f}); collectives per step {collectives} (2 for each of "
          f"{n_bn} BatchNorms, 1 gradient, 1 metrics) ({smi})", flush=True)
    return dict(launches=launches, world1_ms=world1_ms, solo_ms=raw_solo_ms,
                collectives=collectives, kernels=kernels["world 1"])


def phase_dp_gloo(dev: torch.device, smi: str, seed: int, spectrograms: str) -> dict:
    """Phase 18(b) and its time: two gloo ranks on this card on phase 6's
    store, against the solo step in this process."""
    t0 = time.perf_counter()
    card = str(torch.device(dev.type, 0) if dev.type == "cuda" else dev)  # both ranks on it
    ranks = dp_mesh.launch(dp_gloo_rank, 2, card, spectrograms, seed, card, backend="gloo")
    wall = time.perf_counter() - t0
    check(all(r["backend"] == "gloo" and not r["sharded"] for r in ranks), "gloo ranks")
    rconfig = recipe(spectrograms, seed)
    rphase = {k: v for k, v in training.resolve_schedules(rconfig)[0].items() if k != "steps"}
    handler = FeatureHandler(rconfig, dev)
    packed = handler.pack_training(dev)
    flagship = build_model("mixednet", presets.flagship_config())
    torch.backends.cudnn.deterministic = True
    try:
        solo = {}
        for dtype in (torch.float64, torch.float32):
            losses, state, step = dp_run(flagship, packed, rphase, dev, seed, None, dtype)
            solo[str(dtype)] = (losses, state)
        spec_solo_ms = events_ms(lambda: step.step(**rphase), DP_TIMED_STEPS)[0]
    finally:
        torch.backends.cudnn.deterministic = False
    gaps = {}
    for dtype, per_rank in DP_GLOO_RUNS:
        key = (str(dtype), per_rank)
        gaps[key] = dp_gaps(ranks, solo[str(dtype)], key)
        rel, d_param, d_stats = gaps[key]
        print(f"phase 18(b) two gloo ranks on one card, {dtype}, BatchNorm statistics "
              f"{'per rank (the control)' if per_rank else 'global'}, {DP_STEPS} steps against "
              f"the solo step (TF32 off, deterministic cuDNN): loss max rel {rel:.3e}, "
              f"parameters max|d| {d_param:.3e}, statistics max|d| {d_stats:.3e}", flush=True)
        # the parameters are equal on the ranks; the statistics too, unless
        # each rank keeps its own (the control)
        a, b = (r[key][1] for r in ranks)
        check(max_diff(a, b, False) == 0 and (per_rank or max_diff(a, b, True) == 0),
              f"the two ranks' weights differ in run {key}")
    for dtype, (loss_rtol, param_atol) in ((torch.float64, (DP_LOSS_RTOL, DP_PARAM_ATOL)),
                                           (torch.float32, (DP_F32_LOSS_RTOL, DP_F32_PARAM_ATOL))):
        rel, d_param, _ = gaps[(str(dtype), False)]
        check(rel <= loss_rtol and d_param <= param_atol,
              f"two gloo ranks against solo in {dtype}: loss rel {rel} (rtol {loss_rtol}), "
              f"parameters {d_param} (atol {param_atol})")
    rel, d_param, _ = gaps[(str(torch.float32), True)]
    check(rel > DP_F32_LOSS_RTOL and d_param > DP_F32_PARAM_ATOL,
          f"the control (per-rank statistics) is within the float32 bounds: loss rel {rel}, "
          f"parameters {d_param}; the bounds would not tell global statistics from per-rank ones")
    print(f"phase 18(b) held: float64 to loss rtol {DP_LOSS_RTOL} and parameters atol "
          f"{DP_PARAM_ATOL}; float32 to loss rtol {DP_F32_LOSS_RTOL} and parameters atol "
          f"{DP_F32_PARAM_ATOL}, which the control exceeds in both", flush=True)
    full = set(clip_digests(sampler.pack_training_arrays(handler.providers)))
    shards = [set(r["clips"]) for r in ranks]
    check(not shards[0] & shards[1] and shards[0] | shards[1] == full,
          "the two ranks' shards are not a partition of the corpus")
    print(f"phase 18(b) sharded corpus: {len(shards[0]):,} and {len(shards[1]):,} clips on the "
          f"two ranks, disjoint, together the corpus's {len(full):,}", flush=True)
    gloo_ms = ranks[0]["step_ms"]
    print(f"phase 18(b) time: two gloo ranks on one card (a one-card stand-in, not a multi-GPU "
          f"figure): {gloo_ms:.4f} ms per step by CUDA events on rank 0 over {DP_TIMED_STEPS} "
          f"steps (host clock {ranks[0]['host_ms']:.4f} ms), {ranks[0]['collectives_per_step']:.1f} "
          f"collectives per step, against the solo spectrogram step {spec_solo_ms:.4f} ms; phase "
          f"wall {wall:.1f} s with the ranks' start ({smi})", flush=True)
    return dict(gloo_ms=gloo_ms, spectrogram_solo_ms=spec_solo_ms,
                f32_gaps=gaps[(str(torch.float32), False)],
                f32_control_gaps=gaps[(str(torch.float32), True)])


def phase_data_parallel(dev: torch.device, smi: str, seed: int, raw: dict,
                        spectrograms: str) -> dict:
    """Phase 18 (the module docstring): (a) NCCL world 1 on phase 9's
    raw-audio pools; (b) two gloo ranks on this card on phase 6's store."""
    return dict(phase_dp_world1(dev, smi, seed, raw),
                **phase_dp_gloo(dev, smi, seed, spectrograms))


def time_broadcasts(mesh) -> list:
    """From here on, (bytes, ms) of each of ``mesh``'s broadcasts: the card
    is synchronised before and after each, so the host clock spans it."""
    calls, inner = [], mesh.broadcast

    def timed(x, src=0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(x, src)
        torch.cuda.synchronize()
        calls.append((x.numel() * x.element_size(), (time.perf_counter() - t0) * 1e3))
        return out

    mesh.broadcast = timed
    return calls


def refreshing_run(bundle, packed, handler, phase: dict, dev, seed: int, mesh, every: int,
                   steps: int) -> dict:
    """``steps`` data-parallel steps (batch 128) from the seed's weights with
    a blocking pool refresh every ``every`` steps over ``mesh``, as train()
    runs them: rank 0 builds, every rank swaps.  Returns the swap steps with
    a sha1 of the pool after each, the losses, the state, the broadcasts'
    (bytes, ms) and the refresher."""
    model = bundle.init(torch.Generator().manual_seed(seed), device=dev)
    step = make_sharded_train_step(bundle, model, packed, 128, bundle.spectrogram_length, mesh,
                                   generator=torch.Generator(device=dev).manual_seed(seed))
    broadcasts = time_broadcasts(mesh)
    refresher = PoolRefresher(handler, packed, every, mesh=mesh).start()
    swaps, losses = [], []
    try:
        for i in range(1, steps + 1):
            losses.append(float(step.step(**phase)["loss"]))
            if refresher.maybe_swap(packed, i, block=True):
                swaps.append((i, hashlib.sha1(packed.chunks.cpu().numpy().tobytes()).hexdigest()))
    finally:
        refresher.stop()
    state = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
    return dict(swaps=swaps, losses=losses, state=state, broadcasts=broadcasts,
                refresher=refresher, builds=refresher.builds)


def phase_refresh_world1(dev: torch.device, smi: str, seed: int, raw: dict) -> dict:
    """Phase 18(c): pool refresh over a NCCL group of one rank on phase 9's
    full pools, REFRESH_DP: 3 swaps, 3 frontend launches per step, the pool
    tensor changed in place at its shape; the swaps' broadcast ms."""
    every, steps = REFRESH_DP
    config = raw["config"]
    bundle = build_model("mixednet", config["model_config"])
    phase = {k: v for k, v in training.resolve_schedules(config)[0].items() if k != "steps"}
    packed = packed_to(raw["packed"], dev)
    before, ptr = packed.chunks.clone(), packed.chunks.data_ptr()
    handler = FeatureHandler(config, dev)
    mesh = dp_mesh.init_mesh(1, 0, dev, init_method=f"tcp://localhost:{dp_mesh.free_port()}")
    try:
        check(mesh.backend == "nccl", f"world-1 backend {mesh.backend}")
        kernel.frontend_batch.launches = 0
        t0 = time.perf_counter()
        run = refreshing_run(bundle, packed, handler, phase, dev, seed, mesh, every, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernel.frontend_batch.launches
        collectives = mesh.collectives
    finally:
        torch.distributed.destroy_process_group()
    pool_bytes = before.numel() * before.element_size()
    chunk_ms = [ms for nbytes, ms in run["broadcasts"] if nbytes == pool_bytes]
    flag_ms = [ms for nbytes, ms in run["broadcasts"] if nbytes == 1]
    check([i for i, _ in run["swaps"]] == list(range(every, steps + 1, every))
          and run["refresher"].swap_count == steps // every, f"swaps {run['swaps']}")
    check(launches == kernel.LAUNCHES_PER_CALL * steps,
          f"the refreshing world-1 run launched the frontend kernel {launches} times in {steps} steps")
    check(packed.chunks.data_ptr() == ptr and packed.chunks.shape == before.shape,
          "the swap moved or reshaped the pool tensor")
    changed = float((packed.chunks != before).float().mean())
    check(changed > 0.5, f"the swaps changed {changed:.4f} of the pool's samples")
    check(len(chunk_ms) == len(flag_ms) == steps // every and all(map(math.isfinite, run["losses"])),
          f"broadcasts {run['broadcasts'][:8]}, losses {run['losses'][-3:]}")
    print(f"phase 18(c) pool refresh over a NCCL group of one rank: phase 9's pools "
          f"({tuple(before.shape)} int16, {pool_bytes / 1e6:.1f} MB), a blocking refresh every "
          f"{every} of {steps} steps, flagship batch 128: swaps at steps "
          f"{[i for i, _ in run['swaps']]}; frontend launches {launches} "
          f"({launches / steps:.1f} per step); {collectives} collectives in all, "
          f"{len(run['broadcasts'])} of them the swaps' (a flag and the chunks at each); pool "
          f"tensor kept in place, {changed:.4f} of its samples changed; loss "
          f"{run['losses'][-1]:.5f}; wall "
          f"{wall:.1f} s (rank 0 builds {steps // every} pools of {POOL_SIZE} x 2 clips on the "
          f"host)", flush=True)
    print(f"phase 18(c) swap broadcasts (host clock, card synchronised around each): chunks "
          f"{', '.join(f'{ms:.4f}' for ms in chunk_ms)} ms, flag "
          f"{', '.join(f'{ms:.4f}' for ms in flag_ms)} ms ({smi})", flush=True)
    return dict(launches=launches, steps=steps, chunk_ms=chunk_ms, flag_ms=flag_ms, wall=wall)


def refresh_gloo_rank(config: dict, seed: int, device: str) -> dict:
    """Phase 18(d) on one of two ranks sharing the card ``device`` over gloo:
    rank 0 packs the pools of REFRESH_GLOO and broadcasts them, as train()
    does, then the refreshing run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    _, every, steps = REFRESH_GLOO
    mesh = dp_mesh.create_mesh(2, device)
    bundle = build_model("mixednet", config["model_config"])
    phase = {k: v for k, v in training.resolve_schedules(config)[0].items() if k != "steps"}
    handler = FeatureHandler(config, mesh.device)
    packed = handler.pack_training_audio(mesh.device, step_ms=10) if mesh.is_main else None
    packed = dp_corpus.broadcast_packed(packed, mesh)
    run = refreshing_run(bundle, packed, handler, phase, mesh.device, seed, mesh, every, steps)
    pool_bytes = packed.chunks.numel() * packed.chunks.element_size()
    return dict(rank=mesh.rank, backend=mesh.backend, swaps=run["swaps"], state=run["state"],
                builds=run["builds"], thread=run["refresher"]._thread.ident is not None,
                chunk_ms=[ms for n, ms in run["broadcasts"] if n == pool_bytes],
                flag_ms=[ms for n, ms in run["broadcasts"] if n == 1], pool_bytes=pool_bytes)


def phase_refresh_gloo(dev: torch.device, smi: str, seed: int, raw: dict) -> dict:
    """Phase 18(d): pool refresh over two gloo ranks sharing this card,
    phase 9's providers with pools of REFRESH_GLOO's clips: equal pools on
    both ranks after every swap, equal swap steps, rank 0 alone building,
    equal parameters at the end."""
    clips, every, steps = REFRESH_GLOO
    config = dict(raw["config"], features=[dict(f, pack_pool_size=clips)
                                            for f in raw["config"]["features"]
                                            if f.get("type") == "clips"])
    t0 = time.perf_counter()
    card = str(torch.device(dev.type, 0) if dev.type == "cuda" else dev)  # both ranks on it
    ranks = dp_mesh.launch(refresh_gloo_rank, 2, card, config, seed, card, backend="gloo")
    wall = time.perf_counter() - t0
    a, b = ranks
    check(a["backend"] == b["backend"] == "gloo", "gloo ranks")
    check(a["builds"] and a["thread"] and not b["builds"] and not b["thread"],
          "rank 0 alone builds the pools")
    want = list(range(every, steps + 1, every))
    check([i for i, _ in a["swaps"]] == [i for i, _ in b["swaps"]] == want,
          f"swap steps {a['swaps']} and {b['swaps']}")
    check(a["swaps"] == b["swaps"], "the two ranks' pools differ after a swap")
    check(len({d for _, d in a["swaps"]}) == len(want), "a swap left the pool as it was")
    check(all(torch.equal(a["state"][k], b["state"][k]) for k in a["state"]),
          "the two ranks' parameters differ at the end")
    print(f"phase 18(d) pool refresh over two gloo ranks on one card: pools of {clips} clips x 2 "
          f"providers ({a['pool_bytes'] / 1e6:.1f} MB), a blocking refresh every {every} of {steps} "
          f"steps: swaps at steps {want} on both ranks, the chunks' sha1 equal on both after "
          f"each swap ({', '.join(d[:10] for _, d in a['swaps'])}), rank 0 alone built, "
          f"parameters equal at the end; phase wall {wall:.1f} s with the ranks' start", flush=True)
    print(f"phase 18(d) swap broadcasts over gloo on rank 0 (host clock, card synchronised "
          f"around each): chunks {', '.join(f'{ms:.4f}' for ms in a['chunk_ms'])} ms, flag "
          f"{', '.join(f'{ms:.4f}' for ms in a['flag_ms'])} ms ({smi})", flush=True)
    return dict(chunk_ms=a["chunk_ms"], flag_ms=a["flag_ms"], wall=wall)


def phase_host_frontends(dev: torch.device, smi: str) -> dict:
    """Phase 19: the host frontends (frontend/fixedpoint.py, reference.py) on
    the card against the same functions on the CPU, on the golden clips of
    tests/golden/frontend.npz at 10 and 20 ms: the integer-exact frontend bit
    for bit, the float one under the Q6 gate (the share of exact cells
    printed); chunked calls on the card equal the whole clip; ms per
    audio-second on the card and on the CPU (host clock, synchronised)."""
    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
                                  "frontend.npz"))
    clips = [golden[k] for k in sorted(golden.files) if k.startswith("audio_")]
    audio_s = sum(len(c) for c in clips) / FC.SAMPLE_RATE
    exact, worst = {}, 1.0
    for step_ms in HOST_FRONTEND_STEPS:
        for name, module in (("fixedpoint", fixedpoint), ("reference", reference)):
            cells = same = 0
            for clip in clips:
                got = module.generate_features_for_clip(clip, step_ms, device=dev).cpu().numpy()
                want = module.generate_features_for_clip(clip, step_ms, device="cpu").numpy()
                if module is fixedpoint:
                    check(np.array_equal(got, want), f"fixedpoint on the card at {step_ms} ms")
                res = gate.assert_q6_gate(got, want)
                cells, same = cells + res.cells, same + res.exact
            exact[(name, step_ms)] = same / cells
            worst = min(worst, same / cells)
        audio = golden["audio_modulated"]
        frames = FC.num_frames(len(audio), FC.hop_samples(step_ms))
        hop = FC.hop_samples(step_ms)
        for cls in (reference.MicroFrontend, fixedpoint.MicroFrontendInt):
            whole = cls(step_ms, device=dev).process_clip(audio)
            fe = cls(step_ms, device=dev)
            windows = torch.stack([fe.process_window(audio[t * hop : t * hop + FC.WINDOW_SAMPLES])
                                   for t in range(HOST_FRONTEND_WINDOWS)])
            rest = fe.process_clip(audio[HOST_FRONTEND_WINDOWS * hop :])
            check(torch.equal(torch.cat([windows, rest]), whole) and len(whole) == frames,
                  f"chunked {cls.__name__} on the card at {step_ms} ms")
    ms = {}
    for name, module in (("fixedpoint", fixedpoint), ("reference", reference)):
        for where in (dev, torch.device("cpu")):
            module.generate_features_for_clip(clips[0], 10, device=where)  # tables, warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for clip in clips:
                module.generate_features_for_clip(clip, 10, device=where)
            torch.cuda.synchronize()
            ms[(name, where.type)] = (time.perf_counter() - t0) * 1e3 / audio_s
    print(f"phase 19 host frontends on the card against the CPU, {len(clips)} golden clips at "
          f"{' and '.join(map(str, HOST_FRONTEND_STEPS))} ms: fixedpoint bit-equal; exact share "
          + ", ".join(f"{n} {s} ms {v:.6f}" for (n, s), v in exact.items())
          + f"; the float path under the Q6 gate; chunked MicroFrontend and MicroFrontendInt "
          f"({HOST_FRONTEND_WINDOWS} windows, then the rest) equal the whole clip", flush=True)
    print("phase 19 host frontends, ms per audio-second at 10 ms (host clock, synchronised): "
          + ", ".join(f"{n} {w} {v:.4f}" for (n, w), v in ms.items()) + f" ({smi})", flush=True)
    return dict(exact=exact, ms_per_audio_s=ms, worst_exact=worst)


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


def frontend_flops_per_hop() -> float:
    """The least FP32 operations per hop of the micro-frontend's function.

    The window (480 multiplies); the 512-point real FFT as a packed
    256-point complex split-radix FFT (4 M log2 M - 6 M + 8 operations,
    M = 256) and its split step to 257 bins (14 for each pair of bins k,
    256 - k with 0 < k < 128, the halvings folded into the twiddles, and 2
    for bins 0 and 256); the energy of 257 bins (3 each); the mel filters'
    nonzero taps (2 each: every bin feeds at most 2 channels); and
    CELL_FLOPS per feature cell.  That is 11,767, less than the kernel does
    (csrc/frontend.cu counts its own), as a bound must be.
    """
    m = FC.FFT_SIZE // 2
    fft = 4 * m * np.log2(m) - 6 * m + 8 + 14 * (m // 2 - 1) + 2
    mel_taps = np.count_nonzero(FC.mel_filterbank_matrix())
    return float(FC.WINDOW_SAMPLES + fft + 3 * FC.N_FFT_BINS + 2 * mel_taps
                 + CELL_FLOPS * FC.NUM_CHANNELS)


def frontend_bound_ms(batch: int, samples: int, frames: int, audio_bytes: int):
    """Least time for the micro-frontend's function on this card: the larger
    of its FP32 operations (``frontend_flops_per_hop``) over the FP32 peak
    and its bytes (PCM in once, features out once) over the memory rate."""
    flops = batch * frames * frontend_flops_per_hop()
    nbytes = batch * samples * audio_bytes + batch * frames * FC.NUM_CHANNELS * 4
    ops_ms, bytes_ms = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def cufft_filterbank(audio: torch.Tensor, step_ms: int, window: torch.Tensor) -> torch.Tensor:
    """The filterbank stage through cuFFT, a yardstick timed here and used
    nowhere in the package: Hann-windowed frames, rfft zero-padded to 512,
    re^2 + im^2, the mel product, sqrt / 8."""
    mel = plain._device_constants(audio.device)[2]
    frames = plain.frame_audio(audio.to(torch.float32), step_ms) * window
    spec = torch.fft.rfft(frames, n=FC.FFT_SIZE)
    energy = spec.real * spec.real + spec.imag * spec.imag
    return torch.sqrt(torch.clamp(energy @ mel, min=0.0)) / 8.0


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
    t_start = time.perf_counter()

    def mark(phase: int) -> None:
        print(f"chip_smoke: phase {phase} starts at {time.perf_counter() - t_start:.1f} s", flush=True)

    # 1. the card
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"phase 1 card: {name}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi, flush=True)

    # 2. build the kernel; the C++ runtime and the host I/O library on two
    # more threads meanwhile
    runtime_build, native_build = {}, {}

    def gxx_build(builder, into: dict):
        t = time.perf_counter()
        try:
            into["path"] = builder()[0]
        except Exception as e:  # noqa: BLE001 - reported after the join
            into["error"] = e
        into["s"] = time.perf_counter() - t

    gxx = [threading.Thread(target=gxx_build, args=(builder, into))
           for builder, into in ((_build.build_runtime, runtime_build),
                                 (_build.build_native, native_build))]
    for thread in gxx:
        thread.start()
    t0 = time.perf_counter()
    path, report = _build.build("frontend")
    print(f"phase 2 build csrc/frontend.cu: {path.name}")
    for ln in report.splitlines():
        if "registers" in ln or "spill" in ln:
            print(f"  {ln.strip()}")
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s", flush=True)
    for thread in gxx:
        thread.join()
    check("error" not in runtime_build, f"g++ build of the runtime: {runtime_build.get('error')}")
    check("error" not in native_build, f"g++ build of the host I/O library: "
                                       f"{native_build.get('error')}")
    print(f"phase 2 g++ build of native/src/mww_runtime.cc: {runtime_build['path'].name} in "
          f"{runtime_build['s']:.2f} s, of native/src/mww_native.cc: {native_build['path'].name} "
          f"in {native_build['s']:.2f} s (host)", flush=True)

    # 3. kernel against plain on the card
    rng = np.random.default_rng(args.seed)
    pcm_np = synthetic_pcm(rng, STREAMS, CLIP_S * FC.SAMPLE_RATE)
    pcm = torch.from_numpy(pcm_np).to(dev)
    floats = rng.uniform(-0.9, 0.9, (2, 8000)).astype(np.float32)
    floats[0, :4] = [0.5 / 32768, 1.5 / 32768, -2.5 / 32768, 1.2]  # halves, clip
    train_np = synthetic_pcm(rng, *TRAIN_WINDOW)
    t_tone = np.arange(48480) / FC.SAMPLE_RATE
    tones = np.round(30000.0 * np.sin(2 * np.pi * np.array([[250.0], [1000.0], [3300.0], [7000.0]])
                                      * t_tone + rng.uniform(0, 2 * np.pi, (4, 1)))).astype(np.int16)
    cases = [
        ("10ms multi-tile", 10, rng.integers(-25000, 25000, (3, 48480)).astype(np.int16)),
        ("20ms multi-tile", 20, rng.integers(-25000, 25000, (3, 48480)).astype(np.int16)),
        ("10ms ragged tail", 10, rng.integers(-8000, 8000, (2, 480 + 160 * 40 + 77)).astype(np.int16)),
        ("20ms ragged tail", 20, rng.integers(-8000, 8000, (2, 480 + 320 * 40 + 201)).astype(np.int16)),
        ("N < 480", 10, rng.integers(-8000, 8000, (2, 300)).astype(np.int16)),
        ("float input", 10, floats),
        ("full-scale noise", 10, rng.integers(-32767, 32768, (8, 48480)).astype(np.int16)),
        ("pure tones, near-silent channels", 10, tones),
        ("training window", 10, train_np),
        ("2-minute clips, 375 tiles", 10, rng.integers(-20000, 20000, (2, 120 * FC.SAMPLE_RATE)).astype(np.int16)),
        ("main path shape at 20ms", 20, pcm_np),
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
    accepts_kernel.count_accepts.launches = 0
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
    accept_launches = accepts_kernel.count_accepts.launches
    check(accept_launches == 1, f"the main path launched the counting kernel {accept_launches} times")
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
    print(f"phase 4 frontend launches: {launches}; counting kernel launches: {accept_launches}; "
          f"probs in [{float(p.min()):.4f}, {float(p.max()):.4f}]; "
          f"streamed vs forward max|d|={worst:.3e}; predict_clip max|d|={clip_err:.3e}")
    print(f"phase 4 accepts at cutoffs 0.5/0.8/0.9: {counts[50]:.0f}/{counts[80]:.0f}/"
          f"{counts[90]:.0f} over {hours * 3600:.1f} s", flush=True)

    # 5. times: the counting kernel; the frontend kernel at four shapes,
    # whole and launch by launch
    with torch.inference_mode():
        accepts = accepts_phase("phase 5", probs[..., 0])
    long_np = rng.integers(-20000, 20000, LONG_CLIPS).astype(np.int16)
    shapes = [("serving", pcm, STEP_MS), ("training window", torch.from_numpy(train_np).to(dev), 10),
              ("serving 20ms", pcm, 20), ("long clips", torch.from_numpy(long_np).to(dev), 10)]
    times = {}
    window = torch.from_numpy(FC.hann_window().astype(np.float32)).to(dev)
    with torch.inference_mode():
        for label, x, step in shapes:
            sf, ends = kernel.stage_a(x, step)
            carries = kernel.stage_carry(ends)
            call = lambda: kernel.frontend_batch(x, step_ms=step)  # noqa: E731
            tm = dict(
                # the kernel and plain alike: events around 20 back-to-back
                # calls, host work included (the plain version copies a
                # scalar from the host, which waits for the device)
                kernel=cuda_ms(call, 20),
                plain=cuda_ms(lambda: plain.frontend_batch(x, step_ms=step), 20),
                a=queued_ms(lambda: kernel.stage_a(x, step), 50)[0],
                carry=queued_ms(lambda: kernel.stage_carry(ends), 50)[0],
                b=queued_ms(lambda: kernel.stage_b(sf, carries), 50)[0],
                cufft=queued_ms(lambda: cufft_filterbank(x, step, window), 20)[0],
            )
            tm["device"], tm["host_us"] = queued_ms(call, 50)
            nf = FC.num_frames(x.shape[1], FC.hop_samples(step))
            want = plain.scaled_filterbank(plain.frame_audio(x.to(torch.float32), step))
            yard_err = float((cufft_filterbank(x, step, window) - want).abs().max() / want.abs().max())
            del want
            tm["bound"], tm["bound_by"] = frontend_bound_ms(x.shape[0], x.shape[1], nf, x.element_size())
            times[label] = tm
            print(f"phase 5 frontend {label} {list(x.shape)} int16 at {step} ms, T={nf}: kernel "
                  f"{tm['kernel']:.4f} ms, plain {tm['plain']:.4f} ms (both: events around 20 "
                  f"back-to-back calls); kernel on the device alone {tm['device']:.4f} ms (A "
                  f"{tm['a']:.4f} + S {tm['carry']:.4f} + B {tm['b']:.4f}, "
                  f"{kernel.LAUNCHES_PER_CALL} launches), wrapper host time "
                  f"{tm['host_us']:.1f} us per call; bound {tm['bound']:.5f} ms ({tm['bound_by']}; "
                  f"roofline share {tm['bound'] / tm['device']:.4f} of the device time, "
                  f"{tm['bound'] / tm['kernel']:.4f} of the call); cuFFT filterbank-stage "
                  f"yardstick on the device alone {tm['cufft']:.4f} ms (max|d| against plain "
                  f"{yard_err:.2e} of the max); library: none ({smi})", flush=True)
        del long_np, shapes
        kernel_ms, plain_ms = times["serving"]["kernel"], times["serving"]["plain"]
        bound_ms, bound_by = times["serving"]["bound"], times["serving"]["bound_by"]
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
    print(f"phase 5 path: frontend {kernel_ms:.3f} ms + stream_scan {scan_ms:.3f} ms + "
          f"accept counts {accept_ms:.3f} ms; whole path {path_ms:.3f} ms for "
          f"{STREAMS * CLIP_S} audio-s ({smi})", flush=True)
    with torch.inference_mode():
        wall_ms, device_ms, top, _, _ = device_profile(whole_path)
    print(f"phase 5 profile of the whole path: wall {wall_ms:.3f} ms under the profiler, "
          f"device kernels {device_ms:.3f} ms, busy share under the profiler "
          f"{device_ms / wall_ms:.4f}"
          + ("" if device_ms else " (the profiler saw no device time: not measured)"))
    for key, ms, count in top:
        print(f"  {ms:9.3f} ms  x{count:<6d} {key}")

    with tempfile.TemporaryDirectory() as work:
        # 6. training at full width; 7. the step on the card against the CPU
        mark(6)
        spectrograms = os.path.join(work, "spectrograms")
        bundle, packed, phase, flagship_config, flagship_out = phase_training(
            dev, smi, args.seed, spectrograms)
        phase_parity(bundle, packed, phase, dev, smi, args.seed)
        del packed
        # 8. the dataset build; 9. raw-audio training; 10. mixed training and pool refresh
        mark(8)
        built = phase_dataset(dev, smi, args.seed, work)
        mark(9)
        raw = phase_raw_audio(dev, smi, args.seed, work, built)
        mark(10)
        mixed = phase_mixed(dev, smi, args.seed, work, built, spectrograms)
        # 11. Inception serving; 12. Inception training; 13. export and the runtime
        mark(11)
        inception_serving = phase_inception_serving(dev, smi, args.seed, pcm)
        mark(12)
        inception = phase_inception_training(dev, smi, args.seed, work, spectrograms)
        mark(13)
        exported = phase_export(dev, smi, [
            ("flagship", bundle, flagship_config, flagship_out),
            ("inception", inception["bundle"], inception["config"], inception["out"])])
        # 14. population training and the sweep; 15. host streaming
        mark(14)
        swept = phase_population(dev, smi, args.seed, work, spectrograms)
        mark(15)
        streamed = phase_host_stream(dev, smi, args.seed, work, spectrograms)
        # 16. the exported programs on the card; 17. the native host I/O
        mark(16)
        served = phase_exported(dev, smi, [
            ("flagship", bundle, flagship_config, flagship_out, STEP_MS),
            ("inception", inception["bundle"], inception["config"], inception["out"],
             INCEPTION_STEP_MS)], pcm_np)
        mark(17)
        host_io = phase_native_io(smi, native_build, built["wav_root"], args.seed)
        # 18. data-parallel training: NCCL world 1, two gloo ranks on this
        # card; pool refresh over both
        mark(18)
        parallel = phase_data_parallel(dev, smi, args.seed, raw, spectrograms)
        t0 = time.perf_counter()
        refresh1 = phase_refresh_world1(dev, smi, args.seed, raw)
        t1 = time.perf_counter()
        refresh2 = phase_refresh_gloo(dev, smi, args.seed, raw)
        print(f"chip_smoke: phase 18(c) took {t1 - t0:.1f} s, 18(d) "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
        del raw["packed"]
        # 19. the host frontends on the card
        mark(19)
        host_frontends = phase_host_frontends(dev, smi)

    # 20. the kernels line, then the last line
    kernels = [dict(
        name="frontend", route="cuda", source="microwakeword_tpu_torch/csrc/frontend.cu",
        replaces="microwakeword_tpu/frontend/pallas.py:76", launches=launches,
        max_abs_err=max(max_abs, raw["max_abs"]), ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None, ms_a=times["serving"]["a"],
        ms_b=times["serving"]["b"], ms_carry=times["serving"]["carry"],
        ms_device=times["serving"]["device"], host_us_per_call=times["serving"]["host_us"],
        launches_per_call=kernel.LAUNCHES_PER_CALL,
        ms_train_window=times["training window"]["kernel"],
        bound_ms_train_window=times["training window"]["bound"],
        launches_dataset_build=built["launches"],
        launches_raw_audio_run=raw["launches"], raw_audio_steps=raw["steps"],
        launches_per_raw_audio_step=raw["launches"] / raw["steps"],
        ms_device_per_raw_audio_step=raw["frontend_ms"], raw_audio_step_ms=raw["step_ms"],
        launches_mixed_run=mixed["launches"], mixed_step_ms=mixed["step_ms"],
        launches_inception_serving=inception_serving["launches"],
        ms_serving_20ms=times["serving 20ms"]["kernel"],
        bound_ms_serving_20ms=times["serving 20ms"]["bound"],
        inception_serving_path_ms=inception_serving["path_ms"],
        inception_step_ms=inception["m"]["step_ms"],
        runtime_host_ms_per_audio_s={k: v["host_ms_per_audio_s"] for k, v in exported.items()},
        population_member_steps_per_s={k: v["member_steps_per_s"] for k, v in swept["rates"].items()},
        host_stream_step_ms=streamed["times"]["host"][0],
        resident_step_ms=streamed["times"]["resident"][0],
        launches_exported_predict_clip={k: v["launches"] for k, v in served.items()},
        exported_stream_step_ms={k: v["step_ms"] for k, v in served.items()},
        native_decode_ms_per_audio_s=host_io["decode_ms_per_audio_s"],
        native_resample_ms_per_audio_s=host_io["resample_ms_per_audio_s"],
        launches_dp_world1_run=parallel["launches"],
        launches_per_dp_world1_step=parallel["launches"] / DP_STEPS,
        dp_world1_step_ms=parallel["world1_ms"], dp_solo_step_ms=parallel["solo_ms"],
        dp_collectives_per_step=parallel["collectives"],
        dp_world1_kernels_per_step=parallel["kernels"],
        gloo_two_ranks_one_card_step_ms=parallel["gloo_ms"],
        launches_refresh_world1_run=refresh1["launches"],
        launches_per_refresh_world1_step=refresh1["launches"] / refresh1["steps"],
        refresh_chunk_broadcast_ms={"nccl_world1": refresh1["chunk_ms"],
                                    "gloo_two_ranks": refresh2["chunk_ms"]},
        host_frontend_ms_per_audio_s={f"{n} {w}": v for (n, w), v in
                                      host_frontends["ms_per_audio_s"].items()},
    ), dict(
        name="accepts", route="cuda", source="microwakeword_tpu_torch/csrc/accepts.cu",
        replaces="microwakeword_tpu/evaluate/roc.py:31", launches=accept_launches,
        mismatches=0, ms=accepts["kernel"], plain_ms=accepts["plain"], bound_ms=accepts["bound"],
        bound_by="bytes", library_ms=None, ms_device=accepts["device"],
        host_us_per_call=accepts["host_us"],
        launches_inception_serving=inception_serving["accept_launches"],
        ms_inception=inception_serving["accepts"]["kernel"],
        plain_ms_inception=inception_serving["accepts"]["plain"],
        ms_device_inception=inception_serving["accepts"]["device"],
        bound_ms_inception=inception_serving["accepts"]["bound"],
    )]
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
