"""A/B timing of the frontend kernel across source trees, on one CUDA card.

    python3 -m microwakeword_tpu_torch.frontend.ab TREE [TREE ...] [--out FILE]

Each TREE is the root of a checkout of this repo, for example one unpacked
with ``git archive <commit> | tar -x -C TREE``.  Each tree runs once in the
order given, then once more in reverse order, each in a fresh process that imports that tree's
``microwakeword_tpu_torch`` and builds that tree's ``csrc/frontend.cu``, so
versions of the kernel are compared on the same card in one call.  Each run
times ``frontend.kernel.frontend_batch`` on seeded int16 noise at the shapes
of ``chip_smoke.py`` phase 5:

- ``call_ms``: CUDA events around 20 back-to-back calls, host work included
  (how ``chip_smoke.py`` times the kernel and its plain version);
- ``device_ms``: the calls queued behind a spin kernel, the device alone;
- ``kernels``: each CUDA kernel's mean device milliseconds per call under
  ``torch.profiler``, by kernel name, which splits any version into its
  launches without knowing its interface.

At the serving shape each run also reports the share of cells equal to the
tree's plain version.  It prints one JSON line per run and a table, and
writes the runs to ``--out`` as JSON.  Besides the tree's package it imports
only torch and numpy; ``chip_smoke.py`` takes its timing helpers from here.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# (label, [B, N] int16, step_ms): chip_smoke.py phase 5's shapes.
SHAPES = (
    ("serving", (64, 160000), 10),
    ("training window", (128, 32960), 10),
    ("serving 20ms", (64, 160000), 20),
    ("long clips", (8, 600 * 16000), 10),
)


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


def queued_ms(fn, reps: int) -> tuple[float, float]:
    """(mean device milliseconds, mean host microseconds) per call over
    ``reps`` back-to-back calls.

    A spin kernel holds the stream while the host queues all ``reps`` calls,
    so the events time the device alone, not the host's launch overhead (a
    kernel of tens of microseconds can be shorter than the wrapper's host
    time), and the host clock times the host's work alone.  If the spin
    ended before the host was done, it retries with a longer spin.
    """
    fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    while cycles < 10**10:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_us = (time.perf_counter() - t0) / reps * 1e6
        end.record()
        queued_ahead = not start.query()
        torch.cuda.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / reps, host_us
        cycles *= 4
    raise RuntimeError("the host could not queue the calls ahead of the device")


def kernel_name(key: str) -> str:
    """A profiler key such as ``void (anonymous namespace)::f<short, 160>(...)``
    -> ``f<short, 160>``."""
    key = key.replace("(anonymous namespace)::", "")
    m = re.search(r"([A-Za-z_]\w*)\s*(<[^()]*>)?\s*\(", key)
    return (m.group(1) + (m.group(2) or "")) if m else key[:60]


def kernel_ms(fn, reps: int) -> dict[str, float]:
    """Each CUDA kernel's mean device milliseconds per call of ``fn`` over
    ``reps`` calls under torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            name = kernel_name(e.key)
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / reps
    return out


def _worker(tree: Path) -> dict:
    sys.path.insert(0, str(tree))  # run with -P: the tree's package, not this file's
    from microwakeword_tpu_torch.frontend import kernel, plain

    if not Path(kernel.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {kernel.__file__}, not the kernel of {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    rows = []
    with torch.inference_mode():
        for label, shape, step in SHAPES:
            x = torch.from_numpy(rng.integers(-20000, 20000, shape).astype(np.int16)).cuda()
            call = lambda: kernel.frontend_batch(x, step_ms=step)  # noqa: E731
            row = dict(shape=label, audio=list(shape), step_ms=step, call_ms=cuda_ms(call, 20),
                       device_ms=queued_ms(call, 50)[0], kernels=kernel_ms(call, 20))
            if label == "serving":
                got, want = call(), plain.frontend_batch(x, step_ms=step)
                row["exact_share_vs_plain"] = float((got == want).float().mean())
            rows.append(row)
            del x
    return {"tree": str(tree), "device": torch.cuda.get_device_name(0), "shapes": rows}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="+", type=Path)
    parser.add_argument("--out", type=Path)
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    trees = [t.resolve() for t in args.trees]
    if args.worker:
        print(json.dumps(_worker(trees[0])))
        return 0
    if not torch.cuda.is_available():
        print("ab: no CUDA device; the kernels run only on the card", file=sys.stderr)
        return 1
    runs = []
    for tree in trees + trees[::-1]:
        proc = subprocess.run(
            [sys.executable, "-P", str(Path(__file__).resolve()), str(tree), "--worker"],
            cwd=tree, capture_output=True, text=True, timeout=900,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"run of {tree} failed:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(run)
        print(json.dumps(run), flush=True)
    for label, _, _ in SHAPES:
        print(f"{label}:")
        for run in runs:
            row = next(r for r in run["shapes"] if r["shape"] == label)
            split = " + ".join(f"{k} {v:.4f}" for k, v in row["kernels"].items())
            print(f"  {Path(run['tree']).name:<12} call {row['call_ms']:.4f} ms, device "
                  f"{row['device_ms']:.4f} ms ({split})")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
