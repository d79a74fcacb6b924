"""Readings that the limits of ``correct`` are set from; not part of a run.

    python3 benchmark/calibrate.py --workload <name> --seeds 1 2 3 ... [--seconds 3] [--out FILE]

For each seed, in one process, the cell's set-up, a short window (none for
training: its numbers come from set-up's checked steps), and then:

- ``program``: the numbers compared, as a run computes them (the lower
  reading of each limit is the largest over a dozen seeds or more);
- ``control``: the reference computed one precision below the stated one
  (float32 with TF32 on, for float32 with TF32 off) put in the program's
  place, against the reference (the upper reading);
- for training cells, ``half_batch``: the reference at the stated
  precision with the loss taken over half of the batch, a planted fault.

One JSON line per seed on standard output, all of them in ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.lib import device as D  # noqa: E402
from benchmark.lib.cell import load_cell, module  # noqa: E402


def tf32(on: bool) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def readings(cell, dev) -> dict:
    import torch

    D.set_numerics(cell.config)
    traffic = module("traffic", cell.traffic).Traffic(cell, dev)
    t0 = time.perf_counter()
    traffic.setup()
    out = {"seed": cell.seed, "setup_s": time.perf_counter() - t0}
    if cell.traffic != "train":
        traffic.window(cell.seconds)
    traffic.free()
    t0 = time.perf_counter()
    if cell.traffic == "train":
        out["program"] = traffic.readings()
        out["reference_s"] = time.perf_counter() - t0
        tf32(True)
        control = traffic.reference(torch.float32)
        D.set_numerics(cell.config)
        out["control"] = traffic.judge(control)
        out["half_batch"] = traffic.judge(traffic.reference(torch.float32, half_batch=True))
    else:
        out["program"] = traffic.readings()
        out["reference_s"] = time.perf_counter() - t0
        tf32(True)
        out["control"] = traffic.readings(torch.float32, control=True)
        D.set_numerics(cell.config)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    D.point_caches()
    dev = D.require_cards(1)
    rows = []
    for seed in args.seeds:
        row = readings(load_cell(args.workload, seed=seed, seconds=args.seconds), dev)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": args.workload, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
