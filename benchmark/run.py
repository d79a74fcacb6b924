"""Runs one cell of the benchmark once and prints its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell is the entry ``<name>`` of
``BENCHMARK.json``; see ``benchmark/README.md`` for the files it reads.  The
run measures the PyTorch and CUDA port (``microwakeword_tpu_torch``) on the
cards of the machine it starts on:

1. set-up (timed as ``setup_s`` from the start of this process): the card,
   the program's imports and kernel build or load, the inputs and weights
   made from the seed, and the traffic's warm-up, which also drives the
   checked part of the timed path;
2. the window: ``--seconds`` of the cell's traffic, its end-to-end metrics
   on the host's clock, or on the card's (CUDA events around gated steps,
   ``benchmark/lib/gate.py``) for a train cell;
3. with ``--trace 1``, a short profiled slice of the same path and the
   per-layer probes; the line then carries the per-layer metrics;
4. the peak device memory is read, the program's state freed, and the
   plain reference (``benchmark/reference/``) recomputes what the timed
   path produced from the same inputs: each number compared is printed
   beside its limit on standard error and under ``checks`` in the line.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``busy_s`` and
``window_s`` when traced), ``breakdown`` when traced, and ``checks`` last.
Without enough CUDA cards, or with a JAX module loaded at the end, the run
prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.lib import device as D  # noqa: E402
from benchmark.lib.cell import load_cell, metric_family, module  # noqa: E402
from benchmark.lib.isolation import forbidden_modules  # noqa: E402

EXIT_NO_CARD, EXIT_SPEC, EXIT_ISOLATION = 3, 4, 5


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(cell, dev, t_start: float = T_START) -> dict:
    """Set-up, window, optional trace, then the comparison; the result
    object (without the printing)."""
    import torch

    from benchmark.lib import compare

    D.set_numerics(cell.config)
    traffic = module("traffic", cell.traffic).Traffic(cell, dev)
    traffic.setup()
    setup_s = time.perf_counter() - t_start
    e2e, attempted, failed = traffic.window(cell.seconds)
    e2e["setup_s"] = setup_s
    trace = traffic.trace() if cell.trace else None
    device = D.device_info(dev, cell.entry["chips"])
    if trace is None:
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    else:
        metrics = {}
        for m in cell.per_layer:
            value = module("metrics", metric_family(m["name"])).read(trace)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        device.update(busy_s=trace.busy_s(), window_s=trace.window_s())
        ops = collections.Counter(op[4] for op in trace.device_ops)
        print("trace: device operations per unit: "
              + ", ".join(f"{cat} {n / trace.units!r}" for cat, n in sorted(ops.items())),
              file=sys.stderr)
    traffic.free()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = compare.checks(traffic.readings(), cell.workload["limits"])
    result = {"correct": failed == 0 and all(c.ok for c in checks), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": device}
    if trace is not None:
        result["breakdown"] = trace.breakdown()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    D.point_caches()
    try:
        cell = load_cell(args.workload, seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace))
    except (KeyError, FileNotFoundError, ValueError) as err:
        print(f"benchmark: {err}", file=sys.stderr)
        return EXIT_SPEC
    try:
        dev = D.require_cards(cell.entry["chips"])
    except D.NoCard as err:
        print(f"benchmark: no result: {err}", file=sys.stderr)
        return EXIT_NO_CARD
    print(f"benchmark: {cell.name} seed {args.seed} on {D.power_limit()}", file=sys.stderr)
    result = run_cell(cell, dev)
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: no result: JAX modules loaded: {loaded}", file=sys.stderr)
        return EXIT_ISOLATION
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
