"""On the card: the control comes out not correct.

The control is the plain reference put in the program's place and computed
one precision below the configuration's (float32 with TF32 on, where the
configurations state float32 with TF32 off).  At a size a test run holds
(smaller corpora and pools, fewer requests; the cell's batch, streams and
window lengths), for each cell and two seeds: the program's numbers are
within the cell's limits and the control's numbers exceed at least one.
Run on a card with

    python -m pytest -p no:cacheprovider -m cuda benchmark/tests/test_bench_control_cuda.py
"""

from __future__ import annotations

import pytest

from benchmark.calibrate import readings
from benchmark.lib.cell import load_cell

CELLS = ["mixednet-train-rawaudio", "mixednet-score-64x10s", "mixednet-clip-1to3s"]


def smaller(cell):
    w = cell.workload
    if w["traffic"] == "train":
        for p in w["corpus"]["providers"]:
            p["clips"] = min(p["clips"], 200)
    elif w["traffic"] == "score_batch":
        w.update(pool=2, warmup_requests=1)
    else:
        w.update(per_stratum=2, warmup_requests=4)
    return cell


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 202])
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(cuda, name, seed):
    cell = smaller(load_cell(name, seed=seed, seconds=2.0))
    limits = cell.workload["limits"]
    out = readings(cell, cuda)
    assert all(out["program"][k] <= limit for k, limit in limits.items()), out
    assert any(out["control"][k] > limit for k, limit in limits.items()), out
