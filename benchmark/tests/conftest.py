"""The benchmark's tests: the checkout root on sys.path (so ``benchmark``
and the port import), small CPU cells, and the ``cuda`` fixture of the
card-only tests, which decides inside the fixture whether a card is there."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def shrink(cell):
    """The cell at a size a CPU test holds: few clips and streams, small
    batches, short clips; the same traffic, path and numbers compared."""
    w = cell.workload
    if w["traffic"] == "train":
        for p in w["corpus"]["providers"]:
            p["clips"] = 12
        w["recipe"]["batch_size"] = 8
        w.update(warmup_steps=1, profiled_steps=2, sampler_batches=2)
    elif w["traffic"] == "score_batch":
        w.update(streams=2, stream_seconds=2.0, pool=2, warmup_requests=1, accept_probes=1)
    else:
        w.update(per_stratum=2, strata=4, warmup_requests=2, profiled_requests=2,
                 checked_requests=3)
    return cell


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
