"""The numbers that decide ``correct`` and their limits.

Each number is a gap between what the timed path produced and what the
plain reference works out from the same inputs; its limit comes from the
workload file (set from the readings that ``PERF.md`` gives).  A number is
within its limit when it is finite and at most the limit.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from benchmark.reference import frontend as RF


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def checks(readings: dict, limits: dict) -> list[Check]:
    """A Check per reading that has a limit of the same name; a reading with
    none is not compared (PERF.md names it with its readings)."""
    return [Check(name, float(value), float(limits[name]))
            for name, value in readings.items() if name in limits]


def relative_gap(got: float, want: float) -> float:
    return abs(got - want) / abs(want) if want else abs(got)


def level_mismatch(got, want) -> float:
    """The share of feature cells whose level (a multiple of the frontend's
    scale) differs, over paired lists of feature tensors; 1 where there are
    none to compare."""
    differ = cells = 0
    for g, w in zip(got, want):
        w = RF.levels(w)
        differ += int((RF.levels(g.to(w.device)) != w).sum())
        cells += w.numel()
    return differ / cells if cells else 1.0


def _norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def leaf_gaps(got: dict, want: dict, leaves=None) -> list:
    """Each leaf's gap between the norms of ``got`` and ``want`` (name ->
    tensor), against the larger of the reference's norm of that leaf and of
    the median leaf; over ``leaves`` (default all)."""
    names = list(want) if leaves is None else list(leaves)
    g, w = _norms({k: got[k] for k in names}), _norms({k: want[k] for k in names})
    median = sorted(w.values())[len(w) // 2]
    return [abs(g[k] - w[k]) / max(w[k], median, 1e-300) for k in names]


def worst_leaf_gap(got: dict, want: dict, leaves=None) -> float:
    return max(leaf_gaps(got, want, leaves))


def median_leaf_gap(got: dict, want: dict, leaves=None) -> float:
    gaps = sorted(leaf_gaps(got, want, leaves))
    return gaps[len(gaps) // 2]


def moving_leaves(grads: dict, share: float = 1e-3) -> list:
    """The leaves whose reference gradient is not nought to rounding: norm at
    least ``share`` of the median leaf's.  The others move under Adam by
    round-off alone and are left out of the change."""
    norms = _norms(grads)
    median = sorted(norms.values())[len(norms) // 2]
    return [k for k, n in norms.items() if n >= share * median]
