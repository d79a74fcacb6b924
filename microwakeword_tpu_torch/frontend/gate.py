"""The Q6 gate: the one tolerance the frontend is held to.

The port's tests (port against the JAX package) and ``chip_smoke.py`` (the
CUDA kernel against the plain version) both use it.

Why not "at most one quantization step per cell": the PCAN output is floored
to Q6 (``pcan_q6 = floor(pcan * 64)``) before the log stage.  When that floor
flips between two levels because of a one-ULP difference upstream (another
summation order in a matmul, say), the log output jumps by the whole step
between the two levels: between level 0 and level 1 that is
round(64 * ln 8) = 133 uint16 steps.  Such a cell is right on both sides.

With ``u = round(f / 0.0390625)`` the uint16 value of a feature and the Q6
level ``q(u) = round(exp(u / 64) / 8)`` (``q(0) = 0``), a cell passes if
``|u_got - u_want| <= 1`` or if ``|q(u_got) - q(u_want)| == 1``; and at least
``MIN_EXACT_SHARE`` of all cells must have ``u_got == u_want``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from microwakeword_tpu_torch.frontend.constants import FEATURE_SCALE

MIN_EXACT_SHARE = 0.998


def q6_level(u: np.ndarray) -> np.ndarray:
    """uint16 feature value -> the Q6 PCAN level it was computed from."""
    u = np.asarray(u, np.float64)
    return np.where(u == 0, 0.0, np.round(np.exp(u / 64.0) / 8.0))


@dataclasses.dataclass(frozen=True)
class GateResult:
    cells: int
    exact: int  # cells with equal uint16 values
    q6_flips: int  # non-exact cells whose Q6 levels differ by exactly one
    failing: int  # cells that pass neither rule
    max_abs: float  # max |got - want| in feature units

    @property
    def exact_share(self) -> float:
        return self.exact / self.cells if self.cells else 1.0

    @property
    def ok(self) -> bool:
        return self.failing == 0 and self.exact_share >= MIN_EXACT_SHARE

    def summary(self) -> str:
        return (
            f"cells={self.cells} exact_share={self.exact_share:.6f} "
            f"q6_flips={self.q6_flips} failing={self.failing} "
            f"max_abs={self.max_abs}"
        )


def q6_gate(got, want) -> GateResult:
    """Compares two feature arrays (float, in [0, 26]) under the Q6 gate."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"shape {got.shape} != {want.shape}")
    if not (np.isfinite(got).all() and np.isfinite(want).all()):
        raise AssertionError("non-finite features")
    u_got = np.round(got / FEATURE_SCALE)
    u_want = np.round(want / FEATURE_SCALE)
    du = np.abs(u_got - u_want)
    flip = np.abs(q6_level(u_got) - q6_level(u_want)) == 1
    return GateResult(
        cells=int(du.size),
        exact=int((du == 0).sum()),
        q6_flips=int(((du > 1) & flip).sum()),
        failing=int(((du > 1) & ~flip).sum()),
        max_abs=float(np.abs(got - want).max()) if du.size else 0.0,
    )


def assert_q6_gate(got, want, exact: bool = False) -> GateResult:
    """Raises AssertionError unless ``got`` passes the gate against ``want``
    (with ``exact=True``: unless every cell is equal)."""
    res = q6_gate(got, want)
    if not res.ok or (exact and res.exact != res.cells):
        raise AssertionError(f"Q6 gate failed: {res.summary()}")
    return res
