"""The accept-counting kernel (``csrc/accepts.cu`` through
``roc.count_accepts`` on a CUDA tensor) against the CPU loop on the same
data, on the card.  Every comparison is ``torch.equal``: the kernel compares
the same float32 values in the same order of frames.

- data: uniform probabilities, saturated ones (exact 0s and 1s with a few
  values between, as Inception's serving weights give), and values equal to
  float32 cutoffs and their neighbours (``p == cut`` must not fire);
- cooldowns of 0, 1, 25 and 75 frames;
- tracks of 0, 1, fewer than the cooldown and 20,000 frames;
- shapes [T], [B, T] and [A, B, T]; inputs that are not contiguous; a
  float64 input, cast to float32 as the loop casts it;
- one launch per call, inside an ``accept.kernel`` span;
- ``ambient_accept_counts`` over a [64, 332] card tensor makes no host sync
  before its copy of the summed counts to the host.

These tests need an NVIDIA GPU and skip without one.  The file imports only
the port, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_accepts_cuda.py
"""

import numpy as np
import pytest
import torch

from microwakeword_tpu_torch.evaluate import accepts_kernel, roc
from microwakeword_tpu_torch.evaluate.streaming_eval import ambient_accept_counts

CUT = roc.DEFAULT_CUTOFFS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the counting kernel has no CPU mode")
    return torch.device("cuda")


def _probs(kind: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(0.0, 1.0, shape).astype(np.float32)
    if kind == "saturated":
        p = (rng.uniform(size=shape) < 0.3).astype(np.float32)
        between = rng.uniform(size=shape) < 0.02
        p[between] = rng.uniform(0.0, 1.0, int(between.sum()))
        return p
    # ties: each frame a float32 cutoff or one of its neighbours
    cut = CUT.astype(np.float32)[rng.integers(0, len(CUT), shape)]
    step = rng.integers(-1, 2, shape)
    out = np.where(step > 0, np.nextafter(cut, np.float32(2)), cut)
    return np.where(step < 0, np.nextafter(cut, np.float32(-1)), out).astype(np.float32)


def _check(probs: torch.Tensor, reset: int, cutoffs=CUT) -> torch.Tensor:
    """The kernel's counts on the card equal the loop's on the CPU."""
    want = roc.count_accepts(probs.cpu(), cutoffs, reset)
    got = roc.count_accepts(probs, cutoffs, reset)
    assert got.device == probs.device and got.dtype == torch.int64
    assert torch.equal(got.cpu(), want)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [0, 1, 10, 20000])
@pytest.mark.parametrize("reset", [0, 1, 25, 75])
@pytest.mark.parametrize("kind", ["uniform", "saturated", "ties"])
def test_kernel_equals_loop(cuda, kind, reset, frames):
    batch = 4 if frames > 1000 else 16
    probs = torch.from_numpy(_probs(kind, (batch, frames), seed=reset * 7 + frames)).to(cuda)
    want = _check(probs, reset)
    if frames > reset and kind != "ties":
        assert want.sum() > 0  # the comparison saw accepts


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(332,), (64, 332), (3, 5, 120)])
def test_shapes(cuda, shape):
    probs = torch.from_numpy(_probs("uniform", shape, seed=len(shape))).to(cuda)
    got = roc.count_accepts(probs, CUT, 25)
    assert got.shape == shape[:-1] + (len(CUT),)
    _check(probs, 25)


@pytest.mark.cuda
def test_not_contiguous(cuda):
    base = torch.from_numpy(_probs("uniform", (6, 64, 400), seed=11)).to(cuda)
    for probs in (base[:, :, ::3], base[:, ::2, 5:300], base.transpose(1, 2)[..., :50],
                  base[2].t(), base[0, 0, ::7]):
        assert not probs.is_contiguous()
        _check(probs, 25)


@pytest.mark.cuda
def test_float64_is_cast_to_float32(cuda):
    """Values within float32's rounding of a cutoff: the kernel compares
    them after the cast, as the loop does."""
    rng = np.random.default_rng(5)
    cut = CUT[rng.integers(0, len(CUT), (8, 500))].astype(np.float32).astype(np.float64)
    probs = cut + rng.choice([-1e-12, 0.0, 1e-12, 1e-6, -1e-6], cut.shape)
    _check(torch.from_numpy(probs).to(cuda), 5)
    _check(torch.from_numpy(_probs("uniform", (8, 500), 6)).double().to(cuda), 5)


@pytest.mark.cuda
def test_other_cutoffs(cuda):
    probs = torch.from_numpy(_probs("uniform", (16, 300), seed=9)).to(cuda)
    for cutoffs in ([0.5], np.linspace(0, 1, 512), [], np.float32([0.9, 0.1, 0.5])):
        _check(probs, 3, cutoffs)
    with pytest.raises(ValueError, match="cutoffs"):
        roc.count_accepts(probs, np.linspace(0, 1, 513), 3)


@pytest.mark.cuda
def test_one_launch_per_call(cuda):
    probs = torch.from_numpy(_probs("uniform", (64, 328), seed=3)).to(cuda)
    roc.count_accepts(probs, CUT, 25)
    torch.cuda.synchronize()
    launches = accepts_kernel.count_accepts.launches
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        roc.count_accepts(probs, CUT, 25)
        torch.cuda.synchronize()
    assert accepts_kernel.count_accepts.launches == launches + 1
    events = prof.events()
    assert sum(e.name == "accept.kernel" for e in events
               if e.device_type == torch.autograd.DeviceType.CPU) == 1
    on_card = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name != "accept.kernel"]
    assert len(on_card) == 1 and "accepts_kernel" in on_card[0], on_card


@pytest.mark.cuda
def test_ambient_accept_counts_makes_no_host_sync(cuda, monkeypatch):
    """Up to its ``.cpu()`` of the summed counts, the call waits for nothing
    on the card: no blocking copy of the cutoffs, no sync."""
    probs = torch.from_numpy(_probs("uniform", (64, 332), seed=4)).to(cuda)
    roc.count_accepts(probs, CUT, 25)  # the library built and loaded
    torch.cuda.synchronize()
    cpu, modes = torch.Tensor.cpu, []

    def cpu_unchecked(self, *args, **kwargs):
        modes.append(torch.cuda.get_sync_debug_mode())
        torch.cuda.set_sync_debug_mode(0)
        return cpu(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "cpu", cpu_unchecked)
    torch.cuda.set_sync_debug_mode("error")
    try:
        counts, hours = ambient_accept_counts([probs], CUT, 25, 5, stride=3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    monkeypatch.undo()
    assert modes == [2]  # the one copy to the host, reached under the check
    want, want_hours = ambient_accept_counts([probs.cpu()], CUT, 25, 5, stride=3)
    np.testing.assert_array_equal(counts, want)
    assert hours == want_hours and want.sum() > 0
