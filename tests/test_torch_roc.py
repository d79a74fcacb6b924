"""The port's ROC and accept-counting math against the JAX package's, on
identical probability tracks made from a numpy seed."""

import jax
import numpy as np
import pytest
import torch

from microwakeword_tpu.evaluate import roc as jroc
from microwakeword_tpu.evaluate import streaming_eval as jeval
from microwakeword_tpu.models import build_model as jax_build_model
from microwakeword_tpu.models.mixednet import MixedNetConfig as JaxConfig
from microwakeword_tpu_torch import _build
from microwakeword_tpu_torch.evaluate import accepts_kernel, roc, streaming_eval
from microwakeword_tpu_torch.models import MixedNetConfig, build_model, convert

torch.set_num_threads(2)


def _tracks(seed: int, n: int = 4):
    """Tracks with smooth bursts above the cutoffs and plain noise between."""
    rng = np.random.default_rng(seed)
    tracks = []
    for length in rng.integers(40, 400, n):
        p = rng.uniform(0.0, 0.3, length)
        for start in rng.integers(0, length, 3):
            p[start : start + rng.integers(3, 30)] = rng.uniform(0.5, 1.0)
        tracks.append(p.astype(np.float32))
    return tracks


@pytest.mark.parametrize("ignore", [0, 1, 7, 25])
def test_count_accepts_equal(ignore):
    for track in _tracks(ignore):
        want = jroc.count_accepts(track, jroc.DEFAULT_CUTOFFS, ignore)
        got = roc.count_accepts(torch.from_numpy(track), roc.DEFAULT_CUTOFFS, ignore)
        np.testing.assert_array_equal(got.numpy(), want)


def test_count_accepts_batched_equals_per_track():
    tracks = np.stack([t[:40] for t in _tracks(3)])
    got = roc.count_accepts(torch.from_numpy(tracks), roc.DEFAULT_CUTOFFS, 5)
    assert got.shape == (len(tracks), len(roc.DEFAULT_CUTOFFS))
    for row, track in zip(got.numpy(), tracks):
        np.testing.assert_array_equal(row, jroc.count_accepts(track, jroc.DEFAULT_CUTOFFS, 5))


def test_count_accepts_on_cpu_is_the_loop(monkeypatch):
    """A CPU tensor builds and loads no library, launches nothing and opens
    no ``accept.kernel`` span; its counts are the JAX package's."""

    def refuse(*args):
        raise AssertionError("a CPU tensor reached the kernel's library")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(accepts_kernel, "_library", refuse)
    launches = accepts_kernel.count_accepts.launches
    tracks = np.stack([t[:40] for t in _tracks(12)])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = roc.count_accepts(torch.from_numpy(tracks), roc.DEFAULT_CUTOFFS, 7)
        counts, _ = streaming_eval.ambient_accept_counts(
            [torch.from_numpy(tracks)], roc.DEFAULT_CUTOFFS, 7, 5, 3)
    names = {e.name for e in prof.events()}
    assert "accept.counts" in names and "accept.kernel" not in names
    assert accepts_kernel.count_accepts.launches == launches
    for row, track in zip(got.numpy(), tracks):
        np.testing.assert_array_equal(row, jroc.count_accepts(track, jroc.DEFAULT_CUTOFFS, 7))
    want, _ = jeval.ambient_accept_counts(list(tracks), jroc.DEFAULT_CUTOFFS, 7, 5, 3)
    np.testing.assert_array_equal(counts, want)


def test_kernel_wrapper_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="device cpu"):
        accepts_kernel.count_accepts(torch.zeros(3, 10), roc.DEFAULT_CUTOFFS, 5)


def _card_kind(kind: str, shape, seed: int) -> np.ndarray:
    """The data of the kernel's card tests: saturated probabilities (exact 0s
    and 1s, a few values between) or ties (each frame a float32 cutoff or
    one of its neighbours).  The ties leave out cutoff 0, whose neighbours
    are subnormal: XLA on the CPU flushes them to 0, the port does not."""
    rng = np.random.default_rng(seed)
    if kind == "saturated":
        p = (rng.uniform(size=shape) < 0.3).astype(np.float32)
        between = rng.uniform(size=shape) < 0.02
        p[between] = rng.uniform(0.0, 1.0, int(between.sum()))
        return p
    cut = roc.DEFAULT_CUTOFFS.astype(np.float32)[rng.integers(1, len(roc.DEFAULT_CUTOFFS), shape)]
    step = rng.integers(-1, 2, shape)
    out = np.where(step > 0, np.nextafter(cut, np.float32(2)), cut)
    return np.where(step < 0, np.nextafter(cut, np.float32(-1)), out).astype(np.float32)


@pytest.mark.parametrize("reset", [0, 1, 25, 75])
@pytest.mark.parametrize("kind", ["saturated", "ties"])
def test_count_accepts_plain_on_the_card_tests_data(kind, reset):
    """The loop that the kernel is held against on the card counts as the
    JAX package does on the card tests' data, per track of an [A, B, T]
    tensor; a tie (p == cut) does not fire."""
    probs = _card_kind(kind, (3, 2, 120), seed=reset)
    got = roc.count_accepts(torch.from_numpy(probs), roc.DEFAULT_CUTOFFS, reset)
    assert got.shape == (3, 2, len(roc.DEFAULT_CUTOFFS))
    for row, track in zip(got.reshape(6, -1).numpy(), probs.reshape(6, -1)):
        np.testing.assert_array_equal(row, jroc.count_accepts(track, jroc.DEFAULT_CUTOFFS, reset))
    assert torch.equal(got, roc.count_accepts_plain(torch.from_numpy(probs), roc.DEFAULT_CUTOFFS,
                                                    reset))


@pytest.mark.parametrize("cutoffs", [0.5, [[0.2, 0.5], [0.7, 0.9]]], ids=["scalar", "two_axes"])
def test_count_accepts_takes_one_axis_of_cutoffs(cutoffs):
    """On every device: the kernel's one axis of cutoffs is the loop's too."""
    with pytest.raises(ValueError, match="one axis"):
        roc.count_accepts(torch.zeros(3, 10), cutoffs, 5)


@pytest.mark.parametrize("refractory", [0, 3, 50])
def test_count_crossings_equal(refractory):
    for track in _tracks(10 + refractory):
        assert roc.count_crossings(track, 0.5, refractory) == jroc.count_crossings(
            track, 0.5, refractory
        )


def test_moving_average_close():
    for track in _tracks(4):
        want = jroc.moving_average(track, 5)
        got = roc.moving_average(torch.from_numpy(track), 5)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert roc.moving_average(torch.zeros(3), 5).shape == (0,)


def test_false_accepts_per_hour_equal():
    tracks = _tracks(5)
    want = jroc.compute_false_accepts_per_hour(tracks, ignore_slices_after_accept=20, stride=3)
    got = roc.compute_false_accepts_per_hour(
        [torch.from_numpy(t) for t in tracks], ignore_slices_after_accept=20, stride=3
    )
    np.testing.assert_array_equal(got, want)


def test_ambient_accept_counts_equal():
    tracks = _tracks(6)
    want, want_h = jeval.ambient_accept_counts(tracks, jroc.DEFAULT_CUTOFFS, 25, 5, 3, 0.01)
    got, got_h = streaming_eval.ambient_accept_counts(
        [torch.from_numpy(t) for t in tracks], roc.DEFAULT_CUTOFFS, 25, 5, 3, 0.01
    )
    np.testing.assert_array_equal(got, want)
    assert got_h == pytest.approx(want_h, rel=1e-12)
    # a batch of equal-length tracks as one item counts the same
    batch = np.stack([t[:40] for t in tracks])
    want_b, want_bh = jeval.ambient_accept_counts(list(batch), jroc.DEFAULT_CUTOFFS, 25)
    got_b, got_bh = streaming_eval.ambient_accept_counts(
        [torch.from_numpy(batch)], roc.DEFAULT_CUTOFFS, 25
    )
    np.testing.assert_array_equal(got_b, want_b)
    assert got_bh == pytest.approx(want_bh, rel=1e-12)


def test_positive_detection_counts_equal():
    rng = np.random.default_rng(8)
    max_probs = rng.uniform(0, 1, 50)
    want = jeval.positive_detection_counts(max_probs, jroc.DEFAULT_CUTOFFS)
    got = streaming_eval.positive_detection_counts(max_probs, roc.DEFAULT_CUTOFFS)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


@pytest.mark.parametrize("max_faph", [2.0, 0.5])
def test_roc_curve_and_auc_equal(max_faph):
    rng = np.random.default_rng(9)
    faph = np.sort(rng.uniform(0, 5, 101))[::-1].copy()
    faph[-10:] = 0.0
    fnr = np.sort(rng.uniform(0, 1, 101))
    want = jroc.generate_roc_curve(faph, fnr, jroc.DEFAULT_CUTOFFS, max_faph)
    got = roc.generate_roc_curve(faph, fnr, roc.DEFAULT_CUTOFFS, max_faph)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-6)
    assert roc.roc_auc(got[0], got[1]) == pytest.approx(jroc.roc_auc(want[0], want[1]), abs=1e-6)


def test_track_stream_probs_without_padding():
    """The JAX function pads each track to a 512-step bucket; the port does
    not, and the steps both keep are the same (streaming is causal)."""
    kw = dict(pointwise_filters=(8, 8), repeat_in_block=(1, 1),
              mixconv_kernel_sizes=((3,), (5,)), residual_connection=(False, False),
              first_conv_filters=8, first_conv_kernel_size=3, stride=3,
              spectrogram_length=33)
    jb = jax_build_model("mixednet", JaxConfig(**kw))
    variables = jax.tree_util.tree_map(np.asarray, jb.init(jax.random.PRNGKey(1)))
    tb = build_model("mixednet", MixedNetConfig(**kw))
    model = tb.load(convert.flax_to_state(variables), device="cpu")
    track = np.random.default_rng(11).standard_normal((101, 40)).astype(np.float32)
    want = jeval._track_stream_probs(jb, variables, track)
    got = streaming_eval._track_stream_probs(tb, model, track)
    assert got.shape == want.shape == (33,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
