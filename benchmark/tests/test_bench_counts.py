"""The yardstick's counters against hand counts."""

from __future__ import annotations

import pytest

from benchmark.counts import frontend, inception, mixednet
from benchmark.counts.peaks import PEAK_BYTES_PER_S, PEAK_FP32_FLOPS
from benchmark.lib.cell import ROOT, load_json

FLAGSHIP = load_json(ROOT / "benchmark/configs/mixednet-okay-nabu.json")["model"]
INCEPTION = load_json(ROOT / "benchmark/configs/inception-default.json")["model"]


def test_flagship_first_conv_by_hand():
    # 204 frames, k 5, stride 3 -> 67 frames; 32 filters over 40 channels x 5 taps
    macs, frames, step = mixednet._layers(FLAGSHIP)[0]
    assert (macs, frames, step) == (32 * 40 * 5, 67, 1)
    assert 2 * macs * frames == 857_600


def test_flagship_forward_and_streamed_step_by_hand():
    # MixConv taps counted per group: [5], [7, 11], [9, 15], [23] over 32 + 32 channels
    by_hand = (857_600 + 2 * 63 * 32 * 5 + 2 * 63 * 32 * 64
               + 2 * 53 * (32 * 7 + 32 * 11) + 2 * 53 * 64 * 64
               + 2 * 39 * (32 * 9 + 32 * 15) + 2 * 39 * 64 * 64
               + 2 * 17 * 64 * 23 + 2 * 17 * 64 * 64 + 2 * 17 * 64)
    assert mixednet.forward_flops(FLAGSHIP) == by_hand == 2_201_920
    assert mixednet.stream_step_flops(FLAGSHIP) == 2 * (6400 + 160 + 2048 + 576 + 4096 + 768
                                                        + 4096 + 1472 + 4096 + 1088)


def test_inception_forward_by_hand():
    first = 2 * 40 * 24 * 5 * 98
    block1 = 2 * (240 * 90 + 500 * 90 + 240 * 94 + 500 * 90 + 500 * 94 + 240 * 98 + 300 * 90)
    block2 = 2 * (100 * 82 + 500 * 82 + 100 * 86 + 500 * 82 + 500 * 86 + 100 * 90 + 300 * 82)
    block3 = 2 * (160 * 74 + 1280 * 74 + 160 * 78 + 1280 * 74 + 1280 * 78 + 160 * 82 + 768 * 74)
    assert inception.forward_flops(INCEPTION) == first + block1 + block2 + block3 + 2 * 1184


def test_frontend_bound_at_the_serving_shape():
    assert frontend.flops_per_hop() == 11_767
    flops, nbytes = frontend.work(64, 160_000, 10)
    assert flops == 64 * 998 * 11_767
    assert nbytes == 64 * 160_000 * 2 + 64 * 998 * 40 * 4
    bound, what = frontend.bound_s(64, 160_000, 10)
    assert what == "operations" and bound == pytest.approx(flops / PEAK_FP32_FLOPS)
    assert bound * 1e3 == pytest.approx(0.01122, abs=5e-6)
    assert nbytes / PEAK_BYTES_PER_S < bound


def test_frontend_bound_at_the_training_window():
    bound, what = frontend.bound_s(128, 32_960, 10)
    assert what == "operations" and bound * 1e3 == pytest.approx(0.00459, abs=5e-6)
