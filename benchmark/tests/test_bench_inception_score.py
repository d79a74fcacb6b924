"""The cell ``inception-score-64x10s``: microWakeWord's Inception at its
published widths on the serving path (``score_batch`` traffic, 20 ms hops,
one-frame steps).

On the CPU: the cell's files and metrics, the model FLOPs of a streamed step
by hand, the shrunk cell run sound and with a fault planted where the
probabilities and the counts are produced or inside the model (a conv ring
read one frame off, a dropped branch), the port's streamed Inception against
the plain reference, and the reader ``replay_device_us`` on traces built by
hand.  On a card (``cuda``): the reference in TF32 put in the program's
place fails at least one of the cell's limits, and the port's model stage in
TF32 over the exact frontend fails ``prob_gap``.
"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.calibrate import readings
from benchmark.counts import inception as counts
from benchmark.lib import inputs
from benchmark.lib.cell import load_cell, module
from benchmark.lib.profile import Trace
from benchmark.reference import inception as ref
from benchmark.run import run_cell

from test_bench_control_cuda import smaller
from test_bench_faults import _count_altered, _probability_altered, _run
from test_bench_reference import port_bundle

CELL = "inception-score-64x10s"
SCORE_METRICS = {"device_idle.score", "kernels_per_stream_step.score", "accept_ms.score",
                 "frontend_roofline.score", "frontend_launches.score", "mfu.score",
                 "scan_step_host_us.score", "accept_host_ms.score", "scan_idle_share.score",
                 "graph_step_share.score", "replay_device_us.score"}


def test_cell_loads_with_its_metrics():
    cell = load_cell(CELL)
    assert cell.family == "inception" and cell.traffic == "score_batch"
    assert cell.entry["chips"] == 1 and cell.config["window_step_ms"] == 20
    assert {m["name"] for m in cell.end_to_end} == {"score_audio_s_per_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == SCORE_METRICS
    mixednet = load_cell("mixednet-score-64x10s").workload
    same = {k: v for k, v in mixednet.items() if k not in ("why", "limits")}
    assert {k: cell.workload[k] for k in same} == same
    assert set(cell.workload["limits"]) == {"feature_mismatch", "prob_gap", "count_mismatch"}
    assert cell.workload["limits"]["count_mismatch"] == 0


def test_stream_step_flops_by_hand():
    # multiply-adds a frame: first conv 40 x 24 x 5; per block a 1x1 head on
    # each of the three branches, one k5 unit on the second, two on the third,
    # and the 1x1 unit after the concatenation; the dense layer over 74 x 16
    first = 40 * 24 * 5
    block1 = 3 * 24 * 10 + 3 * 10 * 10 * 5 + 30 * 10
    block2 = 3 * 10 * 10 + 3 * 10 * 10 * 5 + 30 * 10
    block3 = 3 * 10 * 16 + 3 * 16 * 16 * 5 + 48 * 16
    dense = 74 * 16
    cfg = load_cell(CELL).config["model"]
    assert ref.tail_length(cfg) == 74
    assert counts.stream_step_flops(cfg) == 2 * (first + block1 + block2 + block3 + dense) == 31_384


def test_sound_run_is_correct():
    result = _run(CELL)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0


# the first block's k5 unit in its second branch, and the first block's
# 1x1 branch (``Inception`` names its units in the order it builds them)
RING = "ConvBnRelu_3/StreamConv_0"
BRANCH = ["ConvBnRelu_1"]


def _ring_one_frame_off(monkeypatch):
    """One conv ring read one frame off, as a ring pointer one slot out reads
    it: its frames rotated by one.  The ring written back is sound."""
    from microwakeword_tpu_torch.models import layers

    apply = layers.stream_apply

    def off(layer, name, x, cache, new_cache):
        if cache is None or name != RING:
            return apply(layer, name, x, cache, new_cache)
        key = f"{name}/ring"
        ring = cache[key]
        new_cache[key] = torch.cat([ring, x], dim=1)[:, -layer.ring:]
        return layer(torch.cat([ring.roll(1, dims=1), x], dim=1))

    monkeypatch.setattr(layers, "stream_apply", off)


def _branch_dropped(monkeypatch):
    """The first block's 1x1 branch gives zeros to the concatenation."""
    from microwakeword_tpu_torch.models.inception import Inception

    branch = Inception._branch

    def dropped(self, names, x, cache, new_cache):
        y = branch(self, names, x, cache, new_cache)
        return torch.zeros_like(y) if list(names) == BRANCH else y

    monkeypatch.setattr(Inception, "_branch", dropped)


def _tf32_model_stage(monkeypatch):
    """The model stage in TF32 (matmuls and cuDNN convolutions) over the
    exact frontend: the flags are on around each scan, so its graph is
    captured and replayed with them."""
    from microwakeword_tpu_torch.models.registry import ModelBundle

    scan = ModelBundle.stream_scan

    def tf32(self, model, x, cache=None):
        flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            return scan(self, model, x, cache)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags

    monkeypatch.setattr(ModelBundle, "stream_scan", tf32)


@pytest.mark.parametrize("fault", [_probability_altered, _count_altered, _ring_one_frame_off,
                                   _branch_dropped],
                         ids=lambda f: f.__name__[1:])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result = _run(CELL)
    assert result["correct"] is False, result["checks"]


def test_stream_scan_against_reference():
    """Serving weights from a seed, batch 4, a stream three times the tail
    plus every ring's frames, so that each ring wraps and the tail is
    refilled several times over."""
    config = load_cell(CELL).config
    cfg = config["model"]
    first, blocks = ref._units(cfg)
    units = first + [u for b in blocks for branch in b[:3] for u in branch]
    rings = sum((k - 1) * d for _, _, _, k, d, _ in units)
    assert rings == 40
    frames = 3 * (ref.tail_length(cfg) + rings)
    bundle = port_bundle(config)
    state = inputs.weights(ref.state_shapes(cfg), torch.Generator().manual_seed(16), "cpu",
                           serving=True)
    model = bundle.load(state, "cpu")
    x = torch.rand((4, frames, 40), generator=torch.Generator().manual_seed(17)) * 26
    with torch.no_grad():
        got = bundle.stream_scan(model, x)[..., 0]
    want = ref.stream_probs({k: v.double() for k, v in state.items()}, cfg, x)
    assert got.shape == want.shape == (4, frames)
    assert float((got.double() - want).abs().max()) <= 1e-6
    assert float(want.std()) > 1e-3  # the probabilities move: the check is not vacuous


def _trace(annotations, ops, launches) -> Trace:
    return Trace(wall_s=1e-4, units=1, device_ops=list(ops), launches=dict(launches),
                 annotations=list(annotations), host_ops=[], span=(0.0, 100.0))


def test_replay_device_us():
    """Two steps, each holding a replay; the graph's kernels carry the
    correlation of the replay's launch.  A kernel launched in the step
    outside its replay, and one launched outside every span, count nowhere."""
    annotations = [("stream.scan", 0.0, 80.0),
                   ("stream.step", 10.0, 30.0), ("stream.replay", 12.0, 20.0),
                   ("stream.step", 40.0, 60.0), ("stream.replay", 42.0, 50.0)]
    ops = [("g1a", 14.0, 18.0, 1, "kernel"), ("g1b", 18.0, 25.0, 1, "kernel"),
           ("g2a", 44.0, 47.0, 2, "kernel"), ("copy", 47.0, 49.0, 2, "gpu_memcpy"),
           ("step", 30.0, 35.0, 3, "kernel"), ("outside", 85.0, 95.0, 4, "kernel")]
    launches = {1: 13.0, 2: 43.0, 3: 25.0, 4: 85.0}
    read = module("metrics", "replay_device_us").read
    assert read(_trace(annotations, ops, launches)) == pytest.approx((4 + 7 + 3 + 2) / 2)
    eager = [a for a in annotations if a[0] != "stream.replay"]
    assert read(_trace(eager, ops, launches)) is None
    assert read(_trace([], [], {})) is None


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 161, 2**31 + 262, 2**31 + 363])
def test_control_is_not_correct(cuda, seed):
    cell = smaller(load_cell(CELL, seed=seed, seconds=2.0))
    limits = cell.workload["limits"]
    out = readings(cell, cuda)
    assert all(out["program"][k] <= limit for k, limit in limits.items()), out
    assert any(out["control"][k] > limit for k, limit in limits.items()), out


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 161, 2**31 + 262, 2**31 + 363])
def test_tf32_model_stage_is_not_correct(cuda, seed, monkeypatch):
    """At the cell's widths and stream length: the frontend and the counts
    stay within their limits, the probabilities do not."""
    cell = smaller(load_cell(CELL, seed=seed, seconds=2.0))
    _tf32_model_stage(monkeypatch)
    checks = run_cell(cell, cuda, time.perf_counter())["checks"]
    assert checks["feature_mismatch"]["value"] <= checks["feature_mismatch"]["limit"], checks
    assert checks["count_mismatch"]["value"] <= checks["count_mismatch"]["limit"], checks
    assert checks["prob_gap"]["value"] > checks["prob_gap"]["limit"], checks
