"""``ModelBundle.stream_scan``'s CUDA graph (``models/stream_graph.py``)
against the eager loop of ``model.step``, on the card, with TF32 off.  Every
comparison is ``torch.equal``: the graph replays the model's own ops.

- both families (the flagship MixedNet, Inception's defaults) at batch 1 and
  64, over 1, 32 and 332 steps, captured and then replayed again;
- a passed-in cache, which the scan leaves as it was;
- weights changed in place after a capture, which the replay sees;
- a ``TrainStep`` built on the module after a capture: its rebound
  parameters retire the stale graph;
- one key used under ``torch.inference_mode()`` and then under ``no_grad``;
- a capture while a torch profiler records: one ``stream.replay`` per
  ``stream.step``, one ``stream.capture``;
- a capture while another thread launches CUDA work;
- a replayed scan makes no host sync.

These tests need an NVIDIA GPU and skip without one.  The file imports only
the port, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_stream_graph_cuda.py
"""

import threading

import pytest
import torch

from microwakeword_tpu_torch.models import build_model, presets, stream_graph
from microwakeword_tpu_torch.train.loop import TrainStep

CONFIGS = {"mixednet": presets.flagship_config, "inception": presets.default_inception_config}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _model(family: str, dev, seed: int = 0):
    """The family's bundle and an eval-mode module with Glorot weights and
    drawn BatchNorm statistics, so that the probabilities spread."""
    bundle = build_model(family, CONFIGS[family]())
    model = bundle.init(torch.Generator().manual_seed(seed), dev)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith(".mean"):
                buf.copy_(0.2 * torch.randn(buf.shape, generator=gen))
            elif name.endswith(".var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))
    return bundle, model


def _spectrogram(bundle, batch: int, steps: int, dev, seed: int = 2) -> torch.Tensor:
    """[batch, frames, 40] features in [0, 26) for ``steps`` steps, with the
    frames short of a last step that the scan drops."""
    gen = torch.Generator().manual_seed(seed)
    frames = (steps + 1) * bundle.stride - 1
    return (26.0 * torch.rand((batch, frames, 40), generator=gen)).to(dev)


@torch.no_grad()
def _eager(bundle, model, x, cache=None) -> torch.Tensor:
    """The eager loop that ``stream_scan`` runs off the card."""
    s = bundle.stride
    cache = bundle.stream_init(model, x.shape[0]) if cache is None else cache
    probs = []
    for i in range(x.shape[1] // s):
        p, cache = model.step(x[:, i * s : (i + 1) * s], cache)
        probs.append(p)
    return torch.stack(probs, dim=1)


def _held(model) -> list:
    return list(stream_graph.graphs(model).values())


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 32, 332])
@pytest.mark.parametrize("batch", [1, 64])
@pytest.mark.parametrize("family", ["mixednet", "inception"])
def test_graph_scan_equals_eager(cuda, family, batch, steps):
    bundle, model = _model(family, cuda)
    x = _spectrogram(bundle, batch, steps, cuda)
    want = _eager(bundle, model, x)
    captured = bundle.stream_scan(model, x)
    replayed = bundle.stream_scan(model, x)
    assert len(_held(model)) == 1
    assert captured.shape == (batch, steps, 1)
    assert torch.equal(captured, want) and torch.equal(replayed, want)
    assert captured.data_ptr() != replayed.data_ptr()  # a fresh output each call


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["mixednet", "inception"])
def test_passed_cache(cuda, family):
    bundle, model = _model(family, cuda)
    x = _spectrogram(bundle, 64, 32, cuda)
    gen = torch.Generator().manual_seed(5)
    cache = {k: torch.randn(v.shape, generator=gen).to(cuda)
             for k, v in bundle.stream_init(model, 64).items()}
    kept = {k: v.clone() for k, v in cache.items()}
    want = _eager(bundle, model, x, cache)
    for _ in range(2):
        assert torch.equal(bundle.stream_scan(model, x, cache), want)
    assert all(torch.equal(cache[k], kept[k]) for k in cache)
    zeros = bundle.stream_scan(model, x)  # its own graph, rings zeroed
    assert torch.equal(zeros, _eager(bundle, model, x)) and not torch.equal(zeros, want)
    assert len(_held(model)) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["mixednet", "inception"])
def test_in_place_weight_change_is_seen(cuda, family):
    bundle, model = _model(family, cuda)
    x = _spectrogram(bundle, 64, 32, cuda)
    before = bundle.stream_scan(model, x)
    graph = _held(model)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1.05)
        for name, buf in model.named_buffers():
            if name.endswith(".mean"):
                buf.add_(0.01)
    after = bundle.stream_scan(model, x)
    assert _held(model) == graph  # replayed, not captured again
    assert torch.equal(after, _eager(bundle, model, x)) and not torch.equal(after, before)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["mixednet", "inception"])
def test_train_step_after_capture_retires_the_graph(cuda, family):
    bundle, model = _model(family, cuda)
    x = _spectrogram(bundle, 64, 32, cuda)
    bundle.stream_scan(model, x)
    stale = _held(model)
    step = TrainStep(bundle, model, None, batch_size=8,
                     features_length=bundle.spectrogram_length)
    with torch.no_grad():
        step.flat.add_(0.01 * torch.randn(step.flat.shape, generator=torch.Generator()
                                          .manual_seed(3)).to(cuda))
    got = bundle.stream_scan(model, x)
    assert torch.equal(got, _eager(bundle, model, x))
    fresh = _held(model)
    assert len(fresh) == 1 and fresh[0] is not stale[0]
    assert fresh[0].pointers[0] == step.flat.data_ptr()


@pytest.mark.cuda
def test_inference_mode_then_no_grad(cuda):
    bundle, model = _model("mixednet", cuda)
    with torch.inference_mode():
        x = _spectrogram(bundle, 1, 99, cuda)
        first = bundle.stream_scan(model, x)
    graph = _held(model)
    plain = x.clone()  # an ordinary tensor, as a no_grad caller holds
    with torch.no_grad():
        second = bundle.stream_scan(model, plain)
    with torch.inference_mode():
        third = bundle.stream_scan(model, x)
    assert _held(model) == graph
    want = _eager(bundle, model, plain)
    assert torch.equal(first, want) and torch.equal(second, want) and torch.equal(third, want)


def _cpu_spans(prof) -> list:
    return [e.name for e in prof.events()
            if e.name.startswith("stream.") and e.device_type == torch.autograd.DeviceType.CPU]


@pytest.mark.cuda
def test_capture_under_profiler(cuda):
    bundle, model = _model("mixednet", cuda)
    x = _spectrogram(bundle, 64, 32, cuda)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for capture in (True, False):
        with torch.profiler.profile(activities=acts) as prof:
            got = bundle.stream_scan(model, x)
            torch.cuda.synchronize()
        names = _cpu_spans(prof)
        assert names.count("stream.scan") == 1
        assert names.count("stream.capture") == int(capture)
        assert names.count("stream.step") == names.count("stream.replay") == 32
        assert torch.equal(got, _eager(bundle, model, x))


@pytest.mark.cuda
def test_capture_while_another_thread_launches(cuda):
    bundle, model = _model("inception", cuda)
    x = _spectrogram(bundle, 64, 32, cuda)
    want = _eager(bundle, model, x)
    started, stop, errors = threading.Event(), threading.Event(), []

    def busy():
        """Allocations of new sizes, draws from a generator of its own,
        matmuls and syncs on this thread's stream.  (A capture registers the
        default CUDA generator, as every PyTorch capture does: a draw from it
        on another thread during the capture raises.)"""
        try:
            gen = torch.Generator(device=cuda).manual_seed(7)
            i = 0
            while not stop.is_set():
                n = 256 + 64 * (i % 16)
                y = torch.rand((n, n), generator=gen, device=cuda)
                float((y @ y).sum())
                started.set()
                i += 1
        except Exception as err:  # the test's thread reports it
            errors.append(err)
            started.set()

    thread = threading.Thread(target=busy)
    thread.start()
    try:
        started.wait(60)
        got = bundle.stream_scan(model, x)
        torch.cuda.synchronize()
    finally:
        stop.set()
        thread.join()
    assert not errors
    assert len(_held(model)) == 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_replayed_scan_makes_no_host_sync(cuda):
    bundle, model = _model("mixednet", cuda)
    x = _spectrogram(bundle, 64, 32, cuda)
    bundle.stream_scan(model, x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = bundle.stream_scan(model, x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, _eager(bundle, model, x))
