"""The CUDA-graph path of ``ModelBundle.stream_scan`` (``models/stream_graph.py``)
where no card is needed:

- on the CPU, and with the module in train mode, the scan runs the eager
  loop: no ``stream.replay`` or ``stream.capture`` span, no graph held;
- ``replays`` engages only for a CUDA input, an eval-mode module and a step;
- the graph key changes when ``p.data`` is rebound (``TrainStep``), when the
  batch, the dtype, the passed cache's rings or a TF32 flag changes, and not
  after an in-place ``add_``.

The graphs themselves run only on the card: ``test_torch_stream_graph_cuda.py``.
"""

import gc
import types
import weakref

import pytest
import torch

from microwakeword_tpu_torch.models import build_model, stream_graph
from microwakeword_tpu_torch.models.mixednet import MixedNetConfig
from microwakeword_tpu_torch.train.loop import TrainStep

torch.set_num_threads(2)

STRIDE = 3
CFG = dict(pointwise_filters=(8, 8), repeat_in_block=(1, 1), mixconv_kernel_sizes=((3,), (5,)),
           residual_connection=(False, False), first_conv_filters=8, first_conv_kernel_size=3,
           stride=STRIDE, spectrogram_length=25)


def _bundle_and_model():
    bundle = build_model("mixednet", MixedNetConfig(**CFG))
    return bundle, bundle.init(torch.Generator().manual_seed(0), "cpu")


def _spans(fn):
    """The names of the port's stream spans that ``fn`` records under the CPU
    profiler, in order."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events() if e.name.startswith("stream.")]


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_cpu_and_train_mode_scan_eagerly(mode):
    bundle, model = _bundle_and_model()
    model.train(mode == "train")
    x = torch.rand((2, 20, 40)) * 20
    names = _spans(lambda: bundle.stream_scan(model, x))
    assert names == ["stream.scan"] + ["stream.step"] * (20 // STRIDE)
    assert stream_graph.graphs(model) == {}


def test_replays_engages_on_cuda_eval_and_a_step():
    _, model = _bundle_and_model()
    on_card = types.SimpleNamespace(is_cuda=True)
    assert stream_graph.replays(model, on_card, 1)
    assert not stream_graph.replays(model, on_card, 0)
    assert not stream_graph.replays(model, torch.zeros((1, 3, 40)), 1)
    model.train()
    assert not stream_graph.replays(model, on_card, 1)


def test_key_holds_what_the_capture_bakes_in():
    bundle, model = _bundle_and_model()
    x = torch.zeros((4, 12, 40))
    spec, pointers = stream_graph.graph_key(model, x, STRIDE)
    assert spec[:5] == (4, STRIDE, 40, torch.float32, torch.device("cpu"))
    assert len(pointers) == len(list(model.parameters())) + len(list(model.buffers()))
    assert stream_graph.graph_key(model, torch.zeros((1, 12, 40)), STRIDE)[0] != spec
    assert stream_graph.graph_key(model, x.double(), STRIDE)[0] != spec
    cache = bundle.stream_init(model, 4)
    assert stream_graph.graph_key(model, x, STRIDE, cache)[0] != spec
    before = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = not before
        assert stream_graph.graph_key(model, x, STRIDE)[0] != spec
    finally:
        torch.backends.cudnn.allow_tf32 = before


def test_key_follows_rebound_data_not_in_place_updates():
    bundle, model = _bundle_and_model()
    x = torch.zeros((4, 12, 40))
    key = stream_graph.graph_key(model, x, STRIDE)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.5)
        model.load_state_dict(model.state_dict())
    assert stream_graph.graph_key(model, x, STRIDE) == key
    step = TrainStep(bundle, model, None, batch_size=4, features_length=25)
    rebound = stream_graph.graph_key(model, x, STRIDE)
    assert rebound[0] == key[0] and rebound[1] != key[1]
    assert rebound[1][0] == step.flat.data_ptr()
    with torch.no_grad():
        step.flat.add_(1.0)
    assert stream_graph.graph_key(model, x, STRIDE) == rebound


def test_graphs_die_with_the_module():
    _, model = _bundle_and_model()
    held = torch.zeros(1)  # stands in for a StepGraph
    stream_graph.graphs(model)["spec"] = held
    gone = weakref.ref(held)
    del held, model
    gc.collect()
    assert gone() is None
