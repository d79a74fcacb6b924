"""The streamed step replayed as a CUDA graph (``ModelBundle.stream_scan``).

A streamed step is the same few dozen small kernels at the same shapes every
step (about 61 for the flagship MixedNet, 216 for Inception), each a few us
on the card; in an eager loop the card waits on the host's dispatch of each
op.  ``StepGraph`` captures one step into a ``torch.cuda.CUDAGraph`` over
static buffers, and ``scan`` then does three things a step on the host: copy
the step's frames into the static input, replay the graph, copy the step's
probability into the call's output.  The graph runs the model's own ops on
the same shapes, so every probability is the eager loop's, bit for bit.

- Static buffers: one input [B, stride, F] and one ring per cache key.
  Inside the graph the step writes its new rings back into them (a copy
  kernel a ring).  A scan first copies its ``cache`` into the rings, or
  zeroes them as ``stream_init`` would.
- What a capture bakes in is its key (``graph_key``): the batch, stride,
  feature width, dtype and device of the input, the rings' keys, shapes and
  dtypes when a cache is passed, the float32 backend flags (TF32, cuDNN's
  deterministic and benchmark modes), and the ``data_ptr()`` of every
  parameter and buffer.  The kernels read the weights where they lie, so an
  in-place change (Adam's flat ``add_``, ``load_state_dict``, BatchNorm
  statistics) shows in the next replay; rebinding ``p.data`` (``TrainStep``
  does) moves a pointer, and a new capture replaces the stale graph.
- Graphs are held per module in a ``WeakKeyDictionary``: they die with the
  module and stay out of its state, its copies and its pickles.
- The buffers and the graph's tensors are made outside inference mode, so
  that a graph captured under ``torch.inference_mode()`` serves a
  ``no_grad`` caller and the reverse.
- A capture runs a few eager warm-up steps on a side stream (cuBLAS's and
  cuDNN's lazy set-up stays out of the graph), then captures on that stream
  in ``thread_local`` mode, so that another thread's CUDA work does not
  break it.  Like every PyTorch capture it registers the default CUDA
  generator, which another thread must not draw from meanwhile (the pool
  refresher augments on the host and draws nothing there).  Neither a
  capture nor a replay waits for the card.

Spans (``trace.py``): ``stream.capture`` around a capture, and
``stream.replay`` around each replay inside its ``stream.step``.
"""

from __future__ import annotations

import itertools
import weakref

import torch

from microwakeword_tpu_torch.trace import span

WARMUP_STEPS = 3

_graphs: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()  # module -> {spec: StepGraph}
_side_streams: dict = {}  # device -> the stream captures run on


def replays(model: torch.nn.Module, x: torch.Tensor, steps: int) -> bool:
    """Whether ``stream_scan`` replays a graph: ``x`` on a CUDA device, the
    module in eval mode, at least one step."""
    return x.is_cuda and not model.training and steps >= 1


def graph_key(model: torch.nn.Module, x: torch.Tensor, stride: int,
              cache: dict | None = None) -> tuple:
    """(spec, pointers) of the graph that scans ``x`` [B, T, F] from
    ``cache``: the spec picks the graph, and a graph whose pointers differ is
    stale."""
    b, _, f = x.shape
    rings = None if cache is None else tuple(
        (k, tuple(v.shape), v.dtype) for k, v in sorted(cache.items()))
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    pointers = tuple(t.data_ptr() for t in itertools.chain(model.parameters(), model.buffers()))
    return (b, stride, f, x.dtype, x.device, rings, flags), pointers


def graphs(model: torch.nn.Module) -> dict:
    """The module's captured graphs, spec -> ``StepGraph``."""
    return _graphs.setdefault(model, {})


def _side_stream(device: torch.device):
    if device not in _side_streams:
        _side_streams[device] = torch.cuda.Stream(device)
    return _side_streams[device]


class StepGraph:
    """One captured streamed step over its static input and rings, which
    take the shapes, dtypes and device of ``frames`` [B, stride, F] and of
    ``rings``."""

    def __init__(self, model: torch.nn.Module, frames: torch.Tensor, rings: dict,
                 pointers: tuple):
        self.pointers = pointers
        device = frames.device
        with torch.inference_mode(False), torch.no_grad():
            self.frames = torch.zeros(frames.shape, dtype=frames.dtype, device=device)
            self.rings = {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
                          for k, v in rings.items()}
            side = _side_stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    self._step(model)
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.prob = self._step(model)
                finally:
                    self.graph.capture_end()
            torch.cuda.current_stream(device).wait_stream(side)

    def _step(self, model: torch.nn.Module) -> torch.Tensor:
        prob, new = model.step(self.frames, self.rings)
        for k, ring in new.items():
            self.rings[k].copy_(ring)
        return prob

    def scan(self, x: torch.Tensor, stride: int, steps: int, cache: dict | None) -> torch.Tensor:
        """[B, steps, 1] probabilities in a fresh tensor, replayed from
        ``cache`` (zeros when None)."""
        for k, ring in self.rings.items():
            if cache is None:
                ring.zero_()
            else:
                ring.copy_(cache[k])
        out = torch.empty((x.shape[0], steps) + tuple(self.prob.shape[1:]),
                          dtype=self.prob.dtype, device=x.device)
        for i in range(steps):
            with span("stream.step"):
                self.frames.copy_(x[:, i * stride : (i + 1) * stride])
                with span("stream.replay"):
                    self.graph.replay()
                out[:, i].copy_(self.prob)
        return out


def scan(bundle, model: torch.nn.Module, x: torch.Tensor, cache: dict | None,
         steps: int) -> torch.Tensor:
    """``bundle.stream_scan`` of ``x`` [B, T, F] on a CUDA device, ``steps``
    >= 1, by the module's graph for its key, captured first where it has
    none or a stale one."""
    spec, pointers = graph_key(model, x, bundle.stride, cache)
    held = graphs(model)
    graph = held.get(spec)
    if graph is None or graph.pointers != pointers:
        held.pop(spec, None)  # a stale graph's pool goes before the new capture
        with span("stream.capture"):
            rings = cache if cache is not None else bundle.stream_init(model, x.shape[0])
            graph = held[spec] = StepGraph(model, x[:, : bundle.stride], rings, pointers)
    return graph.scan(x, bundle.stride, steps, cache)
