"""Layer spans on the profiler's timeline.

``span(name)`` is a ``torch.profiler.record_function`` range while a torch
profiler is recording and a shared null context otherwise, so that an
untraced call pays one flag test and a ``with`` (0.4-0.6 us on a CPU core;
an unguarded ``record_function`` costs about 14 us even with no profiler
running).  A span is a ``user_annotation`` range on Kineto's timeline, the
clock of the device operations in the same trace: a kernel belongs to the
innermost span open when it was launched.  A span's parent is the span that
encloses it on the same host thread; a span opened on a thread that the
traced code started does not reach the trace, so the pool refresher's build
on its worker thread has none.  There is no exporter here: ``train()``'s
``profile_dir`` capture, or any ``torch.profiler.profile`` a caller opens,
writes the trace.  In a trace the number of ranges of one name is that
layer's count (the streamed steps, the train sub-steps).

Spans, by layer:

- train step (``train/loop.py`` ``TrainStep``): ``train.step``, one
  sub-step from the batch draw to Adam, holding ``train.sample`` (the batch
  draw, ``sample_any`` or ``finish_batch``), ``train.forward`` (class
  weights, keep mask, forward, weighted BCE), ``train.backward`` (the
  gradients, their flat vector, the mesh's all-reduce) and ``train.adam``;
  ``train.report``, the reported metrics, once per call after the last
  ``train.step``;
- frontend (``frontend/kernel.py``): ``frontend.batch``, one call of
  ``frontend_batch``, its three launches or the plain CPU path;
- streaming step (``models/registry.py`` ``ModelBundle.stream_scan``):
  ``stream.scan``, the whole scan, holding one ``stream.step`` per step.
  On a CUDA device with the module in eval mode the scan replays a CUDA
  graph of one step (``models/stream_graph.py``; the graph's key is the
  input's batch, stride, feature width, dtype and device, a passed cache's
  ring shapes, the float32 backend flags and the data pointers of the
  parameters and buffers): then each ``stream.step`` holds one
  ``stream.replay``, the graph's launch, and a scan that first captures a
  graph for its key holds one ``stream.capture`` before its steps (warm-up
  steps and the capture);
- accept counting (``evaluate/streaming_eval.py``): ``accept.counts``, one
  call of ``ambient_accept_counts``, the counts brought to the host; on a
  CUDA device each ``roc.count_accepts`` inside it holds one
  ``accept.kernel``, the counting kernel's launch
  (``evaluate/accepts_kernel.py``), which the CPU's loop never opens;
- inference entry (``inference.py`` ``Model``): ``predict.clip``, one
  ``predict_clip`` request, holding ``predict.copy_in`` (the PCM to int16
  and onto the device), ``frontend.batch``, and for ``from_torch`` models
  ``stream.scan`` and ``predict.copy_out`` (the probabilities to the host,
  which waits for the request's queued kernels);
- pool refresh (``data/refresh.py``): ``refresh.swap``, a ready pool
  copied into the corpus, only when a swap happens.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

_NULL = contextlib.nullcontext()

if hasattr(_profiler, "_is_profiler_enabled"):

    def recording() -> bool:
        """Whether a torch profiler is recording (the flag it sets)."""
        return _profiler._is_profiler_enabled

else:  # a torch without the module flag
    recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A ``record_function(name)`` range while a profiler records, else the
    shared null context."""
    return torch.profiler.record_function(name) if recording() else _NULL
