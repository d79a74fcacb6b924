"""Serialized deployment programs through ``torch.export`` (``.mwwt``), the
port's counterpart of ``microwakeword_tpu/export/stablehlo.py``.

A trained model becomes three pure programs with the weights inside, saved
by ``torch.export.save`` from the eval-mode module (running BatchNorm
statistics) and written into one zip, the ``.mwwx`` layout:

    meta.json          format version, model, stride, input features,
                       spectrogram length, the ring-buffer cache's names,
                       shapes and dtypes, torch version, export device
    forward.pt2        [b, T, F] spectrogram -> [b, 1] probabilities, with
                       b a ``torch.export.Dim``: one program for any batch
    stream_init.pt2    () -> the zero ring-buffer cache of one stream
    stream_step.pt2    (cache, [1, stride, F]) -> ([1, 1] probs, new cache)

The programs are exported on the CPU, a host step as the JAX exporter's is,
and ``ExportedModel`` moves them to the caller's device when it loads them
(``torch.export.passes.move_to_device_pass``).  Loading needs
``torch.export.load`` and nothing of the port's model code.  An artifact is
read by the torch installation that wrote it.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np
import torch

from microwakeword_tpu_torch.device import resolve_device

FORMAT_VERSION = 1
PROGRAMS = ("forward", "stream_init", "stream_step")
EXPORT_BATCH = 2  # torch.export specialises an example size of 0 or 1


class _Forward(torch.nn.Module):
    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class _StreamInit(torch.nn.Module):
    def __init__(self, shapes: dict):
        super().__init__()
        self.shapes = shapes

    def forward(self) -> dict:
        return {key: torch.zeros(shape) for key, shape in self.shapes.items()}


class _StreamStep(torch.nn.Module):
    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, cache: dict, frames: torch.Tensor):
        return self.model.step(frames, cache)


def _saved(program) -> bytes:
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_streaming(bundle, state: dict, path: str) -> None:
    """Writes ``bundle`` with ``state`` (a state dict) as a ``.mwwt`` zip at
    ``path``.  A MixedNet with spatial attention and no pooling has no
    streaming form and raises ValueError, as the JAX exporter does."""
    cfg = bundle.config
    if getattr(cfg, "spatial_attention", False) and not cfg.pooled:
        raise ValueError("spatial_attention requires pooled=True for streaming")
    model = bundle.load({k: torch.as_tensor(v).cpu() for k, v in state.items()}, "cpu")
    feats = bundle.input_features
    shapes = model.cache_shapes(1)
    x = torch.zeros(EXPORT_BATCH, bundle.spectrogram_length, feats)
    cache = {key: torch.zeros(shape) for key, shape in shapes.items()}
    frames = torch.zeros(1, bundle.stride, feats)
    with torch.no_grad():
        programs = {
            "forward": torch.export.export(
                _Forward(model), (x,), dynamic_shapes=({0: torch.export.Dim("b", min=1)},)),
            "stream_init": torch.export.export(_StreamInit(shapes), ()),
            "stream_step": torch.export.export(_StreamStep(model), (cache, frames)),
        }
    meta = {
        "format_version": FORMAT_VERSION,
        "model": bundle.name,
        "stride": bundle.stride,
        "input_features": feats,
        "spectrogram_length": bundle.spectrogram_length,
        "cache": {key: {"shape": list(shape), "dtype": "float32"} for key, shape in shapes.items()},
        "torch_version": torch.__version__,
        "export_device": "cpu",
    }
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("meta.json", json.dumps(meta, indent=2))
        for name, program in programs.items():
            z.writestr(f"{name}.pt2", _saved(program))


class ExportedModel:
    """A loaded ``.mwwt`` artifact on ``device`` (default the card): pure
    callables, no link back to the exporter.

    ``forward`` takes any batch; ``stream_step`` carries the explicit
    ring-buffer cache dict as ``ModelBundle.stream_step`` does, so
    ``inference.Model`` and ``streaming_model_roc``'s ``stream_fn`` drive it
    unchanged.
    """

    def __init__(self, path: str, device=None):
        self.device = resolve_device(device)
        with zipfile.ZipFile(path) as z:
            self.meta = json.loads(z.read("meta.json"))
            programs = {name: torch.export.load(io.BytesIO(z.read(f"{name}.pt2")))
                        for name in PROGRAMS}
        if self.device.type != "cpu":
            from torch.export.passes import move_to_device_pass

            programs = {name: move_to_device_pass(ep, self.device)
                        for name, ep in programs.items()}
        self._forward, self._stream_init, self._stream_step = (
            programs[name].module() for name in PROGRAMS)
        self.stride = int(self.meta["stride"])
        self.input_features = int(self.meta["input_features"])
        self.spectrogram_length = int(self.meta["spectrogram_length"])
        self._cache_keys = list(self.meta["cache"])

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    @torch.no_grad()
    def forward(self, x) -> torch.Tensor:
        """[b, T, F] spectrogram -> [b, 1] probabilities."""
        return self._forward(self._tensor(x))

    @torch.no_grad()
    def stream_init(self) -> dict:
        return self._stream_init()

    @torch.no_grad()
    def stream_step(self, cache: dict, frames) -> tuple[torch.Tensor, dict]:
        """(cache, [1, stride, F]) -> ([1, 1] probs, new cache)."""
        # the step's input keeps the key order it was exported with
        return self._stream_step({k: cache[k] for k in self._cache_keys}, self._tensor(frames))

    def predict_spectrogram(self, spectrogram) -> np.ndarray:
        """Streams a [T, F] (or [1, T, F]) spectrogram stride frames at a
        time from a zero cache; returns [T // stride] probabilities (the
        reference's inference.py:98-125)."""
        spec = self._tensor(spectrogram)
        if spec.ndim == 2:
            spec = spec[None]
        steps = spec.shape[1] // self.stride
        cache = self.stream_init()
        probs = []
        for i in range(steps):
            p, cache = self.stream_step(cache, spec[:, i * self.stride : (i + 1) * self.stride])
            probs.append(p[0, 0])
        if not probs:
            return np.zeros((0,), np.float32)
        return torch.stack(probs).cpu().numpy()
