"""Unified model API (port of models/registry.py).

A ``ModelBundle`` holds a config and builds the ``nn.Module``; the module's
parameters and BatchNorm buffers are the model's state, and the same module
drives the training and inference forward passes and the streaming step.
Modules stay in eval mode between calls.  The streaming
ring buffers live in an explicit cache dict passed to and returned by
``stream_step``.  The two families, MixedNet and Inception, share the
module interface (``forward(x, dropout)``, ``step``, ``cache_shapes``,
``reset_parameters``, from ``layers.StreamingModel``); ``FAMILIES`` gives
each its module and its count of frames consumed by valid convs.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from microwakeword_tpu_torch.device import resolve_device
from microwakeword_tpu_torch.models import inception, mixednet
from microwakeword_tpu_torch.trace import span

# name -> (config class, module class, input frames the valid convs consume)
FAMILIES = {
    "mixednet": (mixednet.MixedNetConfig, mixednet.MixedNet,
                 mixednet.spectrogram_slices_dropped),
    "inception": (inception.InceptionConfig, inception.Inception,
                  inception.spectrogram_slices_dropped),
}


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    name: str
    config: Any
    stride: int  # streaming input frames per step
    input_features: int = 40

    # ---- construction -------------------------------------------------
    def build(self) -> torch.nn.Module:
        return FAMILIES[self.name][1](self.config, self.input_features)

    def init(self, generator: torch.Generator, device=None) -> torch.nn.Module:
        """A module with Glorot kernels drawn from ``generator`` (on the CPU),
        zero biases and identity BatchNorm, moved to ``device``."""
        model = self.build()
        model.reset_parameters(generator)
        return model.to(resolve_device(device)).eval()

    def load(self, state: dict, device=None) -> torch.nn.Module:
        """A module holding ``state`` (name -> array or tensor, as
        ``models/convert.py`` gives it), on ``device``."""
        model = self.build()
        model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
        return model.to(resolve_device(device)).eval()

    # ---- non-streaming ------------------------------------------------
    def forward(self, model: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
        """[B, T, F] -> [B, 1] probabilities (running BN stats)."""
        return model(x)

    def forward_train(self, model: torch.nn.Module, x: torch.Tensor, dropout=None) -> torch.Tensor:
        """Training forward: [B, T, F] -> [B, 1] probabilities normalised with
        the batch's statistics, which also update the BatchNorm buffers.
        ``dropout`` drives the dropout layer where the family has one
        (Inception): the generator its keep mask is drawn from, or the keep
        mask itself.  The module is back in eval mode when it returns."""
        model.train()
        try:
            return model(x, dropout)
        finally:
            model.eval()

    # ---- streaming ----------------------------------------------------
    def stream_init(self, model: torch.nn.Module, batch_size: int = 1) -> dict:
        """Zero ring buffers for ``batch_size`` independent streams."""
        param = next(model.parameters())
        return {
            key: torch.zeros(shape, dtype=param.dtype, device=param.device)
            for key, shape in model.cache_shapes(batch_size).items()
        }

    def stream_step(self, model: torch.nn.Module, cache: dict,
                    frames: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """[B, stride, F] newest slices -> ([B, 1] probs, new cache)."""
        return model.step(frames, cache)

    @torch.no_grad()
    def stream_scan(self, model: torch.nn.Module, x: torch.Tensor,
                    cache: dict | None = None) -> torch.Tensor:
        """Steps over a [B, T, F] spectrogram; T % stride frames at the end
        are dropped.  Returns [B, T // stride, 1] per-step probabilities.
        Under a torch profiler the scan is a ``stream.scan`` span holding one
        ``stream.step`` per step (``trace.py``)."""
        with span("stream.scan"):
            b, t, _ = x.shape
            steps = t // self.stride
            if cache is None:
                cache = self.stream_init(model, b)
            probs = []
            for i in range(steps):
                with span("stream.step"):
                    p, cache = model.step(x[:, i * self.stride : (i + 1) * self.stride], cache)
                probs.append(p)
            if not probs:
                return x.new_zeros((b, 0, 1))
            return torch.stack(probs, dim=1)

    # ---- static shape info -------------------------------------------
    @property
    def spectrogram_length(self) -> int:
        return self.config.spectrogram_length

    @property
    def slices_dropped(self) -> int:
        return FAMILIES[self.name][2](self.config)


def build_model(name: str, config: Any = None, **overrides) -> ModelBundle:
    """Builds a ModelBundle for 'mixednet' or 'inception'."""
    if name not in FAMILIES:
        raise ValueError(f"unknown model {name!r}; expected 'mixednet' or 'inception'")
    cfg = config or FAMILIES[name][0](**overrides)
    return ModelBundle(name=name, config=cfg, stride=cfg.stride)
