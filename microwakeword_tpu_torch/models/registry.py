"""Unified model API (port of models/registry.py).

A ``ModelBundle`` holds a config and builds the ``nn.Module``; the module's
parameters and BatchNorm buffers are the model's state, and the same module
drives the full-sequence forward pass and the streaming step.  The streaming
ring buffers live in an explicit cache dict passed to and returned by
``stream_step``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from microwakeword_tpu_torch.device import resolve_device
from microwakeword_tpu_torch.models import mixednet


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    name: str
    config: Any
    stride: int  # streaming input frames per step
    input_features: int = 40

    # ---- construction -------------------------------------------------
    def build(self) -> mixednet.MixedNet:
        return mixednet.MixedNet(self.config, self.input_features)

    def init(self, generator: torch.Generator, device=None) -> mixednet.MixedNet:
        """A module with Glorot kernels drawn from ``generator`` (on the CPU),
        zero biases and identity BatchNorm, moved to ``device``."""
        model = self.build()
        model.reset_parameters(generator)
        return model.to(resolve_device(device)).eval()

    def load(self, state: dict, device=None) -> mixednet.MixedNet:
        """A module holding ``state`` (name -> array or tensor, as
        ``models/convert.py`` gives it), on ``device``."""
        model = self.build()
        model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
        return model.to(resolve_device(device)).eval()

    # ---- non-streaming ------------------------------------------------
    def forward(self, model: mixednet.MixedNet, x: torch.Tensor) -> torch.Tensor:
        """[B, T, F] -> [B, 1] probabilities (running BN stats)."""
        return model(x)

    # ---- streaming ----------------------------------------------------
    def stream_init(self, model: mixednet.MixedNet, batch_size: int = 1) -> dict:
        """Zero ring buffers for ``batch_size`` independent streams."""
        param = next(model.parameters())
        return {
            key: torch.zeros(shape, dtype=param.dtype, device=param.device)
            for key, shape in model.cache_shapes(batch_size).items()
        }

    def stream_step(self, model: mixednet.MixedNet, cache: dict,
                    frames: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """[B, stride, F] newest slices -> ([B, 1] probs, new cache)."""
        return model.step(frames, cache)

    @torch.no_grad()
    def stream_scan(self, model: mixednet.MixedNet, x: torch.Tensor,
                    cache: dict | None = None) -> torch.Tensor:
        """Steps over a [B, T, F] spectrogram; T % stride frames at the end
        are dropped.  Returns [B, T // stride, 1] per-step probabilities."""
        b, t, _ = x.shape
        steps = t // self.stride
        if cache is None:
            cache = self.stream_init(model, b)
        probs = []
        for i in range(steps):
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
        return mixednet.spectrogram_slices_dropped(self.config)


def build_model(name: str, config: Any = None, **overrides) -> ModelBundle:
    """Builds a ModelBundle for 'mixednet' ('inception' waits for its slice)."""
    if name == "mixednet":
        cfg = config or mixednet.MixedNetConfig(**overrides)
        return ModelBundle(name=name, config=cfg, stride=cfg.stride)
    if name == "inception":
        raise NotImplementedError("the Inception model is not ported yet")
    raise ValueError(f"unknown model {name!r}; expected 'mixednet' or 'inception'")
