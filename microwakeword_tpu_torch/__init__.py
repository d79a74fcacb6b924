"""microwakeword_tpu_torch: the PyTorch/CUDA port of microwakeword_tpu.

It runs the serving path of the wake-word system on an NVIDIA H100:

  16 kHz PCM -> micro-frontend features (a hand-written CUDA kernel,
  ``frontend.kernel``) -> the streaming MixedNet with ring-buffer state
  (``models``) -> wake probabilities every ``stride`` frames -> moving
  average and cooldown accept counting (``evaluate``).

The JAX package ``microwakeword_tpu`` is the reference the port is held
against; this package imports nothing of it (nor of jax/flax/optax) and keeps
its own copies of the constants it needs.  Entry points run on the CUDA card
unless the caller passes ``device="cpu"`` (``device.resolve_device``).
"""

from microwakeword_tpu_torch.device import resolve_device  # noqa: F401

__version__ = "0.1.0"
