"""microwakeword_tpu_torch: the PyTorch/CUDA port of microwakeword_tpu.

It runs the wake-word system on an NVIDIA H100:

- serving: 16 kHz PCM -> micro-frontend features (a hand-written CUDA
  kernel, ``frontend.kernel``) -> the streaming model with ring-buffer
  state (``models``) -> wake probabilities every ``stride`` frames -> moving
  average and cooldown accept counting (``evaluate``);
- training on precomputed spectrograms: the ragged store (``data``) ->
  the corpus on the card and its on-device batch draw (``data.sampler``) ->
  train-mode forward and backward, weighted BCE and flat Adam, validation
  and two-step checkpoint selection (``train``) -> the streamed test ROC,
  driven by the ``model_train_eval`` CLI; on raw audio, the frontend
  kernel runs inside the step (``audio``, ``data.sampler``);
- both model families, MixedNet and Inception (``models``);
- the deployment artifact: ``.mww`` float and full-int8 files (``export``)
  for the C++ streaming runtime, which ``native`` builds from the repo's
  source and binds (``inference.Model.from_native``).

The JAX package ``microwakeword_tpu`` is the reference the port is held
against; this package imports nothing of it (nor of jax/flax/optax) and keeps
its own copies of the constants it needs.  Entry points run on the CUDA card
unless the caller passes ``device="cpu"`` (``device.resolve_device``).
"""

from microwakeword_tpu_torch.device import resolve_device  # noqa: F401

__version__ = "0.1.0"
