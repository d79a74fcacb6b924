"""Audio feature frontend: 16 kHz PCM -> 40 mel features per hop.

- constants: the frontend's constants and matrices (NumPy)
- plain:     the plain PyTorch frontend, port of microwakeword_tpu/frontend/xla.py
- kernel:    the hand-written CUDA kernel and its wrapper ``frontend_batch``
- gate:      the Q6 tolerance the frontend is held to
"""

from microwakeword_tpu_torch.frontend.constants import (  # noqa: F401
    FEATURE_SCALE,
    NUM_CHANNELS,
    SAMPLE_RATE,
    WINDOW_SAMPLES,
)
from microwakeword_tpu_torch.frontend.kernel import frontend_batch  # noqa: F401
