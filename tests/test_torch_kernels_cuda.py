"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and skip without one; the kernels have no CPU
mode.  The file imports only the port, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from microwakeword_tpu_torch.frontend import gate, kernel, plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "step_ms,shape,dtype",
    [
        (10, (3, 48480), np.int16),  # multi-tile, ragged last tile
        (20, (3, 48480), np.int16),
        (10, (2, 480 + 160 * 40 + 77), np.int16),  # N not a whole number of hops
        (10, (2, 300), np.int16),  # N < 480: no frames, no launch
        (10, (2, 8000), np.float32),
    ],
)
def test_frontend_kernel_matches_plain(cuda, step_ms, shape, dtype):
    rng = np.random.default_rng(6)
    if dtype == np.int16:
        audio = rng.integers(-25000, 25000, shape).astype(np.int16)
    else:
        audio = rng.uniform(-0.9, 0.9, shape).astype(np.float32)
    x = torch.from_numpy(audio).to(cuda)
    before = kernel.frontend_batch.launches
    got = kernel.frontend_batch(x, step_ms=step_ms)
    torch.cuda.synchronize()
    assert kernel.frontend_batch.launches == before + (2 if got.shape[1] else 0)
    want = plain.frontend_batch(x, step_ms=step_ms)
    gate.assert_q6_gate(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_frontend_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros((2, 1000), dtype=torch.int16, device=cuda)
    with pytest.raises(TypeError):
        kernel.frontend_batch(x.double())
    with pytest.raises(ValueError):
        kernel.frontend_batch(x[:, ::2])  # not contiguous
    with pytest.raises(ValueError):
        kernel.frontend_batch(x[0])  # not [B, N]
