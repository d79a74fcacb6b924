"""Model presets and config-derivation math (port of models/presets.py).

``derive_lengths``: spectrogram_length_final_layer =
1 + (16*clip_ms - 480) // (stride*16*step_ms), and the model input length
adds the slices consumed by valid padding.  ``flagship_config`` is the
published okay_nabu-style MixedNet: 64x4 filters, kernels [5],[7,11],[9,15],
[23], first conv 32 filters k5 s3 (204 input frames at 1.5 s / 10 ms).
``default_inception_config`` is the Inception family's defaults at 1.5 s /
20 ms hops: 102 input frames, 28 of them consumed by the valid convs.
"""

from __future__ import annotations

from microwakeword_tpu_torch.models import inception as I
from microwakeword_tpu_torch.models import mixednet as MX

SAMPLE_RATE = 16000
WINDOW_SIZE_MS = 30


def derive_lengths(clip_duration_ms: int, window_step_ms: int, stride: int,
                   slices_dropped: int) -> tuple[int, int]:
    """Returns (spectrogram_length_final_layer, spectrogram_length)."""
    desired_samples = SAMPLE_RATE * clip_duration_ms // 1000
    window_size_samples = SAMPLE_RATE * WINDOW_SIZE_MS // 1000
    window_step_samples = stride * SAMPLE_RATE * window_step_ms // 1000
    length_minus_window = desired_samples - window_size_samples
    if length_minus_window < 0:
        final = 0
    else:
        final = 1 + length_minus_window // window_step_samples
    return final, final + slices_dropped


def flagship_config(clip_duration_ms: int = 1500, window_step_ms: int = 10):
    """The okay_nabu-style production MixedNet recipe."""
    kw = dict(
        pointwise_filters=(64, 64, 64, 64),
        repeat_in_block=(1, 1, 1, 1),
        mixconv_kernel_sizes=((5,), (7, 11), (9, 15), (23,)),
        residual_connection=(False, False, False, False),
        first_conv_filters=32,
        first_conv_kernel_size=5,
        stride=3,
    )
    probe = MX.MixedNetConfig(spectrogram_length=10_000, **kw)
    dropped = MX.spectrogram_slices_dropped(probe)
    _, spectrogram_length = derive_lengths(
        clip_duration_ms, window_step_ms, kw["stride"], dropped
    )
    return MX.MixedNetConfig(spectrogram_length=spectrogram_length, **kw)


def default_inception_config(clip_duration_ms: int = 1500, window_step_ms: int = 20):
    """The Inception defaults with the input length of the clip and hop."""
    dropped = I.spectrogram_slices_dropped(I.InceptionConfig())
    _, spectrogram_length = derive_lengths(clip_duration_ms, window_step_ms, 1, dropped)
    return I.InceptionConfig(spectrogram_length=spectrogram_length)
