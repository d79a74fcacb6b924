"""Training configuration: derived shapes (port of config.py).

``load_config`` reads the reference's YAML schema (features list, schedules,
metric selection) and ``derive_config`` computes spectrogram_length_final_layer
/ spectrogram_length / training_input_shape from the clip duration, window
step and model stride.  PyYAML is imported only inside ``load_config``, which
only the CLI's ``main`` calls: the card's machine has no PyYAML, and
``chip_smoke.py`` passes a dict to ``derive_config`` instead.
"""

from __future__ import annotations

import dataclasses
import os

from microwakeword_tpu_torch.models.registry import FAMILIES
from microwakeword_tpu_torch.models.presets import derive_lengths


def load_config(path: str, model_config, stride: int | None = None) -> dict:
    """Loads the YAML training config and derives shapes for model_config."""
    import yaml

    with open(path) as f:
        config = yaml.safe_load(f)
    return derive_config(config, model_config, stride)


def derive_config(config: dict, model_config, stride: int | None = None) -> dict:
    """The config dict with spectrogram_length/-_final_layer/stride/
    training_input_shape set and the model config under 'model_config'."""
    config = dict(config)
    config.setdefault("window_step_ms", 20)  # the reference's default
    config["summaries_dir"] = os.path.join(config.get("train_dir", "."), "logs")
    if stride is None:
        stride = getattr(model_config, "stride", 1)
    config["stride"] = stride

    slices_dropped = [f for cls, _, f in FAMILIES.values() if isinstance(model_config, cls)]
    if not slices_dropped:
        raise TypeError(f"unknown model config {type(model_config)}")
    dropped = slices_dropped[0](model_config)

    final, total = derive_lengths(
        int(config["clip_duration_ms"]), int(config["window_step_ms"]), stride, dropped
    )
    config["spectrogram_length_final_layer"] = final
    config["spectrogram_length"] = total
    config["training_input_shape"] = (total, 40)
    config["model_config"] = dataclasses.replace(model_config, spectrogram_length=total)
    return config
