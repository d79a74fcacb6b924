"""ESPHome micro_wake_word model manifest generation (port of
``microwakeword_tpu/export/manifest.py``; NumPy and json only).

The reference stops at the .tflite file and tells the user to hand-write
the deployment manifest (notebooks/basic_training_notebook.ipynb: "you
need to write a model manifest JSON file", pointing at the
esphome/micro-wake-word-models repo for examples).  We close that gap:
given the streamed-ROC result we already compute, pick an operating
cutoff at a target false-accepts-per-hour and emit the complete manifest
v2 JSON next to the exported model, ready to serve to ESPHome.

Manifest v2 schema (micro-wake-word-models/models/v2/*.json):
    type, wake_word, author, website, model (tflite filename),
    trained_languages, version, micro: {probability_cutoff,
    sliding_window_size, feature_step_size, tensor_arena_size,
    minimum_esphome_version}
"""

from __future__ import annotations

import json
import os

import numpy as np

MINIMUM_ESPHOME_VERSION = "2024.7.0"


def recommended_cutoff(roc_result: dict, target_faph: float = 0.5) -> float:
    """Smallest probability cutoff whose measured ambient FAPH is at or
    below ``target_faph`` (lower cutoffs catch more true positives, so we
    want the least strict cutoff that still meets the FAH budget).

    ``roc_result`` is the dict returned by
    evaluate.streaming_eval.streaming_model_roc: ``faph_at_cutoffs`` is indexed by the
    0..1 step-0.01 cutoff grid (reference test.py:343-346).  Falls back
    to the strictest cutoff if no cutoff meets the target.
    """
    faph = np.asarray(roc_result["faph_at_cutoffs"], np.float64)
    n = len(faph)
    cutoffs = np.arange(n) / (n - 1) if n > 1 else np.asarray([0.5])
    ok = np.nonzero(faph <= target_faph)[0]
    if len(ok) == 0:
        return float(cutoffs[-1])
    return float(cutoffs[ok[0]])


def estimate_tensor_arena_size(tflite_path: str, headroom: float = 0.25) -> int:
    """TFLM tensor-arena estimate for the manifest.

    The true arena requirement is only known by running the TFLM memory
    planner on-target; published v2 manifests sit near the model's flatbuffer
    size plus scratch headroom (e.g. okay_nabu: 22,860 B arena for a ~19 kB
    model).  We report size*(1+headroom) rounded up to 1 KiB -- a safe
    starting point the user can shrink after an on-device check.
    """
    size = os.path.getsize(tflite_path)
    est = int(size * (1.0 + headroom))
    return ((est + 1023) // 1024) * 1024


def write_manifest(
    tflite_path: str,
    wake_word: str,
    probability_cutoff: float,
    sliding_window_size: int = 5,
    feature_step_size: int = 10,
    tensor_arena_size: int | None = None,
    author: str = "",
    website: str = "",
    trained_languages: tuple[str, ...] = ("en",),
    manifest_path: str | None = None,
) -> str:
    """Writes the ESPHome manifest v2 JSON next to ``tflite_path``.

    Returns the manifest path.  ``feature_step_size`` is the frontend hop in
    ms (config ``window_step_ms``); ``sliding_window_size`` is the
    probability moving-average width used during evaluation (reference
    test.py:337-341 uses 5 -- the manifest must match so on-device
    behavior reproduces the measured ROC point).
    """
    if manifest_path is None:
        manifest_path = os.path.join(
            os.path.dirname(tflite_path) or ".", wake_word.replace(" ", "_") + ".json"
        )
    if tensor_arena_size is None:
        tensor_arena_size = estimate_tensor_arena_size(tflite_path)
    manifest = {
        "type": "micro",
        "wake_word": wake_word,
        "author": author,
        "website": website,
        "model": os.path.basename(tflite_path),
        "trained_languages": list(trained_languages),
        "version": 2,
        "micro": {
            "probability_cutoff": round(float(probability_cutoff), 2),
            "sliding_window_size": int(sliding_window_size),
            "feature_step_size": int(feature_step_size),
            "tensor_arena_size": int(tensor_arena_size),
            "minimum_esphome_version": MINIMUM_ESPHOME_VERSION,
        },
    }
    with open(manifest_path, "w") as f:
        json.dump(manifest, f, indent=2)
        f.write("\n")
    return manifest_path
