"""Dataset-build CLI: audio clips -> augmented spectrogram ragged stores (port
of ``microwakeword_tpu/build_dataset.py``).

    python -m microwakeword_tpu_torch.build_dataset --config dataset.yaml [--device cpu]

The YAML schema is the JAX CLI's (one document per feature dir):

    output_dir: features/wakeword        # -> output_dir/<mode>/<name>_mmap
    name: wakeword
    clips:                               # audio/clips.py Clips(**...)
      input_directory: generated_samples
      file_pattern: "*.wav"
      random_split_seed: 10
      split_count: 0.1
    augmentation:                        # audio/augmentation.py (optional)
      augmentation_duration_s: 3.2
      augmentation_probabilities: {Gain: 1.0}
    spectrogram_generation:              # audio/spectrograms.py (optional)
      step_ms: 10
      slide_frames: 10
    splits:                              # which Clips split feeds which mode
      training:   {split: train, repeat: 2}
      testing:    {split: test}
      validation: {split: validation}

Ambient stores (long recordings, no splitting or augmentation) use
``splits: {testing_ambient: {split: null}}`` with a separate clips dir and
typically ``spectrogram_generation: {split_spectrogram_duration_s: ...}``.

Spectrograms come from the port's frontend on ``--device`` (default cuda:
the frontend kernel), 32 clips per call.  ``main`` reads the YAML;
``build_feature_dir`` takes the dict and needs no PyYAML.
"""

from __future__ import annotations

import argparse
import os
import sys

from microwakeword_tpu_torch.audio.augmentation import Augmentation
from microwakeword_tpu_torch.audio.clips import Clips
from microwakeword_tpu_torch.audio.spectrograms import SpectrogramGeneration
from microwakeword_tpu_torch.data.ragged_store import RaggedSpectrogramStore
from microwakeword_tpu_torch.device import resolve_device


def build_feature_dir(config: dict, device=None, log=print) -> dict:
    """Builds every split store of one feature-dir config with the frontend
    on ``device`` (None: the card); returns {mode: (count, total_frames)}."""
    dev = resolve_device(device)
    clips = Clips(**config["clips"])
    augmenter = Augmentation(**config["augmentation"]) if config.get("augmentation") else None
    sg = SpectrogramGeneration(clips, augmenter, **(config.get("spectrogram_generation") or {}),
                               device=dev)
    name = config.get("name", "features")
    results = {}
    for mode, split_cfg in config["splits"].items():
        split_cfg = split_cfg or {}
        gen = clips.audio_generator(split=split_cfg.get("split"),
                                    repeat=int(split_cfg.get("repeat", 1)))
        if augmenter is not None:
            gen = augmenter.augment_generator(gen)
        path = os.path.join(config["output_dir"], mode, f"{name}_mmap")
        store = RaggedSpectrogramStore.create(path, sg.batched_spectrograms(gen, dev))
        results[mode] = (len(store), store.total_frames)
        log(f"  {mode}: {len(store)} spectrograms, {store.total_frames} frames -> {path}")
    return results


def main(argv=None) -> int:
    import yaml

    ap = argparse.ArgumentParser(description="Build spectrogram ragged stores from audio clips.")
    ap.add_argument("--config", required=True,
                    help="dataset YAML (one or more documents, each one feature dir)")
    ap.add_argument("--device", default="cuda",
                    help="the device of the frontend: cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)  # no card: raise before reading anything
    with open(args.config) as f:
        docs = [d for d in yaml.safe_load_all(f) if d]
    if not docs:
        print("empty config", file=sys.stderr)
        return 1
    for doc in docs:
        print(f"building {doc.get('output_dir')}:")
        build_feature_dir(doc, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
