"""Ragged memory-mapped spectrogram store (port of data/ragged_store.py).

Zero-copy random access to variable-length [n_frames_i, 40] uint16
spectrograms, in the JAX package's on-disk layout (directory):

    meta.json     {"version": 1, "dtype": "uint16", "n_features": 40, "count": N}
    data.bin      raw row-major [total_frames, n_features] buffer
    offsets.bin   int64 [N+1] cumulative frame offsets

A whole split uploads to the card as one [total_frames, n_features] array
plus offsets (``data/sampler.py``).
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Iterator

import numpy as np


class RaggedSpectrogramStore:
    """Reader/writer for the ragged spectrogram format."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        self.dtype = np.dtype(self.meta["dtype"])
        self.n_features = int(self.meta["n_features"])
        self.offsets = np.fromfile(os.path.join(path, "offsets.bin"), dtype=np.int64)
        total = int(self.offsets[-1]) if len(self.offsets) else 0
        self.data = np.memmap(
            os.path.join(path, "data.bin"), dtype=self.dtype, mode="r",
            shape=(total, self.n_features),
        )

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, i: int) -> np.ndarray:
        start, end = int(self.offsets[i]), int(self.offsets[i + 1])
        return self.data[start:end]

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self[i]

    @property
    def total_frames(self) -> int:
        return int(self.offsets[-1]) if len(self.offsets) else 0

    @classmethod
    def create(cls, path: str, spectrograms: Iterable[np.ndarray], dtype=np.uint16,
               n_features: int = 40) -> "RaggedSpectrogramStore":
        """Writes a store from an iterable of [n_frames_i, n_features] arrays."""
        os.makedirs(path, exist_ok=True)
        offsets = [0]
        dtype = np.dtype(dtype)
        with open(os.path.join(path, "data.bin"), "wb") as f:
            for spec in spectrograms:
                spec = np.ascontiguousarray(spec, dtype=dtype)
                if spec.ndim != 2 or spec.shape[1] != n_features:
                    raise ValueError(f"expected [n, {n_features}] spectrogram, got {spec.shape}")
                f.write(spec.tobytes())
                offsets.append(offsets[-1] + spec.shape[0])
        np.asarray(offsets, dtype=np.int64).tofile(os.path.join(path, "offsets.bin"))
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"version": 1, "dtype": dtype.name, "n_features": n_features,
                       "count": len(offsets) - 1}, f)
        return cls(path)

    @staticmethod
    def is_store(path: str) -> bool:
        return os.path.isfile(os.path.join(path, "meta.json")) and os.path.isfile(
            os.path.join(path, "data.bin"))


def open_ragged(path: str) -> RaggedSpectrogramStore:
    """Opens a ragged spectrogram directory.  The JAX package also reads the
    reference's mmap_ninja RaggedMmap directories; the port reads them once
    converted (scripts/convert_mmap_ninja.py)."""
    if RaggedSpectrogramStore.is_store(path):
        return RaggedSpectrogramStore(path)
    raise ValueError(
        f"{path} is not a ragged spectrogram store; convert mmap_ninja "
        "directories with scripts/convert_mmap_ninja.py"
    )
