"""Weights between the JAX package's flax variables and the port's modules.

NumPy only.  The flax side is ``{'params': tree, 'batch_stats': tree}`` with
numpy arrays as leaves; the port's side is a flat state dict
(``"MixConv_0.weight"`` -> array) that ``ModelBundle.load`` takes.  Module
names are the same on both sides (``models/mixednet.py``); what changes is
the layout of each kernel:

  flax                                   port
  StreamConv  kernel [k, in, out]        weight [out, in, k]    (F.conv1d)
  MixConv     kernel [kmax, 1, C]        weight [C, 1, kmax]    (depthwise)
  PointwiseConv / Dense kernel [in, out] weight [out, in]       (F.linear)
  BatchNorm_i/BatchNorm_0/{scale, bias}  BatchNorm_i.{scale, bias}
  batch_stats .../{mean, var}            BatchNorm_i.{mean, var} (buffers)

``L.BatchNorm`` wraps ``nn.BatchNorm`` in the JAX package, hence the nested
``BatchNorm_i/BatchNorm_0`` on the flax side.  Both directions copy values
bit for bit.
"""

from __future__ import annotations

import numpy as np


def flatten(tree: dict, sep: str = "/", prefix: str = "") -> dict:
    """Nested dict -> {"a/b/c": leaf}."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{sep}{key}" if prefix else str(key)
        if hasattr(value, "items"):
            flat.update(flatten(value, sep, path))
        else:
            flat[path] = value
    return flat


def _unflatten(flat: dict, sep: str = "/") -> dict:
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split(sep)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _kind(module_name: str) -> str:
    return module_name.rsplit("_", 1)[0]


def _to_port(kind: str, leaf: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    if leaf == "kernel":
        if kind in ("StreamConv", "MixConv"):
            return "weight", np.array(arr.transpose(2, 1, 0), order="C")
        if kind in ("PointwiseConv", "Dense"):
            return "weight", np.array(arr.T, order="C")
    if leaf in ("bias", "scale", "mean", "var"):
        return leaf, np.array(arr)
    raise ValueError(f"no port mapping for {kind}/{leaf}")


def _to_flax(kind: str, leaf: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    if leaf == "weight":
        if kind in ("StreamConv", "MixConv"):
            return "kernel", np.array(arr.transpose(2, 1, 0), order="C")
        if kind in ("PointwiseConv", "Dense"):
            return "kernel", np.array(arr.T, order="C")
    if leaf in ("bias", "scale", "mean", "var"):
        return leaf, np.array(arr)
    raise ValueError(f"no flax mapping for {kind}/{leaf}")


def flax_to_state(variables: dict) -> dict:
    """flax ``{'params', 'batch_stats'}`` (numpy leaves) -> port state dict."""
    state = {}
    for collection in ("params", "batch_stats"):
        for path, arr in flatten(variables.get(collection, {})).items():
            *modules, leaf = path.split("/")
            if len(modules) >= 2 and all(_kind(m) == "BatchNorm" for m in modules[-2:]):
                modules = modules[:-1]  # L.BatchNorm's inner nn.BatchNorm
            name, value = _to_port(_kind(modules[-1]), leaf, np.asarray(arr))
            state[".".join(modules + [name])] = value
    return state


def state_to_flax(state: dict) -> dict:
    """Port state dict (arrays or CPU tensors) -> flax ``{'params', 'batch_stats'}``."""
    flat = {"params": {}, "batch_stats": {}}
    for key, value in state.items():
        *modules, leaf = key.split(".")
        kind = _kind(modules[-1])
        arr = value.numpy() if hasattr(value, "numpy") else np.asarray(value)
        name, arr = _to_flax(kind, leaf, arr)
        if kind == "BatchNorm":
            modules = modules + ["BatchNorm_0"]
        collection = "batch_stats" if leaf in ("mean", "var") else "params"
        flat[collection]["/".join(modules + [name])] = arr
    return {k: _unflatten(v) for k, v in flat.items() if v}
