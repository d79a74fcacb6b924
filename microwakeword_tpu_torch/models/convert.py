"""Weights between the JAX package's flax variables and the port's modules.

NumPy only.  The flax side is ``{'params': tree, 'batch_stats': tree}`` with
numpy arrays as leaves; the port's side is a flat state dict
(``"MixConv_0.weight"`` -> array) that ``ModelBundle.load`` takes.  Module
names are the same on both sides (``models/mixednet.py``); what changes is
the layout of each kernel:

  flax                                   port
  StreamConv  kernel [k, in, out]        weight [out, in, k]    (F.conv1d)
  StreamConvTranspose kernel [k, out, in] weight [in, out, k]   (F.conv_transpose1d)
  MixConv     kernel [kmax, 1, C]        weight [C, 1, kmax]    (depthwise)
  PointwiseConv / Dense kernel [in, out] weight [out, in]       (F.linear)
  BatchNorm_i/BatchNorm_0/{scale, bias}  BatchNorm_i.{scale, bias}
  batch_stats .../{mean, var}            BatchNorm_i.{mean, var} (buffers)
  .../SubSpectralNorm_0/BatchNorm_0/*    .../SubSpectralNorm_0.BatchNorm_0.*

``L.BatchNorm`` wraps ``nn.BatchNorm`` in the JAX package, hence the nested
``BatchNorm_i/BatchNorm_0`` on the flax side; ``SubSpectralNorm`` holds a
bare ``nn.BatchNorm``, so its ``BatchNorm_0`` maps one to one.  Both
directions copy values bit for bit.  A stacked population (the JAX
``init_population``'s leaves with a leading [N] axis, the port's
``parallel.population`` stacked state) converts member by member
(``flax_population_to_state``, ``state_to_flax_population``).
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
        if kind in ("StreamConv", "StreamConvTranspose", "MixConv"):
            return "weight", np.array(arr.transpose(2, 1, 0), order="C")
        if kind in ("PointwiseConv", "Dense"):
            return "weight", np.array(arr.T, order="C")
    if leaf in ("bias", "scale", "mean", "var"):
        return leaf, np.array(arr)
    raise ValueError(f"no port mapping for {kind}/{leaf}")


def _to_flax(kind: str, leaf: str, arr: np.ndarray) -> tuple[str, np.ndarray]:
    if leaf == "weight":
        if kind in ("StreamConv", "StreamConvTranspose", "MixConv"):
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
        if kind == "BatchNorm" and not (len(modules) > 1 and _kind(modules[-2]) == "SubSpectralNorm"):
            modules = modules + ["BatchNorm_0"]  # L.BatchNorm's inner nn.BatchNorm
        collection = "batch_stats" if leaf in ("mean", "var") else "params"
        flat[collection]["/".join(modules + [name])] = arr
    return {k: _unflatten(v) for k, v in flat.items() if v}


def flax_population_to_state(stacked: dict) -> dict:
    """Stacked flax ``{'params', 'batch_stats'}`` ([N, ...] leaves) -> the
    port's stacked state dict ([N, ...] arrays)."""
    flat = {c: flatten(stacked[c]) for c in ("params", "batch_stats") if stacked.get(c)}
    n = len(next(iter(flat["params"].values())))
    members = [flax_to_state({c: _unflatten({p: np.asarray(a)[i] for p, a in leaves.items()})
                              for c, leaves in flat.items()}) for i in range(n)]
    return {k: np.stack([m[k] for m in members]) for k in members[0]}


def state_to_flax_population(stacked: dict) -> dict:
    """The port's stacked state dict ([N, ...] arrays or CPU tensors) ->
    stacked flax ``{'params', 'batch_stats'}``."""
    n = len(next(iter(stacked.values())))
    members = [state_to_flax({k: v[i] for k, v in stacked.items()}) for i in range(n)]
    out = {}
    for c in members[0]:
        leaves = [flatten(m[c]) for m in members]
        out[c] = _unflatten({p: np.stack([lv[p] for lv in leaves]) for p in leaves[0]})
    return out
