"""The port's ``torch.export`` artifact (``.mwwt``, ``export/torch_export.py``)
against the live model and the JAX package's ``.mwwx`` (``export/stablehlo.py``).

Weights are the port's, with random BatchNorm statistics, and reach the JAX
package through ``models/convert.state_to_flax``.  The MixConv kernels hold
nonzero taps outside their groups, so the masks, which are non-persistent
buffers, must survive the save and load as constants.

- ``forward`` at batches 1 and 5 equals ``bundle.forward`` to 1e-6 (the
  program is exported at batch 2 with a symbolic batch);
- ``predict_spectrogram`` equals the port's ``stream_scan`` to 1e-6, and
  JAX's ``StableHLOModel.predict_spectrogram`` on the same weights to 1e-5
  (both families);
- ``Model.from_exported(...).predict_clip`` equals
  ``Model.from_torch(...).predict_clip`` on the CPU to 1e-6;
- a process that imports nothing of the port loads the three programs with
  ``torch.export.load`` and reproduces them;
- spatial attention without pooling raises ValueError.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from microwakeword_tpu.export import stablehlo as SH
from microwakeword_tpu.models import build_model as jax_build_model
from microwakeword_tpu.models.inception import InceptionConfig as JaxInceptionConfig
from microwakeword_tpu.models.mixednet import MixedNetConfig as JaxMixedNetConfig
from microwakeword_tpu_torch.export.torch_export import ExportedModel, export_streaming
from microwakeword_tpu_torch.inference import Model
from microwakeword_tpu_torch.models import InceptionConfig, MixedNetConfig, build_model, convert

torch.set_num_threads(2)

CASES = {  # name: (family, config fields)
    "mixednet": ("mixednet", dict(
        pointwise_filters=(16, 16), repeat_in_block=(1, 1), mixconv_kernel_sizes=((5,), (3, 7)),
        residual_connection=(False, True), first_conv_filters=8, first_conv_kernel_size=5,
        stride=3, spectrogram_length=47)),
    "spatial_attention": ("mixednet", dict(
        pointwise_filters=(12,), repeat_in_block=(1,), mixconv_kernel_sizes=((3, 5),),
        residual_connection=(False,), first_conv_filters=8, first_conv_kernel_size=3, stride=1,
        pooled=True, spatial_attention=True, spectrogram_length=30)),
    "inception": ("inception", dict(
        cnn1_filters=(8,), cnn1_kernel_sizes=(3,), cnn1_subspectral_groups=(4,),
        cnn2_filters1=(6,), cnn2_filters2=(8,), cnn2_kernel_sizes=(3,),
        cnn2_subspectral_groups=(2,), cnn2_dilation=(2,), spectrogram_length=24)),
}
JAX_CONFIG = {"mixednet": JaxMixedNetConfig, "inception": JaxInceptionConfig}
PORT_CONFIG = {"mixednet": MixedNetConfig, "inception": InceptionConfig}


@functools.lru_cache(maxsize=None)
def _case(name: str):
    """(port bundle, state, JAX bundle, JAX variables): the port's Glorot
    kernels with noise in the MixConv taps that the group masks drop, and
    random biases and BatchNorm; JAX's variables through
    ``convert.state_to_flax``."""
    family, kw = CASES[name]
    bundle = build_model(family, PORT_CONFIG[family](**kw))
    rng = np.random.default_rng(1)
    state = {}
    for key, value in bundle.init(torch.Generator().manual_seed(1), device="cpu").state_dict().items():
        value = value.numpy()
        if key.endswith("var"):
            value = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        elif key.endswith(("mean", "bias", "scale")) or key.startswith("MixConv"):
            value = value + rng.normal(0.0, 0.1, value.shape).astype(np.float32)
        state[key] = value
    return bundle, state, jax_build_model(family, JAX_CONFIG[family](**kw)), convert.state_to_flax(
        state)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """name -> path of the case's ``.mwwt``."""
    root = tmp_path_factory.mktemp("mwwt")
    out = {}
    for name in CASES:
        bundle, state, _, _ = _case(name)
        out[name] = str(root / f"{name}.mwwt")
        export_streaming(bundle, state, out[name])
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_bundle(artifacts, name):
    bundle, state, _, _ = _case(name)
    model = bundle.load(state, "cpu")
    mixconv = [k for k in state if k.startswith("MixConv") and k.endswith("weight")]
    if mixconv:  # the masks matter: taps outside the groups are nonzero
        assert any(np.count_nonzero(state[k] * (1 - model.get_submodule(k[:-7]).mask.numpy()))
                   for k in mixconv)
    loaded = ExportedModel(artifacts[name], device="cpu")
    assert loaded.meta["model"] == bundle.name and loaded.stride == bundle.stride
    assert loaded.meta["cache"] == {k: {"shape": list(v), "dtype": "float32"}
                                    for k, v in model.cache_shapes(1).items()}
    rng = np.random.default_rng(0)
    for b in (1, 5):
        x = torch.from_numpy(rng.uniform(0, 26, (b, bundle.spectrogram_length, 40))
                             .astype(np.float32))
        got = loaded.forward(x)
        assert got.shape == (b, 1)
        with torch.no_grad():
            np.testing.assert_allclose(got.numpy(), bundle.forward(model, x).numpy(), atol=1e-6)


def _spec(bundle) -> np.ndarray:
    t = bundle.spectrogram_length * 2 + 1
    return np.random.default_rng(1).uniform(0, 26, (t, 40)).astype(np.float32)


@pytest.mark.parametrize("name", list(CASES))
def test_predict_spectrogram_matches_stream_scan(artifacts, name):
    bundle, state, _, _ = _case(name)
    spec = _spec(bundle)
    got = ExportedModel(artifacts[name], device="cpu").predict_spectrogram(spec)
    steps = len(spec) // bundle.stride
    assert got.shape == (steps,)
    want = bundle.stream_scan(bundle.load(state, "cpu"),
                              torch.from_numpy(spec[None, : steps * bundle.stride]))
    np.testing.assert_allclose(got, want.reshape(-1).numpy(), atol=1e-6)


@pytest.mark.parametrize("name", ["mixednet", "inception"])
def test_predict_spectrogram_matches_jax(artifacts, tmp_path, name):
    bundle, _, jb, variables = _case(name)
    jax_path = str(tmp_path / "m.mwwx")
    SH.export_streaming(jb, variables, jax_path, platforms=("cpu",))
    spec = _spec(bundle)
    np.testing.assert_allclose(ExportedModel(artifacts[name], device="cpu").predict_spectrogram(spec),
                               SH.StableHLOModel(jax_path).predict_spectrogram(spec), atol=1e-5)


@pytest.mark.parametrize("name", ["mixednet", "inception"])
def test_model_from_exported_matches_from_torch(artifacts, name):
    bundle, state, _, _ = _case(name)
    step_ms = 20 if name == "inception" else 10
    pcm = np.random.default_rng(2).integers(-8000, 8000, 12000).astype(np.int16)
    got = Model.from_exported(artifacts[name], device="cpu").predict_clip(pcm, step_ms)
    want = Model.from_torch(bundle, state, device="cpu").predict_clip(pcm, step_ms)
    assert got.shape == want.shape and len(got) > 0
    np.testing.assert_allclose(got, want, atol=1e-6)


_ALONE = """
import io, json, sys, zipfile
import torch
torch.set_num_threads(2)
path, x_path = sys.argv[1], sys.argv[2]
with zipfile.ZipFile(path) as z:
    meta = json.loads(z.read("meta.json"))
    prog = {n: torch.export.load(io.BytesIO(z.read(n + ".pt2"))).module()
            for n in ("forward", "stream_init", "stream_step")}
x = torch.load(x_path)
cache = prog["stream_init"]()
probs = []
for i in range(x.shape[1] // meta["stride"]):
    p, cache = prog["stream_step"](cache, x[:, i * meta["stride"] : (i + 1) * meta["stride"]])
    probs.append(float(p[0, 0]))
window = x[:, : meta["spectrogram_length"]].expand(3, -1, -1)
print(json.dumps({"forward": prog["forward"](window)[:, 0].tolist(), "stream": probs,
                  "port": [m for m in sys.modules if m.startswith("microwakeword")]}))
"""


def test_loads_without_the_port(artifacts, tmp_path):
    bundle, state, _, _ = _case("mixednet")
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 26, (1, 60, 40)).astype(np.float32))
    torch.save(x, tmp_path / "x.pt")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _ALONE, artifacts["mixednet"],
                          str(tmp_path / "x.pt")], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["port"] == []
    model = bundle.load(state, "cpu")
    with torch.no_grad():
        want = bundle.forward(model, x[:, : bundle.spectrogram_length])[0, 0]
    np.testing.assert_allclose(got["forward"], [float(want)] * 3, atol=1e-6)
    np.testing.assert_allclose(got["stream"], bundle.stream_scan(model, x).reshape(-1).numpy(),
                               atol=1e-6)


def test_spatial_attention_without_pooling_raises(tmp_path):
    _, state, _, _ = _case("spatial_attention")
    flat = build_model("mixednet", MixedNetConfig(**dict(CASES["spatial_attention"][1],
                                                         pooled=False)))
    with pytest.raises(ValueError, match="pooled=True"):
        export_streaming(flat, state, str(tmp_path / "attn.mwwt"))
    assert not (tmp_path / "attn.mwwt").exists()
