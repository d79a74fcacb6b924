"""The port's MixedNet against the JAX package's, with the same weights.

JAX initialises the variables (BatchNorm statistics randomised from a numpy
seed, so they matter), ``models/convert.py`` moves them into the port, and
the same numpy inputs go through both.  The configs are those of
tests/test_models.py, one parametrised case each.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from microwakeword_tpu.models import build_model as jax_build_model
from microwakeword_tpu.models.mixednet import MixedNetConfig as JaxConfig
from microwakeword_tpu_torch.models import MixedNetConfig, build_model, convert, presets
from microwakeword_tpu_torch.models.mixednet import stream_phase

torch.set_num_threads(2)

BASE = dict(
    pointwise_filters=(16, 16),
    repeat_in_block=(1, 1),
    mixconv_kernel_sizes=((3,), (5,)),
    residual_connection=(False, False),
    first_conv_filters=8,
    first_conv_kernel_size=3,
    stride=1,
    spectrogram_length=29,
)
CONFIGS = {
    "base": {},
    "stride3": {"stride": 3, "spectrogram_length": 33},
    "residual": {"residual_connection": (True, True)},
    "repeat2": {"repeat_in_block": (2, 1), "spectrogram_length": 31},
    "two_kernel_mixconv": {"mixconv_kernel_sizes": ((3, 5), (5, 9)), "spectrogram_length": 33},
    "no_first_conv": {"first_conv_filters": 0, "spectrogram_length": 27},
    "pooled": {"pooled": True},
    "attention_pooled": {"spatial_attention": True, "pooled": True, "max_pool": True},
    "mixconv_bias": {"mixconv_bias": True, "stride": 3, "spectrogram_length": 33},
    "first_conv_k5_s3": {"first_conv_kernel_size": 5, "stride": 3, "spectrogram_length": 34},
}


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _case(name: str):
    """(JAX bundle, flax variables as numpy, port bundle, input [2, 3T, 40])."""
    kw = dict(BASE, **CONFIGS[name])
    jb = jax_build_model("mixednet", JaxConfig(**kw))
    variables = _tree_np(jb.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    variables = {
        "params": jax.tree_util.tree_map(
            lambda a: a + rng.normal(0.0, 0.05, a.shape).astype(np.float32)
            if a.ndim == 1 else a, variables["params"]),  # nonzero biases / BN scale
        "batch_stats": {
            k: {"BatchNorm_0": {
                "mean": rng.normal(0.0, 0.3, v["BatchNorm_0"]["mean"].shape).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, v["BatchNorm_0"]["var"].shape).astype(np.float32),
            }}
            for k, v in variables["batch_stats"].items()
        },
    }
    tb = build_model("mixednet", MixedNetConfig(**kw))
    t, s = kw["spectrogram_length"], kw["stride"]
    x = rng.standard_normal((2, (3 * t // s) * s, 40)).astype(np.float32)
    return jb, variables, tb, x


def _port_model(name: str):
    _, variables, tb, _ = _case(name)
    return tb, tb.load(convert.flax_to_state(variables), device="cpu")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(name):
    jb, variables, _, x = _case(name)
    tb, model = _port_model(name)
    t = tb.spectrogram_length
    want = np.asarray(jb.forward(variables, x[:, -t:]))
    with torch.no_grad():
        got = tb.forward(model, torch.from_numpy(x[:, -t:])).numpy()
    assert got.shape == want.shape == (2, 1)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stream_scan_matches_jax(name):
    jb, variables, _, x = _case(name)
    tb, model = _port_model(name)
    want = np.asarray(jb.stream_scan(variables, x))
    got = tb.stream_scan(model, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, x.shape[1] // tb.stride, 1)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("name", [n for n in CONFIGS if n != "attention_pooled"])
def test_stream_matches_forward(name):
    """Streamed probabilities equal the forward pass over each trailing
    window once the rings are warm (tests/test_models.py:79-88), the window
    shifted by ``stream_phase`` frames where the strided first conv leaves
    frames unused.  Spatial attention streams only the newest frames, so it
    is left out, as in the JAX model."""
    _, _, _, x = _case(name)
    tb, model = _port_model(name)
    t, s = tb.spectrogram_length, tb.stride
    r = stream_phase(tb.config)
    xt = torch.from_numpy(x)
    probs = tb.stream_scan(model, xt)
    steps = x.shape[1] // s
    checked = 0
    for step in range(steps - 1, steps - 5, -1):
        end = (step + 1) * s
        if end + r > x.shape[1]:
            continue
        if end - t < t:
            break
        with torch.no_grad():
            full = tb.forward(model, xt[:, end - t + r : end + r])
        np.testing.assert_allclose(probs[:, step].numpy(), full.numpy(), atol=2e-4)
        checked += 1
    assert checked > 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stream_init_matches_jax_cache(name):
    jb, variables, _, _ = _case(name)
    tb, model = _port_model(name)
    want = {k: tuple(v.shape) for k, v in convert.flatten(jb.stream_init(variables, 3)).items()}
    got = {k: tuple(v.shape) for k, v in tb.stream_init(model, 3).items()}
    assert got == want


@pytest.mark.parametrize("name", list(CONFIGS))
def test_convert_round_trip_is_exact(name):
    _, variables, _, _ = _case(name)
    tb, model = _port_model(name)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    back = convert.state_to_flax(state)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_masked_taps_do_not_change_output():
    jb, variables, tb, x = _case("two_kernel_mixconv")
    t = tb.spectrogram_length
    noisy = jax.tree_util.tree_map(np.copy, variables)
    rng = np.random.default_rng(7)
    for name, leaf in noisy["params"].items():
        if name.startswith("MixConv"):
            k = leaf["kernel"]  # [kmax, 1, C]; group 0 uses its newest k_0 taps
            k[0, :, : k.shape[-1] // 2] = rng.normal(0.0, 1.0, k.shape[-1] // 2)
    model = tb.load(convert.flax_to_state(variables), device="cpu")
    noisy_model = tb.load(convert.flax_to_state(noisy), device="cpu")
    xt = torch.from_numpy(x[:, -t:])
    with torch.no_grad():
        np.testing.assert_array_equal(tb.forward(noisy_model, xt).numpy(),
                                      tb.forward(model, xt).numpy())
    np.testing.assert_allclose(tb.forward(noisy_model, xt).detach().numpy(),
                               np.asarray(jb.forward(noisy, x[:, -t:])), atol=1e-5)


def test_flagship_shapes_and_parameter_count():
    cfg = presets.flagship_config()
    assert cfg.spectrogram_length == 204
    assert stream_phase(cfg) == 1
    tb = build_model("mixednet", cfg)
    model = tb.init(torch.Generator().manual_seed(0), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 25_633
    assert model.cache_shapes(5) == {
        "StreamConv_0/ring": (5, 2, 40),
        "MixConv_0/ring": (5, 4, 32),
        "MixConv_1/ring": (5, 10, 64),
        "MixConv_2/ring": (5, 14, 64),
        "MixConv_3/ring": (5, 22, 64),
        "StreamBuffer_0/ring": (5, 16, 64),
    }


def test_init_is_glorot_per_group():
    """MixConv groups get their own Glorot limit sqrt(6 / (k + k C_g))."""
    tb = build_model("mixednet", presets.flagship_config())
    model = tb.init(torch.Generator().manual_seed(1), device="cpu")
    w = model.MixConv_1.weight.detach()  # kernels (7, 11) over 32 + 32 channels
    assert w[:32, 0, :4].abs().max() == 0  # taps outside the 7-tap group
    for group, k in ((w[:32], 7), (w[32:], 11)):
        limit = np.sqrt(6.0 / (k + k * 32))
        assert 0.9 * limit < group.abs().max() <= limit


def test_inception_waits_for_its_slice():
    with pytest.raises(NotImplementedError):
        build_model("inception")
