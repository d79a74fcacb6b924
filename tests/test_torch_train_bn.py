"""The port's train-mode forward against the JAX package's ``forward_train``.

A reduced-width flagship (width 16) and a residual MixedNet, with the same
weights on both sides (the port's Glorot init with randomised biases, BN
scales and BN statistics, moved to the flax layout by ``models/convert.py``):
one train-mode forward on the same input gives the same probabilities and
the same updated ``batch_stats`` to 1e-5 relative.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from microwakeword_tpu.models import build_model as jax_build_model
from microwakeword_tpu.models.mixednet import MixedNetConfig as JaxConfig
from microwakeword_tpu_torch.models import MixedNetConfig, build_model, convert
from microwakeword_tpu_torch.models import layers as L

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
CONFIGS = {
    # the flagship's kernels, first conv k5 s3 and 204 input frames at width 16
    "flagship_w16": dict(
        pointwise_filters=(16, 16, 16, 16), repeat_in_block=(1, 1, 1, 1),
        mixconv_kernel_sizes=((5,), (7, 11), (9, 15), (23,)),
        residual_connection=(False, False, False, False), first_conv_filters=8,
        first_conv_kernel_size=5, stride=3, spectrogram_length=204),
    "residual": dict(
        pointwise_filters=(16, 16), repeat_in_block=(1, 1), mixconv_kernel_sizes=((3,), (5,)),
        residual_connection=(True, True), first_conv_filters=8, first_conv_kernel_size=3,
        stride=1, spectrogram_length=29),
}


@functools.lru_cache(maxsize=None)
def _case(name: str):
    kw = CONFIGS[name]
    jb = jax_build_model("mixednet", JaxConfig(**kw))
    tb = build_model("mixednet", MixedNetConfig(**kw))
    model = tb.init(torch.Generator().manual_seed(1), device="cpu")
    variables = convert.state_to_flax({k: v.numpy() for k, v in model.state_dict().items()})
    rng = np.random.default_rng(1)
    variables["params"] = jax.tree_util.tree_map(  # nonzero biases, BN scales off 1
        lambda a: a + rng.normal(0.0, 0.05, a.shape).astype(np.float32) if a.ndim == 1 else a,
        variables["params"])
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.2, 1.0, a.shape).astype(np.float32), variables["batch_stats"])
    x = rng.uniform(0.0, 20.0, (4, kw["spectrogram_length"], 40)).astype(np.float32)
    return jax.jit(jb.forward_train), jax.jit(jb.forward), variables, tb, x


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_train_matches_jax(name):
    forward_train, _, variables, tb, x = _case(name)
    want, updates = forward_train(variables, x)
    model = tb.load(convert.flax_to_state(variables), device="cpu")
    with torch.no_grad():
        got = tb.forward_train(model, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert not model.training  # back in eval mode
    want_stats = convert.flax_to_state({"batch_stats": jax.tree_util.tree_map(
        np.asarray, updates["batch_stats"])})
    state = model.state_dict()
    assert want_stats and set(want_stats) <= set(state)
    for key, value in want_stats.items():
        np.testing.assert_allclose(state[key].numpy(), value, rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_eval_after_train_forward_uses_updated_stats(name):
    """After the train-mode forward, the inference forward is JAX's forward
    with the updated statistics."""
    forward_train, forward, variables, tb, x = _case(name)
    _, updates = forward_train(variables, x)
    want = forward({"params": variables["params"], "batch_stats": updates["batch_stats"]}, x[:2])
    model = tb.load(convert.flax_to_state(variables), device="cpu")
    with torch.no_grad():
        tb.forward_train(model, torch.from_numpy(x))
        got = tb.forward(model, torch.from_numpy(x[:2]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_batchnorm_train_mode_formula():
    """Statistics over batch and time, flax's fast variance, the biased
    variance in the running update (not BatchNorm1d's unbiased one)."""
    rng = np.random.default_rng(2)
    x = rng.normal(1.5, 2.0, (3, 7, 5)).astype(np.float32)
    bn = L.BatchNorm(5)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, 5).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.normal(0.0, 1.0, 5).astype(np.float32)))
    bn.train()
    y = bn(torch.from_numpy(x)).detach().numpy()
    xd = x.astype(np.float64).reshape(-1, 5)
    mean, var = xd.mean(0), xd.var(0)  # biased
    np.testing.assert_allclose(y.reshape(-1, 5), (xd - mean) / np.sqrt(var + 1e-3)
                               * bn.scale.detach().numpy() + bn.bias.detach().numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bn.mean.numpy(), 0.01 * mean, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(bn.var.numpy(), 0.99 + 0.01 * var, rtol=1e-5, atol=1e-7)
    bn.eval()
    frozen = bn.mean.clone()
    bn(torch.from_numpy(x))
    assert torch.equal(bn.mean, frozen)


def test_masked_taps_get_zero_gradient():
    _, _, variables, tb, x = _case("flagship_w16")
    model = tb.load(convert.flax_to_state(variables), device="cpu")
    tb.forward_train(model, torch.from_numpy(x)).sum().backward()
    for name in ("MixConv_1", "MixConv_2"):
        mix = model.get_submodule(name)
        masked = mix.mask.expand_as(mix.weight) == 0
        assert masked.any()
        assert torch.count_nonzero(mix.weight.grad[masked]) == 0
        assert torch.count_nonzero(mix.weight.grad[~masked]) > 0
