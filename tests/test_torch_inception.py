"""The port's Inception family and its layers against the JAX package's.

- Delay, SubSpectralNorm, StreamAveragePooling and StreamConvTranspose
  against their JAX twins: the non-streaming op, the streamed steps, the
  SubSpectralNorm in train mode (output and both running statistics) at
  g in {1, 2, 4}, and the transposed conv's kernel < stride error;
- Inception at the small config of tests/test_native_runtime.py, weights
  carried by ``models/convert.py``: ``forward`` (atol 1e-5), ``stream_scan``
  (atol 2e-4), ``forward_train`` with JAX's own dropout mask (rtol 1e-5) and
  the BatchNorm statistics it updates;
- the torch dropout draw: keep rate, 1 / keep scaling, the generator;
- the JAX train step against the port's on the same weights, batches and
  dropout masks (step-0 loss rtol 1e-5);
- the default preset's shapes and parameter count, and the converter's
  round trip for both families.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microwakeword_tpu.data.host_stream import HostStreamedData
from microwakeword_tpu.models import build_model as jax_build_model
from microwakeword_tpu.models import layers as JL
from microwakeword_tpu.models import presets as jax_presets
from microwakeword_tpu.models.inception import InceptionConfig as JaxConfig
from microwakeword_tpu.models.mixednet import MixedNetConfig as JaxMixedNetConfig
from microwakeword_tpu.train import loop as JT
from microwakeword_tpu_torch.data import sampler as S
from microwakeword_tpu_torch.models import InceptionConfig, MixedNetConfig, build_model, convert
from microwakeword_tpu_torch.models import inception as I
from microwakeword_tpu_torch.models import layers as L
from microwakeword_tpu_torch.models import presets
from microwakeword_tpu_torch.train import loop as T

torch.set_num_threads(2)

# tests/test_native_runtime.py:175's Inception: dilation, SSN groups 4 and 2
SMALL = dict(cnn1_filters=(8,), cnn1_kernel_sizes=(3,), cnn1_subspectral_groups=(4,),
             cnn2_filters1=(6, 8), cnn2_filters2=(8, 12), cnn2_kernel_sizes=(3, 5),
             cnn2_subspectral_groups=(1, 2), cnn2_dilation=(1, 2), spectrogram_length=60)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_stream(module, variables, x, block):
    """``module`` (streaming) over x [B, T, C] in blocks of ``block`` frames
    from a zero cache; the outputs concatenated (tests/test_layers_streaming.py)."""
    cache = module.init(jax.random.PRNGKey(0), jnp.zeros_like(x[:, :block])).get("cache", {})
    outs = []
    for t in range(0, x.shape[1], block):
        y, upd = module.apply({**variables, "cache": cache}, x[:, t : t + block], mutable=["cache"])
        cache = upd["cache"]
        outs.append(np.asarray(y))
    return np.concatenate(outs, axis=1)


def _port_stream_all(layer, x, block):
    """The port layer's ``step`` over x in blocks of ``block`` frames."""
    channels = getattr(layer, "ring_channels", getattr(layer, "in_features", 0))
    ring = torch.zeros(x.shape[0], layer.ring, channels) if layer.ring else None
    outs = []
    with torch.no_grad():
        for t in range(0, x.shape[1], block):
            y, ring = layer.step(x[:, t : t + block], ring)
            outs.append(y)
    return torch.cat(outs, dim=1).numpy()


# ---- layers ----------------------------------------------------------------


@pytest.mark.parametrize("delay,also", [(3, False), (3, True), (0, True)])
def test_delay_matches_jax(delay, also):
    x = np.random.default_rng(0).standard_normal((2, 10, 3)).astype(np.float32)
    jmod = JL.Delay(delay, also_in_non_streaming=also)
    want = np.asarray(jmod.apply({}, x))
    layer = L.Delay(3, delay, also_in_non_streaming=also)
    np.testing.assert_array_equal(layer(torch.from_numpy(x)).numpy(), want)
    want_stream = _jax_stream(JL.Delay(delay, streaming=True), {}, x, 1)
    got_stream = _port_stream_all(layer, torch.from_numpy(x), 1)
    np.testing.assert_array_equal(got_stream, want_stream)
    if delay:
        np.testing.assert_array_equal(got_stream[:, delay:], x[:, :-delay])


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_subspectral_norm_train_and_eval_match_jax(groups):
    """Train mode: the output and both running statistics after one update;
    eval mode: the output on the updated statistics."""
    rng = np.random.default_rng(groups)
    x = rng.normal(0.5, 2.0, (3, 7, 8)).astype(np.float32)
    jmod = JL.SubSpectralNorm(groups, use_running_average=False)
    variables = _np_tree(jmod.init(jax.random.PRNGKey(0), x))
    n = 8 if groups == 1 else groups
    assert variables["params"]["BatchNorm_0"]["scale"].shape == (n,)
    variables = {
        "params": {"BatchNorm_0": {"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
                                   "bias": rng.normal(0, 0.3, n).astype(np.float32)}},
        "batch_stats": {"BatchNorm_0": {"mean": rng.normal(0, 0.3, n).astype(np.float32),
                                        "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}},
    }
    want, upd = jmod.apply(variables, x, mutable=["batch_stats"])
    layer = L.SubSpectralNorm(8, groups)
    state = convert.flax_to_state({k: {"SubSpectralNorm_0": v} for k, v in variables.items()})
    layer.load_state_dict({k.split(".", 1)[1]: torch.from_numpy(v) for k, v in state.items()})
    layer.train()
    got = layer(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    for stat in ("mean", "var"):
        np.testing.assert_allclose(getattr(layer.BatchNorm_0, stat).numpy(),
                                   np.asarray(upd["batch_stats"]["BatchNorm_0"][stat]),
                                   rtol=1e-5, atol=1e-7, err_msg=stat)
    layer.eval()
    want_eval = JL.SubSpectralNorm(groups).apply(
        {"params": variables["params"], "batch_stats": _np_tree(upd["batch_stats"])}, x)
    np.testing.assert_allclose(layer(torch.from_numpy(x)).detach().numpy(), np.asarray(want_eval),
                               rtol=1e-5, atol=1e-6)


def test_subspectral_norm_groups_must_divide():
    with pytest.raises(ValueError, match="not divisible"):
        L.SubSpectralNorm(8, 3)


@pytest.mark.parametrize("kernel,stride", [(2, 2), (3, 1), (4, 2), (3, 3)])
def test_stream_average_pooling_matches_jax(kernel, stride):
    """The valid op against JAX's, and the streamed steps against JAX's
    streamed steps (both from zero rings)."""
    x = np.random.default_rng(3).standard_normal((2, 24, 5)).astype(np.float32)
    want = np.asarray(JL.StreamAveragePooling(kernel, stride=stride).apply({}, x))
    layer = L.StreamAveragePooling(5, kernel, stride)
    np.testing.assert_allclose(layer(torch.from_numpy(x)).numpy(), want, atol=1e-6)
    assert list(layer.parameters()) == []
    want_stream = _jax_stream(JL.StreamAveragePooling(kernel, stride=stride, streaming=True), {},
                              x, stride)
    np.testing.assert_allclose(_port_stream_all(layer, torch.from_numpy(x), stride), want_stream,
                               atol=1e-6)


def _conv_transpose_pair(kernel, stride, crop=True):
    x = np.random.default_rng(2).standard_normal((2, 12, 6)).astype(np.float32)
    jmod = JL.StreamConvTranspose(4, kernel, stride=stride, use_bias=True, crop_output=crop)
    params = _np_tree(jmod.init(jax.random.PRNGKey(2), x))["params"]
    params["bias"] = np.linspace(-0.5, 0.5, 4).astype(np.float32)
    layer = L.StreamConvTranspose(6, 4, kernel, stride, use_bias=True, crop_output=crop)
    state = convert.flax_to_state({"params": {"StreamConvTranspose_0": params}})
    layer.load_state_dict({k.split(".", 1)[1]: torch.from_numpy(v) for k, v in state.items()})
    return x, params, layer


@pytest.mark.parametrize("kernel,stride", [(2, 2), (4, 2), (3, 1), (5, 5)])
def test_stream_conv_transpose_matches_jax(kernel, stride):
    x, params, layer = _conv_transpose_pair(kernel, stride)
    want = np.asarray(JL.StreamConvTranspose(4, kernel, stride=stride, use_bias=True).apply(
        {"params": params}, x))
    assert want.shape == (2, 12 * stride, 4)
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    want_stream = _jax_stream(JL.StreamConvTranspose(4, kernel, stride=stride, use_bias=True,
                                                     streaming=True), {"params": params}, x, 1)
    got_stream = _port_stream_all(layer, torch.from_numpy(x), 1)
    np.testing.assert_allclose(got_stream, want_stream, atol=1e-5)
    np.testing.assert_allclose(got_stream, got, atol=1e-5)  # streamed == cropped forward


def test_stream_conv_transpose_uncropped_and_kernel_lt_stride():
    x, params, layer = _conv_transpose_pair(3, 2, crop=False)
    want = np.asarray(JL.StreamConvTranspose(4, 3, stride=2, use_bias=True, crop_output=False)
                      .apply({"params": params}, x))
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 11 * 2 + 3, 4)
    np.testing.assert_allclose(got, want, atol=1e-5)
    small = L.StreamConvTranspose(3, 2, kernel_size=1, stride=3)
    with pytest.raises(ValueError, match="kernel_size"):
        small.step(torch.zeros(1, 4, 3), None)
    with pytest.raises(ValueError):
        JL.StreamConvTranspose(2, kernel_size=1, stride=3, streaming=True).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4, 3)))


@pytest.mark.parametrize("dilation", [1, 2, 3])
def test_dilated_stream_conv_matches_jax(dilation):
    x = np.random.default_rng(4).standard_normal((2, 30, 5)).astype(np.float32)
    jmod = JL.StreamConv(6, 3, dilation=dilation)
    params = _np_tree(jmod.init(jax.random.PRNGKey(1), x))["params"]
    layer = L.StreamConv(5, 6, 3, dilation=dilation)
    assert layer.ring == 2 * dilation
    state = convert.flax_to_state({"params": {"StreamConv_0": params}})
    layer.load_state_dict({k.split(".", 1)[1]: torch.from_numpy(v) for k, v in state.items()})
    with torch.no_grad():
        np.testing.assert_allclose(layer(torch.from_numpy(x)).numpy(),
                                   np.asarray(jmod.apply({"params": params}, x)), atol=1e-5)
    want = _jax_stream(JL.StreamConv(6, 3, dilation=dilation, streaming=True), {"params": params},
                       x, 1)
    np.testing.assert_allclose(_port_stream_all(layer, torch.from_numpy(x), 1), want, atol=1e-5)


# ---- Inception ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _case():
    """(JAX bundle, flax variables with randomised BN, port bundle, model, x [2, 90, 40])."""
    jb = jax_build_model("inception", JaxConfig(**SMALL))
    variables = _np_tree(jax.jit(jb.init)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    variables["params"] = jax.tree_util.tree_map(
        lambda a: a + rng.normal(0.0, 0.05, a.shape).astype(np.float32) if a.ndim == 1 else a,
        variables["params"])
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape) if a.mean() > 0.5
                   else rng.normal(0.0, 0.3, a.shape)).astype(np.float32),
        variables["batch_stats"])
    tb = build_model("inception", InceptionConfig(**SMALL))
    model = tb.load(convert.flax_to_state(variables), device="cpu")
    x = rng.uniform(0.0, 6.0, (2, 90, 40)).astype(np.float32)
    return jb, variables, tb, model, x


def test_inception_forward_matches_jax():
    jb, variables, tb, model, x = _case()
    t = tb.spectrogram_length
    want = np.asarray(jax.jit(jb.forward)(variables, x[:, -t:]))
    with torch.no_grad():
        got = tb.forward(model, torch.from_numpy(x[:, -t:])).numpy()
    assert got.shape == want.shape == (2, 1)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_inception_stream_scan_matches_jax_and_forward():
    jb, variables, tb, model, x = _case()
    want = np.asarray(jax.jit(jb.stream_scan)(variables, x))
    got = tb.stream_scan(model, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 90, 1)
    np.testing.assert_allclose(got, want, atol=2e-4)
    t = tb.spectrogram_length
    with torch.no_grad():
        for end in (90, 89, 75):  # stride 1: the step ending at frame e is forward over [e - T, e)
            full = tb.forward(model, torch.from_numpy(x[:, end - t : end])).numpy()
            np.testing.assert_allclose(got[:, end - 1], full, atol=2e-4)


def test_inception_cache_matches_jax():
    jb, variables, tb, model, _ = _case()
    cache = jax.eval_shape(lambda v: jb.stream_init(v, 3), variables)
    want = {k: tuple(v.shape) for k, v in convert.flatten(cache).items()}
    assert {k: tuple(v.shape) for k, v in tb.stream_init(model, 3).items()} == want
    # the second block's k conv of branch 2: dilation 2, k 5, 8 channels
    assert want["ConvBnRelu_10/StreamConv_0/ring"] == (3, 8, 8)


def _recording_bernoulli(masks):
    """A ``jax.random.bernoulli`` that hands each mask it draws to the host
    (``jax.debug.callback``), in jitted code too: JAX's own dropout masks."""
    real = jax.random.bernoulli

    def bernoulli(k, p=0.5, shape=None, **kw):
        mask = real(k, p, shape, **kw)
        jax.debug.callback(lambda m: masks.append(np.array(m)), mask, ordered=True)
        return mask

    return bernoulli


def test_inception_forward_train_with_jax_dropout_mask(monkeypatch):
    jb, variables, tb, _, x = _case()
    t = tb.spectrogram_length
    masks = []
    monkeypatch.setattr(jax.random, "bernoulli", _recording_bernoulli(masks))
    want, upd = jax.jit(jb.forward_train)(variables, x[:, -t:], dropout_rng=jax.random.PRNGKey(7))
    jax.effects_barrier()
    assert len(masks) == 1 and masks[0].shape == (2, I.tail_length(tb.config) * 12)
    assert 0 < masks[0].mean() < 1
    model = tb.load(convert.flax_to_state(variables), device="cpu")
    got = tb.forward_train(model, torch.from_numpy(x[:, -t:]), torch.from_numpy(masks[0]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    assert not model.training
    stats = convert.state_to_flax({k: v.numpy() for k, v in model.state_dict().items()})
    want_stats = convert.flatten(_np_tree(upd["batch_stats"]))
    for key, value in convert.flatten(stats["batch_stats"]).items():
        np.testing.assert_allclose(value, want_stats[key], rtol=1e-5, atol=1e-6, err_msg=key)


def test_inception_dropout_draw():
    """The torch draw keeps about 1 - rate of the entries, scales the kept
    ones by 1 / keep, repeats with the generator's seed, and refuses a
    train-mode forward with neither a generator nor a mask."""
    cfg = InceptionConfig(**dict(SMALL, dropout=0.3))
    model = I.Inception(cfg)
    width = model.Dense_0.weight.shape[1]  # the forward's shape: [rows, tail * C]
    x = torch.rand(4_000_000 // width, width, generator=torch.Generator().manual_seed(1)) + 0.5
    model.train()
    y = model._dropout(x, torch.Generator().manual_seed(5))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.002
    torch.testing.assert_close(y[kept], x[kept] / 0.7)
    torch.testing.assert_close(model._dropout(x, torch.Generator().manual_seed(5)), y)
    assert not torch.equal(model._dropout(x, torch.Generator().manual_seed(6)), y)
    with pytest.raises(ValueError, match="generator or keep mask"):
        model(torch.zeros(2, cfg.spectrogram_length, 40))
    model.eval()  # eval mode: no dropout, no generator needed
    assert model(torch.zeros(2, cfg.spectrogram_length, 40)).shape == (2, 1)


@pytest.mark.parametrize("family", ["inception", "mixednet"])
def test_keep_mask_is_the_forwards_draw(family):
    """The train steps draw the keep mask through the model: Inception's is
    ``draw_keep_mask`` over [rows, tail * C] with keep 1 - dropout from the
    generator it is given, and MixedNet, which has no dropout, draws none."""
    if family == "mixednet":
        model = build_model("mixednet").build()
        assert model.keep_mask(5, torch.Generator().manual_seed(3)) is None
        return
    cfg = InceptionConfig(**dict(SMALL, dropout=0.3))
    model = I.Inception(cfg)
    got = model.keep_mask(5, torch.Generator().manual_seed(3))
    want = I.draw_keep_mask((5, 12 * I.tail_length(cfg)), 1 - 0.3, torch.Generator().manual_seed(3),
                            torch.device("cpu"))
    assert got.dtype == torch.bool and torch.equal(got, want)
    assert I.Inception(InceptionConfig(**dict(SMALL, dropout=0.0))).keep_mask(5, None) is None


def test_default_inception_preset():
    cfg = presets.default_inception_config()
    assert cfg == InceptionConfig(**vars(jax_presets.default_inception_config()))
    assert cfg.spectrogram_length == 102 and I.spectrogram_slices_dropped(cfg) == 28
    assert I.tail_length(cfg) == 74
    tb = build_model("inception", cfg)
    model = tb.init(torch.Generator().manual_seed(0), device="cpu")
    assert model.Dense_0.weight.shape == (1, 74 * 16)
    assert sum(p.numel() for p in model.parameters()) == 16_205
    assert tb.stride == 1 and tb.slices_dropped == 28


@pytest.mark.parametrize("family", ["inception", "mixednet"])
def test_convert_round_trip_both_families(family):
    """Both directions bit for bit: flax_to_state(state_to_flax(state)) is
    the state, and state_to_flax(flax_to_state(variables)) is a JAX init's
    variables (whose tree state_to_flax gives)."""
    if family == "inception":
        jb = jax_build_model("inception", JaxConfig(**SMALL))
        tb = build_model("inception", InceptionConfig(**SMALL))
    else:
        kw = dict(pointwise_filters=(8, 8), repeat_in_block=(1, 1),
                  mixconv_kernel_sizes=((3,), (3, 5)), residual_connection=(False, True),
                  first_conv_filters=4, first_conv_kernel_size=3, stride=3, spectrogram_length=33,
                  spatial_attention=True, pooled=True)
        jb = jax_build_model("mixednet", JaxMixedNetConfig(**kw))
        tb = build_model("mixednet", MixedNetConfig(**kw))
    model = tb.init(torch.Generator().manual_seed(3), device="cpu")
    rng = np.random.default_rng(3)
    state = {k: v.numpy() + rng.normal(0, 0.1, v.shape).astype(np.float32)
             for k, v in model.state_dict().items()}
    flax_vars = convert.state_to_flax(state)
    init = _np_tree(jax.jit(jb.init)(jax.random.PRNGKey(0)))
    assert jax.tree_util.tree_structure(flax_vars) == jax.tree_util.tree_structure(init)
    for a, b in zip(jax.tree_util.tree_leaves(flax_vars), jax.tree_util.tree_leaves(init)):
        assert a.shape == b.shape and a.dtype == b.dtype
    back = convert.flax_to_state(flax_vars)
    assert set(back) == set(state)
    for k in state:
        np.testing.assert_array_equal(back[k], state[k])
    again = convert.state_to_flax(convert.flax_to_state(init))
    assert jax.tree_util.tree_structure(again) == jax.tree_util.tree_structure(init)
    for a, b in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(init)):
        np.testing.assert_array_equal(a, b)
    tb.load(back, device="cpu")  # the module takes it


# ---- the train step A/B -------------------------------------------------------

B = 8
PHASE = dict(learning_rate=1e-3, time_mask_max_size=0, time_mask_count=0, freq_mask_max_size=0,
             freq_mask_count=0, positive_class_weight=1.0, negative_class_weight=3.0)


def _batches(n, length):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        labels = (rng.uniform(size=B) < 0.5).astype(np.float32)
        windows = rng.integers(0, 300, (B, length, 40)).astype(np.uint16)
        windows[labels > 0.5, :, 20:] += 300
        valid = np.arange(length)[None, :] >= rng.integers(-10, 8, B)[:, None]
        out.append((windows, valid, labels, rng.uniform(1.0, 2.0, B).astype(np.float32)))
    return out


def test_inception_train_step_matches_jax(monkeypatch):
    """JAX's jitted step, traced with a ``jax.random.bernoulli`` that hands
    each dropout mask it draws to the host, against the port's step fed
    those masks in order: the losses (step 0 to 1e-5, the next two to
    1e-4) and the weights after three steps."""
    t = SMALL["spectrogram_length"]
    jb = jax_build_model("inception", JaxConfig(**SMALL))
    tb = build_model("inception", InceptionConfig(**SMALL))
    module = tb.init(torch.Generator().manual_seed(5), device="cpu")
    state = {k: v.numpy().copy() for k, v in module.state_dict().items()}
    variables = convert.state_to_flax(state)
    arrays = dict(
        frames=np.zeros((8, 40), np.uint16), edge_pad=0,
        clip_offset=np.zeros(1, np.int32), clip_length=np.full(1, 8, np.int32),
        provider_logits=np.zeros(1, np.float32), provider_clip_start=np.zeros(1, np.int32),
        provider_clip_count=np.ones(1, np.int32), provider_label=np.ones(1, np.float32),
        provider_penalty=np.ones(1, np.float32), provider_strategy=np.zeros(1, np.int32),
        provider_cutoffs=np.zeros((1, 8), np.int32), provider_n_cutoffs=np.ones(1, np.int32))
    optimizer, call = JT.make_train_step(jb, HostStreamedData(arrays), B, t)
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = optimizer.init(params)
    batches = _batches(3, t)
    masks, jax_losses = [], []
    monkeypatch.setattr(jax.random, "bernoulli", _recording_bernoulli(masks))
    for i, batch in enumerate(batches):
        params, stats, opt_state, metrics = call.jitted(
            params, stats, opt_state, jax.random.PRNGKey(i),
            tuple(jnp.asarray(a) for a in batch), **PHASE)
        jax_losses.append(float(metrics["loss"]))
    jax.effects_barrier()
    assert len(masks) == 3 and not np.array_equal(masks[0], masks[1])

    model = tb.load(state, device="cpu")
    step = T.make_train_step(tb, model, None, B, t, generator=torch.Generator())
    fed = iter(masks)
    monkeypatch.setattr(I, "draw_keep_mask", lambda shape, keep, gen, device: torch.from_numpy(
        next(fed)).reshape(shape))
    losses = []
    for windows, valid, labels, weights in batches:
        m = step.step_on_batch(S.frames_tensor(windows), torch.from_numpy(valid),
                               torch.from_numpy(labels), torch.from_numpy(weights), **PHASE)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses[0], jax_losses[0], rtol=1e-5)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    got = convert.state_to_flax({k: v.detach().numpy() for k, v in model.state_dict().items()})
    for coll, tree in (("params", params), ("batch_stats", stats)):
        want = convert.flatten(_np_tree(tree))
        have = convert.flatten(got[coll])
        assert set(have) == set(want)
        for key in want:
            np.testing.assert_allclose(have[key], want[key], atol=1e-4, err_msg=key)
