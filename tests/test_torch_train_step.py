"""The port's train step against the JAX package's own step.

Identical weights (the port's init, moved to flax by ``models/convert.py``)
and identical gathered batches go through JAX's ``make_train_step`` -- built
on a ``HostStreamedData`` corpus, whose jitted step takes a pre-gathered
(windows, valid, labels, weights) batch, so JAX's real ``_step_flat`` is the
reference -- and through the port's ``step_on_batch``:

- step-0 loss to 1e-5 relative;
- 20 steps of losses to 1e-4 relative, parameters and BatchNorm statistics
  to 1e-3 absolute at lr 1e-3;
- ``steps_per_call`` 3 reports the third sub-step's metrics.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microwakeword_tpu.data.host_stream import HostStreamedData
from microwakeword_tpu.models import build_model as jax_build_model
from microwakeword_tpu.models.mixednet import MixedNetConfig as JaxConfig
from microwakeword_tpu.train import loop as JT
from microwakeword_tpu_torch.data import sampler as S
from microwakeword_tpu_torch.models import MixedNetConfig, build_model, convert
from microwakeword_tpu_torch.train import loop as T

torch.set_num_threads(2)

CFG = dict(pointwise_filters=(16, 16), repeat_in_block=(1, 1), mixconv_kernel_sizes=((3, 5), (5,)),
           residual_connection=(False, True), first_conv_filters=8, first_conv_kernel_size=3,
           stride=1, spectrogram_length=31)
L, B, STEPS = 31, 16, 20
PHASE = dict(learning_rate=1e-3, time_mask_max_size=0, time_mask_count=0, freq_mask_max_size=0,
             freq_mask_count=0, positive_class_weight=1.0, negative_class_weight=5.0)


def _batches(n, seed):
    """n gathered batches: uint16 windows (feature scale), leading invalid
    rows, labels, penalty weights."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        labels = (rng.uniform(size=B) < 0.4).astype(np.float32)
        windows = rng.integers(0, 300, (B, L, 40)).astype(np.uint16)
        windows[labels > 0.5, :, 20:] += 300  # learnable: energy in the high channels
        windows[labels < 0.5, :, :20] += 300
        valid = np.arange(L)[None, :] >= rng.integers(-10, 8, B)[:, None]
        out.append((windows, valid, labels, rng.uniform(1.0, 2.0, B).astype(np.float32)))
    return out


def _port(batch):
    windows, valid, labels, weights = batch
    return (S.frames_tensor(windows), torch.from_numpy(valid), torch.from_numpy(labels),
            torch.from_numpy(weights))


@functools.lru_cache(maxsize=None)
def _setup(steps_per_call: int):
    """(JAX bundle, jitted JAX step, flax variables, JAX opt state, port bundle, state)."""
    jb = jax_build_model("mixednet", JaxConfig(**CFG))
    tb = build_model("mixednet", MixedNetConfig(**CFG))
    module = tb.init(torch.Generator().manual_seed(5), device="cpu")
    state = {k: v.numpy().copy() for k, v in module.state_dict().items()}
    variables = convert.state_to_flax(state)
    # a one-clip corpus: the jitted step reads only the batch it is given
    arrays = dict(
        frames=np.zeros((8, 40), np.uint16), edge_pad=0,
        clip_offset=np.zeros(1, np.int32), clip_length=np.full(1, 8, np.int32),
        provider_logits=np.zeros(1, np.float32), provider_clip_start=np.zeros(1, np.int32),
        provider_clip_count=np.ones(1, np.int32), provider_label=np.ones(1, np.float32),
        provider_penalty=np.ones(1, np.float32), provider_strategy=np.zeros(1, np.int32),
        provider_cutoffs=np.zeros((1, 8), np.int32), provider_n_cutoffs=np.ones(1, np.int32))
    optimizer, call = JT.make_train_step(jb, HostStreamedData(arrays), B, L,
                                         steps_per_call=steps_per_call)
    return jb, call.jitted, variables, optimizer.init(variables["params"]), tb, state


def _jax_run(batches, steps_per_call=1):
    _, step, variables, opt_state, _, _ = _setup(steps_per_call)
    params, stats = variables["params"], variables["batch_stats"]
    losses, metrics = [], None
    rng = jax.random.PRNGKey(0)
    for batch in batches:
        params, stats, opt_state, metrics = step(
            params, stats, opt_state, rng, tuple(jnp.asarray(a) for a in batch), **PHASE)
        losses.append(float(metrics["loss"]))
    return losses, {"params": params, "batch_stats": stats}, metrics


def _port_run(batches, steps_per_call=1):
    *_, tb, state = _setup(1)
    model = tb.load(state, device="cpu")
    step = T.make_train_step(tb, model, None, B, L, steps_per_call=steps_per_call)
    losses, metrics = [], None
    for batch in batches:
        metrics = step.step_on_batch(*batch, **PHASE)
        losses.append(float(metrics["loss"]))
    return losses, model, metrics, step


@functools.lru_cache(maxsize=None)
def _runs():
    batches = _batches(STEPS, 0)
    return _jax_run(batches), _port_run([_port(b) for b in batches])


def test_step0_loss_matches_jax():
    (jax_losses, _, _), (port_losses, _, _, _) = _runs()
    np.testing.assert_allclose(port_losses[0], jax_losses[0], rtol=1e-5)


def test_losses_params_and_stats_match_jax_over_20_steps():
    (jax_losses, jax_vars, _), (port_losses, model, _, step) = _runs()
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-4)
    assert port_losses[-1] < 0.5 * port_losses[0]  # it learns
    got = convert.state_to_flax({k: v.detach().numpy() for k, v in model.state_dict().items()})
    for coll in ("params", "batch_stats"):
        want = convert.flatten(jax.tree_util.tree_map(np.asarray, jax_vars[coll]))
        have = convert.flatten(got[coll])
        assert set(have) == set(want)
        for key in want:
            np.testing.assert_allclose(have[key], want[key], atol=1e-3, err_msg=key)
    # the module's parameters are views into the flat vector the optimizer updates
    assert all(p.untyped_storage().data_ptr() == step.flat.untyped_storage().data_ptr()
               for p in model.parameters())
    assert int(step.count) == STEPS


def test_float64_step_matches_jax():
    """A float64 module gives a float64 step (the card-against-CPU check
    runs it so): the flat vector, the gradient, Adam's moments and the
    BatchNorm statistics stay float64, and its losses are JAX's float32
    ones to the float32 step's tolerance."""
    (jax_losses, _, _), _ = _runs()
    *_, tb, state = _setup(1)
    model = tb.load(state, device="cpu").double()
    step = T.make_train_step(tb, model, None, B, L)
    losses = [float(step.step_on_batch(*_port(b), **PHASE)["loss"]) for b in _batches(STEPS, 0)]
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-4)
    assert {t.dtype for t in (step.flat, step.grad, step.mu, step.nu)} == {torch.float64}
    assert {v.dtype for v in model.state_dict().values()} == {torch.float64}


def test_step_metrics_match_jax():
    (_, _, jax_metrics), (_, _, port_metrics, _) = _runs()
    assert set(port_metrics) == set(jax_metrics)
    for key in ("accuracy", "recall", "precision", "auc"):
        assert float(port_metrics[key]) == pytest.approx(float(jax_metrics[key]), abs=1e-6), key


def test_steps_per_call_reports_last_sub_step():
    batches = _batches(3, 1)
    stacked = tuple(np.stack(a) for a in zip(*batches))
    _, _, jax_metrics = _jax_run([stacked], steps_per_call=3)
    chained_losses, chained_model, chained, _ = _port_run(
        [tuple(torch.stack(t) for t in zip(*[_port(b) for b in batches]))], steps_per_call=3)
    single_losses, single_model, _, _ = _port_run([_port(b) for b in batches])
    assert chained_losses == [single_losses[2]]  # the third sub-step's loss
    np.testing.assert_allclose(chained_losses[0], float(jax_metrics["loss"]), rtol=1e-4)
    for key in ("accuracy", "recall", "precision", "auc"):
        assert float(chained[key]) == pytest.approx(float(jax_metrics[key]), abs=1e-6), key
    for a, b in zip(chained_model.state_dict().values(), single_model.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_one_adam_for_a_model_and_a_population(dtype):
    """The solo step's Adam (a float -lr on [P]) and the population's (an
    [N, 1] -lr on [N, P], one rate per member) are one function over one
    flat layout: each row of the [N, P] update equals the [P] update with
    that row's rate, bit for bit, over 3 steps."""
    gen = torch.Generator().manual_seed(0)
    lrs = [1e-3, 3e-2, 0.5]
    n = len(lrs)
    stacked = [torch.randn((n,) + shape, generator=gen, dtype=dtype)
               for shape in ((4, 5), (257,), ())]
    flat, views, grad, mu, nu, count = T.flat_layout(stacked, (n,))
    assert all(torch.equal(v, t) for v, t in zip(views, stacked))
    assert flat.shape == (n, 278) and count.dtype == torch.int32 and count.shape == ()
    solos = [T.flat_layout([t[i] for t in stacked]) for i in range(n)]
    neg_lr = (-torch.tensor(lrs, dtype=dtype)).reshape(n, 1)
    for _ in range(3):
        grad.copy_(torch.randn(flat.shape, generator=gen, dtype=dtype))
        T.adam(flat, grad, mu, nu, count, neg_lr)
        for i, (s_flat, _, s_grad, s_mu, s_nu, s_count) in enumerate(solos):
            s_grad.copy_(grad[i])
            T.adam(s_flat, s_grad, s_mu, s_nu, s_count, -lrs[i])
    for i, (s_flat, s_views, _, s_mu, s_nu, s_count) in enumerate(solos):
        assert s_flat.shape == (278,) and int(s_count) == int(count) == 3
        assert torch.equal(flat[i], s_flat) and torch.equal(mu[i], s_mu) and torch.equal(nu[i], s_nu)
        # the views follow their flat vectors
        assert all(torch.equal(v[i], w) for v, w in zip(views, s_views))


@pytest.mark.parametrize("seed", [0, 1])
def test_weighted_bce_matches_jax(seed):
    rng = np.random.default_rng(seed)
    probs = rng.uniform(0.0, 1.0, (32, 1)).astype(np.float32)
    probs[:3, 0] = [0.0, 1.0, 1e-9]  # clipped at 1e-7
    labels = (rng.uniform(size=32) < 0.5).astype(np.float32)
    weights = rng.uniform(0.5, 3.0, 32).astype(np.float32)
    want = float(JT.weighted_bce(jnp.asarray(probs), jnp.asarray(labels), jnp.asarray(weights)))
    got = float(T.weighted_bce(*(torch.from_numpy(a) for a in (probs, labels, weights))))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("cfg", [
    {"training_steps": [100, 50, 25], "learning_rates": [0.01, 0.001], "time_mask_count": [3]},
    {},
    {"training_steps": [10], "negative_class_weight": [20], "freq_mask_max_size": [1, 2]},
])
def test_schedules_match_jax(cfg):
    assert T.resolve_schedules(cfg) == JT.resolve_schedules(cfg)
    assert T.pad_schedule([1, 2], 4) == JT.pad_schedule([1, 2], 4)
