"""Population training (``parallel/population.py``) on the CPU, in the pattern
of tests/test_population.py, and against the JAX package's population step.

- a member of a population equals a population of one with its seed (5e-6),
  and with dropout (Inception) equals the solo ``TrainStep`` it stands for;
- members with other seeds differ, and the population learns the task;
- ``share_batch``: member 0 equals the private run, members with one init
  stay equal;
- chained sub-steps equal the unchained loop;
- selection and the leaderboard order;
- split over two gloo ranks, a population equals the solo one;
- against JAX: the same stacked weights (moved by ``models/convert.py``'s
  population converters) and the same fixed batch (JAX's ``sample_batch``
  patched as ``microwakeword_tpu/parallel/population.py`` sees it, inside the
  test only) give losses within 1e-4 relative and weights within 1e-3 after
  10 steps.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microwakeword_tpu.models import build_model as jax_build_model
from microwakeword_tpu.models.mixednet import MixedNetConfig as JaxConfig
from microwakeword_tpu.parallel import population as JP
from microwakeword_tpu_torch.data import sampler as S
from microwakeword_tpu_torch.models import MixedNetConfig, build_model, convert
from microwakeword_tpu_torch.models.inception import InceptionConfig
from microwakeword_tpu_torch.parallel import population as P
from microwakeword_tpu_torch.train import loop as T
from microwakeword_tpu_torch.train import metrics as M

torch.set_num_threads(2)

L = 20
CFG = dict(pointwise_filters=(8, 8), repeat_in_block=(1, 1), mixconv_kernel_sizes=((3,), (5,)),
           residual_connection=(False, False), first_conv_filters=8, first_conv_kernel_size=3,
           spectrogram_length=L)
SA = dict(time_mask_max_size=3, time_mask_count=1, freq_mask_max_size=3, freq_mask_count=1)
ATOL = 5e-6  # tests/test_population.py's member-vs-solo tolerance


def _packed(n_clips=64, length=L):
    """Separable synthetic corpus: positives high channels, negatives low."""
    rng = np.random.default_rng(0)
    lengths = rng.integers(length, length + 10, n_clips)
    half = n_clips // 2
    specs = []
    for i, t in enumerate(lengths):
        s = rng.uniform(0, 80, (t, 40))
        s[:, 20:] += 300.0 if i < half else 0.0
        s[:, :20] += 0.0 if i < half else 300.0
        specs.append(s.astype(np.uint16))
    offsets = np.concatenate([[0], np.cumsum(lengths)])[:-1]

    def i32(v):
        return torch.tensor(v, dtype=torch.int32)

    return S.PackedTrainingData(
        frames=S.frames_tensor(np.concatenate(specs)), clip_offset=i32(offsets),
        clip_length=i32(lengths), provider_logits=torch.zeros(2),
        provider_clip_start=i32([0, half]), provider_clip_count=i32([half, n_clips - half]),
        provider_label=torch.tensor([1.0, 0.0]), provider_penalty=torch.ones(2),
        provider_strategy=i32([1, 0]), provider_cutoffs=torch.zeros((2, S.MAX_CUTOFFS), dtype=torch.int32),
        provider_n_cutoffs=i32([1, 1]))


def _bundle():
    return build_model("mixednet", MixedNetConfig(**CFG))


def _inception():
    return build_model("inception", InceptionConfig(
        cnn1_filters=(8,), cnn1_kernel_sizes=(3,), cnn1_subspectral_groups=(2,),
        cnn2_filters1=(6,), cnn2_filters2=(6,), cnn2_kernel_sizes=(3,),
        cnn2_subspectral_groups=(1,), cnn2_dilation=(1,), dropout=0.5, spectrogram_length=L))


@functools.lru_cache(maxsize=None)
def _jax_population():
    """(JAX bundle, a stacked JAX population of three, numpy leaves)."""
    jb = jax_build_model("mixednet", JaxConfig(**CFG))
    return jb, jax.tree_util.tree_map(np.asarray, JP.init_population(jb, [1, 2, 3]))


def _max_diff(a: dict, b: dict, i: int, j: int) -> float:
    return max(float((a[k][i] - b[k][j]).abs().max()) for k in a)


def test_member_matches_population_of_one():
    bundle, packed = _bundle(), _packed()
    kw = dict(steps=10, batch_size=8, features_length=L, sample_seed=42, spec_augment=SA,
              device="cpu")
    pop, _ = P.train_population(bundle, packed, 3, seeds=[7, 8, 9],
                                learning_rates=[0.01, 0.003, 0.02],
                                positive_class_weights=[1.0, 2.0, 1.0], **kw)
    solo, _ = P.train_population(bundle, packed, 1, seeds=[8], learning_rates=[0.003],
                                 positive_class_weights=[2.0], **kw)
    assert set(pop) == set(bundle.init(torch.Generator(), "cpu").state_dict())
    assert _max_diff(solo, pop, 0, 1) < ATOL
    assert _max_diff(pop, pop, 0, 1) > 1e-3  # other seeds, other members


def test_population_learns_and_members_differ():
    bundle, packed = _bundle(), _packed()
    n = 4
    stacked, history = P.train_population(bundle, packed, n, 30, 16, L,
                                           learning_rates=[0.01] * n, eval_interval=15,
                                           device="cpu")
    assert [h["step"] for h in history] == [15, 30]
    final = history[-1]
    assert final["loss"].shape == (n,)
    assert (final["accuracy"] > 0.85).all(), final["accuracy"]
    assert min(_max_diff(stacked, stacked, i, i + 1) for i in range(n - 1)) > 1e-4


def test_share_batch_member0_matches_private_and_members_share_stream():
    bundle, packed = _bundle(), _packed()
    n = 3
    stacked = P.init_population(bundle, [7, 5, 5], "cpu")  # members 1 and 2: one init

    def run(share):
        gens = [torch.Generator().manual_seed(i) for i in range(n)]
        pop = P.make_population_train_step(bundle, packed, 8, L, stacked, gens,
                                           share_batch=share)
        for _ in range(5):
            pop.step(torch.full((n,), 0.01), torch.ones(n), torch.ones(n), **SA)
        return pop.state()

    shared, private = run(True), run(False)
    assert _max_diff(shared, private, 0, 0) < ATOL
    assert all(torch.equal(v[1], v[2]) for v in shared.values())
    assert _max_diff(private, private, 1, 2) > 1e-6


def test_chained_matches_unchained():
    bundle, packed = _bundle(), _packed()
    kw = dict(n_models=2, steps=10, batch_size=8, features_length=L, seeds=[3, 4],
              learning_rates=[0.01, 0.005], sample_seed=11, eval_interval=5, spec_augment=SA,
              device="cpu")
    for share in (False, True):
        plain, hist_plain = P.train_population(bundle, packed, share_batch=share, **kw)
        chained, hist_chained = P.train_population(bundle, packed, steps_per_call=4,
                                                   share_batch=share, **kw)
        assert _max_diff(plain, chained, 0, 0) < ATOL and _max_diff(plain, chained, 1, 1) < ATOL
        assert [h["step"] for h in hist_plain] == [h["step"] for h in hist_chained] == [5, 10]
        for hp, hc in zip(hist_plain, hist_chained):
            np.testing.assert_allclose(hp["loss"], hc["loss"], rtol=1e-5)


def test_selection_and_leaderboard():
    bundle, packed = _bundle(), _packed()
    rng = np.random.default_rng(1)
    val, labels = [], []
    for i in range(24):
        s = rng.uniform(0, 80, (L, 40))
        s[:, 20:] += 300.0 if i % 2 else 0.0
        s[:, :20] += 0.0 if i % 2 else 300.0
        val.append(s * 0.0390625)
        labels.append(float(i % 2))
    val_x, val_y = np.asarray(val, np.float32), np.asarray(labels, np.float32)
    ambient = np.asarray([rng.uniform(0, 3, (L, 40)) for _ in range(8)], np.float32)
    n = 4
    _, history, selection = P.train_population(
        bundle, packed, n, 30, 16, L, learning_rates=[0.02, 0.02, 0.02, 0.0], eval_interval=10,
        validation=(val_x, val_y), ambient=ambient, ambient_hours=1.0,
        minimization_metric="ambient_false_positives_per_hour",
        maximization_metric="average_viable_recall", target_minimization=0.5, device="cpu")
    lb = selection["leaderboard"]
    assert [row["member"] for row in lb][-1] == 3  # lr 0 cannot learn: last
    assert sorted(row["member"] for row in lb) == list(range(n))
    assert set(lb[0]) == {"member", "seed", "learning_rate", "best_step", "minimization",
                          "maximization", "metrics"}
    assert lb[0]["maximization"] >= lb[-1]["maximization"]
    assert len(history[-1]["validation"]) == n
    # the snapshot is the member's best step: its weights give the recorded metrics
    top = lb[0]["member"]
    model = bundle.load(P.member_variables(selection["best_variables"], top), "cpu")
    eval_fn = T.make_eval_fn(bundle)
    vm = M.validation_metrics(eval_fn(model, val_x), val_y, eval_fn(model, ambient), 1.0)
    np.testing.assert_allclose(vm["average_viable_recall"], lb[0]["maximization"], atol=1e-6)
    np.testing.assert_allclose(vm["ambient_false_positives_per_hour"], lb[0]["minimization"],
                               atol=1e-6)
    assert selection["best_step"][top] == lb[0]["best_step"]


def test_eval_fn_matches_each_member():
    bundle = _bundle()
    stacked = P.init_population(bundle, [0, 1, 2], "cpu")
    x = torch.rand(7, L, 40) * 20
    got = P.make_population_eval_fn(bundle, 3, eval_batch=3)(stacked, x)
    assert got.shape == (3, 7)
    for i in range(3):
        with torch.no_grad():
            want = bundle.forward(bundle.load(P.member_variables(stacked, i), "cpu"), x)
        np.testing.assert_allclose(got[i], want.reshape(-1).numpy(), atol=1e-6)


@pytest.mark.parametrize("share", [False, True])
def test_inception_population_with_dropout(share):
    """Dropout masks come from each member's generator after its batch draws:
    a private member equals the solo TrainStep on the same generator seed;
    with share_batch, member 0 does."""
    bundle, packed = _inception(), _packed()
    seeds, sample_seed, steps = [2, 6], 4, 3
    gens = [torch.Generator().manual_seed(P.member_seed(sample_seed, s)) for s in seeds]
    pop = P.make_population_train_step(bundle, packed, 8, L,
                                       P.init_population(bundle, seeds, "cpu"), gens,
                                       share_batch=share)
    lrs, ones = torch.tensor([0.01, 0.02]), torch.ones(2)
    for _ in range(steps):
        metrics = pop.step(lrs, ones, ones, **SA)
    assert torch.isfinite(metrics["loss"]).all()
    member = 0 if share else 1
    model = bundle.init(torch.Generator().manual_seed(seeds[member]), device="cpu")
    solo = T.make_train_step(bundle, model, packed, 8, L, generator=torch.Generator().manual_seed(
        P.member_seed(sample_seed, seeds[member])))
    phase = dict(SA, learning_rate=float(lrs[member]), positive_class_weight=1.0,
                 negative_class_weight=1.0)
    for _ in range(steps):
        solo.step(**phase)
    state = pop.state()
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(state[k][member].numpy(), v.numpy(), atol=ATOL, err_msg=k)
    assert _max_diff(state, state, 0, 1) > 1e-4


def test_population_step_matches_jax(monkeypatch):
    """The member-batched step against JAX's on one fixed batch, 10 steps."""
    n = 3
    jb, jax_vars = _jax_population()
    bundle = _bundle()
    stacked = {k: torch.from_numpy(v) for k, v in convert.flax_population_to_state(jax_vars).items()}
    # tests/test_torch_train_step.py's batch: uint16 windows at the feature scale
    rng = np.random.default_rng(0)
    labels = (rng.uniform(size=16) < 0.4).astype(np.float32)
    windows = rng.integers(0, 300, (16, L, 40)).astype(np.uint16)
    windows[labels > 0.5, :, 20:] += 300
    windows[labels < 0.5, :, :20] += 300
    feats = windows.astype(np.float32) * 0.0390625
    pens = rng.uniform(1.0, 2.0, 16).astype(np.float32)
    lrs, pos_w, neg_w = [0.001, 0.003, 0.002], [1.0, 2.0, 1.0], [1.0, 1.0, 5.0]

    monkeypatch.setattr(JP.S, "sample_batch",
                        lambda *a, **k: (jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(pens)))
    optimizer, step = JP.make_population_train_step(jb, None, 16, L, share_batch=True)
    params, stats = jax_vars["params"], jax_vars["batch_stats"]
    opt_state = jax.vmap(optimizer.init)(params)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(n, dtype=jnp.uint32))
    sa = dict(time_mask_max_size=0, time_mask_count=0, freq_mask_max_size=0, freq_mask_count=0)
    hyper = tuple(jnp.asarray(v, jnp.float32) for v in (lrs, pos_w, neg_w))

    pop = P.make_population_train_step(bundle, None, 16, L, stacked,
                                       [torch.Generator() for _ in range(n)], share_batch=True)
    port_hyper = tuple(torch.tensor(v) for v in (lrs, pos_w, neg_w))
    for _ in range(10):
        params, stats, opt_state, jm = step(params, stats, opt_state, keys, *hyper, **sa)
        pm = pop.step_on_features(torch.from_numpy(feats), torch.from_numpy(labels),
                                  torch.from_numpy(pens), *port_hyper)
        np.testing.assert_allclose(pm["loss"].numpy(), np.asarray(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(pm["accuracy"].numpy(), np.asarray(jm["accuracy"]))
    got = convert.state_to_flax_population({k: v.detach() for k, v in pop.state().items()})
    want = {"params": params, "batch_stats": stats}
    for coll in ("params", "batch_stats"):
        have, ref = convert.flatten(got[coll]), convert.flatten(want[coll])
        assert set(have) == set(ref)
        for key in ref:
            np.testing.assert_allclose(have[key], np.asarray(ref[key]), atol=1e-3, err_msg=key)


def test_population_converters_round_trip():
    _, jax_vars = _jax_population()
    stacked = convert.flax_population_to_state(jax_vars)
    for i in range(3):
        member = convert.flax_to_state(jax.tree_util.tree_map(lambda a: a[i], jax_vars))
        assert all(np.array_equal(stacked[k][i], member[k]) for k in member)
    back = convert.state_to_flax_population(stacked)
    for coll in ("params", "batch_stats"):
        a, b = convert.flatten(back[coll]), convert.flatten(jax_vars[coll])
        assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in b)


# (bundle, share_batch) of the two-rank populations: private batches, and
# member 0's shared batches with Inception's per-member dropout masks
MESH_RUNS = (("mixednet", False), ("inception", True))


def _mesh_population(family, share_batch, mesh=None):
    """4 members, 6 steps with selection every 3, on one device or split
    over ``mesh`` ranks."""
    bundle = _bundle() if family == "mixednet" else _inception()
    rng = np.random.default_rng(3)
    val_x = rng.uniform(0, 30, (12, L, 40)).astype(np.float32)
    val_x[:6, :, 20:] += 20
    val_y = (np.arange(12) < 6).astype(np.float32)
    return P.train_population(
        bundle, _packed(), 4, 6, 8, L, seeds=[3, 4, 5, 6], learning_rates=[0.01, 0.005] * 2,
        spec_augment=SA, eval_interval=3, validation=(val_x, val_y), share_batch=share_batch,
        mesh=mesh, device="cpu")


def _mesh_populations():
    return [_mesh_population(family, share, mesh=2) for family, share in MESH_RUNS]


def test_mesh_raises():
    """A population split over two gloo ranks (it raised before its slice),
    two members each, equals the solo population member for member: the
    final and best states, the history and the leaderboard, also with a
    shared batch drawn from member 0's generator on the rank without it."""
    from microwakeword_tpu_torch.parallel import mesh as MESH

    ranks = MESH.launch(_mesh_populations, 2, "cpu")
    for (family, share), *runs in zip(MESH_RUNS, *ranks):
        want_state, want_history, want_sel = _mesh_population(family, share)
        for got_state, got_history, got_sel in runs:
            for got, want in ((got_state, want_state),
                              (got_sel["best_variables"], want_sel["best_variables"])):
                assert set(got) == set(want)
                for k in want:
                    # parameters to ATOL; the statistics (variances near 20)
                    # to 1e-5 relative: vmap over 2 members sums in another order
                    stat = k.endswith((".mean", ".var"))
                    np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                               rtol=1e-5 if stat else 0,
                                               atol=1e-6 if stat else ATOL,
                                               err_msg=f"{family} {k}")
            assert [r["step"] for r in got_history] == [r["step"] for r in want_history]
            for g, w in zip(got_history, want_history):
                np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
                assert [v["accuracy"] for v in g["validation"]] == pytest.approx(
                    [v["accuracy"] for v in w["validation"]], abs=1e-6)
            np.testing.assert_array_equal(got_sel["best_step"], want_sel["best_step"])
            assert [r["member"] for r in got_sel["leaderboard"]] == [
                r["member"] for r in want_sel["leaderboard"]]
