"""Data-parallel training and sharded evaluation (``parallel/``) on the CPU.

Two gloo ranks are spawned once by ``parallel.mesh.launch`` (a module
fixture, in the pattern of tests/test_multiprocess.py) and return what the
tests below check, against the port's solo step in this process and the JAX
package's mesh functions on its 8 CPU devices:

- ``auto_mesh`` against JAX's ``auto_mesh``; the ``--mesh N`` rules;
- the per-rank shard packs against JAX's ``shard_training_data``, D = 2, 3;
- the two-rank replicated step against the solo step over 4 steps (losses
  rtol 1e-5, parameters and BatchNorm statistics atol 1e-5, step metrics):
  MixedNet on spectrograms, raw audio through the plain frontend, a mixed
  corpus whose second rank has no audio rows, Inception with dropout 0.2;
- the two-rank step against JAX's sharded step (``make_train_step`` with a
  2-device mesh) on the same weights and gathered batch: step-0 loss to 1e-5
  relative, the step's BatchNorm statistics to 1e-5;
- a sharded corpus: the ranks' clips are disjoint and make the corpus, each
  rank draws only its own clips, a masked provider is never drawn;
- ``batched_track_probs`` against JAX's on a 2-device mesh (1e-5);
- ``streaming_model_roc``: the same global curve on both ranks, equal to the
  solo curve;
- host residency with a mesh raises ValueError;
- pool refresh over the mesh: rank 0 alone builds (its provider draws fresh
  entropy, as augmentation does), the ranks swap at the same steps to equal
  pools, and the refreshing two-rank run in float64 equals a refreshing solo
  run fed rank 0's pools (1e-9);
- a sharded spectrogram corpus with ``pool_refresh_steps`` prints the JAX
  package's notice and trains without refresh, as JAX's mesh train() does.
"""

import contextlib
import io
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microwakeword_tpu.data.host_stream import HostStreamedData
from microwakeword_tpu.data.store import FeatureHandler as JaxFeatureHandler
from microwakeword_tpu.models import build_model as jax_build_model
from microwakeword_tpu.models.mixednet import MixedNetConfig as JaxConfig
from microwakeword_tpu.parallel import corpus as JC
from microwakeword_tpu.parallel import eval as JEV
from microwakeword_tpu.parallel import mesh as JM
from microwakeword_tpu.train import loop as JT
from microwakeword_tpu_torch.data import sampler as S
from microwakeword_tpu_torch.data.ragged_store import RaggedSpectrogramStore
from microwakeword_tpu_torch.data.refresh import PoolRefresher
from microwakeword_tpu_torch.data.store import FeatureHandler
from microwakeword_tpu_torch.evaluate import streaming_eval as E
from microwakeword_tpu_torch.models import MixedNetConfig, build_model, convert
from microwakeword_tpu_torch.models.inception import InceptionConfig
from microwakeword_tpu_torch.parallel import corpus as C
from microwakeword_tpu_torch.parallel import eval as EV
from microwakeword_tpu_torch.parallel import mesh as M
from microwakeword_tpu_torch.parallel.train_step import make_sharded_train_step, shard_seed
from microwakeword_tpu_torch.train import loop as T

torch.set_num_threads(2)

L, B, STEPS = 31, 16, 4
MIXEDNET = dict(pointwise_filters=(12, 12), repeat_in_block=(1, 1),
                mixconv_kernel_sizes=((3, 5), (5,)), residual_connection=(False, True),
                first_conv_filters=8, first_conv_kernel_size=3, stride=1, spectrogram_length=L)
INCEPTION = dict(cnn1_filters=(8,), cnn1_kernel_sizes=(3,), cnn1_subspectral_groups=(4,),
                 cnn2_filters1=(6,), cnn2_filters2=(8,), cnn2_kernel_sizes=(3,),
                 cnn2_subspectral_groups=(2,), cnn2_dilation=(1,), dropout=0.2,
                 spectrogram_length=L)
PHASE = dict(learning_rate=1e-3, time_mask_max_size=4, time_mask_count=1, freq_mask_max_size=4,
             freq_mask_count=1, positive_class_weight=1.0, negative_class_weight=3.0)
PLAIN_PHASE = dict(PHASE, time_mask_count=0, freq_mask_count=0)  # JAX draws its own masks
CASES = ("mixednet", "raw_audio", "mixed", "inception")
TRACK_LENGTHS = (100, 300, 45, 7, 0)


class _Store:
    def __init__(self, clips):
        self.data = np.concatenate(clips)
        self.offsets = np.concatenate([[0], np.cumsum([len(c) for c in clips])])

    def __len__(self):
        return len(self.offsets) - 1


class _Provider:
    """A provider as the packers read one, with mmap-like ``stores``."""

    def __init__(self, label, weight, strategy, spectrograms=None):
        self.label, self.sampling_weight, self.penalty_weight = label, weight, 1.0
        self.truncation_strategy, self.fixed_right_cutoffs = strategy, [0]
        self.stores = {"training": [_Store(spectrograms)]} if spectrograms else None


class _AudioProvider(_Provider):
    """A clips-type provider: raw audio clips."""

    def __init__(self, label, weight, strategy, audio):
        super().__init__(label, weight, strategy)
        self.audio = audio

    def generate_audio_pool(self, shard_index=0, shard_count=1):
        return self.audio


def _spec_providers():
    """Positives (energy in the high channels), negatives, and a one-clip
    negative provider that only shard 0 holds."""
    rng = np.random.default_rng(0)

    def clips(n, positive):
        out = []
        for _ in range(n):
            s = rng.integers(0, 80, (int(rng.integers(20, 60)), 40))
            s[:, 20:] += 300 if positive else 0
            s[:, :20] += 0 if positive else 300
            out.append(s.astype(np.uint16))
        return out

    return [_Provider(1.0, 1.0, "truncate_start", clips(9, True)),
            _Provider(0.0, 1.0, "random", clips(8, False)),
            _Provider(0.0, 4.0, "random", clips(1, False))]


def _audio_providers():
    """Pulsed tones (positives) and noise, int16, 0.3-0.6 s."""
    rng = np.random.default_rng(1)
    t = np.arange(9600) / 16000.0

    def clip(positive):
        n = int(rng.integers(4800, 9600))
        x = rng.normal(0, 800, n)
        if positive:
            x += 12000 * np.sin(2 * np.pi * 2200 * t[:n])
        return np.clip(x, -32768, 32767).astype(np.int16)

    return [_AudioProvider(1.0, 1.0, "truncate_start", [clip(True) for _ in range(5)]),
            _AudioProvider(0.0, 1.0, "random", [clip(False) for _ in range(5)])]


class _FreshAudioProvider(_AudioProvider):
    """A clips-type provider whose first pool is ``audio`` and whose later
    pools add noise drawn from fresh entropy, as augmentation does, so that
    two ranks would build different pools; it keeps the pools it built.
    Given ``replay`` (rank 0's built pools), it returns those in order."""

    def __init__(self, label, weight, strategy, audio, replay=None):
        super().__init__(label, weight, strategy, audio)
        self.calls, self.built, self.replay = 0, [], replay

    def generate_audio_pool(self, shard_index=0, shard_count=1):
        self.calls += 1
        if self.calls == 1:  # the pack
            return self.audio
        if self.replay is not None:
            pool = self.replay[len(self.built)]
        else:
            rng = np.random.default_rng()
            pool = [np.clip(c + rng.integers(-2000, 2000, len(c)), -32768, 32767).astype(np.int16)
                    for c in self.audio]
        self.built.append(pool)
        return pool


REFRESH_EVERY, REFRESH_STEPS = 2, 6


def _refresh_run(mesh=None, replay=None):
    """REFRESH_STEPS float64 steps of the raw-audio case with a blocking pool
    refresh every REFRESH_EVERY steps: this rank's data-parallel step, or the
    solo step fed ``replay`` (each provider's pools, in order)."""
    providers = [_FreshAudioProvider(p.label, p.sampling_weight, p.truncation_strategy, p.audio,
                                     None if replay is None else replay[i])
                 for i, p in enumerate(_audio_providers())]
    packed = S.pack_audio_data(providers, "cpu")
    bundle = _bundle("raw_audio")
    model = bundle.init(torch.Generator().manual_seed(5), device="cpu").to(torch.float64)
    gen = torch.Generator().manual_seed(3)
    if mesh is None:
        step = T.make_train_step(bundle, model, packed, B, L, generator=gen)
    else:
        step = make_sharded_train_step(bundle, model, packed, B, L, mesh, generator=gen)
    refresher = PoolRefresher(types.SimpleNamespace(providers=providers), packed, REFRESH_EVERY,
                              mesh=mesh).start()
    losses, swaps, collectives = [], [], []
    try:
        for i in range(1, REFRESH_STEPS + 1):
            losses.append(float(step.step(**PHASE)["loss"]))
            before = mesh.collectives if mesh else 0
            if refresher.maybe_swap(packed, i, block=True):
                swaps.append((i, packed.chunks.clone()))
            collectives.append(mesh.collectives - before if mesh else 0)
    finally:
        refresher.stop()
    return {"losses": losses, "state": {k: v.clone() for k, v in model.state_dict().items()},
            "swaps": swaps, "collectives": collectives, "thread": refresher._thread.ident,
            "built": [p.built for p in providers]}


def _corpus(case):
    if case == "raw_audio":
        return S.pack_audio_data(_audio_providers(), "cpu")
    if case == "mixed":  # audio 2 of 8 sampling weight: 4 audio rows, all on rank 0
        return S.pack_mixed_data(_audio_providers() + _spec_providers(), "cpu")
    return S.pack_training_data(_spec_providers(), "cpu")


def _bundle(case="mixednet"):
    if case == "inception":
        return build_model("inception", InceptionConfig(**INCEPTION))
    return build_model("mixednet", MixedNetConfig(**MIXEDNET))


def _train(case, mesh=None):
    """STEPS steps of the solo step, or of this rank's data-parallel step:
    (losses, state, last metrics)."""
    bundle = _bundle(case)
    model = bundle.init(torch.Generator().manual_seed(5), device="cpu")
    gen = torch.Generator().manual_seed(3)
    if mesh is None:
        step = T.make_train_step(bundle, model, _corpus(case), B, L, generator=gen)
    else:
        step = make_sharded_train_step(bundle, model, _corpus(case), B, L, mesh, generator=gen)
    metrics = [step.step(**PHASE) for _ in range(STEPS)]
    return ([float(m["loss"]) for m in metrics],
            {k: v.detach().clone() for k, v in model.state_dict().items()},
            {k: float(v) for k, v in metrics[-1].items()})


def _gathered_batch():
    """One gathered batch: uint16 windows, leading invalid rows, labels, weights."""
    rng = np.random.default_rng(2)
    labels = (rng.uniform(size=B) < 0.4).astype(np.float32)
    windows = rng.integers(0, 300, (B, L, 40)).astype(np.uint16)
    windows[labels > 0.5, :, 20:] += 300
    windows[labels < 0.5, :, :20] += 300
    valid = np.arange(L)[None, :] >= rng.integers(-10, 8, B)[:, None]
    return windows, valid, labels, rng.uniform(1.0, 2.0, B).astype(np.float32)


def _init_state():
    model = _bundle().init(torch.Generator().manual_seed(5), device="cpu")
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


def _tracks():
    rng = np.random.default_rng(4)
    return [rng.uniform(0, 20, (t, 40)).astype(np.float32) for t in TRACK_LENGTHS]


def _sharded_draws(mesh):
    """This rank's shard: its real clips' frames, and 30 draws of its rows
    (the frame rows read and the providers chosen)."""
    packed = C.pack_shard(_spec_providers(), mesh)
    real = int(np.sum(packed.provider_clip_count.numpy()[packed.provider_logits.numpy() > -1e29]))
    offsets, lengths = packed.clip_offset.numpy(), packed.clip_length.numpy()
    frames = packed.frames.numpy()
    clips = [frames[o : o + n].tobytes() for o, n in zip(offsets[:real], lengths[:real])]
    gen = torch.Generator().manual_seed(shard_seed(3, mesh.rank))
    p = packed.provider_logits.shape[0]
    provs, rows = [], []
    for _ in range(30):
        u = S.window_uniforms(packed, gen, B // mesh.size)
        provs += torch.argmax(packed.provider_logits - torch.log(-torch.log(u[:, :p])),
                              dim=1).tolist()
        off, n, start, _, _ = S.windows_from_uniforms(packed, u, L)
        r, valid = S.window_rows(off, n, start, L)
        rows += r[valid].tolist()
    spans = [(int(o), int(o + n)) for o, n in zip(offsets[:real], lengths[:real])]
    return {"clips": clips, "provider_logits": packed.provider_logits.numpy(), "provs": provs,
            "rows_in_own_clips": all(any(a <= r < b for a, b in spans) for r in rows)}


def _rank_checks(store_config):
    """Everything the tests read, computed on one rank of a 2-rank mesh."""
    mesh = M.create_mesh(2, "cpu")
    out = {"rank": mesh.rank, "train": {case: _train(case, mesh) for case in CASES}}

    bundle = _bundle()
    model = bundle.load(_init_state(), "cpu")
    step = make_sharded_train_step(bundle, model, None, B, L, mesh)
    batch = [torch.from_numpy(a) for a in _gathered_batch()]
    batch[0] = S.frames_tensor(_gathered_batch()[0])
    out["jax_step0"] = (float(step.step_on_batch(*batch, **PLAIN_PHASE)["loss"]),
                        {k: v.clone() for k, v in model.state_dict().items()})

    out["shard"] = _sharded_draws(mesh)
    gen = torch.Generator().manual_seed(shard_seed(3, mesh.rank))
    model = bundle.init(torch.Generator().manual_seed(5), device="cpu")
    sharded = make_sharded_train_step(bundle, model, C.pack_shard(_spec_providers(), mesh), B,
                                      L, mesh, generator=gen, sharded=True)
    out["shard"]["losses"] = [float(sharded.step(**PHASE)["loss"]) for _ in range(2)]
    out["shard"]["state"] = {k: v.clone() for k, v in model.state_dict().items()}

    model = bundle.load(_init_state(), "cpu")
    out["tracks"] = EV.batched_track_probs(bundle, model, _tracks(), mesh)
    out["roc"] = E.streaming_model_roc(bundle, model, FeatureHandler(store_config),
                                       store_config, mesh=mesh)
    try:
        T.train(bundle, dict(store_config, corpus_residency="host"), FeatureHandler(store_config),
                device="cpu", mesh=mesh)
        out["host_error"] = None
    except ValueError as e:
        out["host_error"] = str(e)

    out["refresh"] = _refresh_run(mesh)
    config = _sharded_refresh_config(store_config, "port_sharded_refresh")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        _, history = T.train(bundle, config, FeatureHandler(config), device="cpu", mesh=mesh)
    out["sharded_refresh"] = (printed.getvalue().splitlines(), history)
    return out


def _sharded_refresh_config(store_config, name):
    return dict(store_config, train_dir=f"{store_config['train_dir']}_{name}",
                corpus_sharding="shard", pool_refresh_steps=1)


@pytest.fixture(scope="module")
def store_config(tmp_path_factory):
    """A tiny store with testing and testing_ambient sets (streaming ROC)."""
    root = tmp_path_factory.mktemp("parallel_store")
    rng = np.random.default_rng(5)
    for name, positive, modes in [("pos", True, {"training": 6, "testing": 5}),
                                  ("neg", False, {"training": 6, "testing": 4,
                                                  "testing_ambient": 3})]:
        for mode, n in modes.items():
            lo, hi = (150, 200) if mode.endswith("ambient") else (40, 90)
            specs = []
            for _ in range(n):
                s = rng.uniform(0, 80, (int(rng.integers(lo, hi)), 40))
                s[:, 20:] += 300 if positive else 0
                specs.append(s.astype(np.uint16))
            RaggedSpectrogramStore.create(str(root / name / mode / "w_mmap"), specs)
    return {
        "train_dir": str(root / "run"), "window_step_ms": 10, "batch_size": B,
        "spectrogram_length": L, "training_steps": [2], "eval_step_interval": 2, "stride": 1,
        "features": [{"features_dir": str(root / name), "truth": truth, "sampling_weight": 1.0,
                      "penalty_weight": 1.0, "truncation_strategy": "random", "type": "mmap"}
                     for name, truth in (("pos", True), ("neg", False))],
    }


@pytest.fixture(scope="module")
def ranks(store_config):
    return M.launch(_rank_checks, 2, "cpu", store_config)


@pytest.mark.parametrize("batch_size", [1, 2, 3, 6, 7, 8, 12, 16, 30, 128])
@pytest.mark.parametrize("min_devices", [1, 2, 4])
def test_auto_mesh_matches_jax(monkeypatch, batch_size, min_devices):
    assert len(jax.devices()) == 8
    want = JM.auto_mesh(batch_size, min_devices)
    monkeypatch.setattr(M, "device_count", lambda device=None: 8)
    got = M.auto_mesh(batch_size, min_devices, device="cpu")
    assert got == (None if want is None else want.devices.size)


def test_mesh_flag_rules(monkeypatch):
    """``--mesh N`` above the visible cards raises (JAX would take fewer
    devices), N must divide the batch, 1 and 'off' are one device, and
    ``auto`` on one card is one device."""
    assert M.mesh_size("off", 128, "cpu") is None
    assert M.mesh_size("1", 128, "cpu") is None
    assert M.mesh_size("auto", 128, "cpu") is None  # the CPU is one device
    assert M.mesh_size("2", 128, "cpu") == 2  # CPU ranks are processes
    with pytest.raises(ValueError, match="does not divide"):
        M.mesh_size("3", 128, "cpu")
    monkeypatch.setattr(M, "resolve_device", lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(M, "device_count", lambda device=None: 1)
    assert M.mesh_size("auto", 128, "cuda") is None
    assert M.mesh_size("1", 128, "cuda") is None
    with pytest.raises(ValueError, match="only 1 CUDA device"):
        M.mesh_size("2", 128, "cuda")
    with pytest.raises(ValueError, match="only 1 CUDA device"):
        M.launch(None, 2, "cuda")
    with pytest.raises(ValueError, match="process group"):
        M.create_mesh(2, "cpu")


@pytest.mark.parametrize("d", [2, 3])
def test_shard_packs_match_jax(d):
    """Rank r's pack (pack_training_arrays' shard r padded to the ranks'
    common lengths) equals device r's arrays of JAX's shard_training_data,
    the padding included."""
    shards = [S.pack_training_arrays(_spec_providers(), r, d) for r in range(d)]
    lengths = np.max([C.shard_lengths(a) for a in shards], axis=0)
    want = JC.shard_training_data(_spec_providers(), JM.create_mesh(d)).stacked
    for r, arrays in enumerate(shards):
        got = C.pad_shard(arrays, lengths)
        assert got["edge_pad"] == want.edge_pad
        for key in C._PAD_VALUES:
            np.testing.assert_array_equal(got[key], np.asarray(getattr(want, key))[r], err_msg=key)
    # the one-clip provider is on shard 0 alone; elsewhere its row is masked
    assert all(np.asarray(want.provider_logits)[r, -1] == C.NEG_INF_LOGIT for r in range(1, d))


@pytest.mark.parametrize("case", CASES)
def test_replicated_step_equals_solo(ranks, case):
    """Global BatchNorm statistics, the global loss and gradient, the solo
    batch's rows and dropout mask: the two-rank step is the solo step."""
    losses, state, metrics = _train(case)
    for out in ranks:
        got_losses, got_state, got_metrics = out["train"][case]
        np.testing.assert_allclose(got_losses, losses, rtol=1e-5)
        for key, value in state.items():
            np.testing.assert_allclose(got_state[key].numpy(), value.numpy(), atol=1e-5,
                                       err_msg=key)
        for key, value in metrics.items():
            assert got_metrics[key] == pytest.approx(value, rel=1e-5, abs=1e-6), key
    a, b = (out["train"][case][1] for out in ranks)
    assert all(torch.equal(a[k], b[k]) for k in a)  # every rank holds the same weights


def test_step_matches_jax_sharded_step(ranks):
    """The same weights and gathered batch through JAX's step on a 2-device
    mesh (the HostStreamedData route of tests/test_torch_train_step.py)."""
    jb = jax_build_model("mixednet", JaxConfig(**MIXEDNET))
    variables = convert.state_to_flax(_init_state())
    arrays = dict(
        frames=np.zeros((8, 40), np.uint16), edge_pad=0,
        clip_offset=np.zeros(1, np.int32), clip_length=np.full(1, 8, np.int32),
        provider_logits=np.zeros(1, np.float32), provider_clip_start=np.zeros(1, np.int32),
        provider_clip_count=np.ones(1, np.int32), provider_label=np.ones(1, np.float32),
        provider_penalty=np.ones(1, np.float32), provider_strategy=np.zeros(1, np.int32),
        provider_cutoffs=np.zeros((1, 8), np.int32), provider_n_cutoffs=np.ones(1, np.int32))
    optimizer, call = JT.make_train_step(jb, HostStreamedData(arrays), B, L,
                                         mesh=JM.create_mesh(2))
    _, stats, _, metrics = call.jitted(
        variables["params"], variables["batch_stats"], optimizer.init(variables["params"]),
        jax.random.PRNGKey(0), tuple(jnp.asarray(a) for a in _gathered_batch()), **PLAIN_PHASE)
    for out in ranks:
        loss, state = out["jax_step0"]
        np.testing.assert_allclose(loss, float(metrics["loss"]), rtol=1e-5)
        # the statistics of the step's forward pass (Adam's first update,
        # lr * g / (|g| + eps), is a sign for every gradient, so reduction
        # order flips the parameters of the near-zero ones)
        have = convert.flatten(convert.state_to_flax(
            {k: v.numpy() for k, v in state.items()})["batch_stats"])
        want = convert.flatten(jax.tree_util.tree_map(np.asarray, stats))
        assert set(have) == set(want)
        for key in want:
            np.testing.assert_allclose(have[key], want[key], atol=1e-5, err_msg=key)


def test_sharded_corpus_draws_own_clips(ranks):
    full = [c.tobytes() for p in _spec_providers() for s in p.stores["training"]
            for c in np.split(s.data, s.offsets[1:-1])]
    shards = [set(out["shard"]["clips"]) for out in ranks]
    assert not shards[0] & shards[1] and shards[0] | shards[1] == set(full)
    for out in ranks:
        shard = out["shard"]
        assert shard["rows_in_own_clips"]
        real = np.flatnonzero(shard["provider_logits"] > -1e29)
        assert set(shard["provs"]) <= set(real.tolist())
        assert np.isfinite(shard["losses"]).all()
    # rank 0 holds the one-clip provider (weight 4 of 6) and draws it; rank 1
    # has its padding row, never drawn
    assert 2 in ranks[0]["shard"]["provs"]
    assert ranks[1]["shard"]["provider_logits"][-1] == C.NEG_INF_LOGIT
    a, b = (out["shard"]["state"] for out in ranks)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_batched_track_probs_matches_jax(ranks):
    jb = jax_build_model("mixednet", JaxConfig(**MIXEDNET))
    want = JEV.batched_track_probs(jb, convert.state_to_flax(_init_state()), _tracks(),
                                   JM.create_mesh(2))
    for out in ranks:
        assert [len(p) for p in out["tracks"]] == list(TRACK_LENGTHS)
        for got, ref in zip(out["tracks"], want):
            np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5)


def test_streaming_roc_is_global_on_every_rank(ranks, store_config):
    bundle = _bundle()
    want = E.streaming_model_roc(bundle, bundle.load(_init_state(), "cpu"),
                                 FeatureHandler(store_config), store_config)
    assert want["positive_count"] == 5
    for out in ranks:
        got = out["roc"]
        assert got["positive_count"] == want["positive_count"]
        assert got["auc"] == pytest.approx(want["auc"], abs=1e-6)
        for key in ("x_faph", "y_frr", "cutoffs", "faph_at_cutoffs", "frr_at_cutoffs"):
            np.testing.assert_allclose(got[key], want[key], atol=1e-6, err_msg=key)


def test_host_residency_with_mesh_raises(ranks):
    for out in ranks:
        assert out["host_error"] is not None and "corpus_residency: host" in out["host_error"]


def test_mesh_refresh_swaps_rank0_pools(ranks):
    """Rank 0 alone runs the build thread; the ranks swap at the same due
    steps to equal pools that are rank 0's builds, each swap one flag and one
    chunk broadcast, no collective between due steps; every rank ends with
    the same weights."""
    a, b = (out["refresh"] for out in ranks)
    assert a["thread"] is not None and b["thread"] is None
    assert [s for s, _ in a["swaps"]] == [s for s, _ in b["swaps"]] == [2, 4, 6]
    for (_, x), (_, y) in zip(a["swaps"], b["swaps"]):
        assert torch.equal(x, y)
    assert all(not built for built in b["built"])  # rank 1 built nothing
    initial = S.pack_audio_data(_audio_providers(), "cpu").chunks
    assert not torch.equal(a["swaps"][0][1], initial)
    for out in (a, b):
        assert out["collectives"] == [0, 2, 0, 2, 0, 2]
    assert all(torch.equal(a["state"][k], b["state"][k]) for k in a["state"])


def test_mesh_refresh_equals_solo_fed_rank0_pools(ranks):
    """In float64 the refreshing two-rank run equals a refreshing solo run
    whose providers return rank 0's pools in order (1e-9)."""
    rank0 = ranks[0]["refresh"]
    solo = _refresh_run(replay=rank0["built"])
    assert [s for s, _ in solo["swaps"]] == [s for s, _ in rank0["swaps"]]
    for (_, x), (_, y) in zip(solo["swaps"], rank0["swaps"]):
        assert torch.equal(x, y)
    for out in ranks:
        np.testing.assert_allclose(out["refresh"]["losses"], solo["losses"], rtol=1e-9)
        for key, value in solo["state"].items():
            np.testing.assert_allclose(out["refresh"]["state"][key].numpy(), value.numpy(),
                                       atol=1e-9, err_msg=key)


def test_sharded_corpus_refresh_is_ignored_as_in_jax(ranks, store_config):
    """A sharded spectrogram corpus with pool_refresh_steps: rank 0 prints the
    JAX notice and both ranks train without refresh; JAX's train() on a
    2-device mesh prints the same notice and trains."""
    for out in ranks:
        printed, history = out["sharded_refresh"]
        assert (T.REFRESH_IGNORED in printed) == (out["rank"] == 0)
        assert [r["step"] for r in history] == [2] and "pool_swaps" not in history[-1]
        assert np.isfinite(history[-1]["train"]["loss"])
    config = _sharded_refresh_config(store_config, "jax_sharded_refresh")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        _, history = JT.train(jax_build_model("mixednet", JaxConfig(**MIXEDNET)), config,
                              JaxFeatureHandler(config), mesh=JM.create_mesh(2))
    assert T.REFRESH_IGNORED in printed.getvalue().splitlines()
    assert [r["step"] for r in history] == [2]
