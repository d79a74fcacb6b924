"""Host-streamed corpora (``data/host_stream.py``) on the CPU.

Torch's CPU and CUDA generators give different streams, so the host's draws
cannot be held against the card's; as the sampler's tests do, the same draws
go through ``windows_from_draws`` on both sides instead:

- the budget and ``corpus_residency`` (auto, hbm, host, the env override, a
  bad value) pick the residency as the JAX package's
  ``pack_training_with_residency`` does;
- the host producer's batches equal the resident gather's, bit for bit, for
  the same draws, with ``steps_per_call`` 1 and 3 and across reuse of its
  two pinned buffers;
- the host draw's provider frequencies follow the sampling weights;
- ``train()`` in host mode gives the losses and weights of the resident step
  fed the same batches.
"""

import numpy as np
import pytest
import torch

from microwakeword_tpu_torch.config import derive_config
from microwakeword_tpu_torch.data import sampler as S
from microwakeword_tpu_torch.data.host_stream import (
    HostBatchProducer,
    HostStreamedData,
    corpus_nbytes,
    hbm_corpus_budget,
    pack_training_with_residency,
)
from microwakeword_tpu_torch.data.ragged_store import RaggedSpectrogramStore
from microwakeword_tpu_torch.data.store import FeatureHandler
from microwakeword_tpu_torch.models import MixedNetConfig, build_model
from microwakeword_tpu_torch.train import loop as T

torch.set_num_threads(2)

B = 16


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    """A small store: positives with energy in the high channels, negatives
    in the low ones; sampling weights 1 : 3."""
    root = tmp_path_factory.mktemp("host_store")
    rng = np.random.default_rng(0)
    for name, positive, n in (("pos", True, 20), ("neg", False, 30)):
        specs = []
        for _ in range(n):
            spec = rng.integers(0, 80, (int(rng.integers(20, 60)), 40)).astype(np.uint16)
            spec[:, 20:] += 300 if positive else 0
            spec[:, :20] += 0 if positive else 300
            specs.append(spec)
        RaggedSpectrogramStore.create(str(root / name / "training" / "w_mmap"), specs)
    cfg = {
        "train_dir": str(root / "run"), "clip_duration_ms": 290, "window_step_ms": 10,
        "batch_size": B, "training_steps": [6], "learning_rates": [0.01], "eval_step_interval": 3,
        "seed": 5, "steps_per_call": 1,
        "features": [
            {"features_dir": str(root / "pos"), "truth": True, "sampling_weight": 1.0,
             "penalty_weight": 1.0, "truncation_strategy": "truncate_start", "type": "mmap"},
            {"features_dir": str(root / "neg"), "truth": False, "sampling_weight": 3.0,
             "penalty_weight": 2.0, "truncation_strategy": "random", "type": "mmap"},
        ],
    }
    model_cfg = MixedNetConfig(pointwise_filters=(8, 8), repeat_in_block=(1, 1),
                               mixconv_kernel_sizes=((3,), (5,)),
                               residual_connection=(False, False), first_conv_filters=8,
                               first_conv_kernel_size=3, spectrogram_length=10_000)
    return derive_config(cfg, model_cfg)


def _arrays(config):
    return S.pack_training_arrays(FeatureHandler(config, "cpu").providers, device="cpu")


def test_budget(monkeypatch):
    monkeypatch.delenv("MWW_CORPUS_HBM_BUDGET", raising=False)
    assert hbm_corpus_budget("cpu") == 6 * 10**9
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"total_memory": 80 * 2**30})())
    assert hbm_corpus_budget() == int(80 * 2**30 * 0.6)  # None: the card
    monkeypatch.setenv("MWW_CORPUS_HBM_BUDGET", "1e6")
    assert hbm_corpus_budget() == 10**6
    assert hbm_corpus_budget("cpu") == 10**6


@pytest.mark.parametrize("residency,budget,want", [
    ("auto", 10**12, S.PackedTrainingData),
    ("hbm", 10**12, S.PackedTrainingData),
    ("auto", 1000, HostStreamedData),
    ("host", 10**12, HostStreamedData),
    ("hbm", 1000, ValueError),
    ("disk", 10**12, ValueError),
])
def test_residency(config, monkeypatch, capsys, residency, budget, want):
    monkeypatch.setenv("MWW_CORPUS_HBM_BUDGET", str(budget))
    providers = FeatureHandler(config, "cpu").providers
    cfg = {"corpus_residency": residency}
    if want is ValueError:
        with pytest.raises(ValueError, match="corpus_residency"):
            pack_training_with_residency(providers, cfg, "cpu")
        return
    packed = pack_training_with_residency(providers, cfg, "cpu")
    assert isinstance(packed, want)
    notice = "streaming it from host RAM" in capsys.readouterr().out
    assert notice == (residency == "auto" and want is HostStreamedData)
    if want is HostStreamedData:
        arrays = _arrays(config)
        assert packed.nbytes == arrays["frames"].nbytes
        assert corpus_nbytes(arrays) > budget or residency == "host"
        np.testing.assert_array_equal(packed.frames.view(np.uint16), arrays["frames"])
        assert packed.meta.frames.shape == (1, 40)


@pytest.mark.parametrize("steps", [1, 3])
def test_host_batches_bit_equal_to_resident(config, steps):
    """The same draws (a second generator with the producer's seed) through
    the resident gather give the producer's windows, bit for bit; five calls
    cycle both pinned buffers, and earlier batches stay as they were."""
    arrays = _arrays(config)
    resident = S.upload_training_arrays(arrays, "cpu")
    length = config["spectrogram_length"]
    producer = HostBatchProducer(HostStreamedData(arrays), B, length, steps, "cpu",
                                 torch.Generator().manual_seed(9))
    same_draws = torch.Generator().manual_seed(9)
    kept = []
    for call in range(5):
        n = steps if call != 3 else 1  # a short call, as at an eval boundary
        got = producer(n)
        want = []
        for _ in range(n):
            rows, valid, labels, weights = S.sample_batch_indices(resident, same_draws, B, length)
            want.append((resident.frames[rows], valid, labels, weights))
        want = tuple(torch.stack(t) for t in zip(*want))
        if steps == 1:
            want = tuple(t[0] for t in want)
        assert got[0].dtype == torch.int16 and got[0].shape[-2:] == (length, 40)
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.equal(g, w)
        kept.append((got, want))
    for got, want in kept:
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert producer.waits == 0  # the CPU records no copy events

    # and the finished features equal sample_batch's on the resident corpus
    feats_gen, sample_gen = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    host = HostBatchProducer(HostStreamedData(arrays), B, length, 1, "cpu", feats_gen)
    windows, valid, labels, weights = host()
    feats, labels_r, weights_r = S.sample_batch(resident, sample_gen, B, length)
    assert torch.equal(S.finish_batch(None, windows, valid), feats)
    assert torch.equal(labels, labels_r) and torch.equal(weights, weights_r)


def test_host_draw_provider_frequencies(config):
    """Sampling weights 1 : 3 give a quarter positives (penalty 1) and three
    quarters negatives (penalty 2)."""
    length = config["spectrogram_length"]
    producer = HostBatchProducer(HostStreamedData(_arrays(config)), 256, length, 1, "cpu",
                                 torch.Generator().manual_seed(1))
    _, valid, labels, weights = producer.draw(16)
    frac = float(labels.mean())
    assert abs(frac - 0.25) < 0.02, frac  # 4,096 draws: 3.5 standard deviations
    assert torch.equal(weights, torch.where(labels > 0.5, 1.0, 2.0))
    # positives are truncate_start: every window ends on the clip's last frame
    assert bool(valid[labels > 0.5][:, -1].all())


@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_host_mode_train_matches_resident_fed_same_batches(config, tmp_path, steps_per_call):
    """train() with corpus_residency: host against the resident TrainStep
    fed the resident gather of the same draws, from the same weights and
    step generator: the same losses at every record and the same weights."""
    cfg = dict(config, train_dir=str(tmp_path / "host"), corpus_residency="host",
               steps_per_call=steps_per_call)
    bundle = build_model("mixednet", config["model_config"])
    fh = FeatureHandler(cfg, "cpu")
    model, history = T.train(bundle, cfg, fh, device="cpu")
    assert [r["step"] for r in history] == [3, 6]

    seed, length = cfg["seed"], cfg["spectrogram_length"]
    resident = S.upload_training_arrays(_arrays(config), "cpu")
    replica = bundle.init(torch.Generator().manual_seed(seed), device="cpu")
    step = T.make_train_step(bundle, replica, resident, B, length,
                             generator=torch.Generator().manual_seed(seed))
    draws = torch.Generator().manual_seed(seed)
    phase = {k: v for k, v in T.resolve_schedules(cfg)[0].items() if k != "steps"}
    losses = []
    for _ in range(6):
        rows, valid, labels, weights = S.sample_batch_indices(resident, draws, B, length)
        losses.append(float(step.step_on_batch(resident.frames[rows], valid, labels, weights,
                                               **phase)["loss"]))
    assert [r["train"]["loss"] for r in history] == [losses[2], losses[5]]
    for k, v in replica.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
