"""The plain reference against the port at small sizes on the CPU.  The
reference imports nothing of the port; these tests hold the two side by
side so that a run's gaps measure the port, not the reference."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.lib import inputs
from benchmark.lib.cell import ROOT, load_json, module
from benchmark.reference import accepts as RA
from benchmark.reference import frontend as RF
from benchmark.reference import training as RT

CONFIGS = {name: load_json(ROOT / f"benchmark/configs/{name}.json")
           for name in ("mixednet-okay-nabu", "inception-default")}


def port_bundle(config):
    from microwakeword_tpu_torch.models import build_model
    from microwakeword_tpu_torch.models.registry import FAMILIES

    def frozen(v):
        return tuple(frozen(x) for x in v) if isinstance(v, list) else v

    cfg = FAMILIES[config["family"]][0](**{k: frozen(v) for k, v in config["model"].items()})
    return build_model(config["family"], cfg)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_model_against_port(name):
    config = CONFIGS[name]
    ref, cfg = module("reference", config["family"]), config["model"]
    bundle = port_bundle(config)
    shapes = ref.state_shapes(cfg)
    port_shapes = {k: tuple(v.shape) for k, v in bundle.build().state_dict().items()}
    assert list(shapes.items()) == list(port_shapes.items())
    state = inputs.weights(shapes, torch.Generator().manual_seed(3), "cpu", serving=True)
    model = bundle.load(state, "cpu")
    ref_state = {k: v.double() for k, v in state.items()}
    x = torch.rand((3, cfg["spectrogram_length"] + 12, 40), generator=torch.Generator().manual_seed(4)) * 20
    with torch.no_grad():
        streamed = bundle.stream_scan(model, x)[..., 0]
        full = bundle.forward(model, x[:, :cfg["spectrogram_length"]])
    assert torch.allclose(streamed.double(), ref.stream_probs(ref_state, cfg, x), atol=1e-6)
    assert torch.allclose(full.double(), ref.forward(ref_state, cfg, x[:, :cfg["spectrogram_length"]]),
                          atol=1e-6)
    keep = torch.rand((3, shapes["Dense_0.weight"][1])) < 0.8
    model.train()
    with torch.no_grad():
        trained = model(x[:, :cfg["spectrogram_length"]], keep)
    want = ref.forward(ref_state, cfg, x[:, :cfg["spectrogram_length"]], train=True, keep=keep)
    assert torch.allclose(trained.double(), want, atol=1e-6)


def test_frontend_against_port():
    from microwakeword_tpu_torch.frontend import gate, plain

    pcm = inputs.pcm_clips(torch.Generator().manual_seed(7), 3, 20_000, True, "cpu")
    for step_ms in (10, 20):
        got = plain.frontend_batch(pcm, step_ms).numpy()
        want = RF.features(pcm, step_ms).numpy()
        assert gate.q6_gate(got, want).ok


def test_accept_counting_against_port():
    from microwakeword_tpu_torch.evaluate import roc

    probs = torch.rand((4, 200), generator=torch.Generator().manual_seed(8))
    ma = roc.moving_average(probs, 5)
    assert np.array_equal(ma.numpy(), RA.sliding_mean(probs.numpy(), 5))
    want = RA.accept_counts(RA.sliding_mean(probs.numpy(), 5), RA.DEFAULT_CUTOFFS, 25)
    assert np.array_equal(roc.count_accepts(ma, roc.DEFAULT_CUTOFFS, 25).numpy(), want)


def _providers(kind):
    gen = torch.Generator().manual_seed(9)
    specs = [(1.0, 2.0, "truncate_start"), (0.0, 10.0, "random")]
    if kind == "audio":
        return [RT.Provider(label, 1.0, weight, strategy,
                            inputs.pcm_clips(gen, 6, 40_000, label > 0.5, "cpu").numpy())
                for label, weight, strategy in specs]
    out = []
    for (label, weight, strategy), frames in zip(specs, [(40, 80), (30, 140)]):
        data, offsets = inputs.spectrogram_corpus(gen, 7, frames, label > 0.5, 40, "cpu")
        out.append(RT.Provider(label, 1.0, weight, strategy, data, offsets))
    return out


class _Port:
    """A reference provider as the port's packing functions read one."""

    def __init__(self, p):
        self.sampling_weight, self.label, self.penalty_weight = p.weight, p.label, p.penalty
        self.truncation_strategy, self.fixed_right_cutoffs = p.strategy, []
        self._p = p
        if p.offsets is not None:
            store = type("Store", (), {"data": p.data, "offsets": p.offsets,
                                       "__len__": lambda s: len(p.offsets) - 1})()
            self.stores = {"training": [store]}

    def generate_audio_pool(self, shard_index=0, shard_count=1):
        return iter(self._p.data)


@pytest.mark.parametrize("kind", ["audio", "spectrogram"])
def test_batch_draws_against_port(kind):
    from microwakeword_tpu_torch.data import sampler

    providers = _providers(kind)
    port = [_Port(p) for p in providers]
    masks = dict(time_mask_max_size=5, time_mask_count=2, freq_mask_max_size=5, freq_mask_count=2)
    g_port, g_ref = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    if kind == "audio":
        packed = sampler.pack_audio_data(port, "cpu")
        pcm, labels, pen = sampler.draw_audio_windows(packed, g_port, 16, 60)
        r_pcm, r_labels, r_pen = RT.draw_audio(providers, g_ref, 16, 60, 10, "cpu")
        assert torch.equal(pcm, r_pcm)
    else:
        packed = sampler.pack_training_data(port, "cpu")
        feats, labels, pen = sampler.sample_batch(packed, g_port, 16, 60, **masks)
        r_feats, r_labels, r_pen = RT.draw_spectrograms(providers, g_ref, 16, 60, 0.0390625, "cpu",
                                                        torch.float32)
        r_feats = RT.spec_augment(g_ref, r_feats, 5, 2, 5, 2)
        assert torch.equal(feats, r_feats)
    assert torch.equal(labels, r_labels) and torch.equal(pen, r_pen)
    assert 0 < float(labels.sum()) < 16
