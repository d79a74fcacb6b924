"""The port's raw-audio and mixed sampler against the JAX package's.

- ``pack_audio_data`` and ``pack_mixed_data`` equal JAX's arrays at 10 and
  20 ms hops;
- ``audio_windows_from_draws``, fed the values JAX draws from a step key
  (``r_prov, r_clip, r_win, r_aug = split(rng, 4)``), gives bit-equal chunk
  windows, and its features pass the Q6 gate against JAX's
  ``sample_audio_feature_batch`` (the xla backend with and without
  SpecAugment, and once the pallas backend in interpret mode);
- short clips are right-aligned behind leading silence;
- the mixed batch's sub-batch sizes and layout;
- the torch draw's provider frequencies and window ranges;
- the raw-audio and mixed samplers never ask the host for a value.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from microwakeword_tpu.data import sampler as JS
from microwakeword_tpu.data.ragged_store import RaggedSpectrogramStore
from microwakeword_tpu.data.store import FeatureHandler as JaxFeatureHandler
from microwakeword_tpu_torch.data import sampler as S
from microwakeword_tpu_torch.data.store import FeatureHandler
from microwakeword_tpu_torch.frontend import gate

torch.set_num_threads(2)

L = 24
BATCH = 16
MASKS = dict(time_mask_max_size=5, time_mask_count=2, freq_mask_max_size=5, freq_mask_count=2)
STRATEGIES = ("random", "truncate_start", "truncate_end", "fixed_right_cutoff")


class FakeAudioProvider:
    """A clips-type provider with fixed clips, for both packages."""

    def __init__(self, clips, strategy="random", weight=1.0, label=1.0, penalty=1.0):
        self.clips = clips
        self.truncation_strategy = strategy
        self.sampling_weight = weight
        self.label = label
        self.penalty_weight = penalty
        self.fixed_right_cutoffs = [0]

    def generate_audio_pool(self, shard_index, shard_count):
        return self.clips


def _providers(step_ms=10, seed=0):
    """Four providers, one per strategy, with clips shorter and longer than
    the window, float and int16."""
    rng = np.random.default_rng(seed)
    hop = 16 * step_ms
    out = []
    for i, strategy in enumerate(STRATEGIES):
        lengths = rng.integers(hop * 8, hop * (L + 30), 5 + i)
        clips = [rng.uniform(-0.6, 0.6, n).astype(np.float32) if k % 2 else
                 rng.integers(-20000, 20000, n).astype(np.int16) for k, n in enumerate(lengths)]
        out.append(FakeAudioProvider(clips, strategy, weight=(3.0, 1.0, 0.5, 1.5)[i],
                                     label=float(i % 2), penalty=1.0 + i))
    return out


def _assert_fields_equal(got, want, fields):
    for name in fields:
        g, w = getattr(got, name), getattr(want, name)
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert np.asarray(g).dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


AUDIO_FIELDS = ("chunks", "clip_offset", "clip_chunks", "provider_logits", "provider_clip_start",
                "provider_clip_count", "provider_label", "provider_penalty", "provider_strategy",
                "hop_samples", "edge_pad")


@pytest.mark.parametrize("step_ms", [10, 20])
def test_pack_audio_data_matches_jax(step_ms):
    providers = _providers(step_ms)
    want = JS.pack_audio_data(providers, 0, 1, step_ms=step_ms)
    got = S.pack_audio_data(providers, "cpu", 0, 1, step_ms=step_ms)
    _assert_fields_equal(got, want, AUDIO_FIELDS)
    assert got.chunks.shape[1] == 16 * step_ms


@pytest.fixture(scope="module")
def mmap_config(tmp_path_factory):
    """Two mmap feature dirs with training clips and one validation-only."""
    root = tmp_path_factory.mktemp("mixed_stores")
    rng = np.random.default_rng(1)
    for name, modes in (("neg", ("training",)), ("neg2", ("training",)), ("val", ("validation",))):
        for mode in modes:
            specs = [rng.integers(0, 700, (int(t), 40), dtype=np.uint16)
                     for t in rng.integers(10, 60, 9)]
            RaggedSpectrogramStore.create(str(root / name / mode / "x_mmap"), specs)
    features = [{"features_dir": str(root / name), "truth": False, "sampling_weight": w,
                 "penalty_weight": 0.5, "truncation_strategy": "random", "type": "mmap"}
                for name, w in (("neg", 2.0), ("neg2", 1.0), ("val", 5.0))]
    return {"stride": 1, "window_step_ms": 10, "features": features}


@pytest.mark.parametrize("step_ms", [10, 20])
def test_pack_mixed_data_matches_jax(mmap_config, step_ms):
    audio = _providers(step_ms, seed=2)[:2]
    want = JS.pack_mixed_data(audio + JaxFeatureHandler(mmap_config).providers, 0, 1, step_ms)
    got = S.pack_mixed_data(audio + FeatureHandler(mmap_config).providers, "cpu", 0, 1, step_ms)
    assert isinstance(got, S.PackedMixedData) and isinstance(want, JS.PackedMixedData)
    # the validation-only dir joins no corpus: 4.0 of audio, 3.0 of spectrograms
    assert got.audio_fraction == want.audio_fraction == pytest.approx(4.0 / 7.0)
    _assert_fields_equal(got.audio, want.audio, AUDIO_FIELDS)
    _assert_fields_equal(got.spec, want.spec, ("clip_offset", "clip_length", "provider_logits",
                                               "provider_clip_count", "provider_penalty"))
    np.testing.assert_array_equal(got.spec.frames.numpy().view(np.uint16), np.asarray(want.spec.frames))
    # one class alone: the plain corpora
    assert isinstance(S.pack_mixed_data(audio, "cpu", step_ms=step_ms), S.PackedAudioData)
    spec_only = S.pack_mixed_data(FeatureHandler(mmap_config).providers, "cpu", step_ms=step_ms)
    assert isinstance(spec_only, S.PackedTrainingData)


@functools.lru_cache(maxsize=None)
def _jax_sample(**kw):
    return jax.jit(functools.partial(JS.sample_audio_feature_batch, **kw),
                   static_argnums=(2, 3))


def _jax_draws(packed_jax, rng, batch):
    """The values sample_audio_feature_batch draws from a step key."""
    r_prov, r_clip, r_win, _ = jax.random.split(rng, 4)
    prov = jax.random.categorical(r_prov, packed_jax.provider_logits, shape=(batch,))
    return (torch.from_numpy(np.array(prov)), torch.from_numpy(np.array(jax.random.uniform(r_clip, (batch,)))),
            torch.from_numpy(np.array(jax.random.uniform(r_win, (batch,)))))


def _jax_windows(packed_jax, rng, batch, length):
    """JAX's gathered chunks for a step key, as sample_audio_feature_batch
    places them (sampler.py:417-436), flattened to PCM."""
    prov, u_clip, u_win = (jnp.asarray(t.numpy()) for t in _jax_draws(packed_jax, rng, batch))
    hop = packed_jax.hop_samples
    n_chunks = length + JS.window_chunks_for_hop(hop) - 1
    count = packed_jax.provider_clip_count[prov]
    clip = packed_jax.provider_clip_start[prov] + jnp.minimum(
        jnp.floor(u_clip * count).astype(jnp.int32), count - 1)
    n, off = packed_jax.clip_chunks[clip], packed_jax.clip_offset[clip]
    strategy = packed_jax.provider_strategy[prov]
    start_random = jnp.floor(u_win * jnp.maximum(n - n_chunks, 1)).astype(jnp.int32)
    start_long = jnp.select([strategy == JS.TRUNCATE_START, strategy == JS.TRUNCATE_END],
                            [n - n_chunks, jnp.zeros_like(n)], start_random)
    start = jnp.where(n > n_chunks, start_long, n - n_chunks)
    chunks, valid = JS.gather_windows(packed_jax.chunks, off, n, start, n_chunks)
    return np.asarray(chunks * valid[:, :, None]).reshape(batch, -1)


def _jax_augment_uniforms(rng, batch):
    """apply_spec_augment's uniforms from the step key's fourth split."""
    key = jax.random.split(rng, 4)[3]
    sizes, starts = [], []
    for _ in range(MASKS["time_mask_count"] + MASKS["freq_mask_count"]):
        key, r1, r2 = jax.random.split(key, 3)
        sizes.append(np.asarray(jax.random.uniform(r1, (batch,))))
        starts.append(np.asarray(jax.random.uniform(r2, (batch,))))
    return torch.from_numpy(np.stack(sizes, 1)), torch.from_numpy(np.stack(starts, 1))


@pytest.mark.parametrize("step_ms,augment", [(10, False), (10, True), (20, False)])
def test_audio_windows_from_draws_match_jax(step_ms, augment):
    providers = _providers(step_ms, seed=3)
    packed_jax = JS.pack_audio_data(providers, 0, 1, step_ms=step_ms)
    data = S.pack_audio_data(providers, "cpu", 0, 1, step_ms=step_ms)
    masks = MASKS if augment else {}
    for seed in (0, 1):
        rng = jax.random.PRNGKey(seed)
        pcm, labels, weights = S.audio_windows_from_draws(data, *_jax_draws(packed_jax, rng, BATCH), L)
        assert pcm.dtype == torch.int16 and pcm.is_contiguous()
        np.testing.assert_array_equal(pcm.numpy(), _jax_windows(packed_jax, rng, BATCH, L))
        want, want_labels, want_weights = _jax_sample(**masks)(packed_jax, rng, BATCH, L)
        got = S.audio_features(pcm, data.hop_samples, L)
        if augment:
            got = S.spec_augment_from_uniforms(got, *_jax_augment_uniforms(rng, BATCH), **MASKS)
        assert got.shape == (BATCH, L, 40)
        gate.assert_q6_gate(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))
        np.testing.assert_array_equal(weights.numpy(), np.asarray(want_weights))


def test_audio_features_match_jax_pallas_backend():
    """The JAX package's Pallas kernel (interpreted on the CPU) at a small
    size: the same windows, the Q6 gate."""
    providers = [FakeAudioProvider([np.random.default_rng(4).integers(-8000, 8000, 160 * 40)
                                    .astype(np.int16)], "truncate_start")]
    packed_jax = JS.pack_audio_data(providers, 0, 1)
    data = S.pack_audio_data(providers, "cpu")
    rng = jax.random.PRNGKey(5)
    want, _, _ = JS.sample_audio_feature_batch(packed_jax, rng, 2, 20, frontend_backend="pallas")
    pcm, _, _ = S.audio_windows_from_draws(data, *_jax_draws(packed_jax, rng, 2), 20)
    gate.assert_q6_gate(S.audio_features(pcm, 160, 20).numpy(), np.asarray(want))


def test_short_clip_left_pad():
    """A clip shorter than the window is right-aligned behind silence
    (tests/test_data.py:351): the leading frames are zero, the last carry
    signal, and equal those of the clip alone."""
    n_clip = 10  # chunks, < L + 2
    audio = np.random.default_rng(4).integers(-8000, 8000, n_clip * S.HOP_SAMPLES).astype(np.int16)
    data = S.pack_audio_data([FakeAudioProvider([audio], "random", label=0.0)], "cpu")
    f, _, _ = S.sample_audio_feature_batch(data, torch.Generator().manual_seed(1), 1, L)
    f = f[0].numpy()
    n_silent = (L + S.window_chunks_for_hop(S.HOP_SAMPLES) - 1) - n_clip
    assert np.all(f[: n_silent - S.window_chunks_for_hop(S.HOP_SAMPLES) + 1] == 0.0)
    assert f[-1].max() > 0
    pcm, _, _ = S.audio_windows_from_draws(data, torch.zeros(1, dtype=torch.int64), torch.zeros(1),
                                           torch.zeros(1), L)
    assert np.all(pcm[0, : n_silent * S.HOP_SAMPLES].numpy() == 0)
    np.testing.assert_array_equal(pcm[0, n_silent * S.HOP_SAMPLES :].numpy(), audio)


@pytest.mark.parametrize("batch,fraction,want", [
    (16, 0.5, 8), (16, 0.01, 1), (16, 0.99, 15), (128, 4 / 7, 73), (7, 0.3, 2)])
def test_mixed_batch_sizes(mmap_config, batch, fraction, want):
    """round(B * fraction) clamped to [1, B - 1], audio rows first."""
    assert S.mixed_batch_sizes(batch, fraction) == (want, batch - want)
    audio = [FakeAudioProvider(_providers()[0].clips, label=1.0, penalty=2.0)]
    mixed = S.pack_mixed_data(audio + FeatureHandler(mmap_config).providers, "cpu")
    mixed = S.PackedMixedData(mixed.audio, mixed.spec, fraction)
    feats, labels, weights = S.sample_mixed_batch(mixed, torch.Generator().manual_seed(0), batch, L,
                                                  **MASKS)
    assert feats.shape == (batch, L, 40)
    np.testing.assert_array_equal(labels.numpy(), [1.0] * want + [0.0] * (batch - want))
    np.testing.assert_array_equal(weights.numpy(), [2.0] * want + [0.5] * (batch - want))


def test_torch_draw_frequencies_and_ranges():
    """The draw of sample_audio_feature_batch: providers by sampling weight
    (chi-square), clips uniform within each provider, window starts per
    strategy."""
    providers = _providers(seed=5)
    data = S.pack_audio_data(providers, "cpu")
    draws, p = 20_000, len(providers)
    u = torch.rand((draws, p + 2), generator=torch.Generator().manual_seed(0))
    prov = torch.argmax(data.provider_logits - torch.log(-torch.log(u[:, :p])), dim=1)
    weights = np.array([q.sampling_weight for q in providers])
    observed = np.bincount(prov.numpy(), minlength=p)
    assert stats.chisquare(observed, draws * weights / weights.sum()).pvalue > 1e-3
    off, n, start = (t.numpy() for t in S.audio_window_starts(data, prov, u[:, p], u[:, p + 1], L))
    clip = np.searchsorted(data.clip_offset.numpy(), off)
    prov = prov.numpy()
    n_chunks = L + S.window_chunks_for_hop(S.HOP_SAMPLES) - 1
    long = n > n_chunks
    assert np.all(start[~long] == n[~long] - n_chunks)  # short clips: leading silence
    for q, strategy in enumerate(STRATEGIES):
        first, count = int(data.provider_clip_start[q]), int(data.provider_clip_count[q])
        assert stats.chisquare(np.bincount(clip[prov == q] - first, minlength=count)).pvalue > 1e-3
        sel = long & (prov == q)
        assert sel.sum() > 100
        if strategy == "truncate_start":
            assert np.all(start[sel] == n[sel] - n_chunks)
        elif strategy == "truncate_end":
            assert np.all(start[sel] == 0)
        else:  # random, and fixed_right_cutoff as random on raw audio
            assert start[sel].min() == 0 and np.all(start[sel] <= n[sel] - n_chunks - 1)


def test_audio_sampler_never_syncs(mmap_config, monkeypatch):
    """No value of a tensor reaches Python in the raw-audio or mixed draw,
    gather, frontend or augment."""
    data = S.pack_audio_data(_providers(), "cpu")
    mixed = S.pack_mixed_data(_providers()[:1] + FeatureHandler(mmap_config).providers, "cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("host sync in the sampler")

    for name in ("item", "tolist", "numpy", "__bool__", "__int__", "__float__", "__index__", "nonzero"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "nonzero", refuse)
    gen = torch.Generator().manual_seed(1)
    feats, labels, weights = S.sample_audio_feature_batch(data, gen, BATCH, L, **MASKS)
    mixed_feats, _, _ = S.sample_mixed_batch(mixed, gen, BATCH, L, **MASKS)
    monkeypatch.undo()
    assert feats.shape == mixed_feats.shape == (BATCH, L, 40)
    assert labels.shape == weights.shape == (BATCH,)
    assert bool((feats >= 0).all()) and bool((feats <= 26.0).all()) and bool((feats > 0).any())


def test_sample_any_dispatches_by_corpus(mmap_config):
    gen = torch.Generator().manual_seed(2)
    audio = S.pack_audio_data(_providers(), "cpu")
    spec = FeatureHandler(mmap_config).pack_training("cpu")
    mixed = S.pack_mixed_data(_providers()[:1] + FeatureHandler(mmap_config).providers, "cpu")
    for packed in (audio, spec, mixed):
        feats, labels, _ = S.sample_any(packed, gen, BATCH, L)
        assert feats.shape == (BATCH, L, 40) and labels.shape == (BATCH,)
