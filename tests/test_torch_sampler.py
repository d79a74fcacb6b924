"""The port's on-device sampler against the JAX package's.

Same synthetic stores on disk (full-range uint16 values, clips shorter and
longer than the window, all four truncation strategies), read by both
packages' FeatureHandlers:

- ``pack_training_arrays`` equals JAX's field by field;
- ``windows_from_draws``, fed the values JAX draws from a step key, equals
  JAX's ``_draw_windows`` exactly;
- the gather and ``finish_batch`` on JAX's rows equal JAX's ``sample_batch``
  bit for bit, with and without SpecAugment (the augment fed JAX's
  uniforms);
- the torch draw's provider frequencies match the sampling weights
  (chi-square) and its window starts stay within each strategy's range;
- the draw, gather and augment never ask the host for a value.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from scipy import stats

from microwakeword_tpu.data import sampler as JS
from microwakeword_tpu.data.ragged_store import RaggedSpectrogramStore
from microwakeword_tpu.data.store import FeatureHandler as JaxFeatureHandler
from microwakeword_tpu_torch.data import sampler as S
from microwakeword_tpu_torch.data.store import FeatureHandler

torch.set_num_threads(2)

L = 30
BATCH = 64
MASKS = dict(time_mask_max_size=5, time_mask_count=2, freq_mask_max_size=5, freq_mask_count=2)
NO_MASKS = dict(time_mask_max_size=0, time_mask_count=0, freq_mask_max_size=0, freq_mask_count=0)
PROVIDERS = [  # (name, strategy, sampling weight, cutoffs)
    ("rand", "random", 3.0, None),
    ("start", "truncate_start", 1.0, None),
    ("end", "truncate_end", 0.5, None),
    ("cut", "fixed_right_cutoff", 1.5, [0, 3, 7]),
]


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    root = tmp_path_factory.mktemp("sampler_stores")
    rng = np.random.default_rng(0)
    features = []
    for i, (name, strategy, weight, cutoffs) in enumerate(PROVIDERS):
        specs = [rng.integers(0, 65536, (int(t), 40), dtype=np.uint16)
                 for t in rng.integers(12, 70, 13 + 4 * i)]
        for part in range(2):  # two stores per provider
            d = root / name / "training" / f"p{part}_mmap"
            RaggedSpectrogramStore.create(str(d), specs[part::2])
        fs = {"features_dir": str(root / name), "truth": i % 2 == 0, "sampling_weight": weight,
              "penalty_weight": 1.0 + i, "truncation_strategy": strategy, "type": "mmap"}
        if cutoffs:
            fs["fixed_right_cutoffs"] = cutoffs
        features.append(fs)
    return {"stride": 1, "window_step_ms": 10, "features": features}


@pytest.fixture(scope="module")
def packed(config):
    arrays = JS.pack_training_arrays(JaxFeatureHandler(config).providers, 0, 1)
    return JS.upload_training_arrays(arrays), S.upload_training_arrays(arrays, device="cpu")


@functools.lru_cache(maxsize=None)
def _jitted():
    return (
        jax.jit(JS._draw_windows, static_argnums=(2, 3)),
        jax.jit(JS.sample_batch_indices, static_argnums=(2, 3)),
        jax.jit(JS.sample_batch, static_argnums=(2, 3), static_argnames=tuple(MASKS)),
    )


@pytest.mark.parametrize("shard", [(0, 1), (1, 3)])
def test_pack_matches_jax(config, shard):
    want = JS.pack_training_arrays(JaxFeatureHandler(config).providers, *shard)
    got = S.pack_training_arrays(FeatureHandler(config).providers, *shard)
    assert set(got) == set(want)
    for key, value in want.items():
        assert np.asarray(got[key]).dtype == np.asarray(value).dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def _jax_draws(packed_jax, rng):
    """The values _draw_windows draws from a step key, by public calls."""
    r_prov, r_clip, r_win, r_cut, _ = jax.random.split(rng, 5)
    prov = jax.random.categorical(r_prov, packed_jax.provider_logits, shape=(BATCH,))
    return [np.array(a) for a in (prov, *(jax.random.uniform(r, (BATCH,)) for r in (r_clip, r_win, r_cut)))]


def _jax_augment_uniforms(rng):
    """finish_batch's augment key (the fifth split), split per mask as
    apply_spec_augment splits it: [B, masks] sizes and starts."""
    key = jax.random.split(rng, 5)[4]
    sizes, starts = [], []
    for _ in range(MASKS["time_mask_count"] + MASKS["freq_mask_count"]):
        key, r1, r2 = jax.random.split(key, 3)
        sizes.append(np.asarray(jax.random.uniform(r1, (BATCH,))))
        starts.append(np.asarray(jax.random.uniform(r2, (BATCH,))))
    return torch.from_numpy(np.stack(sizes, 1)), torch.from_numpy(np.stack(starts, 1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_windows_from_draws_matches_jax(packed, seed):
    packed_jax, data = packed
    rng = jax.random.PRNGKey(seed)
    want = _jitted()[0](packed_jax, rng, BATCH, L)
    prov, u_clip, u_win, u_cut = (torch.from_numpy(a) for a in _jax_draws(packed_jax, rng))
    got = S.windows_from_draws(data, prov, u_clip, u_win, u_cut, L)
    for name, g, w in zip(("off", "n", "start", "labels", "weights"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    strategies = data.provider_strategy[prov].numpy()
    assert set(strategies) == {S.RANDOM, S.TRUNCATE_START, S.TRUNCATE_END, S.FIXED_RIGHT_CUTOFF}
    assert (got[1] <= L).any() and (got[1] > L).any()  # short and long clips


@pytest.mark.parametrize("augment", [False, True])
def test_gather_and_finish_match_sample_batch(packed, augment):
    packed_jax, data = packed
    masks = MASKS if augment else NO_MASKS
    _, indices, sample = _jitted()
    for seed in (3, 4):
        rng = jax.random.PRNGKey(seed)
        want, want_labels, want_weights = sample(packed_jax, rng, BATCH, L, **masks)
        rows, valid, labels, weights = (np.asarray(a) for a in indices(packed_jax, rng, BATCH, L))
        windows = data.frames[torch.from_numpy(rows)]
        got = S.finish_batch(None, windows, torch.from_numpy(valid))
        if augment:
            got = S.spec_augment_from_uniforms(got, *_jax_augment_uniforms(rng), **masks)
            assert (got == 0).sum() > (np.asarray(sample(packed_jax, rng, BATCH, L, **NO_MASKS)[0]) == 0).sum()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(labels, np.asarray(want_labels))
        np.testing.assert_array_equal(weights, np.asarray(want_weights))
        # the port's own gather from the draw's (off, n, start) takes the same rows
        prov, u_clip, u_win, u_cut = (torch.from_numpy(a) for a in _jax_draws(packed_jax, rng))
        off, n, start, _, _ = S.windows_from_draws(data, prov, u_clip, u_win, u_cut, L)
        port_rows, port_valid = S.window_rows(off, n, start, L)
        np.testing.assert_array_equal(port_rows.numpy(), rows)
        np.testing.assert_array_equal(port_valid.numpy(), valid)
        gathered, _ = S.gather_windows(data.frames, off, n, start, L)
        assert torch.equal(gathered, windows)


def test_torch_draw_frequencies_and_ranges(packed):
    _, data = packed
    gen = torch.Generator().manual_seed(0)
    draws = 20_000
    off, n, start, _, _ = S._draw_windows(data, gen, draws, L)
    clip = np.searchsorted(data.clip_offset.numpy(), off.numpy())
    prov = np.searchsorted(data.provider_clip_start.numpy(), clip, side="right") - 1
    weights = np.array([w for _, _, w, _ in PROVIDERS])
    observed = np.bincount(prov, minlength=len(PROVIDERS))
    assert stats.chisquare(observed, draws * weights / weights.sum()).pvalue > 1e-3
    n, start = n.numpy(), start.numpy()
    long = n > L
    assert np.all(start[~long] == n[~long] - L)  # short clips: left zero padding
    for p, (_, strategy, _, cutoffs) in enumerate(PROVIDERS):
        sel = long & (prov == p)
        assert sel.sum() > 100
        if strategy == "random":
            assert start[sel].min() == 0 and np.all(start[sel] <= n[sel] - L - 1)
            assert np.all(start[sel] >= 0)
        elif strategy == "truncate_start":
            assert np.all(start[sel] == n[sel] - L)
        elif strategy == "truncate_end":
            assert np.all(start[sel] == 0)
        else:
            cut = n[sel] - L - start[sel]
            assert set(np.unique(cut)) == set(cutoffs)


def test_sample_batch_never_syncs(packed, monkeypatch):
    """No value of a tensor reaches Python in the draw, gather or augment."""
    _, data = packed

    def refuse(*args, **kwargs):
        raise AssertionError("host sync in the sampler")

    for name in ("item", "tolist", "numpy", "__bool__", "__int__", "__float__", "__index__", "nonzero"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "nonzero", refuse)
    gen = torch.Generator().manual_seed(1)
    feats, labels, weights = S.sample_batch(data, gen, BATCH, L, **MASKS)
    monkeypatch.undo()
    assert feats.shape == (BATCH, L, 40) and labels.shape == weights.shape == (BATCH,)
    assert bool((feats >= 0).all()) and bool((feats <= 65535 * S.FEATURE_SCALE).all())


def test_uint16_bits_round_trip():
    values = np.array([[0, 1, 32767, 32768, 65534, 65535]], np.uint16)
    got = S.windows_to_float(S.frames_tensor(values))
    np.testing.assert_array_equal(got.numpy(), values.astype(np.float32))
