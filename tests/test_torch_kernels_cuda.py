"""The port's CUDA kernels against their plain versions, on the card, the
data-parallel step around the frontend kernel and the pool refresh in a NCCL
group of one, and the host frontends on the card against the CPU.

These tests need an NVIDIA GPU and skip without one; the kernels have no CPU
mode.  The file imports only the port, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""

import types

import numpy as np
import pytest
import torch

from microwakeword_tpu_torch.data import sampler
from microwakeword_tpu_torch.frontend import gate, kernel, plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _audio(kind: str, shape: tuple, rng: np.random.Generator) -> np.ndarray:
    if kind == "float":
        return rng.uniform(-0.9, 0.9, shape).astype(np.float32)
    if kind == "full-scale":  # stresses cancellation in the FFT
        return rng.integers(-32767, 32768, shape).astype(np.int16)
    if kind == "tone":  # near-silent channels: bins far below the frame's energy
        t = np.arange(shape[1]) / 16000
        freqs = rng.uniform(200.0, 7000.0, (shape[0], 1))
        return np.round(30000 * np.sin(2 * np.pi * freqs * t)).astype(np.int16)
    return rng.integers(-25000, 25000, shape).astype(np.int16)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "step_ms,shape,kind",
    [
        (10, (3, 48480), "noise"),  # multi-tile, ragged last tile
        (20, (3, 48480), "noise"),
        (10, (2, 480 + 160 * 40 + 77), "noise"),  # N not a whole number of hops
        (10, (2, 300), "noise"),  # N < 480: no frames, no launch
        (10, (2, 8000), "float"),
        (10, (128, 32960), "noise"),  # the flagship's raw-audio training window
        (20, (64, 160000), "noise"),  # serving length at 20 ms
        (10, (2, 120 * 16000), "noise"),  # 2-minute clips: the carry scan over 375 tiles
        (10, (8, 48480), "full-scale"),
        (10, (8, 48480), "tone"),
    ],
)
def test_frontend_kernel_matches_plain(cuda, step_ms, shape, kind):
    audio = _audio(kind, shape, np.random.default_rng(6))
    x = torch.from_numpy(audio).to(cuda)
    before = kernel.frontend_batch.launches
    got = kernel.frontend_batch(x, step_ms=step_ms)
    torch.cuda.synchronize()
    assert kernel.frontend_batch.launches == before + (
        kernel.LAUNCHES_PER_CALL if got.shape[1] else 0)
    want = plain.frontend_batch(x, step_ms=step_ms)
    gate.assert_q6_gate(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("step_ms,batch,length", [(10, 128, 204), (20, 64, 102)])
def test_frontend_kernel_in_the_train_step(cuda, step_ms, batch, length):
    """The raw-audio train step's input: int16 hop chunks gathered from a
    packed pool, rows outside the clip zeroed, (L + 2) * 160 samples at 10 ms
    and (L + 1) * 320 at 20 ms, for L frames."""
    rng = np.random.default_rng(7)
    hop = 16 * step_ms
    n_chunks = length + sampler.window_chunks_for_hop(hop) - 1
    clips = [rng.integers(-20000, 20000, int(n)).astype(np.int16)
             for n in rng.integers(hop * 20, hop * (n_chunks + 60), 40)]
    provider = types.SimpleNamespace(
        generate_audio_pool=lambda shard_index, shard_count: clips, sampling_weight=1.0,
        penalty_weight=1.0, label=1.0, truncation_strategy="random")
    data = sampler.pack_audio_data([provider], cuda, step_ms=step_ms)
    pcm, _, _ = sampler.draw_audio_windows(data, torch.Generator(device=cuda).manual_seed(0),
                                           batch, length)
    assert pcm.shape == (batch, n_chunks * hop) and pcm.dtype == torch.int16
    assert bool((pcm[:, :hop] == 0).all(dim=1).any())  # short clips: leading silence
    before = kernel.frontend_batch.launches
    got = sampler.audio_features(pcm, hop, length)
    torch.cuda.synchronize()
    assert kernel.frontend_batch.launches == before + kernel.LAUNCHES_PER_CALL
    gate.assert_q6_gate(got.cpu().numpy(), plain.frontend_batch(pcm, step_ms).cpu().numpy())


@pytest.mark.cuda
def test_frontend_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros((2, 1000), dtype=torch.int16, device=cuda)
    with pytest.raises(TypeError):
        kernel.frontend_batch(x.double())
    with pytest.raises(ValueError):
        kernel.frontend_batch(x[:, ::2])  # not contiguous
    with pytest.raises(ValueError):
        kernel.frontend_batch(x[0])  # not [B, N]


@pytest.mark.cuda
def test_nccl_world1_raw_audio_step_equals_solo(cuda):
    """The data-parallel step in a NCCL group of one rank, on raw audio
    through the frontend kernel (3 launches a step), equals the solo step
    from the same seed and weights: every share is 1.0 and every collective
    returns its input (deterministic cuDNN, so both runs take one algorithm)."""
    from microwakeword_tpu_torch.models import build_model, presets
    from microwakeword_tpu_torch.parallel import mesh as M
    from microwakeword_tpu_torch.parallel.train_step import make_sharded_train_step
    from microwakeword_tpu_torch.train import loop as training

    rng = np.random.default_rng(8)
    providers = [types.SimpleNamespace(
        generate_audio_pool=lambda shard_index, shard_count, c=clips: c, sampling_weight=w,
        penalty_weight=1.0, label=label, truncation_strategy=strategy)
        for clips, w, label, strategy in (
            ([rng.integers(-20000, 20000, int(n)).astype(np.int16)
              for n in rng.integers(16000, 48000, 30)], 2.0, 1.0, "truncate_start"),
            ([rng.integers(-3000, 3000, int(n)).astype(np.int16)
              for n in rng.integers(16000, 48000, 30)], 10.0, 0.0, "random"))]
    data = sampler.pack_audio_data(providers, cuda)
    bundle = build_model("mixednet", presets.flagship_config())
    phase = dict(learning_rate=1e-3, time_mask_max_size=5, time_mask_count=2,
                 freq_mask_max_size=5, freq_mask_count=2, positive_class_weight=1.0,
                 negative_class_weight=20.0)
    steps, runs = 5, []
    torch.backends.cudnn.deterministic = True
    mesh = M.init_mesh(1, 0, cuda, init_method=f"tcp://localhost:{M.free_port()}")
    try:
        assert mesh.backend == "nccl"
        for m in (None, mesh):
            model = bundle.init(torch.Generator().manual_seed(0), device=cuda)
            gen = torch.Generator(device=cuda).manual_seed(1)
            step = (training.make_train_step(bundle, model, data, 32, bundle.spectrogram_length,
                                             generator=gen) if m is None else
                    make_sharded_train_step(bundle, model, data, 32, bundle.spectrogram_length, m,
                                            generator=gen))
            before = kernel.frontend_batch.launches
            losses = [float(step.step(**phase)["loss"]) for _ in range(steps)]
            assert kernel.frontend_batch.launches - before == steps * kernel.LAUNCHES_PER_CALL
            runs.append((losses, {k: v.detach().clone() for k, v in model.state_dict().items()}))
    finally:
        torch.distributed.destroy_process_group()
        torch.backends.cudnn.deterministic = False
    (solo_losses, solo), (dp_losses, dp) = runs
    np.testing.assert_allclose(dp_losses, solo_losses, rtol=0, atol=1e-6)
    assert max(float((dp[k] - solo[k]).abs().max()) for k in solo) <= 1e-6


class _Pools:
    """A clips-type provider whose successive builds return ``pools`` in
    order (the last one again once they run out)."""

    sampling_weight = penalty_weight = label = 1.0
    truncation_strategy = "random"

    def __init__(self, pools):
        self.pools, self.calls = pools, 0

    def generate_audio_pool(self, shard_index=0, shard_count=1):
        self.calls += 1
        return self.pools[min(self.calls, len(self.pools)) - 1]


@pytest.mark.cuda
def test_nccl_world1_refresh_swaps_in_place(cuda):
    """Pool refresh over a NCCL group of one rank: the rank builds, swaps at
    each due step (blocking) with one flag and one chunk broadcast, and the
    pool tensor on the card holds the new pool in place."""
    from microwakeword_tpu_torch.data.refresh import PoolRefresher
    from microwakeword_tpu_torch.parallel import mesh as M

    rng = np.random.default_rng(9)
    pools = [[rng.integers(-9000, 9000, 8000).astype(np.int16) for _ in range(6)]
             for _ in range(4)]
    provider = _Pools(pools)
    data = sampler.pack_audio_data([provider], cuda)
    chunks, ptr = data.chunks, data.chunks.data_ptr()
    mesh = M.init_mesh(1, 0, cuda, init_method=f"tcp://localhost:{M.free_port()}")
    try:
        refresher = PoolRefresher(types.SimpleNamespace(providers=[provider]), data, 2,
                                  mesh=mesh).start()
        try:
            swaps = []
            for step in range(1, 5):
                before = mesh.collectives
                if refresher.maybe_swap(data, step, block=True):
                    swaps.append((step, mesh.collectives - before, data.chunks.clone()))
        finally:
            refresher.stop()
    finally:
        torch.distributed.destroy_process_group()
    assert [(s, n) for s, n, _ in swaps] == [(2, 2), (4, 2)]
    assert data.chunks.data_ptr() == ptr and data.chunks is chunks
    for (_, _, got), pool in zip(swaps, pools[1:]):
        assert torch.equal(got.cpu(), sampler.pack_audio_data([_Pools([pool])], "cpu").chunks)


@pytest.mark.cuda
@pytest.mark.parametrize("step_ms", [10, 20])
def test_host_frontends_on_card_equal_cpu(cuda, step_ms):
    """frontend/fixedpoint.py on the card equals the CPU bit for bit;
    frontend/reference.py passes the Q6 gate against the CPU."""
    from microwakeword_tpu_torch.frontend import fixedpoint, reference

    rng = np.random.default_rng(10)
    t = np.arange(24000) / 16000
    audio = np.clip(rng.normal(0, 800, t.size) + 9000 * np.sin(2 * np.pi * 1500 * t)
                    * (np.sin(2 * np.pi * 5 * t) > 0), -32768, 32767).astype(np.int16)
    got = fixedpoint.generate_features_for_clip(audio, step_ms, device=cuda)
    assert got.is_cuda
    want = fixedpoint.generate_features_for_clip(audio, step_ms, device="cpu")
    assert torch.equal(got.cpu(), want)
    got = reference.generate_features_for_clip(audio, step_ms, device=cuda)
    want = reference.generate_features_for_clip(audio, step_ms, device="cpu")
    gate.assert_q6_gate(got.cpu().numpy(), want.numpy())
