// Micro-frontend for Hopper (sm_90a): 16 kHz PCM -> [B, T, 40] float32
// features in [0, 26], the same function as microwakeword_tpu_torch's
// frontend/plain.py frontend_batch.
//
// Replaces the TPU kernel microwakeword_tpu/frontend/pallas.py:_kernel
// (pallas_call at pallas.py:191).  That kernel walks the time tiles of a row
// in order and carries the noise estimate from one tile to the next in VMEM.
// Blocks on Hopper run in parallel and in no order, so the work is split in
// two launches and nothing carries between blocks:
//
//   A  filterbank_kernel, grid (time tile of kTile hops, batch row): stage the
//      tile's PCM in shared memory, windowed real DFT for 257 bins against
//      the Hann-folded [480, 257] cos/sin matrices (one thread per bin, the
//      block padded to kBinsPad threads; FP32 FMAs, no tensor cores: TF32
//      would break parity), energy re^2 + im^2, the [257, 40] mel product,
//      sqrt / 8 -> scaled filterbank sf [B, T, 40].
//   B  agc_kernel, one thread per (row, channel): walks T in order with the
//      noise estimate in a register (the EMA), then noise subtraction, PCAN,
//      Q6 floor, log scale, round, clip.  Neighbouring threads take
//      neighbouring channels, so the 160-byte rows are read and written
//      coalesced.  The TPU's in-tile Hillis-Steele scan and its cross-tile
//      carry have no counterpart: the carry never leaves the thread.
//
// What bounds it on an H100: the function itself needs about 15k FP32
// operations per hop (a 512-point real FFT, about 11.5k; the window; the
// triangular mel filters, each bin feeding at most 2 channels; the EMA and
// AGC) against about 2 bytes per sample in and 160 bytes per hop out, so its
// least time is set by the FP32 rate, close to the memory rate.  This kernel
// does far more: its dense DFT and mel products are 2*480*257 + 257*40 =
// 257,000 MACs (0.514 MFLOP) per hop, about 34 times the function's work.
// The design does nothing about that yet; a real FFT is the fast design.
//
// Numerics: built with --fmad=false, so every expression rounds operation by
// operation as PyTorch's eager ops do; the DFT and mel dot products call
// fmaf explicitly.  floorf and rintf (round half to even, like torch.round
// and jnp.round), IEEE powf, logf, sqrtf and division; no fast math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWindow = 480;     // samples per frame (30 ms)
constexpr int kBins = 257;       // real-DFT bins of a 512-point transform
constexpr int kBinsPad = 288;    // threads of launch A: 257 bins in 9 whole warps
constexpr int kChannels = 40;    // mel channels
constexpr int kTile = 32;        // hops per block of launch A
constexpr int kEnergyRow = kBinsPad + 1;  // shared row stride, no bank clash
constexpr int kAgcThreads = 32;

__device__ __forceinline__ float pcm(int16_t v) { return static_cast<float>(v); }

// Float input in [-1, 1]: clip(x * 32768) then round half to even.
__device__ __forceinline__ float pcm(float v) {
  return rintf(fminf(fmaxf(v * 32768.0f, -32768.0f), 32767.0f));
}

template <typename T, int HOP>
__global__ void __launch_bounds__(kBinsPad, 2)
filterbank_kernel(const T* __restrict__ audio, int n_samples, int n_frames,
                  const float* __restrict__ wc, const float* __restrict__ ws,
                  const float* __restrict__ mel, float* __restrict__ sf) {
  constexpr int kSpan = (kTile - 1) * HOP + kWindow;  // samples of the tile
  static_assert(kSpan % 4 == 0 && HOP % 4 == 0, "float4 rows");
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                   // [kSpan] PCM of this tile
  float* energy = smem + kSpan;       // [kTile][kEnergyRow]

  const int t0 = blockIdx.x * kTile;
  const int b = blockIdx.y;
  const int nt = min(kTile, n_frames - t0);
  const T* src = audio + (long long)b * n_samples + (long long)t0 * HOP;
  const int avail = n_samples - t0 * HOP;
  for (int i = threadIdx.x; i < kSpan; i += blockDim.x) {
    xs[i] = i < avail ? pcm(src[i]) : 0.0f;
  }
  __syncthreads();

  // Windowed DFT: thread k < kBins owns bin k for all kTile frames of the
  // tile; the padding threads keep zero energy, which the mel loop never reads.
  const int k = threadIdx.x;
  float re[kTile], im[kTile];
#pragma unroll
  for (int t = 0; t < kTile; ++t) {
    re[t] = 0.0f;
    im[t] = 0.0f;
  }
  if (k < kBins) {
    for (int i = 0; i < kWindow; i += 4) {
      float c[4], s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[j] = __ldg(wc + (i + j) * kBins + k);
        s[j] = __ldg(ws + (i + j) * kBins + k);
      }
#pragma unroll
      for (int t = 0; t < kTile; ++t) {
        const float4 x = *reinterpret_cast<const float4*>(xs + t * HOP + i);
        re[t] = fmaf(x.x, c[0], re[t]);
        im[t] = fmaf(x.x, s[0], im[t]);
        re[t] = fmaf(x.y, c[1], re[t]);
        im[t] = fmaf(x.y, s[1], im[t]);
        re[t] = fmaf(x.z, c[2], re[t]);
        im[t] = fmaf(x.z, s[2], im[t]);
        re[t] = fmaf(x.w, c[3], re[t]);
        im[t] = fmaf(x.w, s[3], im[t]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kTile; ++t) {
    energy[t * kEnergyRow + k] = re[t] * re[t] + im[t] * im[t];
  }
  __syncthreads();

  // Mel projection and sqrt / 8 for the tile's valid frames.
  for (int o = threadIdx.x; o < nt * kChannels; o += blockDim.x) {
    const int t = o / kChannels;
    const int c = o - t * kChannels;
    const float* e = energy + t * kEnergyRow;
    float acc = 0.0f;
    for (int q = 0; q < kBins; ++q) {
      acc = fmaf(e[q], __ldg(mel + q * kChannels + c), acc);
    }
    sf[((long long)b * n_frames + t0 + t) * kChannels + c] =
        sqrtf(fmaxf(acc, 0.0f)) / 8.0f;
  }
}

// Noise subtraction + PCAN + Q6 floor + log scale (plain.py _agc_output).
__device__ __forceinline__ float agc_output(float x, float est) {
  const float sub = fmaxf(x - fminf(est, x), 0.05f * x);
  const float snr = (sub / 8.0f) * powf(1.0f + est / 10.0f, -0.95f);
  const float pcan = snr < 2.0f ? snr * snr / 4.0f : snr - 1.0f;
  const float value = floorf(pcan * 64.0f) * 8.0f;
  const float logged = value > 1.0f ? logf(fmaxf(value, 1.0f)) * 64.0f : 0.0f;
  return fminf(fmaxf(rintf(logged), 0.0f), 65535.0f) * 0.0390625f;
}

__global__ void __launch_bounds__(kAgcThreads)
agc_kernel(const float* __restrict__ sf, float* __restrict__ out, int batch,
           int n_frames) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= batch * kChannels) return;
  const int b = idx / kChannels;
  const int c = idx - b * kChannels;
  const float smoothing = (c % 2 == 0) ? 0.025f : 0.06f;
  const float keep = 1.0f - smoothing;
  const long long row = (long long)b * n_frames * kChannels + c;
  const float* src = sf + row;
  float* dst = out + row;
  float est = 0.0f;
#pragma unroll 8
  for (int t = 0; t < n_frames; ++t) {
    const float x = src[(long long)t * kChannels];
    est = keep * est + smoothing * x;
    dst[(long long)t * kChannels] = agc_output(x, est);
  }
}

template <typename T, int HOP>
cudaError_t launch_filterbank(const void* audio, int batch, int n_samples,
                              int n_frames, const float* wc, const float* ws,
                              const float* mel, float* sf, cudaStream_t stream) {
  constexpr int kSpan = (kTile - 1) * HOP + kWindow;
  constexpr size_t kSmem = (kSpan + kTile * kEnergyRow) * sizeof(float);
  auto kernel = filterbank_kernel<T, HOP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_frames + kTile - 1) / kTile, batch);
  kernel<<<grid, kBinsPad, kSmem, stream>>>(static_cast<const T*>(audio),
                                            n_samples, n_frames, wc, ws, mel, sf);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mww_frontend_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch A.  audio: [batch, n_samples] int16 (audio_is_float 0) or float32;
// wc, ws: [480, 257] float32; mel: [257, 40];
// sf: [batch, n_frames, 40] float32 scratch.  Returns a cudaError_t.
int mww_frontend_filterbank(const void* audio, int audio_is_float, int batch,
                            int n_samples, int n_frames, int hop,
                            const float* wc, const float* ws, const float* mel,
                            float* sf, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hop == 160) {
    return audio_is_float
               ? launch_filterbank<float, 160>(audio, batch, n_samples, n_frames, wc, ws, mel, sf, s)
               : launch_filterbank<int16_t, 160>(audio, batch, n_samples, n_frames, wc, ws, mel, sf, s);
  }
  if (hop == 320) {
    return audio_is_float
               ? launch_filterbank<float, 320>(audio, batch, n_samples, n_frames, wc, ws, mel, sf, s)
               : launch_filterbank<int16_t, 320>(audio, batch, n_samples, n_frames, wc, ws, mel, sf, s);
  }
  return cudaErrorInvalidValue;
}

// Launch B.  sf, out: [batch, n_frames, 40] float32.  Returns a cudaError_t.
int mww_frontend_agc(const float* sf, float* out, int batch, int n_frames,
                     void* stream) {
  const int threads = batch * kChannels;
  agc_kernel<<<(threads + kAgcThreads - 1) / kAgcThreads, kAgcThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(sf, out, batch, n_frames);
  return cudaGetLastError();
}

}  // extern "C"
