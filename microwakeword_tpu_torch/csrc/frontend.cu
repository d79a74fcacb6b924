// Micro-frontend for Hopper (sm_90a): 16 kHz PCM -> [B, T, 40] float32
// features in [0, 26], the same function as microwakeword_tpu_torch's
// frontend/plain.py frontend_batch.
//
// Replaces the TPU kernel microwakeword_tpu/frontend/pallas.py:_kernel
// (pallas_call at pallas.py:191).  That kernel walks the time tiles of a row
// in order and carries the noise estimate from one tile to the next in VMEM.
// Blocks on Hopper run in parallel and in no order, so the work is three
// launches, and the carry is rebuilt from per-tile sums instead:
//
//   A  filterbank_kernel, one block of kThreadsA threads per (batch row, tile
//      of kTile hops): stage the tile's PCM in shared memory once, as int16
//      (overlapping frames share it: 5,440 samples for 32 hops at 10 ms);
//      per hop, 16 threads window 480 samples in FP32 and pack the 512-point
//      zero-padded real frame into 256 complex values z[n] = x[2n] + i x[2n+1];
//      a 256-point FFT as 16 x 16 (a 16-point FFT in registers, a twiddle, a
//      transpose through shared memory, a second 16-point FFT); the split
//      step to the 257 real-FFT bins, two bins per pair (k, 256 - k), the
//      partner value by warp shuffle; energy re^2 + im^2.  Then each warp
//      takes whole mel channels with one hop per lane (the host spreads the
//      channels over the warps by tap count): the filters' nonzero taps only
//      (each bin feeds at most 2 channels), sqrt / 8 -> scaled filterbank
//      sf [B, T, 40], stored coalesced; and the tile's local EMA end, the
//      noise estimate after its hops from a zero start, by a warp butterfly
//      -> ends [B, n_tiles, 40].
//   S  carry_scan_kernel, one thread per (row, channel): the estimate
//      entering tile j, carry_j = D carry_{j-1} + end_{j-1} with carry_0 = 0
//      and D = (1-s)^kTile (the EMA is linear), a scan over the row's tile
//      ends -> carries [B, n_tiles, 40].  Its chain is n_tiles = T / 32
//      steps of one multiply and one add, so the frontend's work stays
//      linear in T for clips of any length.
//   B  ema_agc_kernel, one thread per (row, tile, part of kPartB hops,
//      channel): the thread reads its tile's carry, carries it over the
//      tile's hops before its part (the EMA alone), then walks its part with
//      the estimate in a register and applies noise subtraction, PCAN, Q6
//      floor, log scale, round, clip.  At [64, 160000] that is 327,680
//      threads with a serial chain of at most 24 + 8 steps, 8 of them with
//      the AGC, in place of 2,560 threads walking all 998 hops.
//
// What bounds it on an H100: the function needs about 11.8k FP32 operations
// per hop (chip_smoke.py frontend_bound_ms: a packed split-radix FFT and its
// split step, the energies, the 456 mel taps and 29 per feature cell)
// against 2 bytes per sample in and 160 bytes per hop out, so its least time
// is set by the FP32 rate, close to the memory rate.  Launch A's FP32
// operations per hop, counted from the code below (a fused multiply-add
// counts as 2):
//   window                    480 multiplies                        480
//   two passes of 16 16-point FFTs (radix 4 x 4: 8 radix-4
//     butterflies of 16 adds, 8 complex multiplies of 6)   32 x 176 = 5,632
//   twiddles between the passes   15 x 16 complex multiplies of 6 = 1,440
//   split step and energy, 129 pairs x 24 (4 adds and 4 halvings,
//     a complex multiply, 4 adds, 2 energies of 3)                 3,096
//   mel taps                      456 x 2 (fmaf)                    912
//   sqrt and / 8                  40 x 2                             80
//   local EMA                     40 x 3                            120
//   total                                                        11,760
// which is 1/44 of the dense DFT it replaces.  Its FFT, split step and
// energies are 10,168 of them, against 9,215 in the least count (a
// split-radix FFT needs fewer multiplies than radix 4 x 4 with a full
// twiddle pass).  S adds 2 per tile and channel; B adds 3 + 24 per cell and
// 3 per hop of its tile before its part (180 per hop on average): about
// 13,000 per hop in all, 1.11 times the function's least work.
// Shared memory per block of A: 69.6 KB of hop buffers, 8 KB of tables, 5.2
// KB of the tile's sf and the PCM (10.9 KB at 10 ms, 20.8 KB at 20 ms), so
// two blocks (32 warps) fit on an SM; __launch_bounds__ caps registers at 64.
// Nothing of A goes back to device memory but sf and the tile ends: the
// frames, spectra and energies stay in registers and shared memory.  So A is
// bound by instruction issue and shared-memory latency with 32 warps per SM,
// not by memory; B by the instructions of its IEEE powf and logf; S, 40
// threads per row, by its launch and its chain of n_tiles steps.
//
// Numerics: built with --fmad=false, so every expression rounds operation by
// operation as PyTorch's eager ops do; complex multiplies and the mel taps
// call fmaf explicitly.
// Twiddles, window and decay come from tables computed in float64 on the
// host and cast to float32 (frontend/kernel.py host_tables).  floorf and
// rintf (round half to even, like torch.round), IEEE powf, logf, sqrtf and
// division; no fast math.  The FFT and the tile carry sum in other orders
// than the plain version's matmuls; the Q6 gate (frontend/gate.py) holds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWindow = 480;     // samples per frame (30 ms)
constexpr int kBins = 257;       // real-FFT bins of a 512-point transform
constexpr int kChannels = 40;    // mel channels
constexpr int kTile = 32;        // hops per block of launch A, and per EMA tile
constexpr int kHopThreads = 16;  // threads per hop
constexpr int kThreadsA = kTile * kHopThreads;
constexpr int kWarpsA = kThreadsA / 32;
constexpr int kMelRounds = 3;    // mel channels per warp of launch A, at most
constexpr int kMaxTaps = 512;    // room for the mel weights in shared memory
constexpr int kSfStride = kChannels + 1;  // row stride of the tile's sf, no bank clash
constexpr int kPad = 17;         // row stride (complex) of a hop's transpose buffer
constexpr int kHopBuf = 16 * kPad;  // complex values per hop buffer
constexpr int kThreadsB = 128;
constexpr int kPartB = 8;        // hops that one thread of launch B scores
constexpr int kPartsB = kTile / kPartB;

// Host tables (frontend/kernel.py host_tables), float32.
struct Tables {
  const float* window;       // [480] Hann window
  const float* fft16;        // [3] cos(pi/8), sin(pi/8), cos(pi/4)
  const float2* tw256;       // [16][16] W256^(n2 k1) at [k1][n2]
  const float2* tw512;       // [257] W512^k
  const int* mel_first;      // [40] first bin of each channel
  const int* mel_offset;     // [41] start of each channel's taps in mel_weights
  const float* mel_weights;  // [456] nonzero mel weights, channel by channel
  const int* mel_slots;      // [kMelRounds][kWarpsA] channel of warp w in round r, or -1
  const float* ema_powers;   // [2][32] (1 - s)^m for even and odd channels
};

__device__ __forceinline__ int16_t pcm16(int16_t v) { return v; }

// Float input in [-1, 1]: clip(x * 32768) then round half to even; the
// result is an integer in int16's range, so it is kept as one.
__device__ __forceinline__ int16_t pcm16(float v) {
  return static_cast<int16_t>(rintf(fminf(fmaxf(v * 32768.0f, -32768.0f), 32767.0f)));
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(fmaf(a.x, w.x, -(a.y * w.y)), fmaf(a.x, w.y, a.y * w.x));
}

// 4-point DFT in place, W4 = -i: (a, b, c, d) = (x0, x1, x2, x3) -> (X0, X1, X2, X3).
__device__ __forceinline__ void dft4(float2& a, float2& b, float2& c, float2& d) {
  const float2 t0 = cadd(a, c), t1 = csub(a, c), t2 = cadd(b, d), t3 = csub(b, d);
  a = cadd(t0, t2);
  c = csub(t0, t2);
  b = make_float2(t1.x + t3.y, t1.y - t3.x);  // t1 - i t3
  d = make_float2(t1.x - t3.y, t1.y + t3.x);  // t1 + i t3
}

// Position of output k in v after fft16: the 4 x 4 transpose of k.
__host__ __device__ constexpr int fft16_pos(int k) { return 4 * (k & 3) + (k >> 2); }

// 16-point DFT, W16 = exp(-2 pi i / 16), as 4 x 4: input n = 4a + b at v[n];
// output k = c + 4d at v[fft16_pos(k)] = v[4c + d].
__device__ __forceinline__ void fft16(float2 (&v)[16], float c8, float s8, float r2) {
#pragma unroll
  for (int b = 0; b < 4; ++b) dft4(v[b], v[4 + b], v[8 + b], v[12 + b]);
  // v[4c + b] = U[b][c]; times W16^(b c)
  const float2 w1 = make_float2(c8, -s8), w2 = make_float2(r2, -r2),
               w3 = make_float2(s8, -c8), w6 = make_float2(-r2, -r2),
               w9 = make_float2(-c8, s8);
  v[5] = cmul(v[5], w1);
  v[9] = cmul(v[9], w2);
  v[13] = cmul(v[13], w3);
  v[6] = cmul(v[6], w2);
  v[10] = make_float2(v[10].y, -v[10].x);  // W16^4 = -i
  v[14] = cmul(v[14], w6);
  v[7] = cmul(v[7], w3);
  v[11] = cmul(v[11], w6);
  v[15] = cmul(v[15], w9);
#pragma unroll
  for (int c = 0; c < 4; ++c) dft4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
}

// Energies of bins k and 256 - k of the 512-point real FFT from
// a = Z[k], b = Z[(256 - k) mod 256] and w = W512^k: with E = (a + conj b) / 2
// and O = (a - conj b) / (2i), X[k] = E + w O and X[256 - k] = conj(E - w O).
__device__ __forceinline__ void split_pair(float2 a, float2 b, float2 w,
                                           float& lo, float& hi) {
  const float2 even = make_float2((a.x + b.x) * 0.5f, (a.y - b.y) * 0.5f);
  const float2 odd = make_float2((a.y + b.y) * 0.5f, (b.x - a.x) * 0.5f);
  const float2 wo = cmul(odd, w);
  const float2 x = cadd(even, wo), y = csub(even, wo);
  lo = x.x * x.x + x.y * x.y;
  hi = y.x * y.x + y.y * y.y;
}

// Stages kernel A's PCM: 16 bytes of samples from src to dst.
__device__ __forceinline__ void stage16(int16_t* dst, const int16_t* src) {
  *reinterpret_cast<int4*>(dst) = __ldg(reinterpret_cast<const int4*>(src));
}

__device__ __forceinline__ void stage16(int16_t* dst, const float* src) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(src));
  *reinterpret_cast<short4*>(dst) = make_short4(pcm16(f.x), pcm16(f.y), pcm16(f.z), pcm16(f.w));
}

__device__ __forceinline__ float smoothing_of(int c) { return (c % 2 == 0) ? 0.025f : 0.06f; }

template <int HOP>
struct SmemA {
  static constexpr int kSpan = (kTile - 1) * HOP + kWindow;  // samples of a tile
  static constexpr size_t kBuf = 0;                          // float2 [kTile][kHopBuf]
  static constexpr size_t kTw256 = kBuf + sizeof(float2) * kTile * kHopBuf;
  static constexpr size_t kTw512 = kTw256 + sizeof(float2) * 256;
  static constexpr size_t kWin = kTw512 + sizeof(float2) * 258;
  static constexpr size_t kMelW = kWin + sizeof(float) * kWindow;
  static constexpr size_t kSf = kMelW + sizeof(float) * kMaxTaps;
  static constexpr size_t kPcm = kSf + sizeof(float) * kTile * kSfStride;
  static constexpr size_t kBytes = (kPcm + sizeof(int16_t) * kSpan + 15) / 16 * 16;
};

template <typename T, int HOP>
__global__ void __launch_bounds__(kThreadsA, 2)
filterbank_kernel(const T* __restrict__ audio, int n_samples, int n_frames,
                  int n_tiles, Tables tab, float* __restrict__ sf,
                  float* __restrict__ ends) {
  using S = SmemA<HOP>;
  static_assert(HOP % 2 == 0, "hops start on whole complex samples");
  static_assert(kTile == 32, "the mel step puts the tile's hops on a warp's lanes");
  extern __shared__ __align__(16) unsigned char smem[];
  float2* buf = reinterpret_cast<float2*>(smem + S::kBuf);
  float2* tw256 = reinterpret_cast<float2*>(smem + S::kTw256);
  float2* tw512 = reinterpret_cast<float2*>(smem + S::kTw512);
  float* win = reinterpret_cast<float*>(smem + S::kWin);
  float* melw = reinterpret_cast<float*>(smem + S::kMelW);
  float* sfs = reinterpret_cast<float*>(smem + S::kSf);
  int16_t* xs = reinterpret_cast<int16_t*>(smem + S::kPcm);

  const int tile = blockIdx.x % n_tiles;
  const int b = blockIdx.x / n_tiles;
  const int t0 = tile * kTile;
  const int nt = min(kTile, n_frames - t0);
  const T* src = audio + (long long)b * n_samples + (long long)t0 * HOP;
  const int avail = n_samples - t0 * HOP;
  // 16-byte loads where the tile's start allows them, all issued before the
  // first is stored, then one sample at a time for the rest of the span (a
  // ragged end reads as zeros).
  constexpr int kVec = 16 / sizeof(T);
  const int n_vec = reinterpret_cast<uintptr_t>(src) % 16 == 0 ? min(avail, S::kSpan) / kVec : 0;
#pragma unroll
  for (int r = 0; r < (S::kSpan / kVec + kThreadsA - 1) / kThreadsA; ++r) {
    const int i = threadIdx.x + r * kThreadsA;
    if (i < n_vec) stage16(xs + i * kVec, src + i * kVec);
  }
  for (int i = n_vec * kVec + threadIdx.x; i < S::kSpan; i += kThreadsA) {
    xs[i] = i < avail ? pcm16(src[i]) : int16_t(0);
  }
  for (int i = threadIdx.x; i < 256; i += kThreadsA) tw256[i] = tab.tw256[i];
  for (int i = threadIdx.x; i < kBins; i += kThreadsA) tw512[i] = tab.tw512[i];
  for (int i = threadIdx.x; i < kWindow; i += kThreadsA) win[i] = tab.window[i];
  const int n_taps = __ldg(tab.mel_offset + kChannels);
  for (int i = threadIdx.x; i < n_taps; i += kThreadsA) melw[i] = tab.mel_weights[i];
  const float c8 = __ldg(tab.fft16), s8 = __ldg(tab.fft16 + 1), r2 = __ldg(tab.fft16 + 2);
  __syncthreads();

  // Hop h of the tile belongs to the 16 threads of one half-warp.  Hops past
  // the end of a ragged last tile run on zeros and write nothing.
  const int h = threadIdx.x / kHopThreads;
  const int j = threadIdx.x % kHopThreads;
  const int lane = threadIdx.x % 32;
  float2* hb = buf + h * kHopBuf;
  float2 v[16];

  // Pass 1, thread j = n2: v[n1] = z[16 n1 + n2] (n1 = 15 is zero padding:
  // samples 480..511), a 16-point FFT over n1, then times W256^(n2 k1).
  const int16_t* x = xs + h * HOP;
#pragma unroll
  for (int n1 = 0; n1 < 15; ++n1) {
    const int m = 32 * n1 + 2 * j;
    const short2 p = *reinterpret_cast<const short2*>(x + m);
    const float2 w = *reinterpret_cast<const float2*>(win + m);
    v[n1] = make_float2(static_cast<float>(p.x) * w.x, static_cast<float>(p.y) * w.y);
  }
  v[15] = make_float2(0.0f, 0.0f);
  fft16(v, c8, s8, r2);
#pragma unroll
  for (int k1 = 1; k1 < 16; ++k1) {
    v[fft16_pos(k1)] = cmul(v[fft16_pos(k1)], tw256[k1 * 16 + j]);
  }
#pragma unroll
  for (int k1 = 0; k1 < 16; ++k1) hb[k1 * kPad + j] = v[fft16_pos(k1)];
  __syncwarp();

  // Pass 2, thread j = k1: a 16-point FFT over n2 -> Z[k1 + 16 k2] at
  // v[fft16_pos(k2)].
#pragma unroll
  for (int n2 = 0; n2 < 16; ++n2) v[n2] = hb[j * kPad + n2];
  __syncwarp();
  fft16(v, c8, s8, r2);

  // Split step, by pairs: bins k = j + 16 i and 256 - k (i < 8) need Z[k],
  // this thread's v[pos(i)], and Z[256 - k], which thread (16 - j) mod 16
  // holds as its v[pos(15 - i)] (v[pos((16 - i) mod 16)] for j = 0, whose
  // partner is itself; its pair i = 0 is bins 0 and 256).  Thread 0 also
  // takes bin 128, which pairs with itself.  Energies go to the hop buffer,
  // offset by 17 h words so that the mel step's lanes (one hop each) read
  // distinct banks.
  float* energy = reinterpret_cast<float*>(hb) + (17 * h) % 32;
  const int partner = (lane & 16) | ((16 - j) & 15);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 mine = j == 0 ? v[fft16_pos((16 - i) & 15)] : v[fft16_pos(15 - i)];
    const float2 other = make_float2(__shfl_sync(0xffffffffu, mine.x, partner),
                                     __shfl_sync(0xffffffffu, mine.y, partner));
    const int k = j + 16 * i;
    split_pair(v[fft16_pos(i)], other, tw512[k], energy[k], energy[256 - k]);
  }
  if (j == 0) {
    float unused;
    split_pair(v[fft16_pos(8)], v[fft16_pos(8)], tw512[128], energy[128], unused);
  }
  __syncthreads();  // every hop's energies are in place

  // Mel filters, warp by warp: a warp takes whole channels (the host spreads
  // them over the warps by tap count) with one hop per lane, so each weight
  // is read once for all lanes and each lane reads its own hop's energies.
  // The taps are summed in ascending bin order, then sqrt / 8.  The tile's
  // local EMA end, sum over its nt hops of (1-s)^(nt-1-h) s x_h, is a
  // butterfly sum over the lanes.
  const int warp = threadIdx.x / 32;
  const float* lane_energy = reinterpret_cast<const float*>(buf + lane * kHopBuf) + (17 * lane) % 32;
#pragma unroll 1
  for (int r = 0; r < kMelRounds; ++r) {
    const int c = __ldg(tab.mel_slots + r * kWarpsA + warp);
    if (c < 0) continue;
    const int first = __ldg(tab.mel_first + c);
    const int o0 = __ldg(tab.mel_offset + c), o1 = __ldg(tab.mel_offset + c + 1);
    float acc = 0.0f;
    for (int o = o0; o < o1; ++o) acc = fmaf(lane_energy[first + o - o0], melw[o], acc);
    const float amp = sqrtf(fmaxf(acc, 0.0f)) / 8.0f;
    sfs[lane * kSfStride + c] = amp;
    float term = lane < nt
        ? (smoothing_of(c) * amp) * __ldg(tab.ema_powers + (c % 2) * kTile + nt - 1 - lane)
        : 0.0f;
#pragma unroll
    for (int d = 16; d > 0; d /= 2) term += __shfl_xor_sync(0xffffffffu, term, d);
    if (lane == 0) ends[((long long)b * n_tiles + tile) * kChannels + c] = term;
  }
  __syncthreads();

  // The tile's sf rows are contiguous in device memory: coalesced stores.
  float* dst = sf + ((long long)b * n_frames + t0) * kChannels;
  for (int i = threadIdx.x; i < nt * kChannels; i += kThreadsA) {
    dst[i] = sfs[(i / kChannels) * kSfStride + i % kChannels];
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

// The estimate entering each tile of a row, from launch A's tile ends.
__global__ void __launch_bounds__(kThreadsB)
carry_scan_kernel(const float* __restrict__ ends, const float* __restrict__ decay,
                  float* __restrict__ carries, int batch, int n_tiles) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= batch * kChannels) return;
  const int c = idx % kChannels;
  const long long base = (long long)(idx / kChannels) * n_tiles * kChannels + c;
  const float d = __ldg(decay + c % 2);
  float est = 0.0f;
#pragma unroll 8
  for (int j = 0; j < n_tiles; ++j) {
    const long long at = base + (long long)j * kChannels;
    carries[at] = est;
    est = d * est + __ldg(ends + at);
  }
}

__global__ void __launch_bounds__(kThreadsB)
ema_agc_kernel(const float* __restrict__ sf, const float* __restrict__ carries,
               float* __restrict__ out, int batch, int n_frames, int n_tiles) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= batch * n_tiles * kPartsB * kChannels) return;
  const int c = idx % kChannels;
  const int part = (idx / kChannels) % kPartsB;
  const int tile = (idx / (kChannels * kPartsB)) % n_tiles;
  const int b = idx / (kChannels * kPartsB * n_tiles);
  const int t0 = tile * kTile;
  const int ts = t0 + part * kPartB;  // the first hop this thread scores
  if (ts >= n_frames) return;
  const float s = smoothing_of(c), keep = 1.0f - s;
  float est = __ldg(carries + ((long long)b * n_tiles + tile) * kChannels + c);
  // The tile's hops before this thread's part: the EMA alone.
  const long long row = (long long)b * n_frames * kChannels + c;
  const float* src = sf + row;
  float* dst = out + row;
  for (int t = t0; t < ts; ++t) est = keep * est + s * src[t * kChannels];
  const int te = min(ts + kPartB, n_frames);
#pragma unroll 8
  for (int t = ts; t < te; ++t) {
    const float x = src[t * kChannels];
    est = keep * est + s * x;
    dst[t * kChannels] = agc_output(x, est);
  }
}

template <typename T, int HOP>
cudaError_t launch_filterbank(const void* audio, int batch, int n_samples,
                              int n_frames, const Tables& tab, float* sf,
                              float* ends, cudaStream_t stream) {
  constexpr size_t kSmem = SmemA<HOP>::kBytes;
  auto kernel = filterbank_kernel<T, HOP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (n_frames + kTile - 1) / kTile;
  kernel<<<batch * n_tiles, kThreadsA, kSmem, stream>>>(
      static_cast<const T*>(audio), n_samples, n_frames, n_tiles, tab, sf, ends);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mww_frontend_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch layout that frontend/kernel.py builds its tables for: hops per
// tile, and the [rounds][warps] shape of launch A's mel_slots.
void mww_frontend_layout(int* tile, int* mel_rounds, int* warps_a) {
  *tile = kTile;
  *mel_rounds = kMelRounds;
  *warps_a = kWarpsA;
}

// Launch A.  audio: [batch, n_samples] int16 (audio_is_float 0) or float32;
// the tables of frontend/kernel.py host_tables; sf: [batch, n_frames, 40]
// and ends: [batch, ceil(n_frames / kTile), 40] float32.  Returns a
// cudaError_t.
int mww_frontend_filterbank(const void* audio, int audio_is_float, int batch,
                            int n_samples, int n_frames, int hop,
                            const float* window, const float* fft16,
                            const float* tw256, const float* tw512,
                            const int* mel_first, const int* mel_offset,
                            const float* mel_weights, const int* mel_slots,
                            const float* ema_powers, float* sf, float* ends,
                            void* stream) {
  const Tables tab{window, fft16, reinterpret_cast<const float2*>(tw256),
                   reinterpret_cast<const float2*>(tw512), mel_first,
                   mel_offset, mel_weights, mel_slots, ema_powers};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hop == 160) {
    return audio_is_float
               ? launch_filterbank<float, 160>(audio, batch, n_samples, n_frames, tab, sf, ends, s)
               : launch_filterbank<int16_t, 160>(audio, batch, n_samples, n_frames, tab, sf, ends, s);
  }
  if (hop == 320) {
    return audio_is_float
               ? launch_filterbank<float, 320>(audio, batch, n_samples, n_frames, tab, sf, ends, s)
               : launch_filterbank<int16_t, 320>(audio, batch, n_samples, n_frames, tab, sf, ends, s);
  }
  return cudaErrorInvalidValue;
}

// Launch S.  ends: launch A's tile ends, [batch, n_tiles, 40]; decay: [2]
// (1 - s)^kTile for even and odd channels; carries: like ends.  Returns a
// cudaError_t.
int mww_frontend_carry_scan(const float* ends, const float* decay, float* carries,
                            int batch, int n_tiles, void* stream) {
  const int threads = batch * kChannels;
  carry_scan_kernel<<<(threads + kThreadsB - 1) / kThreadsB, kThreadsB, 0,
                      static_cast<cudaStream_t>(stream)>>>(ends, decay, carries,
                                                           batch, n_tiles);
  return cudaGetLastError();
}

// Launch B.  sf, out: [batch, n_frames, 40]; carries: launch S's output.
// Returns a cudaError_t.
int mww_frontend_ema_agc(const float* sf, const float* carries, float* out,
                         int batch, int n_frames, void* stream) {
  const int n_tiles = (n_frames + kTile - 1) / kTile;
  const int threads = batch * n_tiles * kPartsB * kChannels;
  ema_agc_kernel<<<(threads + kThreadsB - 1) / kThreadsB, kThreadsB, 0,
                   static_cast<cudaStream_t>(stream)>>>(sf, carries, out,
                                                        batch, n_frames, n_tiles);
  return cudaGetLastError();
}

}  // extern "C"
