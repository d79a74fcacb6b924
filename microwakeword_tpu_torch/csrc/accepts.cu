// Cooldown accept counting for Hopper (sm_90a): probabilities [R, T] ->
// int64 counts [R, n_cutoffs], the same function as
// microwakeword_tpu_torch/evaluate/roc.py count_accepts on a CPU tensor.
//
// Replaces no TPU kernel: the JAX package counts with a lax.scan over time
// (microwakeword_tpu/evaluate/roc.py _count_accepts), which XLA compiles into
// one loop.  Eager PyTorch has no such loop: on the card the per-frame form
// issued about 7 small operations a frame (2,300 launches for 64 streams of
// 328 frames), each costing the host more than the card, behind a blocking
// copy of the cutoffs.  This kernel is the whole count in one launch.
//
// Per (track, cutoff) the count is a serial chain along time: the cooldown
// of frame t depends on frame t - 1's.  Tracks and cutoffs are independent,
// so:
//   - one block per track (a row of R), one thread per cutoff (the block is
//     n_cutoffs rounded up to a warp: 101 -> 128); a long single track is one
//     block and never waits behind a batch;
//   - the block stages the track's float32 probabilities through shared
//     memory in chunks of kChunk frames, loaded by all its threads at
//     neighbouring addresses (coalesced); every thread then reads frame i at
//     the same address (a broadcast, no bank conflict);
//   - each thread walks the frames in order with its cooldown and its count
//     in registers, and writes its int64 count once at the end;
//   - the cutoffs come by value in the launch's parameters
//     (__grid_constant__, at most kMaxCutoffs), so no host-to-device copy,
//     and no wait for the stream, precedes the launch.
// Per frame: cooldown = max(cooldown - 1, 0); fire when cooldown == 0 and
// p > cut (float32 against float32); on a fire cooldown = reset, count + 1;
// the cooldown starts at reset.
//
// What bounds it on an H100: 4 bytes a frame in and 8 a count out (84 KB
// and 52 KB at [64, 328] x 101: 0.04 us at 3.35 TB/s) and about 5 integer
// and compare operations a (frame, cutoff).  Neither is near the card's
// rate: a thread's chain of T dependent steps of a few cycles each sets the
// kernel's time, a few microseconds at the serving shapes, where the launch
// itself is most of the cost.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCutoffs = 512;  // threads of a block at most; 2 KB of parameters
constexpr int kChunk = 1024;      // frames staged in shared memory per pass

struct Cutoffs {
  float v[kMaxCutoffs];
};

__global__ void __launch_bounds__(kMaxCutoffs)
    accepts_kernel(const float* __restrict__ probs, int n_frames,
                   const __grid_constant__ Cutoffs cut, int n_cutoffs, int reset,
                   long long* __restrict__ counts) {
  __shared__ float frames[kChunk];
  const int j = threadIdx.x;
  const float c = j < n_cutoffs ? cut.v[j] : 0.0f;
  const float* row = probs + static_cast<long long>(blockIdx.x) * n_frames;
  int cooldown = reset;
  int fired = 0;
  for (int t0 = 0; t0 < n_frames; t0 += kChunk) {
    const int len = min(kChunk, n_frames - t0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < len; i += blockDim.x) frames[i] = row[t0 + i];
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < len; ++i) {
      cooldown = max(cooldown - 1, 0);
      const bool fire = (cooldown == 0) & (frames[i] > c);
      cooldown = fire ? reset : cooldown;
      fired += fire;
    }
  }
  if (j < n_cutoffs) {
    counts[static_cast<long long>(blockIdx.x) * n_cutoffs + j] = fired;
  }
}

}  // namespace

extern "C" {

const char* mww_accepts_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// probs: [rows, n_frames] float32, contiguous; cutoffs: n_cutoffs floats in
// host memory, copied into the launch's parameters; counts: [rows,
// n_cutoffs] int64.  Launches on ``stream``; returns a cudaError_t,
// cudaErrorInvalidValue for more than kMaxCutoffs cutoffs.
int mww_accepts_count(const float* probs, int rows, int n_frames, const float* cutoffs,
                      int n_cutoffs, int reset, long long* counts, void* stream) {
  if (rows < 1 || n_frames < 0 || n_cutoffs < 1 || n_cutoffs > kMaxCutoffs) {
    return cudaErrorInvalidValue;
  }
  Cutoffs cut = {};
  for (int j = 0; j < n_cutoffs; ++j) cut.v[j] = cutoffs[j];
  const int threads = (n_cutoffs + 31) / 32 * 32;
  accepts_kernel<<<rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(probs, n_frames, cut,
                                                                           n_cutoffs, reset, counts);
  return cudaGetLastError();
}

}  // extern "C"
