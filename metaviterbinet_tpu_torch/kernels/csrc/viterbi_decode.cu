// Greedy zero-delay Viterbi decode of precomputed branch metrics.
//
// Replaces the Pallas kernel metaviterbinet_tpu/kernels/acs.py::pallas_viterbi_decode
// (_decode_kernel): priors [W, T, S] f32 in, bits [W, T] f32 out, the ACS
// recursion and readout of metaviterbinet_tpu/ops/trellis.py::viterbi_decode.
// It is the decode of the online engine's per-block detection, after the
// ViterbiNet MLP has written the priors, at W = 1.
//
// What bounds it on an H100: at the engine's W = 1 the latency of the
// T-step dependent chain of one word, far above its byte bound of
// 4 (W T S + W T) bytes; at large W device memory (each step reads S priors
// against ~3.5 S f32 operations).
// What the design does about it:
//   - the priors leave the chain: the whole block (one warp) copies its
//     words' priors into shared memory with cp.async, in tiles of kSteps
//     steps through a ring of kStages tiles, kStages - 1 tiles ahead of the
//     recursion, so the chain reads only shared memory (the first version
//     read device memory one step ahead and waited on it every step);
//   - the per-step minimum and the readout are trees of depth log2(S/2)
//     (acs.cuh), and a tile's steps are fully unrolled;
//   - a block runs at most kMaxWords words, fewer when W is small, so that
//     W words spread over up to one block per SM: ceil(W / SMs) words per
//     block, with the device's SM count read once (on an H100 SXM's 132,
//     W = 300 takes 100 blocks; W = 1 is one block of one word).
// One lane per word keeps its S metrics in registers and stores its bit of
// each step. Any W and T: the ragged edges are masked.
//
// Rounding: the ACS step (acs.cuh) is adds, subtracts and mins only, so the
// bits are identical to the plain PyTorch recursion.
#include <cuda_runtime.h>

#include "acs.cuh"

namespace {

constexpr int kThreads = 32;  // one warp per block
constexpr int kMaxWords = 8;  // words (chains) per block at most
constexpr int kSteps = 16;    // time steps per staged tile
constexpr int kStages = 4;    // tiles in the ring
constexpr int kMaxDevices = 64;

// floats of one word's row in a staged tile: kSteps steps of S priors, plus
// a pad of one vector so that neighbouring lanes' rows start in other banks
template <int S>
__host__ __device__ constexpr int row_floats() {
  return kSteps * S + (S < 4 ? S : 4);
}

template <int S>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  constexpr int kBytes = 4 * (S < 4 ? S : 4);
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(kBytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// issue the copies of tile `tile` (steps tile * kSteps ..) of the block's
// words into ring stage `stage`; every lane takes every 32nd vector
template <int S>
__device__ __forceinline__ void load_tile(const float* __restrict__ priors, float* stage, long w0,
                                          int words, int T, int tile) {
  constexpr int kVec = S < 4 ? S : 4;
  const int t0 = tile * kSteps;
  const int steps = min(kSteps, T - t0);
  const int per_word = steps * S / kVec;
  for (int i = threadIdx.x; i < words * per_word; i += kThreads) {
    const int w = i / per_word, v = i - w * per_word;
    cp_async<S>(stage + w * row_floats<S>() + v * kVec,
                priors + ((w0 + w) * T + t0) * S + v * kVec);
  }
}

template <int S>
__device__ __forceinline__ void load_priors(const float* __restrict__ src, float (&p)[S]) {
  if constexpr (S == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    p[0] = v.x;
    p[1] = v.y;
  } else {
#pragma unroll
    for (int s = 0; s < S; s += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + s);
      p[s] = v.x;
      p[s + 1] = v.y;
      p[s + 2] = v.z;
      p[s + 3] = v.w;
    }
  }
}

template <int S>
__global__ void __launch_bounds__(kThreads)
viterbi_decode_kernel(const float* __restrict__ priors, float* __restrict__ out, int W, int T,
                      int words_per_block) {
  extern __shared__ __align__(16) float ring[];  // [kStages][words_per_block][row_floats]
  const int lane = threadIdx.x;
  const long w0 = static_cast<long>(blockIdx.x) * words_per_block;
  const int words = static_cast<int>(min(static_cast<long>(words_per_block), W - w0));
  const bool live = lane < words;
  const int stage_floats = words_per_block * row_floats<S>();
  float* bits = out + (w0 + lane) * T;
  const int n_tiles = (T + kSteps - 1) / kSteps;

  float m[S];
#pragma unroll
  for (int s = 0; s < S; ++s) m[s] = 0.0f;

  // prologue: the first kStages - 1 tiles in flight (one commit group each,
  // empty past the last tile, so that the group count stays uniform)
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile<S>(priors, ring + st * stage_floats, w0, words, T, st);
    cp_async_commit();
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int ahead = tile + kStages - 1;
    if (ahead < n_tiles) {
      load_tile<S>(priors, ring + (ahead % kStages) * stage_floats, w0, words, T, ahead);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this lane's copies of `tile` have landed
    __syncthreads();               // and every lane's
    if (live) {
      const float* row = ring + (tile % kStages) * stage_floats + lane * row_floats<S>();
      const int t0 = tile * kSteps;
      if (t0 + kSteps <= T) {
#pragma unroll
        for (int c = 0; c < kSteps; ++c) {
          float p[S];
          load_priors<S>(row + c * S, p);
          bits[t0 + c] = acs_step<S>(m, p);
        }
      } else {
        for (int c = 0; c < T - t0; ++c) {
          float p[S];
          load_priors<S>(row + c * S, p);
          bits[t0 + c] = acs_step<S>(m, p);
        }
      }
    }
    __syncthreads();  // the stage is read before a later tile overwrites it
  }
  cp_async_wait<0>();
}

// the current device's SM count, read once per device (no stream work, so
// safe while a CUDA graph captures); 0 on an error
int sm_count() {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  if (cached[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    cached[dev] = n;
  }
  return cached[dev];
}

template <int S>
cudaError_t launch(const float* priors, float* out, int W, int T, cudaStream_t stream) {
  const int sms = sm_count();
  if (sms == 0) return cudaErrorInvalidDevice;
  const int words_per_block = min(kMaxWords, (W + sms - 1) / sms);
  const int blocks = (W + words_per_block - 1) / words_per_block;
  const size_t bytes = sizeof(float) * kStages * words_per_block * row_floats<S>();
  viterbi_decode_kernel<S><<<blocks, kThreads, bytes, stream>>>(priors, out, W, T,
                                                                words_per_block);
  return cudaGetLastError();
}

}  // namespace

// priors [W, T, S] (16-byte aligned, 8-byte for S = 2), out [W, T]: f32,
// contiguous, on the current device. Returns the CUDA error of the launch
// (0 on success).
extern "C" int viterbi_decode(const float* priors, float* out, int W, int T, int S,
                              cudaStream_t stream) {
  cudaError_t err;
  switch (S) {
    case 2: err = launch<2>(priors, out, W, T, stream); break;
    case 4: err = launch<4>(priors, out, W, T, stream); break;
    case 8: err = launch<8>(priors, out, W, T, stream); break;
    case 16: err = launch<16>(priors, out, W, T, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
