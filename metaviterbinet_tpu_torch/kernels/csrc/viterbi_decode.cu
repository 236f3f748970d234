// Greedy zero-delay Viterbi decode of precomputed branch metrics.
//
// Replaces the Pallas kernel metaviterbinet_tpu/kernels/acs.py::pallas_viterbi_decode
// (_decode_kernel): priors [W, T, S] f32 in, bits [W, T] f32 out, the ACS
// recursion and readout of metaviterbinet_tpu/ops/trellis.py::viterbi_decode.
// It is the decode of the online engine's per-block detection, after the
// ViterbiNet MLP has written the priors.
//
// What bounds it on an H100: at the engine's W = 1 the latency of the
// T-step dependent chain of one word, far above its byte bound of
// 4 (W T S + W T) bytes; at large W device memory (each step reads S priors
// against ~3.5 S f32 operations).
// What the design does about it: one thread per word keeps its S metrics in
// registers and reads its S priors per step with 16-byte vector loads (the
// word's priors of one step are S contiguous floats), one step ahead of the
// ACS so that the load latency is off the chain. A block of 32 words stages
// the bits through shared memory in tiles of 32 steps, so that they leave in
// coalesced rows. Any W and T: the ragged edges are masked.
//
// Rounding: the ACS step (acs.cuh) is adds, subtracts and mins only, so the
// bits are identical to the plain PyTorch recursion.
#include <cuda_runtime.h>

#include "acs.cuh"

namespace {

constexpr int kWords = 32;  // words (threads) per block
constexpr int kSteps = 32;  // time steps per staged tile of bits

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
__global__ void __launch_bounds__(kWords)
viterbi_decode_kernel(const float* __restrict__ priors, float* __restrict__ out, int W, int T) {
  __shared__ float tile[kWords][kSteps + 1];
  const int lane = threadIdx.x;
  const long w0 = static_cast<long>(blockIdx.x) * kWords;
  const bool live = w0 + lane < W;
  const float* word = priors + (w0 + lane) * static_cast<long>(T) * S;

  float m[S];
  float next[S];
#pragma unroll
  for (int s = 0; s < S; ++s) m[s] = 0.0f;
  if (live && T > 0) load_priors<S>(word, next);

  for (int t0 = 0; t0 < T; t0 += kSteps) {
    const int steps = min(kSteps, T - t0);
    if (live) {
      for (int c = 0; c < steps; ++c) {
        float p[S];
#pragma unroll
        for (int s = 0; s < S; ++s) p[s] = next[s];
        if (t0 + c + 1 < T) load_priors<S>(word + static_cast<long>(t0 + c + 1) * S, next);
        tile[lane][c] = acs_step<S>(m, p);
      }
    }
    __syncthreads();
    for (int i = lane; i < kWords * kSteps; i += kWords) {
      const int r = i / kSteps, c = i % kSteps;
      if (w0 + r < W && c < steps) out[(w0 + r) * T + t0 + c] = tile[r][c];
    }
    __syncthreads();
  }
}

template <int S>
void launch(const float* priors, float* out, int W, int T, cudaStream_t stream) {
  const int blocks = (W + kWords - 1) / kWords;
  viterbi_decode_kernel<S><<<blocks, kWords, 0, stream>>>(priors, out, W, T);
}

}  // namespace

// priors [W, T, S] (16-byte aligned, 8-byte for S = 2), out [W, T]: f32,
// contiguous, on the current device. Returns the CUDA error of the launch
// (0 on success).
extern "C" int viterbi_decode(const float* priors, float* out, int W, int T, int S,
                              cudaStream_t stream) {
  switch (S) {
    case 2: launch<2>(priors, out, W, T, stream); break;
    case 4: launch<4>(priors, out, W, T, stream); break;
    case 8: launch<8>(priors, out, W, T, stream); break;
    case 16: launch<16>(priors, out, W, T, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
