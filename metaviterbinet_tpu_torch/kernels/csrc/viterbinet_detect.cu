// ViterbiNet detect: the per-symbol 1 -> 100 -> 50 -> S branch-metric MLP
// (viterbinet_mlp.cuh) fused with the greedy zero-delay ACS recursion.
//
// Replaces the Pallas kernel
// metaviterbinet_tpu/kernels/acs.py::fused_viterbinet_detect
// (_run_detect_kernel -> _detect_kernel). Only y is read and only the bits
// are written; no activation or prior reaches device memory.
//
// What bounds it on an H100: operations. ~1.2e4 FLOP per symbol against
// 8 bytes of y and bits. The products have bf16 operands, whose peak is the
// tensor cores'; this first version runs them as f32 FMAs on the CUDA
// cores, which caps it at the f32 rate. Moving the two products onto wgmma
// is later work.
// What the design does about it: the MLP does not depend on the ACS chain,
// so a block of 8 words computes the priors of 32 steps of its words with
// all 256 threads (one (word, step) each, weights broadcast from shared
// memory), parks them in shared memory, and then 8 threads run the 8
// chains over those 32 steps with their metrics in registers. Several
// blocks share an SM, so one block's chains overlap another's MLP. Any W
// and T: the ragged edges are masked.
#include <cuda_runtime.h>

#include "acs.cuh"
#include "viterbinet_mlp.cuh"

namespace {

constexpr int kWords = 8;                   // words (chains) per block
constexpr int kSteps = 32;                  // time steps per chunk
constexpr int kThreads = kWords * kSteps;   // one (word, step) per thread

template <int S>
__global__ void __launch_bounds__(kThreads)
viterbinet_detect_kernel(const float* __restrict__ y, const float* __restrict__ w1,
                         const float* __restrict__ b1, const float* __restrict__ w2,
                         const float* __restrict__ b2, const float* __restrict__ w3,
                         const float* __restrict__ b3, float* __restrict__ out, int W,
                         int T) {
  // per-word stride of the prior buffer: S+1 per step and +1 per word keep
  // both the MLP threads' writes and the chain threads' reads conflict-free
  constexpr int kStepStride = S + 1;
  constexpr int kWordStride = kSteps * kStepStride + 1;
  __shared__ MlpWeights<S> s_mlp;
  __shared__ float s_prior[kWords * kWordStride];
  __shared__ float s_bits[kWords][kSteps];

  const int tid = threadIdx.x;
  load_mlp<S>(s_mlp, w1, b1, w2, b2, w3, b3, tid, kThreads);

  const long w0 = static_cast<long>(blockIdx.x) * kWords;
  const int mw = tid / kSteps;  // MLP phase: this thread's word ...
  const int mc = tid % kSteps;  // ... and step within the chunk
  float m[S];
#pragma unroll
  for (int s = 0; s < S; ++s) m[s] = 0.0f;

  for (int t0 = 0; t0 < T; t0 += kSteps) {
    const int steps = min(kSteps, T - t0);
    __syncthreads();  // weights loaded / previous chunk's bits written out
    if (w0 + mw < W && mc < steps)
      symbol_prior<S>(s_mlp, y[(w0 + mw) * T + t0 + mc],
                      s_prior + mw * kWordStride + mc * kStepStride);
    __syncthreads();
    if (tid < kWords && w0 + tid < W) {
      const float* prior = s_prior + tid * kWordStride;
      for (int c = 0; c < steps; ++c) {
        float p[S];
#pragma unroll
        for (int s = 0; s < S; ++s) p[s] = prior[c * kStepStride + s];
        s_bits[tid][c] = acs_step<S>(m, p);
      }
    }
    __syncthreads();
    if (w0 + mw < W && mc < steps) out[(w0 + mw) * T + t0 + mc] = s_bits[mw][mc];
  }
}

template <int S>
void launch(const float* y, const float* w1, const float* b1, const float* w2,
            const float* b2, const float* w3, const float* b3, float* out, int W, int T,
            cudaStream_t stream) {
  const int blocks = (W + kWords - 1) / kWords;
  viterbinet_detect_kernel<S><<<blocks, kThreads, 0, stream>>>(y, w1, b1, w2, b2, w3, b3,
                                                               out, W, T);
}

}  // namespace

// y [W, T]; w1 [100] (the [100, 1] weight), b1 [100], w2 [50, 100], b2 [50],
// w3 [S, 50], b3 [S]; out [W, T]: f32, contiguous, on the current device.
// Returns the CUDA error of the launch (0 on success).
extern "C" int viterbinet_detect(const float* y, const float* w1, const float* b1,
                                 const float* w2, const float* b2, const float* w3,
                                 const float* b3, float* out, int W, int T, int S,
                                 cudaStream_t stream) {
  switch (S) {
    case 2: launch<2>(y, w1, b1, w2, b2, w3, b3, out, W, T, stream); break;
    case 4: launch<4>(y, w1, b1, w2, b2, w3, b3, out, W, T, stream); break;
    case 8: launch<8>(y, w1, b1, w2, b2, w3, b3, out, W, T, stream); break;
    case 16: launch<16>(y, w1, b1, w2, b2, w3, b3, out, W, T, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
