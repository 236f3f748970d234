// Full-CSI Viterbi detect: analytic Gaussian branch metric fused with the
// greedy zero-delay ACS recursion.
//
// Replaces the Pallas kernel metaviterbinet_tpu/kernels/acs.py::fused_va_detect
// (_va_kernel). Per word and step t, prior_s = (y_t - mu_s)^2 / 2 - log sqrt(2 pi)
// is computed in registers from the word's S state means, then one ACS step
// runs; only y and mu are read and only the bits are written.
//
// What bounds it on an H100: device memory. Each symbol reads 4 B of y and
// writes 4 B of bits against ~8.5 S f32 operations, far below the card's
// ratio of operations to bytes; at small W it is the latency of the T-step
// serial chain of each word instead.
// What the design does about it: one thread per word keeps the S metrics
// and S means in registers for the whole chain, so nothing but y, mu and
// the bits touches device memory. A block of 32 words stages y and the bits
// through shared memory in tiles of 32 steps, so that both move in coalesced
// 128-byte rows although each thread walks its own word. Any W and T: the
// ragged edges are masked.
//
// Rounding: the prior is written with explicit round-to-nearest intrinsics so
// nvcc cannot contract it into an FMA; it rounds like the plain PyTorch
// version (models/va.py::branch_priors_from_mu) and the kernel is
// bit-identical to it.
#include <cuda_runtime.h>

#include "acs.cuh"

namespace {

constexpr int kWords = 32;  // words (threads) per block
constexpr int kSteps = 32;  // time steps per staged tile
// float32(log(sqrt(2 pi))), the constant the PyTorch and JAX versions subtract
constexpr float kLogSqrt2Pi = 0x1.d67f1cp-1f;

template <int S>
__global__ void __launch_bounds__(kWords)
va_detect_kernel(const float* __restrict__ y, const float* __restrict__ mu,
                 float* __restrict__ out, int W, int T) {
  __shared__ float tile[kWords][kSteps + 1];
  const int lane = threadIdx.x;
  const long w0 = static_cast<long>(blockIdx.x) * kWords;
  const bool live = w0 + lane < W;

  float m[S];
  float mean[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    m[s] = 0.0f;
    mean[s] = live ? mu[(w0 + lane) * S + s] : 0.0f;
  }

  for (int t0 = 0; t0 < T; t0 += kSteps) {
    const int steps = min(kSteps, T - t0);
    for (int i = lane; i < kWords * kSteps; i += kWords) {
      const int r = i / kSteps, c = i % kSteps;
      if (w0 + r < W && c < steps) tile[r][c] = y[(w0 + r) * T + t0 + c];
    }
    __syncthreads();
    if (live) {
      for (int c = 0; c < steps; ++c) {
        const float yt = tile[lane][c];
        float p[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float d = __fsub_rn(yt, mean[s]);
          p[s] = __fsub_rn(__fmul_rn(__fmul_rn(d, d), 0.5f), kLogSqrt2Pi);
        }
        tile[lane][c] = acs_step_linear<S>(m, p);
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
void launch(const float* y, const float* mu, float* out, int W, int T, cudaStream_t stream) {
  const int blocks = (W + kWords - 1) / kWords;
  va_detect_kernel<S><<<blocks, kWords, 0, stream>>>(y, mu, out, W, T);
}

}  // namespace

// y [W, T], mu [W, S], out [W, T]: f32, contiguous, on the current device.
// Returns the CUDA error of the launch (0 on success).
extern "C" int va_detect(const float* y, const float* mu, float* out, int W, int T, int S,
                         cudaStream_t stream) {
  switch (S) {
    case 2: launch<2>(y, mu, out, W, T, stream); break;
    case 4: launch<4>(y, mu, out, W, T, stream); break;
    case 8: launch<8>(y, mu, out, W, T, stream); break;
    case 16: launch<16>(y, mu, out, W, T, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
