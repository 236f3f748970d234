// Time-chunked ViterbiNet detect: K1's MLP + ACS over overlap-save chunks
// of the time axis, one chain per (word, chunk).
//
// Replaces the Pallas kernel
// metaviterbinet_tpu/kernels/acs.py::fused_viterbinet_detect_chunked
// (_run_detect_kernel -> _detect_kernel with overlap > 0). T splits into C
// chunks of Tc = T / C symbols. Chain j = w * C + c (w-major, as the TPU
// lanes are) decodes chunk c of word w: it first warms up on the last
// `overlap` symbols of chunk c - 1, whose bits it drops, then decodes its Tc
// symbols. The chain reads y at its own offsets (no extended copy in device
// memory) and writes only its Tc bits.
//
// Stream-head chunks (c == 0) skip their warm-up. The TPU kernel runs it on
// zeroed priors, which keep every path metric at exactly 0.0 (0 + 0, a min
// of zeros, minus 0), and drops its bits; skipping it leaves the same zero
// metrics, so the head chains are bit-exact against it (their warm-up rows
// of a tile are computed and not stored).
//
// The per-symbol priors come from viterbinet_mlp.cuh's wgmma tile, the code
// K1 runs: a row of a tensor-core product depends only on its own operands,
// so a symbol's priors are bit-identical in both kernels, and the bits then
// equal K1's wherever the trellis forgets its start within `overlap` steps.
//
// What bounds it on an H100: operations, as K1: ~1.2e4 FLOP per extended
// symbol, W * (T + (C - 1) * overlap) of them, against 8 bytes of y and bits
// per symbol. Why it exists: at the protocol's 300 words an unchunked chain
// is 136 dependent ACS steps; chunking gives C times the chains of
// overlap + Tc steps each.
// The design: a block of 8 chains computes the priors of 32 steps of its
// chains with both of its warpgroups (four 64-symbol wgmma tiles) into
// shared memory, then 8 threads run the 8 chains over those steps with
// their metrics in registers. Any W, any C dividing T with 1 <= overlap <=
// Tc: the ragged edges are masked.
#include <cuda_runtime.h>

#include "acs.cuh"
#include "viterbinet_mlp.cuh"

namespace {

constexpr int kChains = 8;                  // chains per block
constexpr int kSteps = 32;                  // time steps per chunk of the loop
constexpr int kThreads = kChains * kSteps;  // one (chain, step) per thread

template <int S>
__global__ void __launch_bounds__(kThreads)
viterbinet_detect_chunked_kernel(const float* __restrict__ y, const float* __restrict__ w1,
                                 const float* __restrict__ b1, const float* __restrict__ w2,
                                 const float* __restrict__ b2, const float* __restrict__ w3,
                                 const float* __restrict__ b3, float* __restrict__ out,
                                 int W, int T, int C, int overlap) {
  constexpr int kStepStride = S + 1;
  constexpr int kChainStride = kSteps * kStepStride + 1;
  __shared__ MlpWeights<S> s_mlp;
  __shared__ float s_prior[kChains * kChainStride];
  __shared__ float s_bits[kChains][kSteps];

  const int tid = threadIdx.x;
  load_mlp<S>(s_mlp, w1, b1, w2, b2, w3, b3, tid, kThreads);

  const int Tc = T / C;
  const int ext = overlap + Tc;  // steps of a chain, warm-up included
  const long n_chains = static_cast<long>(W) * C;
  const long j0 = static_cast<long>(blockIdx.x) * kChains;

  // Step e of a chain (0 <= e < ext) reads symbol c * Tc - overlap + e of
  // its word; e < overlap is warm-up (none for a head chain), e >= overlap
  // writes its bit to that same symbol's place in out. The MLP phase runs
  // the iteration's kChains x kSteps (chain, step) symbols, index
  // chain * kSteps + step, as kThreads / kTileRows wgmma tiles, two per
  // warpgroup; this thread owns two rows of each (see mlp_tile).
  const int lane = tid % 32;
  const int r0 = 128 * (tid / 128) + 16 * (tid / 32 % 4) + lane / 4;
  const long achain = j0 + tid;  // ACS phase: threads 0..7, one chain each
  const bool a_live = tid < kChains && achain < n_chains;
  const int a_first = (a_live && achain % C == 0) ? overlap : 0;
  float m[S];
#pragma unroll
  for (int s = 0; s < S; ++s) m[s] = 0.0f;

  for (int e0 = 0; e0 < ext; e0 += kSteps) {
    const int steps = min(kSteps, ext - e0);
    __syncthreads();  // weights loaded / previous chunk's bits written out
#pragma unroll
    for (int tile = 0; tile < 2; ++tile) {
      int idx[2];
      float yv[2];
      bool live[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        idx[h] = r0 + kTileRows * tile + 8 * h;
        const long chain = j0 + idx[h] / kSteps;
        const int c = idx[h] % kSteps, e = e0 + c;
        const int first = chain % C == 0 ? overlap : 0;  // first step the chain runs
        live[h] = chain < n_chains && c < steps && e >= first;
        yv[h] = live[h] ? y[(chain / C) * T + (chain % C) * Tc - overlap + e] : 0.0f;
      }
      float p[2][kPriorCols<S>()];
      mlp_tile<S>(s_mlp, yv[0], yv[1], p[0], p[1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!live[h]) continue;
        float* dst = s_prior + (idx[h] / kSteps) * kChainStride + (idx[h] % kSteps) * kStepStride;
#pragma unroll
        for (int j = 0; j < kPriorCols<S>(); ++j) {
          const int col = prior_col<S>(j, lane);
          if (col < S) dst[col] = p[h][j];
        }
      }
    }
    __syncthreads();
    if (a_live) {
      const float* prior = s_prior + tid * kChainStride;
      for (int c = max(0, a_first - e0); c < steps; ++c) {
        float p[S];
#pragma unroll
        for (int s = 0; s < S; ++s) p[s] = prior[c * kStepStride + s];
        s_bits[tid][c] = acs_step<S>(m, p);
      }
    }
    __syncthreads();
    const int mj = tid / kSteps, mc = tid % kSteps;  // write-out: one (chain, step) each
    const long chain = j0 + mj;
    if (chain < n_chains && mc < steps && e0 + mc >= overlap)
      out[(chain / C) * T + (chain % C) * Tc - overlap + e0 + mc] = s_bits[mj][mc];
  }
}

template <int S>
void launch(const float* y, const float* w1, const float* b1, const float* w2,
            const float* b2, const float* w3, const float* b3, float* out, int W, int T,
            int C, int overlap, cudaStream_t stream) {
  const long chains = static_cast<long>(W) * C;
  const int blocks = static_cast<int>((chains + kChains - 1) / kChains);
  viterbinet_detect_chunked_kernel<S><<<blocks, kThreads, 0, stream>>>(
      y, w1, b1, w2, b2, w3, b3, out, W, T, C, overlap);
}

}  // namespace

// y [W, T]; w1 [100] (the [100, 1] weight), b1 [100], w2 [50, 100], b2 [50],
// w3 [S, 50], b3 [S]; out [W, T]: f32, contiguous, on the current device.
// C divides T and 1 <= overlap <= T / C (the wrapper checks both).
// Returns the CUDA error of the launch (0 on success).
extern "C" int viterbinet_detect_chunked(const float* y, const float* w1, const float* b1,
                                         const float* w2, const float* b2, const float* w3,
                                         const float* b3, float* out, int W, int T, int S,
                                         int C, int overlap, cudaStream_t stream) {
  if (C < 1 || T % C != 0 || overlap < 1 || overlap > T / C)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (S) {
    case 2: launch<2>(y, w1, b1, w2, b2, w3, b3, out, W, T, C, overlap, stream); break;
    case 4: launch<4>(y, w1, b1, w2, b2, w3, b3, out, W, T, C, overlap, stream); break;
    case 8: launch<8>(y, w1, b1, w2, b2, w3, b3, out, W, T, C, overlap, stream); break;
    case 16: launch<16>(y, w1, b1, w2, b2, w3, b3, out, W, T, C, overlap, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
