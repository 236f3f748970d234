// Full-CSI Viterbi detect: analytic Gaussian branch metric fused with the
// greedy zero-delay ACS recursion.
//
// Replaces the Pallas kernel metaviterbinet_tpu/kernels/acs.py::fused_va_detect
// (_va_kernel). Per word and step t, prior_s = (y_t - mu_s)^2 / 2 - log sqrt(2 pi)
// from the word's S state means, then one ACS step; only y and mu are read
// and only the bits are written.
//
// What bounds it on an H100: at small W (the VA engine's one word per
// launch, the protocol's 300) the latency of each word's T-step dependent
// chain; at large W the SM's memory pipeline, since every symbol's S priors
// pass through shared memory twice and each lane of a full block reads and
// writes its own word's row of y and the bits (its byte bound, 8 bytes per
// symbol, is 4x below what it takes at 65536 words).
// What the design does about it (prior_ring.cuh): the metric leaves the
// chain. One producer warp computes the priors of the next slot of
// (step, word) symbols, its 32 lanes over the slot's symbols, into a ring in
// shared memory, while the chain warp's lanes, one per word, run the ACS
// over the slot that has arrived (the tree step of acs.cuh), with nothing
// but loads from shared memory on their chain. The producer loads its
// samples one slot ahead, in 16-byte loads where a lane's rows are 4 steps
// of one word and y is 16-byte aligned, and the chain stores its bits 4
// steps at a time. A block holds ceil(W / SMs) words (at most 32), so W =
// 300 spreads over 100 SMs and W = 1 is one block. Any W and T: the ragged
// edges are masked.
//
// Rounding: the prior is written with explicit round-to-nearest intrinsics
// so nvcc cannot contract it into an FMA; it rounds like the plain PyTorch
// version (models/va.py::branch_priors_from_mu) and the ACS is adds,
// subtracts and mins, so the kernel is bit-identical to it.
#include <cuda_runtime.h>

#include "prior_ring.cuh"

namespace {

constexpr int kThreads = 64;  // warp 0: the chains; warp 1: the producer
// float32(log(sqrt(2 pi))), the constant the PyTorch and JAX versions subtract
constexpr float kLogSqrt2Pi = 0x1.d67f1cp-1f;

// the samples of rows lane, lane + 32, ... of slot `slot` (0 past the end);
// y16: y is 16-byte aligned
template <int N>
__device__ __forceinline__ void load_samples(const float* __restrict__ y, float (&v)[N], int slot,
                                             int n_slots, long w0, int words, int slot_steps,
                                             int T, int lane, bool y16) {
  const int t0 = slot * slot_steps;
  const int rows = slot < n_slots ? min(slot_steps, T - t0) * words : 0;
  if (N == 4 && words == kChainWords && slot_steps == 4 && T % 4 == 0 && y16) {
    // a full block at large W: lane l's rows are word l's 4 steps, one
    // 16-byte load (with y aligned and T % 4 == 0, so are the rows)
    const float4 q = rows > 0 ? *reinterpret_cast<const float4*>(y + (w0 + lane) * T + t0)
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int r = lane + 32 * j;
    const int c = r / words;
    v[j] = r < rows ? y[(w0 + r - c * words) * T + t0 + c] : 0.0f;
  }
}

template <int S>
struct Smem {
  float ring[kStages * kSlotRows * kStride<S>()];
  float mean[kChainWords * kStride<S>()];
  RingBarriers bar;
};

template <int S>
__global__ void __launch_bounds__(kThreads)
va_detect_kernel(const float* __restrict__ y, const float* __restrict__ mu,
                 float* __restrict__ out, int W, int T, int words_per_block, int slot_steps,
                 bool y16) {
  constexpr int kRow = kStride<S>();
  __shared__ __align__(16) Smem<S> sm;
  const int tid = threadIdx.x;
  const long w0 = static_cast<long>(blockIdx.x) * words_per_block;
  const int words = static_cast<int>(min(static_cast<long>(words_per_block), W - w0));
  for (int i = tid; i < words * S; i += kThreads)
    sm.mean[(i / S) * kRow + i % S] = mu[w0 * S + i];
  if (tid == 0) ring_init(sm.bar, 32, 32);
  __syncthreads();

  if (tid < 32) {
    run_chains<S>(sm.ring, sm.bar, 0, words, slot_steps, T, store_width(T, slot_steps),
                  out + (w0 + tid) * T);
    return;
  }
  // the producer warp: lane l takes rows l, l + 32, ... of each slot, and
  // loads its samples of the next slot before computing this one's priors
  constexpr int kRowsPerLane = kSlotRows / 32;
  const int lane = tid - 32;
  const int n_slots = (T + slot_steps - 1) / slot_steps;
  // with words dividing 32 a lane's rows all belong to word lane % words
  const bool one_word = 32 % words == 0;
  float mean[S];
  load_row<S>(sm.mean + (lane % words) * kRow, mean);
  float ycur[kRowsPerLane], ynext[kRowsPerLane];
  load_samples<kRowsPerLane>(y, ycur, 0, n_slots, w0, words, slot_steps, T, lane, y16);
  for (int slot = 0; slot < n_slots; ++slot) {
    load_samples<kRowsPerLane>(y, ynext, slot + 1, n_slots, w0, words, slot_steps, T, lane, y16);
    ring_acquire(sm.bar, slot);
    const int rows = min(slot_steps, T - slot * slot_steps) * words;
    float* dst = sm.ring + (slot % kStages) * kSlotRows * kRow;
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) {
      const int r = lane + 32 * j;
      if (r >= rows) break;
      if (!one_word) load_row<S>(sm.mean + (r % words) * kRow, mean);
      float p[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float d = __fsub_rn(ycur[j], mean[s]);
        p[s] = __fsub_rn(__fmul_rn(__fmul_rn(d, d), 0.5f), kLogSqrt2Pi);
      }
      float* row = dst + r * kRow;
      if constexpr (S == 2) {
        *reinterpret_cast<float2*>(row) = make_float2(p[0], p[1]);
      } else {
#pragma unroll
        for (int s = 0; s < S; s += 4)
          *reinterpret_cast<float4*>(row + s) = make_float4(p[s], p[s + 1], p[s + 2], p[s + 3]);
      }
    }
    mbar_arrive(&sm.bar.full[slot % kStages]);
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) ycur[j] = ynext[j];
  }
}

template <int S>
void launch(const float* y, const float* mu, float* out, int W, int T, int words_per_block,
            int slot_steps, cudaStream_t stream) {
  const int blocks = (W + words_per_block - 1) / words_per_block;
  // y may be a view at any float offset; out is the wrapper's own tensor
  const bool y16 = reinterpret_cast<uintptr_t>(y) % 16 == 0;
  va_detect_kernel<S><<<blocks, kThreads, 0, stream>>>(y, mu, out, W, T, words_per_block,
                                                        slot_steps, y16);
}

}  // namespace

// y [W, T], mu [W, S], out [W, T]: f32, contiguous, on the current device.
// A block runs words_per_block words (1..32) through slots of slot_steps
// steps (words_per_block * slot_steps <= 128); kernels/acs.py::chain_geometry
// picks both. Returns the CUDA error of the launch (0 on success).
extern "C" int va_detect(const float* y, const float* mu, float* out, int W, int T, int S,
                         int words_per_block, int slot_steps, cudaStream_t stream) {
  if (words_per_block < 1 || words_per_block > kChainWords || slot_steps < 1 ||
      words_per_block * slot_steps > kSlotRows)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (S) {
    case 2: launch<2>(y, mu, out, W, T, words_per_block, slot_steps, stream); break;
    case 4: launch<4>(y, mu, out, W, T, words_per_block, slot_steps, stream); break;
    case 8: launch<8>(y, mu, out, W, T, words_per_block, slot_steps, stream); break;
    case 16: launch<16>(y, mu, out, W, T, words_per_block, slot_steps, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
