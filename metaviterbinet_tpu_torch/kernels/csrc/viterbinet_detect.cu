// ViterbiNet detect: the per-symbol 1 -> 100 -> 50 -> S branch-metric MLP
// (viterbinet_mlp.cuh) fused with the greedy zero-delay ACS recursion.
//
// Replaces the Pallas kernel
// metaviterbinet_tpu/kernels/acs.py::fused_viterbinet_detect
// (_run_detect_kernel -> _detect_kernel). Only y is read and only the bits
// are written; no activation or prior reaches device memory.
//
// What bounds it on an H100: operations. ~1.2e4 FLOP per symbol against 8
// bytes of y and bits: the two products on the bf16 tensor cores and, once
// they are there, the 100 sigmoids per symbol on the special-function
// units. At the protocol's W = 300, the latency of each word's 136-step
// chain and of the first slot's tiles as well.
// What the design does about it (prior_ring.cuh, viterbinet_mlp.cuh): a
// block is two producer warpgroups and one chain warp. Each warpgroup
// computes one 64-symbol wgmma tile of the next slot of (step, word)
// symbols into a ring in shared memory, its samples loaded one slot ahead;
// the chain warp's lanes, one per word, run the ACS over the slot that has
// arrived, so the MLP and the chain overlap even with one block on an SM.
// A slot holds up to 128 symbols of the block's words and a warpgroup whose
// tile holds no live symbol skips it, so a partial last slot costs its live
// tiles. A block holds ceil(W / SMs) words (at most 32): W = 300 spreads
// over 100 SMs, W = 65536 fills every chain lane and every tile. Any W and
// T: the ragged edges are masked.
#include <cuda_runtime.h>

#include "prior_ring.cuh"
#include "viterbinet_mlp.cuh"

namespace {

constexpr int kGroups = kSlotRows / kTileRows;  // producer warpgroups: one tile of a slot each
constexpr int kProducers = 128 * kGroups;       // warps 0 .. 4 kGroups - 1
constexpr int kThreads = kProducers + 32;       // and the chain warp

// this thread's samples y0, y1 of tile rows r0, r0 + 8 of slot `slot` (0
// past the end or past the slot's live rows)
__device__ __forceinline__ void tile_samples(const float* __restrict__ y, float& y0, float& y1,
                                             int slot, int n_slots, long w0, int words,
                                             int slot_steps, int T, int r0) {
  const int t0 = slot * slot_steps;
  const int rows = slot < n_slots ? min(slot_steps, T - t0) * words : 0;
  const int c0 = r0 / words, c1 = (r0 + 8) / words;
  y0 = r0 < rows ? y[(w0 + r0 - c0 * words) * T + t0 + c0] : 0.0f;
  y1 = r0 + 8 < rows ? y[(w0 + r0 + 8 - c1 * words) * T + t0 + c1] : 0.0f;
}

template <int S>
struct Smem {
  MlpWeights<S> mlp;
  float ring[kStages * kSlotRows * kStride<S>()];
  RingBarriers bar;
};

template <int S>
__global__ void __launch_bounds__(kThreads)
viterbinet_detect_kernel(const float* __restrict__ y, const float* __restrict__ w1,
                         const float* __restrict__ b1, const float* __restrict__ w2,
                         const float* __restrict__ b2, const float* __restrict__ w3,
                         const float* __restrict__ b3, float* __restrict__ out, int W, int T,
                         int words_per_block, int slot_steps) {
  constexpr int kRow = kStride<S>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<S>& sm = *reinterpret_cast<Smem<S>*>(smem_raw);
  const int tid = threadIdx.x;
  const long w0 = static_cast<long>(blockIdx.x) * words_per_block;
  const int words = static_cast<int>(min(static_cast<long>(words_per_block), W - w0));
  load_mlp<S, kThreads>(sm.mlp, w1, b1, w2, b2, w3, b3, tid);
  if (tid == 0) ring_init(sm.bar, kProducers, 32);
  __syncthreads();

  if (tid >= kProducers) {
    run_chains<S>(sm.ring, sm.bar, 0, words, slot_steps, T, store_width(T, slot_steps),
                  out + (w0 + tid - kProducers) * T);
    return;
  }
  // the producer warpgroups: group g computes tile g of each slot, rows
  // 64 g .. 64 g + 63; this thread owns two of them (see mlp_tile) and loads
  // their samples of the next slot before computing this one's
  const int lane = tid % 32, group = tid / 128;
  const int ra = kTileRows * group + 16 * (tid / 32 % 4) + lane / 4, rb = ra + 8;
  const int n_slots = (T + slot_steps - 1) / slot_steps;
  float ya, yb, na, nb;
  tile_samples(y, ya, yb, 0, n_slots, w0, words, slot_steps, T, ra);
  for (int slot = 0; slot < n_slots; ++slot) {
    tile_samples(y, na, nb, slot + 1, n_slots, w0, words, slot_steps, T, ra);
    ring_acquire(sm.bar, slot);
    const int rows = min(slot_steps, T - slot * slot_steps) * words;
    if (kTileRows * group < rows) {  // uniform over the warpgroup
      float pa[kPriorCols<S>()], pb[kPriorCols<S>()];
      mlp_tile<S>(sm.mlp, ya, yb, pa, pb);
      float* dst = sm.ring + (slot % kStages) * kSlotRows * kRow;
#pragma unroll
      for (int j = 0; j < kPriorCols<S>(); j += 2) {
        const int col = prior_col<S>(j, lane);
        if (col >= S) continue;
        if (ra < rows) *reinterpret_cast<float2*>(dst + ra * kRow + col) = make_float2(pa[j], pa[j + 1]);
        if (rb < rows) *reinterpret_cast<float2*>(dst + rb * kRow + col) = make_float2(pb[j], pb[j + 1]);
      }
    }
    mbar_arrive(&sm.bar.full[slot % kStages]);
    ya = na;
    yb = nb;
  }
}

template <int S>
cudaError_t launch(const float* y, const float* w1, const float* b1, const float* w2,
                   const float* b2, const float* w3, const float* b3, float* out, int W, int T,
                   int words_per_block, int slot_steps, cudaStream_t stream) {
  // above the 48 KB a block gets by default at S = 16 (no stream work, so
  // safe while a CUDA graph captures)
  const cudaError_t attr = cudaFuncSetAttribute(
      viterbinet_detect_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, sizeof(Smem<S>));
  if (attr != cudaSuccess) return attr;
  const int blocks = (W + words_per_block - 1) / words_per_block;
  viterbinet_detect_kernel<S><<<blocks, kThreads, sizeof(Smem<S>), stream>>>(
      y, w1, b1, w2, b2, w3, b3, out, W, T, words_per_block, slot_steps);
  return cudaGetLastError();
}

}  // namespace

// y [W, T]; w1 [100] (the [100, 1] weight), b1 [100], w2 [50, 100], b2 [50],
// w3 [S, 50], b3 [S]; out [W, T]: f32, contiguous, on the current device.
// A block runs words_per_block words (1..32) through slots of slot_steps
// steps (words_per_block * slot_steps <= 128); kernels/acs.py::chain_geometry
// picks both. Returns the CUDA error of the launch (0 on success).
extern "C" int viterbinet_detect(const float* y, const float* w1, const float* b1,
                                 const float* w2, const float* b2, const float* w3,
                                 const float* b3, float* out, int W, int T, int S,
                                 int words_per_block, int slot_steps, cudaStream_t stream) {
  if (words_per_block < 1 || words_per_block > kChainWords || slot_steps < 1 ||
      words_per_block * slot_steps > kSlotRows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (S) {
    case 2: err = launch<2>(y, w1, b1, w2, b2, w3, b3, out, W, T, words_per_block, slot_steps, stream); break;
    case 4: err = launch<4>(y, w1, b1, w2, b2, w3, b3, out, W, T, words_per_block, slot_steps, stream); break;
    case 8: err = launch<8>(y, w1, b1, w2, b2, w3, b3, out, W, T, words_per_block, slot_steps, stream); break;
    case 16: err = launch<16>(y, w1, b1, w2, b2, w3, b3, out, W, T, words_per_block, slot_steps, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

namespace {

template <int S>
__global__ void __launch_bounds__(128)
tile_priors_kernel(const float* __restrict__ y, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, const float* __restrict__ w3,
                   const float* __restrict__ b3, float* __restrict__ priors) {
  __shared__ MlpWeights<S> mlp;
  const int tid = threadIdx.x, lane = tid % 32;
  load_mlp<S, 128>(mlp, w1, b1, w2, b2, w3, b3, tid);
  __syncthreads();
  const int ra = 16 * (tid / 32) + lane / 4, rb = ra + 8;
  float pa[kPriorCols<S>()], pb[kPriorCols<S>()];
  mlp_tile<S>(mlp, y[ra], y[rb], pa, pb);
#pragma unroll
  for (int j = 0; j < kPriorCols<S>(); ++j) {
    const int col = prior_col<S>(j, lane);
    if (col >= S) continue;
    priors[ra * S + col] = pa[j];
    priors[rb * S + col] = pb[j];
  }
}

}  // namespace

// One wgmma tile of priors, the code K1 and K4 run: y [64] -> priors
// [64, S] (the network as for viterbinet_detect), so that the card tests
// can hold the tensor-core products against the plain version's priors.
extern "C" int viterbinet_tile_priors(const float* y, const float* w1, const float* b1,
                                      const float* w2, const float* b2, const float* w3,
                                      const float* b3, float* priors, int S,
                                      cudaStream_t stream) {
  switch (S) {
    case 2: tile_priors_kernel<2><<<1, 128, 0, stream>>>(y, w1, b1, w2, b2, w3, b3, priors); break;
    case 4: tile_priors_kernel<4><<<1, 128, 0, stream>>>(y, w1, b1, w2, b2, w3, b3, priors); break;
    case 8: tile_priors_kernel<8><<<1, 128, 0, stream>>>(y, w1, b1, w2, b2, w3, b3, priors); break;
    case 16: tile_priors_kernel<16><<<1, 128, 0, stream>>>(y, w1, b1, w2, b2, w3, b3, priors); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
