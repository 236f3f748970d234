// Time-chunked ViterbiNet detect: K1's MLP + ACS over overlap-save chunks
// of the time axis, one chain per (word, chunk).
//
// Replaces the Pallas kernel
// metaviterbinet_tpu/kernels/acs.py::fused_viterbinet_detect_chunked
// (_run_detect_kernel -> _detect_kernel with overlap > 0). T splits into C
// chunks of Tc = T / C symbols. Chain j = w * C + c (w-major, as the TPU
// lanes are) decodes chunk c of word w: it first warms up on the last
// `overlap` symbols of chunk c - 1, whose bits it drops, then decodes its Tc
// symbols. The producers read y at the chain's own offsets (no extended
// copy in device memory) and the chain writes only its Tc bits.
//
// Stream-head chains (c == 0) skip their warm-up. The TPU kernel runs it on
// zeroed priors, which keep every path metric at exactly 0.0 (0 + 0, a min
// of zeros, minus 0), and drops its bits; skipping it leaves the same zero
// metrics, so the head chains are bit-exact against it, and their warm-up
// symbols are never computed.
//
// The per-symbol priors come from viterbinet_mlp.cuh's wgmma tile, the code
// K1 runs: a row of a tensor-core product depends only on its own operands,
// so a symbol's priors are bit-identical in both kernels, and the bits then
// equal K1's wherever the trellis forgets its start within `overlap` steps.
//
// What bounds it on an H100: operations, as K1: ~1.2e4 FLOP per symbol,
// W (T + (C - 1) overlap) symbols, against 8 bytes of y and bits per
// symbol; with the products on the tensor cores, the latency of the MLP
// tiles (the 100 sigmoids per symbol on the special-function units, two
// dependent products) more than their throughput. At the protocol's W = 300
// the latency of each set's slots of tiles, of which each producer
// warpgroup runs up to 5 in turn, more than the chains' 66 dependent steps.
// Why it exists: an unchunked chain is T = 136 dependent ACS steps;
// chunking gives C times the chains of overlap + Tc steps each.
// What the design does about it (prior_ring.cuh, as K1 and K2): a block is
// three producer warpgroups and one chain warp. Each warpgroup computes one
// 64-symbol tile of each slot of (step, chain) symbols into a ring in shared
// memory, its samples loaded one slot ahead; the chain warp's lanes, one
// per chain, run the ACS over the slot that has arrived, so the MLP and the
// chains overlap. The chains form sets of ceil(W C / SMs) chains, rounded
// up to whole words (at most 32): 300 words at C = 4 are 100 sets of 12
// chains, one block each. A set's slots are first its warm-up, holding only
// the chains that warm up (no stream-head rows), then its stored steps; at
// 65536 words the 132 blocks, one per SM, take 62 or 63 sets each one after
// another through the same ring, with the weights loaded once. The bits
// leave in 16-byte stores where every chain's row allows it
// (prior_ring.cuh::store_width). Any W, any C dividing T and 1 <= overlap
// <= Tc: the ragged edges are masked. Where C > 32 a set is no whole number
// of words and every chain has a warm-up row, which a stream-head chain
// does not run.
//
// Measured on an H100 80GB HBM3 at 700 W (PERF.md section 6, device ms, a
// CUDA graph of back-to-back calls, scripts/torch_kernel_probe.py --time):
// 0.0142-0.0144 at 300 x 136 with C = 4 and 0.0144-0.0146 with C = 2 (K1
// 0.0157 in the same call; this kernel's first design 0.0266-0.0270), 1.039
// at 65536 x 136 with C = 4 (K1 0.546; first design 2.82). The chain alone
// (K5 over 1200 x 66 priors) takes 0.0086 at 300 x 136, C = 4: the slots'
// tiles, not the chains, bound it there.
#include <cuda_runtime.h>

#include "prior_ring.cuh"
#include "viterbinet_mlp.cuh"

namespace {

// three producer warpgroups, one 64-symbol tile of each slot apiece, so a
// slot holds up to 192 symbols
constexpr int kGroups = 3;
// symbols of a slot at most (kernels/acs.py::K4_SLOT_ROWS)
constexpr int kRows = kGroups * kTileRows;
constexpr int kProducers = 128 * kGroups;   // warps 0 .. 4 kGroups - 1
constexpr int kThreads = kProducers + 32;   // and the chain warp

// The launch and the shape of a chain set's ring slots: `warm_slots` slots
// of up to warm_steps warm-up steps of the set's warming chains, then
// main_slots slots of up to slot_steps stored steps of all its chains.
struct Shape {
  int T, C, Tc, overlap, chains, n_chains;
  int warm_steps, warm_slots, slot_steps, main_slots, n_slots;
};

// Chain set g holds chains j0 = g * chains .. j0 + lanes - 1. Where C <= 32
// the set is whole words (chains is a multiple of C) and its lanes are
// ordered so that the chains that warm up come first: lane l < warming is
// chunk 1 + l % (C - 1) of the set's word l / (C - 1), lane warming + i the
// stream-head chunk 0 of word i. Where C > 32 lane l is chain j0 + l and
// every lane has a warm-up row, which a stream-head chain does not run.
struct SetLanes {
  int lanes, warming;
  long w0;  // the set's first word (C <= 32)
  int j0;
};

// The lanes of a set of `lanes` chains that run a warm-up: all but the
// stream-head chunks where the set is whole words (C <= 32), else all
// (kernels/acs.py::warming_chains sizes the warm-up slots by the same rule).
__host__ __device__ __forceinline__ int warming_lanes(int lanes, int C) {
  return C <= kChainWords ? lanes - lanes / C : lanes;
}

__device__ __forceinline__ SetLanes set_lanes(const Shape& sh, int g) {
  SetLanes s;
  s.j0 = g * sh.chains;
  s.lanes = min(sh.chains, sh.n_chains - s.j0);
  s.w0 = s.j0 / sh.C;
  s.warming = warming_lanes(s.lanes, sh.C);
  return s;
}

// lane l's (word, chunk)
__device__ __forceinline__ void lane_chain(const Shape& sh, const SetLanes& s, int l, long& word,
                                           int& chunk) {
  if (sh.C > kChainWords) {
    word = (s.j0 + l) / sh.C;
    chunk = (s.j0 + l) % sh.C;
  } else if (l < s.warming) {
    word = s.w0 + l / (sh.C - 1);
    chunk = 1 + l % (sh.C - 1);
  } else {
    word = s.w0 + l - s.warming;
    chunk = 0;
  }
}

// Where a producer thread's tile row r of a slot of one mode (warm-up or
// stored steps) of one chain set reads y: step e0 + step of a chain whose
// step e reads y[base + e], e counted from the start of its warm-up;
// `head`: a stream-head chain, whose warm-up row (C > 32) is not read.
struct RowSource {
  long base;
  int step;
  bool head;
};

__device__ __forceinline__ RowSource row_source(const Shape& sh, const SetLanes& s, int r,
                                                int per_step) {
  long word;
  int chunk;
  lane_chain(sh, s, r % per_step, word, chunk);
  return {word * sh.T + chunk * sh.Tc - sh.overlap, r / per_step, chunk == 0};
}

// A producer thread's cursor over its block's ring slots: the chain set
// and slot of the slot it loads next, and the sources of the thread's rows
// ra, rb in that slot's mode of that set, recomputed when either changes
// (twice a set).
struct SlotRows {
  int set = 0, slot = -1;
  int per_step = 0;
  RowSource a, b;
};

// advances rs to the block's next ring slot and loads the samples of rows
// ra, rb there (0 past the slot's live rows, past the block's last set and
// on a stream-head chain's warm-up); returns the slot's live rows
__device__ __forceinline__ int next_slot(const float* __restrict__ y, const Shape& sh,
                                         SlotRows& rs, int my_sets, int ra, int rb, float& ya,
                                         float& yb) {
  if (++rs.slot == sh.n_slots) {
    rs.slot = 0;
    ++rs.set;
  }
  if (rs.set >= my_sets) {
    ya = yb = 0.0f;
    return 0;
  }
  const bool stored = rs.slot >= sh.warm_slots;
  if (rs.slot == 0 || rs.slot == sh.warm_slots) {
    const SetLanes s = set_lanes(sh, blockIdx.x + rs.set * gridDim.x);
    rs.per_step = stored ? s.lanes : s.warming;
    rs.a = row_source(sh, s, ra, rs.per_step);
    rs.b = row_source(sh, s, rb, rs.per_step);
  }
  const int e0 = stored ? sh.overlap + (rs.slot - sh.warm_slots) * sh.slot_steps
                        : rs.slot * sh.warm_steps;
  const int steps = stored ? min(sh.slot_steps, sh.overlap + sh.Tc - e0)
                           : min(sh.warm_steps, sh.overlap - e0);
  const int rows = steps * rs.per_step;
  ya = ra < rows && (stored || !rs.a.head) ? y[rs.a.base + e0 + rs.a.step] : 0.0f;
  yb = rb < rows && (stored || !rs.b.head) ? y[rs.b.base + e0 + rs.b.step] : 0.0f;
  return rows;
}

template <int S>
struct Smem {
  MlpWeights<S> mlp;
  float ring[kStages * kRows * kStride<S>()];
  RingBarriers bar;
};

// The grid's blocks take the chain sets blockIdx.x, blockIdx.x + gridDim.x,
// ... of chains_per_block chains each: one block per SM runs its sets one
// after another through the same ring, with the weights loaded once.
template <int S>
__global__ void __launch_bounds__(kThreads)
viterbinet_detect_chunked_kernel(const float* __restrict__ y, const float* __restrict__ w1,
                                 const float* __restrict__ b1, const float* __restrict__ w2,
                                 const float* __restrict__ b2, const float* __restrict__ w3,
                                 const float* __restrict__ b3, float* __restrict__ out, int W,
                                 int T, int C, int overlap, int chains_per_block, int warm_steps,
                                 int slot_steps) {
  constexpr int kRow = kStride<S>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<S>& sm = *reinterpret_cast<Smem<S>*>(smem_raw);
  const int tid = threadIdx.x;
  Shape sh;
  sh.T = T;
  sh.C = C;
  sh.Tc = T / C;
  sh.overlap = overlap;
  sh.chains = chains_per_block;
  sh.n_chains = W * C;
  sh.warm_steps = warm_steps;
  // C = 1: every chain is a stream head, and none warms up
  sh.warm_slots = C == 1 ? 0 : (overlap + warm_steps - 1) / warm_steps;
  sh.slot_steps = slot_steps;
  sh.main_slots = (sh.Tc + slot_steps - 1) / slot_steps;
  sh.n_slots = sh.warm_slots + sh.main_slots;
  const int n_sets = (sh.n_chains + chains_per_block - 1) / chains_per_block;
  const int my_sets = (n_sets - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int n_k = my_sets * sh.n_slots;  // the block's ring slots
  load_mlp<S, kThreads>(sm.mlp, w1, b1, w2, b2, w3, b3, tid);
  if (tid == 0) ring_init(sm.bar, kProducers, 32);
  __syncthreads();

  if (tid >= kProducers) {
    const int lane = tid - kProducers;
    for (int set = 0; set < my_sets; ++set) {
      const SetLanes s = set_lanes(sh, blockIdx.x + set * gridDim.x);
      long word;
      int chunk;
      lane_chain(sh, s, lane, word, chunk);
      WarmUp warm;
      warm.slots = sh.warm_slots;
      warm.slot_steps = warm_steps;
      warm.steps = overlap;
      warm.lanes = s.warming;
      warm.run = lane < s.lanes && chunk != 0;
      // lane l's bits: chunk `chunk` of word `word`
      run_chains<S, true, kRows>(sm.ring, sm.bar, set * sh.n_slots, s.lanes, slot_steps, sh.Tc,
                                 store_width(sh.Tc, slot_steps), out + word * T + chunk * sh.Tc,
                                 warm);
    }
    return;
  }
  // the producer warpgroups: group g computes tile g of each slot, rows
  // 64 g .. 64 g + 63; this thread owns two of them (see mlp_tile) and loads
  // their samples of the next slot before computing this one's
  const int lane = tid % 32, group = tid / 128;
  const int ra = kTileRows * group + 16 * (tid / 32 % 4) + lane / 4, rb = ra + 8;
  SlotRows rs;
  float ya, yb;
  int rows = next_slot(y, sh, rs, my_sets, ra, rb, ya, yb);
  for (int k = 0; k < n_k; ++k) {
    float na, nb;
    const int next_rows = next_slot(y, sh, rs, my_sets, ra, rb, na, nb);
    ring_acquire(sm.bar, k);
    if (kTileRows * group < rows) {  // uniform over the warpgroup
      float pa[kPriorCols<S>()], pb[kPriorCols<S>()];
      mlp_tile<S>(sm.mlp, ya, yb, pa, pb);
      float* dst = sm.ring + (k % kStages) * kRows * kRow;
#pragma unroll
      for (int j = 0; j < kPriorCols<S>(); j += 2) {
        const int col = prior_col<S>(j, lane);
        if (col >= S) continue;
        if (ra < rows) *reinterpret_cast<float2*>(dst + ra * kRow + col) = make_float2(pa[j], pa[j + 1]);
        if (rb < rows) *reinterpret_cast<float2*>(dst + rb * kRow + col) = make_float2(pb[j], pb[j + 1]);
      }
    }
    mbar_arrive(&sm.bar.full[k % kStages]);
    rows = next_rows;
    ya = na;
    yb = nb;
  }
}

template <int S>
cudaError_t launch(const float* y, const float* w1, const float* b1, const float* w2,
                   const float* b2, const float* w3, const float* b3, float* out, int W, int T,
                   int C, int overlap, int chains_per_block, int warm_steps, int slot_steps,
                   int blocks, cudaStream_t stream) {
  // above the 48 KB a block gets by default (no stream work, so safe while a
  // CUDA graph captures)
  const cudaError_t attr = cudaFuncSetAttribute(viterbinet_detect_chunked_kernel<S>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                sizeof(Smem<S>));
  if (attr != cudaSuccess) return attr;
  viterbinet_detect_chunked_kernel<S><<<blocks, kThreads, sizeof(Smem<S>), stream>>>(
      y, w1, b1, w2, b2, w3, b3, out, W, T, C, overlap, chains_per_block, warm_steps, slot_steps);
  return cudaGetLastError();
}

}  // namespace

// y [W, T]; w1 [100] (the [100, 1] weight), b1 [100], w2 [50, 100], b2 [50],
// w3 [S, 50], b3 [S]; out [W, T], 16-byte aligned: f32, contiguous, on the
// current device. C divides T, 1 <= overlap <= T / C and W * C < 2^31. The
// W C chains form sets of chains_per_block chains (1..32; a multiple of C
// where C <= 32), which `blocks` blocks take in turn. A set warms up
// through slots of warm_steps steps of its warming chains, then decodes
// through slots of slot_steps steps of all its chains (at most 192
// symbols a slot either way), storing 4 bits at a time where 4 divides
// T / C and slot_steps, else 1 (store_width); kernels/acs.py::chunked_geometry
// picks them all. Returns the CUDA error of the launch (0 on success).
extern "C" int viterbinet_detect_chunked(const float* y, const float* w1, const float* b1,
                                         const float* w2, const float* b2, const float* w3,
                                         const float* b3, float* out, int W, int T, int S,
                                         int C, int overlap, int chains_per_block,
                                         int warm_steps, int slot_steps, int blocks,
                                         cudaStream_t stream) {
  const long chains = static_cast<long>(W) * C;
  const bool words = C <= kChainWords;  // sets of whole words
  if (C < 1 || T % C != 0 || overlap < 1 || overlap > T / C || chains >= (1L << 31) ||
      chains_per_block < 1 || chains_per_block > kChainWords ||
      (words && chains_per_block % C != 0) || warm_steps < 1 ||
      warm_steps * warming_lanes(chains_per_block, C) > kRows || slot_steps < 1 ||
      chains_per_block * slot_steps > kRows || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      blocks < 1 || blocks > (chains + chains_per_block - 1) / chains_per_block)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (S) {
    case 2: err = launch<2>(y, w1, b1, w2, b2, w3, b3, out, W, T, C, overlap, chains_per_block, warm_steps, slot_steps, blocks, stream); break;
    case 4: err = launch<4>(y, w1, b1, w2, b2, w3, b3, out, W, T, C, overlap, chains_per_block, warm_steps, slot_steps, blocks, stream); break;
    case 8: err = launch<8>(y, w1, b1, w2, b2, w3, b3, out, W, T, C, overlap, chains_per_block, warm_steps, slot_steps, blocks, stream); break;
    case 16: err = launch<16>(y, w1, b1, w2, b2, w3, b3, out, W, T, C, overlap, chains_per_block, warm_steps, slot_steps, blocks, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
