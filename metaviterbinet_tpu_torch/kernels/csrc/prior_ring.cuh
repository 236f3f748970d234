// A prior producer and a chain consumer in one block, shared by K1
// (viterbinet_detect.cu), K2 (va_detect.cu) and K4
// (viterbinet_detect_chunked.cu).
//
// Each kernel computes a branch metric per (chain, step) symbol that does
// not depend on the ACS chain, then runs one dependent chain per word (K1,
// K2) or per overlap-save time chunk of a word (K4). On an H100 the chain's
// latency is the floor at small W (K5, which runs the same chain over priors
// staged in shared memory, takes ~0.08 us per step), so the metric is moved
// off the chain: producer warps compute the priors of the next slot of
// symbols into a ring of kStages slots in shared memory while the block's
// chain warp runs the ACS over the slot that has arrived.
//
// A slot holds `slot_steps` steps of the block's `lanes` chains (at most
// kSlotRows symbols; K4's slots 192), row c * lanes + l for step c of chain
// l, each row kStride<S>() floats (S priors, padded for S >= 8 so that the
// chain lanes' 16-byte loads of neighbouring rows fall in different
// banks). Hand-off:
// full[s] completes when every producer thread has arrived after writing
// slot s, empty[s] when every chain lane has arrived after reading it; the
// producer waits on empty[s] before refilling it. mbarriers, not
// __syncthreads, so the chain waits only for the slot it needs.
//
// The chain loop (run_chains) takes per launch the ring slot of a chain
// set's first slot (first: K4's blocks run several sets one after another
// through the same ring; 0 for K1 and K2), the steps of a chain (n_steps),
// the store width (1 or 4 floats) and, for K4 (kChunked), the warm-up:
// slots of steps whose bits are dropped, holding only the chains that warm
// up, before the stored steps. K1 and K2 are the case of no warm-up and one
// set. Each lane of a full block at large W touches its own chain's row of
// the output, 32 rows per warp instruction; such an instruction costs the
// SM's memory pipeline about as much as 32 coalesced ones, so the bits
// leave in 16-byte stores of 4 steps where every lane's row is 16-byte
// aligned (store_width; this halved K2's time at 65536 words on an H100,
// PERF.md). K4's rows at T = 136 and 4 chunks start 8-byte aligned and take
// 4-byte stores: 8-byte ones were no faster (PERF.md).
//
// The launch geometry (chains per block or set, steps per slot) is computed
// by the wrappers (kernels/acs.py::chain_geometry, ::chunked_geometry) from
// W and the SM count.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "acs.cuh"

constexpr int kStages = 3;       // slots in the ring
constexpr int kChainWords = 32;  // chains of a block at most: one chain warp
constexpr int kSlotRows = 128;   // symbols of a slot at most: slot_steps * chains

template <int S>
__host__ __device__ constexpr int kStride() {
  return S >= 8 ? S + 4 : S;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// release: this thread's earlier shared-memory accesses are ordered before
// the phase completes
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// acquire: returns once the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

struct RingBarriers {
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// one thread initialises; the caller synchronises the block after
__device__ __forceinline__ void ring_init(RingBarriers& b, unsigned producers,
                                          unsigned consumers) {
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    mbar_init(&b.full[s], producers);
    mbar_init(&b.empty[s], consumers);
  }
}

// producer side: wait until slot `slot % kStages` may be written
__device__ __forceinline__ void ring_acquire(RingBarriers& b, int slot) {
  if (slot >= kStages) mbar_wait(&b.empty[slot % kStages], ((slot / kStages) - 1) & 1);
}

template <int S>
__device__ __forceinline__ void load_row(const float* __restrict__ src, float (&p)[S]) {
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

// The bits' store width in floats: 4 where a and b are multiples of 4, so
// that with a lane's bits starting 16-byte aligned plus a multiple of 4
// floats and a slot's steps a multiple of 4, every 16-byte store is
// aligned; else 1.
__host__ __device__ constexpr int store_width(int a, int b) {
  return (a | b) % 4 == 0 ? 4 : 1;
}

template <int V>
__device__ __forceinline__ void store_bits(float* __restrict__ dst, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *dst = v[0];
  }
}

// Steps t0 + c .. t0 + c + V - 1 of one chain from slot rows c .. c + V - 1
// (`stride` floats apart); their bits go to bits[t0 + c] .. (none without
// kStore: warm-up steps)
template <int S, int V, bool kStore = true>
__device__ __forceinline__ void chain_steps(float (&m)[S], const float* row, int stride, int t0,
                                            int c, float* __restrict__ bits) {
  float v[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float p[S];
    load_row<S>(row + (c + i) * stride, p);
    v[i] = acs_step<S>(m, p);
  }
  if constexpr (kStore) store_bits<V>(bits + t0 + c, v);
}

// the `steps` steps of one chain in a slot, V at a time
template <int S, int V, bool kStore = true>
__device__ __forceinline__ void chain_slot(float (&m)[S], const float* row, int stride, int t0,
                                           int steps, float* __restrict__ bits) {
  if constexpr (V == 1) {
#pragma unroll 4
    for (int c = 0; c < steps; ++c) chain_steps<S, 1, kStore>(m, row, stride, t0, c, bits);
  } else {
    for (int c = 0; c < steps; c += V) chain_steps<S, V, kStore>(m, row, stride, t0, c, bits);
  }
}

// K4's warm-up (viterbinet_detect_chunked.cu): before its stored steps a
// chain runs `steps` steps whose bits are dropped, in `slots` ring slots
// of up to slot_steps steps of `lanes` chains each (the chains that warm
// up: row c * lanes + l for step c of lane l); `run`: this lane warms up.
struct WarmUp {
  int slots = 0, slot_steps = 1, steps = 0, lanes = 0;
  bool run = false;
};

// The chain warp: lane l < lanes runs its chain with its S metrics in
// registers from 0, over ring slots first, first + 1, ... in order (first:
// the slots the chain warp took before, for a block that runs several sets
// of chains). kChunked (K4): first the warm-up's slots, whose bits are
// dropped. Then n_steps steps whose bit of step t goes to bits[t] (bits:
// this lane's output, 16-byte aligned plus a multiple of `width` floats;
// width = store_width of slot_steps and the row offsets), 4 or 1 at a
// time. A slot holds kRows symbols at most (K4's are larger than K1's and
// K2's). Every lane takes part in the hand-off, live or not.
template <int S, bool kChunked = false, int kRows = kSlotRows>
__device__ __forceinline__ void run_chains(const float* ring, RingBarriers& b, int first,
                                           int lanes, int slot_steps, int n_steps, int width,
                                           float* __restrict__ bits, const WarmUp& warm = {}) {
  constexpr int kRow = kStride<S>();
  const int lane = threadIdx.x % 32;
  const bool live = lane < lanes;
  float m[S];
#pragma unroll
  for (int s = 0; s < S; ++s) m[s] = 0.0f;
  if constexpr (kChunked) {
    for (int slot = 0; slot < warm.slots; ++slot) {
      const int k = first + slot;
      const int st = k % kStages;
      mbar_wait(&b.full[st], (k / kStages) & 1);
      if (warm.run) {
        const int t0 = slot * warm.slot_steps;
        chain_slot<S, 1, false>(m, ring + st * kRows * kRow + lane * kRow, warm.lanes * kRow, t0,
                                min(warm.slot_steps, warm.steps - t0), bits);
      }
      mbar_arrive(&b.empty[st]);
    }
    first += warm.slots;
  }
  const int n_slots = (n_steps + slot_steps - 1) / slot_steps;
  for (int slot = 0; slot < n_slots; ++slot) {
    const int k = first + slot;
    const int st = k % kStages;
    mbar_wait(&b.full[st], (k / kStages) & 1);
    if (live) {
      const int t0 = slot * slot_steps;
      const int steps = min(slot_steps, n_steps - t0);
      const float* row = ring + st * kRows * kRow + lane * kRow;
      const int stride = lanes * kRow;
      if (width == 4) {
        chain_slot<S, 4>(m, row, stride, t0, steps, bits);
      } else {
        chain_slot<S, 1>(m, row, stride, t0, steps, bits);
      }
    }
    mbar_arrive(&b.empty[st]);
  }
}
