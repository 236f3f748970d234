// A prior producer and a chain consumer in one block, shared by K1
// (viterbinet_detect.cu) and K2 (va_detect.cu).
//
// Both kernels compute a branch metric per (word, step) symbol that does not
// depend on the ACS chain, then run one T-step dependent chain per word. On
// an H100 the chain's latency is the floor at small W (K5, which runs the
// same chain over priors staged in shared memory, takes ~0.08 us per step),
// so the metric is moved off the chain: producer warps compute the priors of
// the next slot of symbols into a ring of kStages slots in shared memory
// while the block's chain warp runs the ACS over the slot that has arrived.
//
// A slot holds `slot_steps` steps of the block's `words` words (at most
// kSlotRows symbols), row c * words + w for step c of word w, each row
// kStride<S>() floats (S priors, padded for S >= 8 so that the chain lanes'
// 16-byte loads of neighbouring rows fall in different banks). Hand-off:
// full[s] completes when every producer thread has arrived after writing
// slot s, empty[s] when every chain lane has arrived after reading it; the
// producer waits on empty[s] before refilling it. mbarriers, not
// __syncthreads, so the chain waits only for the slot it needs.
//
// Each lane of a full block at large W touches its own word's row of the
// output, 32 rows per warp instruction; such an instruction costs the SM's
// memory pipeline about as much as 32 coalesced ones, so where the rows are
// 16-byte aligned (T % 4 == 0) the bits leave in 16-byte stores, one per 4
// steps (on an H100 this halved K2's time at 65536 words, PERF.md).
//
// The launch geometry (words per block, steps per slot) is computed by the
// wrapper (kernels/acs.py::chain_geometry) from W and the SM count.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "acs.cuh"

constexpr int kStages = 3;       // slots in the ring
constexpr int kChainWords = 32;  // words of a block at most: one chain warp
constexpr int kSlotRows = 128;   // symbols of a slot at most: slot_steps * words

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

// The chain warp: lane w < words runs word w's ACS with its S metrics in
// registers over every slot of the ring in order, and writes its bit of
// each step to bits[t] (bits = out + (w0 + w) * T, 16-byte aligned where T
// is a multiple of 4, as the wrapper's output is). Every lane takes part in
// the hand-off, live or not.
template <int S>
__device__ __forceinline__ void run_chains(const float* ring, RingBarriers& b, int words,
                                           int slot_steps, int T, float* __restrict__ bits) {
  constexpr int kRow = kStride<S>();
  const int lane = threadIdx.x % 32;
  const bool live = lane < words;
  float m[S];
#pragma unroll
  for (int s = 0; s < S; ++s) m[s] = 0.0f;
  const int n_slots = (T + slot_steps - 1) / slot_steps;
  // every word's row and every slot start at a multiple of 4 steps
  const bool vec4 = T % 4 == 0 && slot_steps % 4 == 0;
  for (int slot = 0; slot < n_slots; ++slot) {
    const int st = slot % kStages;
    mbar_wait(&b.full[st], (slot / kStages) & 1);
    if (live) {
      const int t0 = slot * slot_steps;
      const int steps = min(slot_steps, T - t0);
      const float* row = ring + st * kSlotRows * kRow + lane * kRow;
      const int stride = words * kRow;
      if (vec4) {  // a store of 16 bytes per 4 steps
        for (int c = 0; c < steps; c += 4) {
          float four[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float p[S];
            load_row<S>(row + (c + i) * stride, p);
            four[i] = acs_step<S>(m, p);
          }
          *reinterpret_cast<float4*>(bits + t0 + c) = make_float4(four[0], four[1], four[2], four[3]);
        }
      } else {
#pragma unroll 4
        for (int c = 0; c < steps; ++c) {
          float p[S];
          load_row<S>(row + c * stride, p);
          bits[t0 + c] = acs_step<S>(m, p);
        }
      }
    }
    mbar_arrive(&b.empty[st]);
  }
}
