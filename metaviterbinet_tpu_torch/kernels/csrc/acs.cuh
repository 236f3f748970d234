// Greedy zero-delay add-compare-select step shared by the detect kernels.
//
// Semantics of metaviterbinet_tpu/ops/trellis.py::viterbi_decode: the bit of
// step t is the LSB of the lowest state index holding the minimum metric,
// read BEFORE the ACS stage; the predecessors of state s are (2s) mod S and
// (2s+1) mod S; after each stage the per-word minimum is subtracted. All
// path-metric arithmetic is f32 adds, subtracts and mins, so there is no
// multiply for the compiler to contract and the step is exact against the
// plain PyTorch recursion.
//
// The step writes the same value to states s and s + S/2, so with metrics
// that start equal (every kernel starts them at 0.0) the two halves stay
// equal and the lowest tied minimum always lies in the first half: the
// readout searches S/2 states. Both reductions are trees of depth
// log2(S/2), which shortens the dependent chain from metric to metric. fminf
// is exact, so the order of the minimum changes no bit; the argmin keeps the
// left (lower) operand unless the right one is strictly smaller, which is the
// lowest index among exact ties (renormalisation pins the minimum to 0.0, so
// ties do happen).
//
// Every kernel takes this step. Against a linear readout over all S states
// with a running minimum (the same bits), it took ~23% less time in K2 at
// one word, 8% less at 65536 words and ~17% less in K1 at 300 words on an
// H100 80GB HBM3 at 700 W; the linear readout is 176 FSETP and 297 FSEL in
// K2's S = 16 SASS against the tree's 70 FSETP, 60 FSEL and 75 SEL (PERF.md
// section 6).
#pragma once

#include <cuda_runtime.h>

template <int S>
__device__ __forceinline__ float acs_step(float (&m)[S], const float (&p)[S]) {
  constexpr int H = S / 2;
  // readout: tree argmin over m[0 .. H), each node over a contiguous range of
  // states with its left child the lower one
  float best[H];
  int bit[H];
#pragma unroll
  for (int s = 0; s < H; ++s) {
    best[s] = m[s];
    bit[s] = s & 1;
  }
#pragma unroll
  for (int n = H; n > 1; n >>= 1) {
#pragma unroll
    for (int s = 0; s < n / 2; ++s) {
      const bool right = best[2 * s + 1] < best[2 * s];
      bit[s] = right ? bit[2 * s + 1] : bit[2 * s];
      best[s] = right ? best[2 * s + 1] : best[2 * s];
    }
  }
  // add, then compare-select over each predecessor pair (2s, 2s+1): the new
  // metric of s and of s + S/2 is the same pair minimum
  float pair[H], mn[H];
#pragma unroll
  for (int s = 0; s < H; ++s) {
    pair[s] = fminf(__fadd_rn(m[2 * s], p[2 * s]), __fadd_rn(m[2 * s + 1], p[2 * s + 1]));
    mn[s] = pair[s];
  }
#pragma unroll
  for (int n = H; n > 1; n >>= 1) {
#pragma unroll
    for (int s = 0; s < n / 2; ++s) mn[s] = fminf(mn[2 * s], mn[2 * s + 1]);
  }
#pragma unroll
  for (int s = 0; s < H; ++s) {
    const float v = __fsub_rn(pair[s], mn[0]);
    m[s] = v;
    m[s + H] = v;
  }
  return static_cast<float>(bit[0]);
}
