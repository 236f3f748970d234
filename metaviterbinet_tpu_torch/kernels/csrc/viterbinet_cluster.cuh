// The cluster layout of ViterbiNet's 1-100-50-S parameters, shared by K6
// (online_adapt.cu) and K7 (maml_pairs.cu): one launch of a thread-block
// cluster of kCluster CTAs, each holding full copies of the parameters in
// its shared memory, flat and back to back in the order of Layout<S>, and
// CTA r owning the r-th slice of kSlice<S> of them (whole float4 quads),
// which it reduces over the cluster and updates. The Python side of the
// same layout is kernels/online_sgd.py (CLUSTER_SIZE, MAX_SMEM_BYTES,
// n_params, align4).
//
// Each kernel's own shared-memory offsets (Smem), phases and arithmetic
// stay in its source. The names are in an anonymous namespace, as each
// source's own are: each source is a library of its own.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kH1 = 100;
constexpr int kH2 = 50;
constexpr int kLd2 = 52;             // row stride of the [t][50] activations (16-byte rows)
constexpr int kThreads = 256;
constexpr int kCluster = 16;         // CTAs of the cluster (kernels/online_sgd.py::CLUSTER_SIZE)
constexpr int kHalf = kH2 / 2;       // a thread's rows of a 50 x 100 product: j and j + 25
constexpr int kQuads = kH1 / 4;      // float4 groups along the 100 hidden units
constexpr int kGradRows = 5;         // a weight gradient's tile (dz2 h1^T): 5 rows x 4 columns
constexpr int kGradTiles = (kH2 / kGradRows) * kQuads;
constexpr int kMaxSmemBytes = 232448;  // what one CTA may use on an H100

// the six tensors in the order w1 [100] (the [100, 1] weight), b1 [100],
// w2 [50, 100], b2 [50], w3 [S, 50], b3 [S]; in shared memory they lie back
// to back in that order
struct Tensors {
  float* t[6];
};

template <int S>
struct Layout {
  static constexpr int kW1 = 0;
  static constexpr int kB1 = kW1 + kH1;
  static constexpr int kW2 = kB1 + kH1;
  static constexpr int kB2 = kW2 + kH2 * kH1;
  static constexpr int kW3 = kB2 + kH2;
  static constexpr int kB3 = kW3 + S * kH2;
  static constexpr int kCount = kB3 + S;
  static constexpr int kPadded = (kCount + 3) & ~3;  // each flat copy ends in zeros up to here
  static constexpr int kLdl = S + 1;  // row stride of the [t][S] logits (K7: slot S holds a CE)
};

// the flat parameter index i inside the six tensors
template <int S>
__device__ __forceinline__ float* element(const Tensors& ts, int i) {
  using L = Layout<S>;
  if (i < L::kB1) return ts.t[0] + i;
  if (i < L::kW2) return ts.t[1] + (i - L::kB1);
  if (i < L::kB2) return ts.t[2] + (i - L::kW2);
  if (i < L::kW3) return ts.t[3] + (i - L::kB2);
  if (i < L::kB3) return ts.t[4] + (i - L::kW3);
  return ts.t[5] + (i - L::kB3);
}

__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }

// the parameters owned by each CTA of the cluster: a slice of kSlice (a
// multiple of 4, so that slices are whole float4 quads)
template <int S>
constexpr int kSlice = align4((Layout<S>::kPadded + kCluster - 1) / kCluster);

// length of rank r's slice (the last one is shorter)
template <int S>
__device__ __forceinline__ int slice_len(int r) {
  return min(kSlice<S>, Layout<S>::kPadded - r * kSlice<S>);
}

__device__ __forceinline__ void fma4(float& acc, const float4& a, const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void fma4(float4& acc, const float4& a, float b) {
  acc.x = fmaf(a.x, b, acc.x);
  acc.y = fmaf(a.y, b, acc.y);
  acc.z = fmaf(a.z, b, acc.z);
  acc.w = fmaf(a.w, b, acc.w);
}

}  // namespace
