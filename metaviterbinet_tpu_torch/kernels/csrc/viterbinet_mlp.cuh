// The per-symbol ViterbiNet branch metric shared by the detect kernels
// (viterbinet_detect.cu, viterbinet_detect_chunked.cu), so that one
// symbol's priors are bit-identical in both. Per symbol:
//   h1 = sigmoid(w1 * y + b1)            [100], f32
//   h2 = relu(W2 . bf16(h1) + b2)        [50],  bf16 operands, f32 sums
//   logits = W3 . bf16(h2) + b3          [S],   bf16 operands, f32 sums
//   prior = -logits.
// The products have bf16 operands, as in the TPU kernel; they run as f32
// FMAs on the CUDA cores (a bf16 x bf16 product is exact in f32, so an FMA
// rounds exactly like a multiply then an add). Every other add and multiply
// is an explicit _rn intrinsic, so nvcc contracts nothing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int kH1 = 100;
constexpr int kH2 = 50;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The network in shared memory: W2 and W3 bf16-rounded and transposed to
// [in][out], so that the threads of a warp read one broadcast row. The
// struct is 16-byte aligned with the matrices first, so that rows of W2
// load as 16-byte vectors: a float-aligned layout with the vectors first
// compiled to narrower loads and a slower K1 with the same bits (see
// PERF.md).
template <int S>
struct alignas(16) MlpWeights {
  float w2t[kH1][kH2];
  float w3t[kH2][S];
  float w1[kH1], b1[kH1], b2[kH2], b3[S];
};

// w1 [100] (the [100, 1] weight), b1 [100], w2 [50, 100], b2 [50],
// w3 [S, 50], b3 [S]; every thread of the block calls it, and the caller
// synchronises before the first read.
template <int S>
__device__ __forceinline__ void load_mlp(MlpWeights<S>& s, const float* __restrict__ w1,
                                         const float* __restrict__ b1,
                                         const float* __restrict__ w2,
                                         const float* __restrict__ b2,
                                         const float* __restrict__ w3,
                                         const float* __restrict__ b3, int tid, int n_threads) {
  for (int i = tid; i < kH1; i += n_threads) {
    s.w1[i] = w1[i];
    s.b1[i] = b1[i];
  }
  for (int i = tid; i < kH2; i += n_threads) s.b2[i] = b2[i];
  for (int i = tid; i < S; i += n_threads) s.b3[i] = b3[i];
  for (int i = tid; i < kH1 * kH2; i += n_threads) {
    const int j = i / kH1, k = i % kH1;  // w2 is [H2, H1]
    s.w2t[k][j] = bf16_round(w2[i]);
  }
  for (int i = tid; i < kH2 * S; i += n_threads) {
    const int st = i / kH2, j = i % kH2;  // w3 is [S, H2]
    s.w3t[j][st] = bf16_round(w3[i]);
  }
}

// The S priors of one received sample yv, written to prior[0..S).
template <int S>
__device__ __forceinline__ void symbol_prior(const MlpWeights<S>& s, float yv, float* prior) {
  float h2[kH2];
#pragma unroll
  for (int j = 0; j < kH2; ++j) h2[j] = 0.0f;
#pragma unroll 2
  for (int k = 0; k < kH1; ++k) {
    const float a = __fadd_rn(__fmul_rn(s.w1[k], yv), s.b1[k]);
    const float h1 = bf16_round(1.0f / (1.0f + expf(-a)));
#pragma unroll
    for (int j = 0; j < kH2; ++j) h2[j] = fmaf(s.w2t[k][j], h1, h2[j]);
  }
#pragma unroll
  for (int j = 0; j < kH2; ++j) h2[j] = bf16_round(fmaxf(__fadd_rn(h2[j], s.b2[j]), 0.0f));
#pragma unroll
  for (int st = 0; st < S; ++st) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kH2; ++j) acc = fmaf(s.w3t[j][st], h2[j], acc);
    prior[st] = -__fadd_rn(acc, s.b3[st]);
  }
}
