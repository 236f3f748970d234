// Fused online adaptation of ViterbiNet: n Adam steps of cross-entropy over
// the trellis states of one word, in one launch of a thread-block cluster.
//
// Replaces the Pallas kernel
// metaviterbinet_tpu/kernels/online_sgd.py::online_adapt_viterbinet
// (_make_kernel). Per step, over the word's T symbols:
//   h1 = sigmoid(w1 y + b1) [100, T], h2 = relu(W2 h1 + b2) [50, T],
//   logits = W3 h2 + b3 [S, T], dlogits = (softmax(logits) - onehot) / T,
//   the hand-written backward through relu and sigmoid, and the Adam update
//   of all 5250 + 51 S parameters with the bias correction taken from the
//   running powers b1^t and b2^t, as the TPU kernel carries them.
// Everything is f32: no TF32, no bf16 (the TPU kernel's products run at
// HIGHEST precision), so no tensor cores (wgmma has no f32 path).
//
// What bounds it on an H100: operations, about 36,300 T f32 operations per
// step for the products, softmax and backward, plus ~14 per parameter for
// Adam: 0.01501 ms for 200 steps at T = 136 at the card's f32 rate. The
// steps are sequential and one step's work is small (0.66 M FMAs per large
// product at T = 136), so the kernel runs on one cluster of kCluster = 16
// CTAs (the largest an H100 allows, non-portable), and its share of the
// bound is 132 / 16 times the card's: 0.124 ms (0.248 ms for the portable 8,
// which measured slower, PERF.md). A first version ran the loop in one
// 1024-thread block (1/132 of the card) with one output per thread and two
// shared-memory reads per FMA: 19.14 ms, 9.7x its one-SM share.
// What the design does about it:
//   - the word's T columns are split across the cluster, ceil(T / 16) per CTA
//     (a CTA past the end has none and contributes zero gradients). Each CTA
//     holds a full copy of the parameters in shared memory, and its own
//     columns of y, the labels, h1, h2, the logits and dz2; the forward, the
//     softmax and the backward to dz1 are column-local;
//   - the weight gradients are column sums: each CTA writes its partial
//     gradient of all parameters into its shared memory. After a cluster
//     barrier, CTA r owns the r-th 1/16 slice of the parameters (one float4
//     quad per thread): it reads that slice's 16 partials over distributed
//     shared memory and sums them in rank order 0..15 (deterministic: no
//     atomics), applies Adam with the quad's moments held in registers
//     across all n steps, and writes the new values into its own copy. After
//     a second cluster barrier every CTA reads the other slices from their
//     owners' copies. Each step thus has two cluster barriers and only
//     remote loads: remote stores (a barrier's release waits for them), bulk
//     copies between the CTAs' shared memories and a multicast from global
//     memory all measured slower (PERF.md);
//   - the three large products (W2 h1, dz2 h1^T, W2^T dz2) are register
//     tiled: each thread computes a 2x2, 5x4 or 2x4 tile and reads its
//     operands as float4 along the contracted or the output dimension, with
//     activations stored column by column (feature index fastest); the
//     logits and the softmax run on S lanes per column, with shuffles;
//   - parameters, gradients and activations stay in shared memory for all n
//     steps; y, the labels, the parameters and the moments are read once and
//     written once.
//
// Rounding: the products are f32 FMAs and sum in another order than the
// plain version; nvcc also contracts a*b+c. The sigmoid's, the softmax's and
// Adam's divisions are __fdividef and Adam's square root is sqrt.approx
// (within 2 ulp): IEEE division and square root take a slow path on some
// values, which made the owners' phase several times slower. The result is
// held to a tolerance, not bit for bit. Two launches on the same inputs
// give the same bits.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "viterbinet_cluster.cuh"

namespace cg = cooperative_groups;

namespace {

// offsets, in floats, of one CTA's shared memory with `cols` columns; every
// CTA of the cluster has the same layout, so a peer's parameters and partial
// gradient are at the same offsets (kernels/online_sgd.py::smem_bytes
// computes the same total)
template <int S>
struct Smem {
  int g, y, label, h1, h2, dz2, lg, total;  // the parameters are at 0
  __host__ __device__ constexpr explicit Smem(int cols)
      : g(Layout<S>::kPadded),
        y(2 * Layout<S>::kPadded),
        label(y + align4(cols)),
        h1(label + align4(cols)),
        h2(h1 + cols * kH1),
        dz2(h2 + cols * kLd2),
        lg(dz2 + cols * kLd2),
        total(lg + cols * Layout<S>::kLdl) {}
};

// f32 square root without the IEEE slow paths (relative error <= 2^-23)
__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

template <int S>
__global__ void __launch_bounds__(kThreads, 1)
online_adapt_kernel(const float* __restrict__ y, const int* __restrict__ states, Tensors params,
                    Tensors mu, Tensors nu, int T, int n_iters, float lr, float b1, float b2,
                    float omb1, float omb2, float eps, float inv_t,
                    const float* __restrict__ powers) {
  using L = Layout<S>;
  constexpr int kLdl = L::kLdl;
  // this CTA's slice of the parameters for the reduction and Adam, in
  // float4 quads: each thread owns at most one quad
  constexpr int kSl = kSlice<S>;
  static_assert(kSl / 4 <= kThreads, "one quad per thread");

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cols = (T + kCluster - 1) / kCluster;
  const int t0 = rank * cols;
  const int tl = max(0, min(cols, T - t0));  // this CTA's columns
  const int pairs = (tl + 1) / 2;

  extern __shared__ __align__(16) float smem[];
  const Smem<S> at(cols);
  float* P = smem;                                      // parameters, flat
  float* G = smem + at.g;                               // partial gradient, flat
  float* Y = smem + at.y;                               // [tl]
  int* label = reinterpret_cast<int*>(smem + at.label); // [tl]
  float* H1 = smem + at.h1;                             // [tl][100] h1, then dz1
  float* H2 = smem + at.h2;                             // [tl][52] relu(z2)
  float* DZ2 = smem + at.dz2;                           // [tl][52]
  float* LG = smem + at.lg;                             // [tl][S + 1] logits, then dlogits
  const float* W1 = P + L::kW1;
  const float* B1 = P + L::kB1;
  const float* W2 = P + L::kW2;
  const float* B2 = P + L::kB2;
  const float* W3 = P + L::kW3;
  const float* B3 = P + L::kB3;
  const int tid = threadIdx.x;
  const int lo = rank * kSl, len = slice_len<S>(rank);
  const bool owner = 4 * tid < len;
  const int quad = lo + 4 * tid;  // first parameter of this thread's quad

  float m[4] = {}, v[4] = {};
  if (owner) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (quad + c < L::kCount) {
        m[c] = *element<S>(mu, quad + c);
        v[c] = *element<S>(nu, quad + c);
      }
    }
  }
  for (int i = tid; i < L::kPadded; i += kThreads) {
    P[i] = i < L::kCount ? *element<S>(params, i) : 0.0f;
    G[i] = 0.0f;  // (the pad stays 0: no phase writes it)
  }
  for (int t = tid; t < tl; t += kThreads) {
    Y[t] = y[t0 + t];
    label[t] = states[t0 + t];
  }
  __syncthreads();

  // b1^count and b2^count before the first step, from device memory (the
  // wrapper gathers them at the optimizer's count, which lives on the card)
  float pow1 = powers[0], pow2 = powers[1];
  for (int it = 0; it < n_iters; ++it) {
    pow1 *= b1;
    pow2 *= b2;
    // Adam's bias corrections as reciprocals, once per step
    const float ic1 = 1.0f / (1.0f - pow1), ic2 = 1.0f / (1.0f - pow2);

    // ---- forward: h1 ----
#pragma unroll 4
    for (int i = tid; i < tl * kH1; i += kThreads) {
      const int t = i / kH1, k = i - t * kH1;
      H1[i] = __fdividef(1.0f, 1.0f + expf(-(W1[k] * Y[t] + B1[k])));
    }
    __syncthreads();

    // ---- h2 = relu(W2 h1 + b2): 2 rows x 2 columns per thread ----
    for (int i = tid; i < pairs * kHalf; i += kThreads) {
      const int j = i % kHalf, t = 2 * (i / kHalf);
      const bool two = t + 1 < tl;
      const float4* wa = reinterpret_cast<const float4*>(W2 + j * kH1);
      const float4* wb = reinterpret_cast<const float4*>(W2 + (j + kHalf) * kH1);
      const float4* ha = reinterpret_cast<const float4*>(H1 + t * kH1);
      const float4* hb = reinterpret_cast<const float4*>(H1 + (two ? t + 1 : t) * kH1);
      float a00 = 0.0f, a01 = 0.0f, a10 = 0.0f, a11 = 0.0f;
#pragma unroll 5
      for (int q = 0; q < kQuads; ++q) {
        const float4 x0 = wa[q], x1 = wb[q], h0 = ha[q], h1 = hb[q];
        fma4(a00, x0, h0);
        fma4(a01, x0, h1);
        fma4(a10, x1, h0);
        fma4(a11, x1, h1);
      }
      H2[t * kLd2 + j] = fmaxf(a00 + B2[j], 0.0f);
      H2[t * kLd2 + j + kHalf] = fmaxf(a10 + B2[j + kHalf], 0.0f);
      if (two) {
        H2[(t + 1) * kLd2 + j] = fmaxf(a01 + B2[j], 0.0f);
        H2[(t + 1) * kLd2 + j + kHalf] = fmaxf(a11 + B2[j + kHalf], 0.0f);
      }
    }
    __syncthreads();

    // ---- logits = W3 h2 + b3 and dlogits = (softmax - onehot) / T: a
    // group of S lanes per column, lane s on logit s, the softmax's max and
    // sum over the group by shuffles ----
    for (int base = 0; base < tl; base += kThreads / S) {
      const int t = base + tid / S, s = tid % S;
      const bool live = t < tl;
      const float* w = W3 + s * kH2;
      const float* h = H2 + (live ? t : 0) * kLd2;
      float acc = 0.0f;
#pragma unroll 10
      for (int j = 0; j < kH2; ++j) acc = fmaf(w[j], h[j], acc);
      const float logit = acc + B3[s];
      float mx = logit;
#pragma unroll
      for (int o = S / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float e = expf(logit - mx);
      float sum = e;
#pragma unroll
      for (int o = S / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (live) LG[t * kLdl + s] = (__fdividef(e, sum) - (s == label[t] ? 1.0f : 0.0f)) * inv_t;
    }
    __syncthreads();

    // ---- partial dW3, db3 and dz2 = [z2 > 0] W3^T dlogits ----
    for (int i = tid; i < S * kH2 + S + tl * kH2; i += kThreads) {
      if (i < S * kH2) {
        const int s = i / kH2, j = i - s * kH2;
        float acc = 0.0f;
        for (int t = 0; t < tl; ++t) acc = fmaf(LG[t * kLdl + s], H2[t * kLd2 + j], acc);
        G[L::kW3 + i] = acc;
      } else if (i < S * kH2 + S) {
        const int s = i - S * kH2;
        float acc = 0.0f;
        for (int t = 0; t < tl; ++t) acc += LG[t * kLdl + s];
        G[L::kB3 + s] = acc;
      } else {
        const int o = i - S * kH2 - S;
        const int t = o / kH2, j = o - t * kH2;
        const float* lg = LG + t * kLdl;
        float acc = 0.0f;
#pragma unroll
        for (int s = 0; s < S; ++s) acc = fmaf(W3[s * kH2 + j], lg[s], acc);
        DZ2[t * kLd2 + j] = H2[t * kLd2 + j] > 0.0f ? acc : 0.0f;
      }
    }
    __syncthreads();

    // ---- partial dW2 = dz2 h1^T (5 rows x 4 columns per thread), db2 ----
    for (int i = tid; i < kGradTiles + kH2; i += kThreads) {
      if (i < kGradTiles) {
        const int jg = i / kQuads, kq = i - jg * kQuads;
        float4 acc[kGradRows];
#pragma unroll
        for (int r = 0; r < kGradRows; ++r) acc[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int t = 0; t < tl; ++t) {
          const float4 h = *reinterpret_cast<const float4*>(H1 + t * kH1 + 4 * kq);
          const float* d = DZ2 + t * kLd2 + kGradRows * jg;
#pragma unroll
          for (int r = 0; r < kGradRows; ++r) fma4(acc[r], h, d[r]);
        }
#pragma unroll
        for (int r = 0; r < kGradRows; ++r) {
          *reinterpret_cast<float4*>(G + L::kW2 + (kGradRows * jg + r) * kH1 + 4 * kq) = acc[r];
        }
      } else {
        const int j = i - kGradTiles;
        float acc = 0.0f;
        for (int t = 0; t < tl; ++t) acc += DZ2[t * kLd2 + j];
        G[L::kB2 + j] = acc;
      }
    }
    __syncthreads();

    // ---- dz1 = (W2^T dz2) h1 (1 - h1), over h1 in place: 2 columns x 4 ----
    for (int i = tid; i < pairs * kQuads; i += kThreads) {
      const int kq = i % kQuads, t = 2 * (i / kQuads);
      const bool two = t + 1 < tl;
      const float* da = DZ2 + t * kLd2;
      const float* db = DZ2 + (two ? t + 1 : t) * kLd2;
      float4 acc0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), acc1 = acc0;
#pragma unroll 10
      for (int j = 0; j < kH2; ++j) {
        const float4 w = *reinterpret_cast<const float4*>(W2 + j * kH1 + 4 * kq);
        fma4(acc0, w, da[j]);
        fma4(acc1, w, db[j]);
      }
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        if (b == 1 && !two) break;
        float4* hp = reinterpret_cast<float4*>(H1 + (t + b) * kH1 + 4 * kq);
        const float4 a = b == 0 ? acc0 : acc1;
        float4 h = *hp;
        h.x = a.x * h.x * (1.0f - h.x);
        h.y = a.y * h.y * (1.0f - h.y);
        h.z = a.z * h.z * (1.0f - h.z);
        h.w = a.w * h.w * (1.0f - h.w);
        *hp = h;
      }
    }
    __syncthreads();

    // ---- partial dw1 = sum_t dz1 y, db1 = sum_t dz1 ----
    for (int k = tid; k < kH1; k += kThreads) {
      float dw = 0.0f, db = 0.0f;
      for (int t = 0; t < tl; ++t) {
        const float d = H1[t * kH1 + k];
        dw = fmaf(d, Y[t], dw);
        db += d;
      }
      G[L::kW1 + k] = dw;
      G[L::kB1 + k] = db;
    }
    cluster.sync();  // every CTA's partial gradient is written

    // ---- the owner of each quad: sum its 16 partials in rank order, Adam
    // into my copy of the slice ----
    if (owner) {
      float g[4] = {};
#pragma unroll
      for (int q = 0; q < kCluster; ++q) {
        const float4 part =
            *reinterpret_cast<const float4*>(cluster.map_shared_rank(G, q) + quad);
        if (q == 0) {
          g[0] = part.x;
          g[1] = part.y;
          g[2] = part.z;
          g[3] = part.w;
        } else {
          g[0] += part.x;
          g[1] += part.y;
          g[2] += part.z;
          g[3] += part.w;
        }
      }
      float p[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        m[c] = b1 * m[c] + omb1 * g[c];
        v[c] = b2 * v[c] + omb2 * g[c] * g[c];
        p[c] = P[quad + c] - __fdividef(lr * (m[c] * ic1), sqrt_approx(v[c] * ic2) + eps);
      }
      *reinterpret_cast<float4*>(P + quad) = make_float4(p[0], p[1], p[2], p[3]);
    }
    // every slice is updated in its owner's copy, and no owner still reads a
    // partial gradient that the next step overwrites
    cluster.sync();

    // ---- read the other slices from their owners' copies. An owner
    // updates its slice again only after the next step's first cluster
    // barrier, which every CTA reaches after these reads ----
    constexpr int kPulls = (L::kPadded / 4 + kThreads - 1) / kThreads;
    float4 got[kPulls];
#pragma unroll
    for (int r = 0; r < kPulls; ++r) {
      const int i = 4 * (tid + r * kThreads), from = i / kSl;
      if (i < L::kPadded && from != rank) {
        got[r] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(P, from) + i);
      }
    }
#pragma unroll
    for (int r = 0; r < kPulls; ++r) {
      const int i = 4 * (tid + r * kThreads), from = i / kSl;
      if (i < L::kPadded && from != rank) *reinterpret_cast<float4*>(P + i) = got[r];
    }
    __syncthreads();
  }
  cluster.sync();  // no peer still reads this CTA's copy

  if (owner) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (quad + c < L::kCount) {
        *element<S>(params, quad + c) = P[quad + c];
        *element<S>(mu, quad + c) = m[c];
        *element<S>(nu, quad + c) = v[c];
      }
    }
  }
}

// the kernel's attributes, set once before its first launch (so not while a
// CUDA graph captures one)
template <int S>
cudaError_t configure() {
  const cudaError_t err = cudaFuncSetAttribute(
      online_adapt_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (err != cudaSuccess) return err;
  // a cluster of more than 8 CTAs is not portable
  return cudaFuncSetAttribute(online_adapt_kernel<S>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// the kernel's arguments, as the C entry point receives them
struct Args {
  const float* y;
  const int* states;
  Tensors params, mu, nu;
  int T, n_iters;
  float lr, b1, b2, omb1, omb2, eps, inv_t;
  const float* powers;
};

template <int S>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * Smem<S>((a.T + kCluster - 1) / kCluster).total;
  if (bytes > kMaxSmemBytes) return cudaErrorInvalidValue;
  static const cudaError_t configured = configure<S>();
  if (configured != cudaSuccess) return configured;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &config, online_adapt_kernel<S>, a.y, a.states, a.params, a.mu, a.nu, a.T, a.n_iters,
      a.lr, a.b1, a.b2, a.omb1, a.omb2, a.eps, a.inv_t, a.powers);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// y [T] f32, states [T] int32; p_*, m_*, v_* the parameters and their two
// Adam moments, each six f32 tensors (w1 [100, 1], b1 [100], w2 [50, 100],
// b2 [50], w3 [S, 50], b3 [S]), contiguous, on the current device, updated
// in place. powers [2] f32 on the device: b1^count and b2^count before the
// first step.
// Returns the CUDA error of the launch (0 on success; a cluster the card
// cannot place is refused, not replaced).
extern "C" int online_adapt(const float* y, const int* states, float* p_w1, float* p_b1,
                            float* p_w2, float* p_b2, float* p_w3, float* p_b3, float* m_w1,
                            float* m_b1, float* m_w2, float* m_b2, float* m_w3, float* m_b3,
                            float* v_w1, float* v_b1, float* v_w2, float* v_b2, float* v_w3,
                            float* v_b3, int T, int S, int n_iters, float lr,
                            float b1, float b2, float omb1, float omb2, float eps, float inv_t,
                            const float* powers, cudaStream_t stream) {
  const Args a{y, states,
               {{p_w1, p_b1, p_w2, p_b2, p_w3, p_b3}},
               {{m_w1, m_b1, m_w2, m_b2, m_w3, m_b3}},
               {{v_w1, v_b1, v_w2, v_b2, v_w3, v_b3}},
               T, n_iters, lr, b1, b2, omb1, omb2, eps, inv_t, powers};
  cudaError_t err;
  switch (S) {
    case 2: err = launch<2>(a, stream); break;
    case 4: err = launch<4>(a, stream); break;
    case 8: err = launch<8>(a, stream); break;
    case 16: err = launch<16>(a, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
