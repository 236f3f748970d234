// Fused MAML pairs of ViterbiNet (K7): a chunk of a meta iteration's
// second-order (support, query) pairs in one launch of a thread-block
// cluster.
//
// Replaces no Pallas kernel: the JAX package runs each pair as plain
// jax.grad through jax.grad under lax.cond in a scan (its train/meta.py::
// make_maml_step, the online engine's meta_adapt). Added because the port's
// autograd pair (train/meta.py::maml_pair_step) is about 243 small kernels,
// each of a few microseconds, under an IF node of its own, and a by-word meta
// run spent nine tenths of its device time in them (PERF.md). For each pair
// i of the chunk whose take[i] holds, in order, over the support's n_s
// symbols (its window's words back to back) and the query's n_q:
//   1. the support's CE over its trellis states, mean over n_s, and its
//      gradient g_s at theta: h1 = sigmoid(w1 y + b1) [100], h2 = relu(W2 h1
//      + b2) [50], logits = W3 h2 + b3 [S], dlogits = (softmax - onehot) /
//      n_s, and the hand-written backward through relu and sigmoid;
//   2. theta' = theta - meta_lr g_s;
//   3. the query's CE and its gradient g_q at theta' (the CE, mean over n_q,
//      added to *loss);
//   4. second order: the meta-gradient g_q - meta_lr H_s g_q, the support's
//      Hessian at theta times g_q by a forward-over-reverse pass over step
//      1's activations: R{x}, x's derivative along g_q, through the forward
//      (R h1 = h1 (1 - h1) (v_w1 y + v_b1), R h2 = [h2 > 0] (V_W2 h1 + W2
//      R h1 + v_b2), R logits = V_W3 h2 + W3 R h2 + v_b3, R dlogits = p (R
//      logits - <p, R logits>) / n_s) and the backward (relu's mask fixed,
//      its second derivative zero; sigmoid's in R{h1 (1 - h1)} = (1 - 2 h1)
//      R h1). First order: g_q;
//   5. one Adam step of theta, train/optim.py's expression op for op, the
//      bias correction the factors table's row at the count, which advances.
// Everything is f32 (no TF32, no tensor cores: wgmma has no f32 path), with
// IEEE division and square root in the softmax, the CE and Adam (the
// approximate intrinsics drift ~100x further from float64, PERF.md).
//
// What bounds it on an H100: operations. A second-order pair at n_s = n_q =
// T = 136 is about 19.9 MFLOP (portbench/counts.py::maml_pair_ops): ~12
// products of the 50 x 100 layer over T columns, the rest small. That is
// 0.3 us at the card's f32 rate, but the pairs are sequential and each is
// small, so the kernel runs on one cluster of kCluster = 16 CTAs, whose share
// of that rate makes ~2.5 us a pair. What the design does about it, K6's
// layout (online_adapt.cu, viterbinet_cluster.cuh):
//   - the support's and the query's columns are split across the cluster,
//     ceil(n / 16) per CTA; forward, softmax and the backward to dh1, and the
//     R pass, are column-local. Each CTA holds theta, theta', the direction
//     g_q and its partial gradient in shared memory (4 x 24 KB at S = 16), and
//     its columns' activations: the support's kept from step 1 to step 4;
//   - each of a pair's three gradients (g_s, g_q, H_s g_q) is a column sum:
//     every CTA writes its partial, and after a cluster barrier CTA r, the
//     owner of the r-th 1/16 slice of the parameters (one float4 quad per
//     thread), sums that slice's 16 partials over distributed shared memory
//     in rank order 0..15 (deterministic: no atomics), applies the step's
//     update to its own copy (theta', g_q, or Adam with the quad's moments
//     held in registers over the whole chunk), and after a second barrier
//     every CTA pulls the other slices from their owners: six cluster
//     barriers a second-order pair, four a first-order one;
//   - the 50 x 100 products are register tiled with float4 operands, the
//     R pass's two-term products in the same loop; the logits and softmax
//     run on S lanes a column with shuffles;
//   - a pair whose take[i] is false is skipped by the whole cluster alike.
//     The rows, labels, params, moments, count and loss are read once and
//     written once (the rows once a pair).
//
// Rounding: the products are f32 FMAs and sum in another order than the
// plain version (kernels/maml_pairs.py); the result is held to a tolerance
// and to a float64 witness. Two launches on the same inputs give the same
// bits.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "viterbinet_cluster.cuh"

namespace cg = cooperative_groups;

namespace {

// offsets, in floats, of one CTA's shared memory with cs support columns and
// cw = max(cs, query columns) work columns; every CTA has the same layout, so
// a peer's copies are at the same offsets (kernels/maml_pairs.py::smem_bytes
// computes the same total). theta is at 0.
template <int S>
struct Smem {
  int q, v, g, ys, ls, yq, lq, h1, dh1, h2, dz2, pr, dl, a1, ad1, a2, ad2, al, total;
  __host__ __device__ constexpr Smem(int cs, int cw)
      : q(Layout<S>::kPadded),
        v(2 * Layout<S>::kPadded),
        g(3 * Layout<S>::kPadded),
        ys(4 * Layout<S>::kPadded + 4),
        ls(ys + align4(cw)),
        yq(ls + align4(cw)),
        lq(yq + align4(cw)),
        h1(lq + align4(cw)),
        dh1(h1 + cs * kH1),
        h2(dh1 + cs * kH1),
        dz2(h2 + cs * kLd2),
        pr(dz2 + cs * kLd2),
        dl(pr + align4(cs * Layout<S>::kLdl)),
        a1(dl + align4(cs * Layout<S>::kLdl)),
        ad1(a1 + cw * kH1),
        a2(ad1 + cw * kH1),
        ad2(a2 + cw * kLd2),
        al(ad2 + cw * kLd2),
        total(al + align4(cw * Layout<S>::kLdl)) {}
};

// the kernel's arguments, as the C entry point receives them
struct Args {
  const float* s_rx;
  const int* s_states;
  const float* q_rx;
  const int* q_states;
  const bool* take;
  Tensors params, mu, nu;
  int* count;
  const float* table;
  float* loss;
  int chunk, n_s, n_q, n_rows, second_order;
  float meta_lr, lr, b1, b2, omb1, omb2, eps;
};

__device__ __forceinline__ const float4& f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ------------------------------------------------------------------ phases
// Each phase is run by every thread of the CTA over its tl columns and
// holds no barrier: the caller puts one between phases that depend.

// h1 = sigmoid(w1 y + b1) at the params P
template <int S>
__device__ void hidden1(const float* P, const float* Y, int tl, float* H1) {
  using L = Layout<S>;
  for (int i = threadIdx.x; i < tl * kH1; i += kThreads) {
    const int t = i / kH1, k = i - t * kH1;
    H1[i] = __fdiv_rn(1.0f, 1.0f + expf(-(P[L::kW1 + k] * Y[t] + P[L::kB1 + k])));
  }
}

// rows j and j + 25 of A X (+ B Z) over one column: A, B [50][100], X, Z [100]
template <bool kTwo>
__device__ __forceinline__ void rows_dot(const float* A, const float* X, const float* B,
                                         const float* Z, int j, float& lo, float& hi) {
  const float4* a0 = reinterpret_cast<const float4*>(A + j * kH1);
  const float4* a1 = reinterpret_cast<const float4*>(A + (j + kHalf) * kH1);
  const float4* x = reinterpret_cast<const float4*>(X);
  lo = 0.0f;
  hi = 0.0f;
#pragma unroll 5
  for (int q = 0; q < kQuads; ++q) {
    const float4 xv = x[q];
    fma4(lo, a0[q], xv);
    fma4(hi, a1[q], xv);
  }
  if (kTwo) {
    const float4* b0 = reinterpret_cast<const float4*>(B + j * kH1);
    const float4* b1 = reinterpret_cast<const float4*>(B + (j + kHalf) * kH1);
    const float4* z = reinterpret_cast<const float4*>(Z);
#pragma unroll 5
    for (int q = 0; q < kQuads; ++q) {
      const float4 zv = z[q];
      fma4(lo, b0[q], zv);
      fma4(hi, b1[q], zv);
    }
  }
}

// h2 = relu(W2 h1 + b2) at the params P
template <int S>
__device__ void hidden2(const float* P, const float* H1, int tl, float* H2) {
  using L = Layout<S>;
  for (int i = threadIdx.x; i < tl * kHalf; i += kThreads) {
    const int t = i / kHalf, j = i - t * kHalf;
    float lo, hi;
    rows_dot<false>(P + L::kW2, H1 + t * kH1, nullptr, nullptr, j, lo, hi);
    H2[t * kLd2 + j] = fmaxf(lo + P[L::kB2 + j], 0.0f);
    H2[t * kLd2 + j + kHalf] = fmaxf(hi + P[L::kB2 + j + kHalf], 0.0f);
  }
}

// logits = W3 h2 + b3 on a group of S lanes a column, lane s on logit s, the
// softmax's max and sum over the group by shuffles: DL = (softmax - onehot)
// / n; with kKeep the softmax into PR; the column's CE into DL's slot S
template <int S, bool kKeep>
__device__ void softmax(const float* P, const float* H2, const int* label, int tl, float n,
                        float* PR, float* DL) {
  using L = Layout<S>;
  constexpr int kLdl = L::kLdl;
  for (int base = 0; base < tl; base += kThreads / S) {
    const int t = base + threadIdx.x / S, s = threadIdx.x % S;
    const bool live = t < tl;
    const float* w = P + L::kW3 + s * kH2;
    const float* h = H2 + (live ? t : 0) * kLd2;
    float acc = 0.0f;
#pragma unroll 10
    for (int j = 0; j < kH2; ++j) acc = fmaf(w[j], h[j], acc);
    const float logit = acc + P[L::kB3 + s];
    float mx = logit;
#pragma unroll
    for (int o = S / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float e = expf(logit - mx);
    float sum = e;
#pragma unroll
    for (int o = S / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (live) {
      const float p = __fdiv_rn(e, sum);
      const bool hit = s == label[t];
      DL[t * kLdl + s] = __fdiv_rn(p - (hit ? 1.0f : 0.0f), n);
      if (kKeep) PR[t * kLdl + s] = p;
      if (hit) DL[t * kLdl + S] = (mx + logf(sum)) - logit;
    }
  }
}

// the R pass's logits R z3 = V_W3 h2 + W3 R h2 + v_b3 on S lanes a column and
// RDL = p (R z3 - <p, R z3>) / n, p the support's softmax PR
template <int S>
__device__ void r_softmax(const float* P, const float* V, const float* H2, const float* RH2,
                          const float* PR, int tl, float n, float* RDL) {
  using L = Layout<S>;
  constexpr int kLdl = L::kLdl;
  for (int base = 0; base < tl; base += kThreads / S) {
    const int t = base + threadIdx.x / S, s = threadIdx.x % S;
    const bool live = t < tl;
    const int c = live ? t : 0;
    const float* vw = V + L::kW3 + s * kH2;
    const float* w = P + L::kW3 + s * kH2;
    const float* h = H2 + c * kLd2;
    const float* rh = RH2 + c * kLd2;
    float acc = 0.0f;
#pragma unroll 10
    for (int j = 0; j < kH2; ++j) acc = fmaf(w[j], rh[j], fmaf(vw[j], h[j], acc));
    const float rz = acc + V[L::kB3 + s];
    const float p = PR[c * kLdl + s];
    float dot = p * rz;
#pragma unroll
    for (int o = S / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    if (live) RDL[t * kLdl + s] = __fdiv_rn(p * (rz - dot), n);
  }
}

// the partial gradient's W3 and b3: sum_t La[t][s] Ha[t][j] (+ Lb[t][s]
// Hb[t][j]) and sum_t La[t][s]; and D[t][j] = [H2[t][j] > 0] sum_s (Wa[s][j]
// La[t][s] (+ Wb[s][j] Lb[t][s])), the backward into the relu layer
template <int S, bool kTwo>
__device__ void back3(const float* Wa, const float* La, const float* Ha, const float* Wb,
                      const float* Lb, const float* Hb, const float* H2, int tl, float* G,
                      float* D) {
  using L = Layout<S>;
  constexpr int kLdl = L::kLdl;
  for (int i = threadIdx.x; i < S * kH2 + S + tl * kH2; i += kThreads) {
    if (i < S * kH2) {
      const int s = i / kH2, j = i - s * kH2;
      float acc = 0.0f;
      for (int t = 0; t < tl; ++t) {
        acc = fmaf(La[t * kLdl + s], Ha[t * kLd2 + j], acc);
        if (kTwo) acc = fmaf(Lb[t * kLdl + s], Hb[t * kLd2 + j], acc);
      }
      G[L::kW3 + i] = acc;
    } else if (i < S * kH2 + S) {
      const int s = i - S * kH2;
      float acc = 0.0f;
      for (int t = 0; t < tl; ++t) acc += La[t * kLdl + s];
      G[L::kB3 + s] = acc;
    } else {
      const int o = i - S * kH2 - S;
      const int t = o / kH2, j = o - t * kH2;
      float acc = 0.0f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        acc = fmaf(Wa[s * kH2 + j], La[t * kLdl + s], acc);
        if (kTwo) acc = fmaf(Wb[s * kH2 + j], Lb[t * kLdl + s], acc);
      }
      D[t * kLd2 + j] = H2[t * kLd2 + j] > 0.0f ? acc : 0.0f;
    }
  }
}

// the partial gradient's W2 and b2: sum_t Da[t][j] Xa[t][k] (+ Db[t][j]
// Xb[t][k]) in tiles of 5 rows x 4 columns, and sum_t Da[t][j]
template <int S, bool kTwo>
__device__ void back2(const float* Da, const float* Xa, const float* Db, const float* Xb, int tl,
                      float* G) {
  using L = Layout<S>;
  for (int i = threadIdx.x; i < kGradTiles + kH2; i += kThreads) {
    if (i < kGradTiles) {
      const int jg = i / kQuads, kq = i - jg * kQuads;
      float4 acc[kGradRows];
#pragma unroll
      for (int r = 0; r < kGradRows; ++r) acc[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int t = 0; t < tl; ++t) {
        const float4 x = f4(Xa + t * kH1 + 4 * kq);
        const float* d = Da + t * kLd2 + kGradRows * jg;
#pragma unroll
        for (int r = 0; r < kGradRows; ++r) fma4(acc[r], x, d[r]);
        if (kTwo) {
          const float4 xb = f4(Xb + t * kH1 + 4 * kq);
          const float* db = Db + t * kLd2 + kGradRows * jg;
#pragma unroll
          for (int r = 0; r < kGradRows; ++r) fma4(acc[r], xb, db[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kGradRows; ++r) {
        *reinterpret_cast<float4*>(G + L::kW2 + (kGradRows * jg + r) * kH1 + 4 * kq) = acc[r];
      }
    } else {
      const int j = i - kGradTiles;
      float acc = 0.0f;
      for (int t = 0; t < tl; ++t) acc += Da[t * kLd2 + j];
      G[L::kB2 + j] = acc;
    }
  }
}

// four hidden units 4 kq.. of sum_j Wa[j][k] Da[j] (+ Wb[j][k] Db[j]) over
// one column: Wa, Wb [50][100], Da, Db [50]
template <bool kTwo>
__device__ __forceinline__ float4 cols_dot(const float* Wa, const float* Da, const float* Wb,
                                           const float* Db, int kq) {
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 10
  for (int j = 0; j < kH2; ++j) {
    fma4(acc, f4(Wa + j * kH1 + 4 * kq), Da[j]);
    if (kTwo) fma4(acc, f4(Wb + j * kH1 + 4 * kq), Db[j]);
  }
  return acc;
}

// dh1 = W2^T dz2 at the params P
template <int S>
__device__ void hidden1_back(const float* P, const float* DZ2, int tl, float* DH1) {
  using L = Layout<S>;
  for (int i = threadIdx.x; i < tl * kQuads; i += kThreads) {
    const int t = i / kQuads, kq = i - t * kQuads;
    *reinterpret_cast<float4*>(DH1 + t * kH1 + 4 * kq) =
        cols_dot<false>(P + L::kW2, DZ2 + t * kLd2, nullptr, nullptr, kq);
  }
}

// the partial gradient's w1 and b1: sum_t d y and sum_t d, with d = D[t][k]
// h1 (1 - h1), the backward through the sigmoid, or, without H1, D[t][k]
template <int S>
__device__ void back1(const float* D, const float* H1, const float* Y, int tl, float* G) {
  using L = Layout<S>;
  for (int k = threadIdx.x; k < kH1; k += kThreads) {
    float dw = 0.0f, db = 0.0f;
    for (int t = 0; t < tl; ++t) {
      float d = D[t * kH1 + k];
      if (H1 != nullptr) {
        const float h = H1[t * kH1 + k];
        d = d * (h * (1.0f - h));
      }
      dw = fmaf(d, Y[t], dw);
      db += d;
    }
    G[L::kW1 + k] = dw;
    G[L::kB1 + k] = db;
  }
}

// one column set's loss and gradient at the params P, the partial gradient
// into G: the forward into H1, H2 and DL (PR, the softmax, with kKeep), the
// backward through DZ2 and DH1
template <int S, bool kKeep>
__device__ void gradient(const float* P, const float* Y, const int* label, int tl, float n,
                         float* H1, float* H2, float* PR, float* DL, float* DZ2, float* DH1,
                         float* G) {
  hidden1<S>(P, Y, tl, H1);
  __syncthreads();
  hidden2<S>(P, H1, tl, H2);
  __syncthreads();
  softmax<S, kKeep>(P, H2, label, tl, n, PR, DL);
  __syncthreads();
  back3<S, false>(P + Layout<S>::kW3, DL, H2, nullptr, nullptr, nullptr, H2, tl, G, DZ2);
  __syncthreads();
  back2<S, false>(DZ2, H1, nullptr, nullptr, tl, G);
  hidden1_back<S>(P, DZ2, tl, DH1);
  __syncthreads();
  back1<S>(DH1, H1, Y, tl, G);
}

// the owner's quad of the cluster's gradient: its 16 partials summed in rank
// order over distributed shared memory
__device__ __forceinline__ float4 reduce_quad(cg::cluster_group& cluster, float* G, int quad) {
  float4 g = f4(cluster.map_shared_rank(G, 0) + quad);
#pragma unroll
  for (int r = 1; r < kCluster; ++r) {
    const float4 part = f4(cluster.map_shared_rank(G, r) + quad);
    g.x += part.x;
    g.y += part.y;
    g.z += part.z;
    g.w += part.w;
  }
  return g;
}

// read the other CTAs' slices of the copy X from their owners' copies
template <int S>
__device__ void pull(cg::cluster_group& cluster, float* X, int rank) {
  using L = Layout<S>;
  constexpr int kPulls = (L::kPadded / 4 + kThreads - 1) / kThreads;
  float4 got[kPulls];
#pragma unroll
  for (int r = 0; r < kPulls; ++r) {
    const int i = 4 * (threadIdx.x + r * kThreads), from = i / kSlice<S>;
    if (i < L::kPadded && from != rank) got[r] = f4(cluster.map_shared_rank(X, from) + i);
  }
#pragma unroll
  for (int r = 0; r < kPulls; ++r) {
    const int i = 4 * (threadIdx.x + r * kThreads), from = i / kSlice<S>;
    if (i < L::kPadded && from != rank) *reinterpret_cast<float4*>(X + i) = got[r];
  }
}

// train/optim.py's Adam on one parameter, op for op: returns the new value
__device__ __forceinline__ float adam(const Args& a, float& m, float& v, float p, float g,
                                      float bc0, float bc1) {
  m = __fadd_rn(__fmul_rn(a.omb1, g), __fmul_rn(a.b1, m));
  v = __fadd_rn(__fmul_rn(a.omb2, __fmul_rn(g, g)), __fmul_rn(a.b2, v));
  const float step =
      __fdiv_rn(__fmul_rn(m, bc0), __fadd_rn(__fsqrt_rn(__fmul_rn(v, bc1)), a.eps));
  return __fadd_rn(p, __fmul_rn(step, -a.lr));
}

template <int S>
__global__ void __launch_bounds__(kThreads, 1) maml_pairs_kernel(const Args a) {
  using L = Layout<S>;
  constexpr int kLdl = L::kLdl;
  static_assert(kSlice<S> / 4 <= kThreads, "one quad per thread");

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int cs = (a.n_s + kCluster - 1) / kCluster, cq = (a.n_q + kCluster - 1) / kCluster;
  const int ts = max(0, min(cs, a.n_s - rank * cs));  // this CTA's support columns
  const int tq = max(0, min(cq, a.n_q - rank * cq));  // and query columns
  const float ns = static_cast<float>(a.n_s), nq = static_cast<float>(a.n_q);

  extern __shared__ __align__(16) float smem[];
  const Smem<S> at(cs, max(cs, cq));
  float* P = smem;            // theta
  float* Q = smem + at.q;     // theta'
  float* V = smem + at.v;     // g_q, the R pass's direction
  float* G = smem + at.g;     // the partial gradient; G[kPadded] the query's partial CE
  float* YS = smem + at.ys;
  int* LS = reinterpret_cast<int*>(smem + at.ls);
  float* YQ = smem + at.yq;
  int* LQ = reinterpret_cast<int*>(smem + at.lq);
  // the support's activations, kept for the R pass
  float* H1 = smem + at.h1;
  float* DH1 = smem + at.dh1;
  float* H2 = smem + at.h2;
  float* DZ2 = smem + at.dz2;
  float* PR = smem + at.pr;
  float* DL = smem + at.dl;
  // the query's, then the R pass's
  float* A1 = smem + at.a1;
  float* AD1 = smem + at.ad1;
  float* A2 = smem + at.a2;
  float* AD2 = smem + at.ad2;
  float* AL = smem + at.al;

  const int lo = rank * kSlice<S>, len = slice_len<S>(rank);
  const bool owner = 4 * tid < len;
  const int quad = lo + 4 * tid;  // first parameter of this thread's quad
  float m[4] = {}, v[4] = {};
  if (owner) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (quad + c < L::kCount) {
        m[c] = *element<S>(a.mu, quad + c);
        v[c] = *element<S>(a.nu, quad + c);
      }
    }
  }
  for (int i = tid; i < L::kPadded; i += kThreads) {
    P[i] = i < L::kCount ? *element<S>(a.params, i) : 0.0f;
    Q[i] = 0.0f;
    V[i] = 0.0f;
    G[i] = 0.0f;  // (the pad stays 0: no phase writes it)
  }
  if (tid == 0) G[L::kPadded] = 0.0f;
  int count = *a.count;
  float loss = *a.loss;
  __syncthreads();

  for (int i = 0; i < a.chunk; ++i) {
    if (!a.take[i]) continue;  // every thread of the cluster alike
    for (int t = tid; t < ts; t += kThreads) {
      YS[t] = a.s_rx[i * a.n_s + rank * cs + t];
      LS[t] = a.s_states[i * a.n_s + rank * cs + t];
    }
    for (int t = tid; t < tq; t += kThreads) {
      YQ[t] = a.q_rx[i * a.n_q + rank * cq + t];
      LQ[t] = a.q_states[i * a.n_q + rank * cq + t];
    }
    __syncthreads();

    // ---- 1. the support's gradient at theta ----
    gradient<S, true>(P, YS, LS, ts, ns, H1, H2, PR, DL, DZ2, DH1, G);
    cluster.sync();  // every partial g_s is written
    // ---- 2. theta' = theta - meta_lr g_s on my slice ----
    if (owner) {
      const float4 g = reduce_quad(cluster, G, quad);
      const float gs[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) Q[quad + c] = __fsub_rn(P[quad + c], __fmul_rn(a.meta_lr, gs[c]));
    }
    // every slice of theta' is in its owner's copy, and no owner still reads
    // a partial that the query overwrites
    cluster.sync();
    pull<S>(cluster, Q, rank);
    __syncthreads();

    // ---- 3. the query's gradient at theta', and its CE ----
    gradient<S, false>(Q, YQ, LQ, tq, nq, A1, A2, nullptr, AL, AD2, AD1, G);
    if (tid == 0) {
      float ce = 0.0f;
      for (int t = 0; t < tq; ++t) ce += AL[t * kLdl + S];
      G[L::kPadded] = ce;
    }
    cluster.sync();  // every partial g_q and CE is written
    const int row = min(count, a.n_rows - 1);
    const float bc0 = a.table[2 * row], bc1 = a.table[2 * row + 1];
    if (owner) {
      const float4 g = reduce_quad(cluster, G, quad);
      const float gq[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (a.second_order) {
          V[quad + c] = gq[c];
        } else {
          P[quad + c] = adam(a, m[c], v[c], P[quad + c], gq[c], bc0, bc1);
        }
      }
    }
    if (rank == 0 && tid == 0) {
      float ce = 0.0f;
      for (int r = 0; r < kCluster; ++r) ce += cluster.map_shared_rank(G, r)[L::kPadded];
      loss = __fadd_rn(loss, __fdiv_rn(ce, nq));
    }
    ++count;
    cluster.sync();
    if (!a.second_order) {
      pull<S>(cluster, P, rank);
      __syncthreads();
      continue;
    }
    pull<S>(cluster, V, rank);
    __syncthreads();

    // ---- 4. H_s g_q at theta, forward over reverse through the support's
    // activations: R h1 into A1, R h2 into A2, R dlogits into AL, R dz2 into
    // AD2, then R dz1 over R h1 ----
    for (int i1 = tid; i1 < ts * kH1; i1 += kThreads) {
      const int t = i1 / kH1, k = i1 - t * kH1;
      const float h = H1[i1];
      A1[i1] = (h * (1.0f - h)) * (V[L::kW1 + k] * YS[t] + V[L::kB1 + k]);
    }
    __syncthreads();
    for (int i2 = tid; i2 < ts * kHalf; i2 += kThreads) {
      const int t = i2 / kHalf, j = i2 - t * kHalf;
      float rlo, rhi;
      rows_dot<true>(V + L::kW2, H1 + t * kH1, P + L::kW2, A1 + t * kH1, j, rlo, rhi);
      A2[t * kLd2 + j] = H2[t * kLd2 + j] > 0.0f ? rlo + V[L::kB2 + j] : 0.0f;
      A2[t * kLd2 + j + kHalf] =
          H2[t * kLd2 + j + kHalf] > 0.0f ? rhi + V[L::kB2 + j + kHalf] : 0.0f;
    }
    __syncthreads();
    r_softmax<S>(P, V, H2, A2, PR, ts, ns, AL);
    __syncthreads();
    back3<S, true>(P + L::kW3, AL, H2, V + L::kW3, DL, A2, H2, ts, G, AD2);
    __syncthreads();
    back2<S, true>(AD2, H1, DZ2, A1, ts, G);
    __syncthreads();  // R h1 is read: R dz1 overwrites it
    for (int i3 = tid; i3 < ts * kQuads; i3 += kThreads) {
      const int t = i3 / kQuads, kq = i3 - t * kQuads;
      const float4 acc =
          cols_dot<true>(V + L::kW2, DZ2 + t * kLd2, P + L::kW2, AD2 + t * kLd2, kq);
      float4* rp = reinterpret_cast<float4*>(A1 + t * kH1 + 4 * kq);
      const float4 r = *rp, h = f4(H1 + t * kH1 + 4 * kq), d = f4(DH1 + t * kH1 + 4 * kq);
      float4 out;
      out.x = acc.x * (h.x * (1.0f - h.x)) + d.x * (r.x * (1.0f - 2.0f * h.x));
      out.y = acc.y * (h.y * (1.0f - h.y)) + d.y * (r.y * (1.0f - 2.0f * h.y));
      out.z = acc.z * (h.z * (1.0f - h.z)) + d.z * (r.z * (1.0f - 2.0f * h.z));
      out.w = acc.w * (h.w * (1.0f - h.w)) + d.w * (r.w * (1.0f - 2.0f * h.w));
      *rp = out;
    }
    __syncthreads();
    back1<S>(A1, nullptr, YS, ts, G);
    cluster.sync();  // every partial H_s g_q is written

    // ---- 5. Adam on g_q - meta_lr H_s g_q ----
    if (owner) {
      const float4 g = reduce_quad(cluster, G, quad);
      const float hv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float meta = __fsub_rn(V[quad + c], __fmul_rn(a.meta_lr, hv[c]));
        P[quad + c] = adam(a, m[c], v[c], P[quad + c], meta, bc0, bc1);
      }
    }
    cluster.sync();
    pull<S>(cluster, P, rank);
    __syncthreads();
  }
  cluster.sync();  // no peer still reads this CTA's copies

  if (owner) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (quad + c < L::kCount) {
        *element<S>(a.params, quad + c) = P[quad + c];
        *element<S>(a.mu, quad + c) = m[c];
        *element<S>(a.nu, quad + c) = v[c];
      }
    }
  }
  if (rank == 0 && tid == 0) {
    *a.count = count;
    *a.loss = loss;
  }
}

// the kernel's attributes, set once before its first launch (so not while a
// CUDA graph captures one)
template <int S>
cudaError_t configure() {
  const cudaError_t err = cudaFuncSetAttribute(
      maml_pairs_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (err != cudaSuccess) return err;
  // a cluster of more than 8 CTAs is not portable
  return cudaFuncSetAttribute(maml_pairs_kernel<S>,
                              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <int S>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int cs = (a.n_s + kCluster - 1) / kCluster, cq = (a.n_q + kCluster - 1) / kCluster;
  const size_t bytes = sizeof(float) * Smem<S>(cs, cs > cq ? cs : cq).total;
  if (bytes > kMaxSmemBytes || a.chunk < 1 || a.n_rows < 1) return cudaErrorInvalidValue;
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
  const cudaError_t err = cudaLaunchKernelEx(&config, maml_pairs_kernel<S>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// s_rx [chunk, n_s] f32 and s_states [chunk, n_s] int32 (each pair's
// support, its window's words back to back, and their trellis states),
// q_rx [chunk, n_q] and q_states [chunk, n_q] (its query), take [chunk]
// bool; p_*, m_*, v_* the parameters and their two Adam moments, each six
// f32 tensors (w1 [100, 1], b1 [100], w2 [50, 100], b2 [50], w3 [S, 50],
// b3 [S]); count the 0-d int32 Adam count, table [n_rows, 2] f32 Adam's
// bias-correction factors by count (train/optim.py::adam_factors), loss 0-d
// f32; all contiguous on the current device; the parameters, moments, count
// and loss updated in place.
// Returns the CUDA error of the launch (0 on success; a cluster the card
// cannot place is refused, not replaced).
extern "C" int maml_pairs(const float* s_rx, const int* s_states, const float* q_rx,
                          const int* q_states, const bool* take, float* p_w1, float* p_b1,
                          float* p_w2, float* p_b2, float* p_w3, float* p_b3, float* m_w1,
                          float* m_b1, float* m_w2, float* m_b2, float* m_w3, float* m_b3,
                          float* v_w1, float* v_b1, float* v_w2, float* v_b2, float* v_w3,
                          float* v_b3, int* count, const float* table, float* loss, int chunk,
                          int n_s, int n_q, int S, int n_rows, int second_order, float meta_lr,
                          float lr, float b1, float b2, float omb1, float omb2, float eps,
                          cudaStream_t stream) {
  const Args a{s_rx, s_states, q_rx, q_states, take,
               {{p_w1, p_b1, p_w2, p_b2, p_w3, p_b3}},
               {{m_w1, m_b1, m_w2, m_b2, m_w3, m_b3}},
               {{v_w1, v_b1, v_w2, v_b2, v_w3, v_b3}},
               count, table, loss, chunk, n_s, n_q, n_rows, second_order,
               meta_lr, lr, b1, b2, omb1, omb2, eps};
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
