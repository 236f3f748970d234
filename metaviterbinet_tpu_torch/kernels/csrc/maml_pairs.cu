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
// IEEE division and square root in the sigmoid, the softmax, the CE and Adam
// (the approximate intrinsics drift ~100x further from float64, PERF.md).
//
// What bounds it on an H100: operations. A second-order pair at n_s = n_q =
// T = 136 is about 19.9 MFLOP (portbench/counts.py::maml_pair_ops): ~12
// products of the 50 x 100 layer over T columns, the rest small. That is
// 0.3 us at the card's f32 rate, but the pairs are sequential and each is
// small, so the kernel runs on one cluster of kCluster = 16 CTAs, whose share
// of that rate makes ~2.5 us a pair. K6's layout (online_adapt.cu,
// viterbinet_cluster.cuh):
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
//     barriers a second-order pair, four a first-order one. Each reduce and
//     each pull moves ~23 KB into every CTA over distributed shared memory,
//     which the phase probe (scripts/torch_k7_phases.py) found running at
//     ~12 bytes a clock an SM: ~1 us each, the exchange's bound.
// Inside a pair (PERF.md section 5: the column-local phases were 21 of the
// previous design's 35 us a pair, its one-column dot products bound by the
// shared-memory pipe, which takes ~4 clocks for a warp's float4 read of
// distinct addresses, ~5 for W2's rows on 25 lanes and ~2.6 for one
// address), each CTA has kK7Threads = 384 threads (168 registers each: at
// 512 the hot loops spilled) and:
//   - the W2 h1 products (the forward, and the R pass's two-term one) run on
//     warps that each take one half of the 100-deep sums for kRowCols
//     columns, lane j < 25 on rows j and j + 25: every lane reads the same
//     columns of h1 and its own rows of W2, so W2 is read once per kRowCols
//     columns, and no lane waits for a shuffle; the halves go to scratch
//     that the phase does not read (a column's dh1 rows) and the logits
//     phase adds them up (splitting the sums across lanes, with shuffles to
//     add the parts, measured slower);
//   - a column's h2, logits, softmax, dlogits and its backward into dz2 run
//     on one warp, lane s + S ks on logit s over every (32 / S)-th of the
//     50, with no CTA barrier in between;
//   - the W2^T dz2 products, in tiles of four hidden units by kColCols
//     columns with kColSplit lanes eight apart splitting the 50-deep sums
//     (a quarter-warp reads eight quads of one row), run in one phase with
//     the weight gradients of the last two layers;
//   - each pull first stores rank 0's slice, which holds w1 and b1, and
//     computes the next h1 (or R h1) while the rest of it is in flight;
//   - Adam runs on one parameter a thread (the slice's float4 owners only
//     sum it), and no global read is on a pair's critical path: take[] of
//     the next 32 pairs is read at the pair's start, the next pair's rows
//     are copied asynchronously (cp.async) into the row buffers once the
//     pair has read them, and the bias-correction row is read with them;
// a second-order pair has 16 CTA barriers and the six cluster barriers. The
// tiles follow S and the columns a CTA holds, nothing else.
//
// Rounding: the products are f32 FMAs and sum in another order than the
// plain version (kernels/maml_pairs.py); the result is held to a tolerance
// and to a float64 witness. Two launches on the same inputs give the same
// bits: every sum is taken in a fixed order.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "viterbinet_cluster.cuh"

namespace cg = cooperative_groups;

namespace {

// K7's own schedule (K6 keeps the header's kThreads)
constexpr int kK7Threads = 384;
constexpr int kK7Warps = kK7Threads / 32;
constexpr int kRowCols = 3;   // columns of a rows tile (rows j and j + 25 on lane j)
constexpr int kRowCut = 52;   // a rows tile's warp sums over k < kRowCut or the rest
constexpr int kColSplit = 4;  // lanes splitting a cols tile's sums (j = jl, jl + 4, ..)
constexpr int kColCols = 5;   // columns of a cols tile (hidden units 4 kq .. 4 kq + 3)
constexpr int kW3Quads = (kH2 + 3) / 4;  // a W3 gradient row in groups of four
// threads 0.. copy a pair's support rows, kRowLanes.. its query's: a CTA's
// shared memory holds at most ~117 columns of either (S = 2, one support
// column), fewer than kRowLanes
constexpr int kRowLanes = kK7Threads / 2;

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

// ------------------------------------------------------------ phase probe
// Built only with K7_PHASE_STAMPS defined, into a library of its own
// (scripts/torch_k7_phases.py); the package's build never defines it, and
// then K7_STAMP is empty. Thread 0 of each CTA adds the clock64 cycles since
// its previous stamp to the slot of the phase that the stamp ends, in
// shared memory, and writes the slots to k7_cycles at the launch's end,
// with clock64 and %globaltimer at the launch's start and end (k7_span) to
// convert cycles to time.
#ifdef K7_PHASE_STAMPS
#define K7_PHASES(X)                                                                          \
  X(prologue) X(skip) K7_GRADIENT(X, s)                                                       \
  X(c1_sync) X(c1_reduce) X(c2_sync) X(next_read) X(c2_pull) X(c2_pull_sync)                  \
  K7_GRADIENT(X, q) X(c3_sync) X(c3_reduce) X(c4_sync) X(c4_pull) X(c4_pull_sync)             \
  X(r_h2_dots) X(r_h2) X(r_h2_sync) X(r_logits_h2) X(r_logits_softmax) X(r_logits_bcast)      \
  X(r_logits) X(r_logits_sync) X(r_grads_cdots) X(r_grads_cshfl) X(r_grads) X(r_grads_sync)   \
  X(r_back1) X(c5_sync) X(c5_reduce) X(c5_reduce_sync) X(c5_adam) X(c6_sync) X(c6_pull)       \
  X(c6_pull_sync) X(epilogue)
// a gradient's phases after h1 (which the pull before it computes), the
// support's (s) and the query's (q) in one order; those with a part name
// (_dots, ..) end inside the phase function
#define K7_GRADIENT(X, g)                                                                     \
  X(g##_h2_dots) X(g##_h2) X(g##_h2_sync) X(g##_logits_h2) X(g##_logits_softmax)              \
  X(g##_logits_bcast) X(g##_logits) X(g##_logits_sync) X(g##_grads_cdots) X(g##_grads_cshfl)  \
  X(g##_grads) X(g##_grads_sync) X(g##_back1)
#define K7_ENUM(n) kPhase_##n,
enum { K7_PHASES(K7_ENUM) kPhases };
#define K7_NAME(n) #n " "
constexpr int kProbeSlots = 96;
static_assert(kPhases <= kProbeSlots, "one slot a phase");
__device__ long long k7_cycles[kCluster][kProbeSlots];
__device__ long long k7_span[kCluster][4];
__shared__ long long k7_acc[kProbeSlots];
__shared__ long long k7_last;

__device__ __forceinline__ long long k7_globaltimer() {
  long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  return now;
}

// the first part slot of the phase function running now, or -1
__shared__ int k7_part;

__device__ __forceinline__ void k7_stamp(int phase) {
  if (threadIdx.x == 0) {
    const long long now = clock64();
    k7_acc[phase] += now - k7_last;
    k7_last = now;
  }
}

__device__ __forceinline__ void k7_probe_begin(int rank) {
  if (threadIdx.x == 0) {
    for (int p = 0; p < kProbeSlots; ++p) k7_acc[p] = 0;
    k7_span[rank][1] = k7_globaltimer();
    k7_part = -1;
    k7_span[rank][0] = k7_last = clock64();
  }
}

__device__ __forceinline__ void k7_probe_end(int rank) {
  if (threadIdx.x == 0) {
    k7_span[rank][2] = clock64();
    k7_span[rank][3] = k7_globaltimer();
    for (int p = 0; p < kProbeSlots; ++p) k7_cycles[rank][p] = k7_acc[p];
  }
}
#define K7_STAMP(phase) k7_stamp(phase)
// the phase function's part n ends here
#define K7_PART(n) \
  if (k7_part >= 0) k7_stamp(k7_part + (n))
// the next phase function's parts start at slot `phase` (-1: none)
#define K7_PARTS(phase) \
  if (threadIdx.x == 0) k7_part = (phase)
#else
#define K7_PART(n) \
  do {             \
  } while (0)
#define K7_PARTS(phase) \
  do {                  \
  } while (0)
#define K7_STAMP(phase) \
  do {                  \
  } while (0)
#endif

__device__ __forceinline__ const float4& f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ------------------------------------------------------------------ phases
// Each phase is run by every thread of the CTA over its tl columns and
// holds no barrier: the caller puts one between phases that depend.

// half h of rows j and j + 25 of A X (+ B Z) over the tl columns of X
// [t][100] (and Z), A, B [50][100]: the sum over k < kRowCut (h = 0) or
// over the rest (h = 1), into ZP[h][t][j] ([2][tl][50], which the
// logits phase adds up). A warp takes one half of kRowCols columns, lane
// j < 25 its two rows, so that every lane reads the same columns of X and
// its own rows of A
template <bool kTwo>
__device__ __forceinline__ void rows_halves(const float* A, const float* X, const float* B,
                                            const float* Z, int tl, float* ZP) {
  const int j = threadIdx.x & 31;
  const int groups = 2 * ((tl + kRowCols - 1) / kRowCols);
  if (j >= kHalf) return;
  for (int g = threadIdx.x / 32; g < groups; g += kK7Warps) {
    const int h = g & 1, c0 = g / 2 * kRowCols;
    int col[kRowCols];
#pragma unroll
    for (int c = 0; c < kRowCols; ++c) col[c] = min(c0 + c, tl - 1) * kH1;
    float lo[kRowCols], hi[kRowCols];
#pragma unroll
    for (int c = 0; c < kRowCols; ++c) lo[c] = hi[c] = 0.0f;
    const float* a0 = A + j * kH1;
    const float* a1 = a0 + kHalf * kH1;
    const float* b0 = B + j * kH1;
    const float* b1 = b0 + kHalf * kH1;
#pragma unroll 2
    for (int q = h * kRowCut; q < (h ? kH1 : kRowCut); q += 4) {
      const float4 u = f4(a0 + q), w = f4(a1 + q);
#pragma unroll
      for (int c = 0; c < kRowCols; ++c) {
        const float4 x = f4(X + col[c] + q);
        fma4(lo[c], u, x);
        fma4(hi[c], w, x);
      }
      if (kTwo) {
        const float4 bu = f4(b0 + q), bw = f4(b1 + q);
#pragma unroll
        for (int c = 0; c < kRowCols; ++c) {
          const float4 z = f4(Z + col[c] + q);
          fma4(lo[c], bu, z);
          fma4(hi[c], bw, z);
        }
      }
    }
    K7_PART(0);
    float* zp = ZP + h * tl * kH2;
#pragma unroll
    for (int c = 0; c < kRowCols; ++c) {
      if (c0 + c < tl) {
        zp[(c0 + c) * kH2 + j] = lo[c];
        zp[(c0 + c) * kH2 + j + kHalf] = hi[c];
      }
    }
  }
}

// a column on one warp: h2 = relu(W2 h1 + b2) from rows_halves' two halves
// ZP into H2, the logits W3 h2 + b3, lane s + S ks on logit s over every
// (32 / S)-th of the 50; the softmax's max and sum by shuffles:
// DL = (softmax - onehot) / n, with kKeep the softmax into PR, the column's
// CE into DL's slot S; then its backward into the relu layer, DZ2[t][j] =
// [h2 > 0] sum_s W3[s][j] DL[t][s], lanes on j
template <int S, bool kKeep>
__device__ void logits_back(const float* P, const float* ZP, float* H2, const int* label,
                            int tl, float n, float* PR, float* DL, float* DZ2) {
  using L = Layout<S>;
  constexpr int kLdl = L::kLdl, kParts = 32 / S;
  const int lane = threadIdx.x & 31, s = lane % S, ks = lane / S;
  const float* w = P + L::kW3 + s * kH2;
  for (int t = threadIdx.x / 32; t < tl; t += kK7Warps) {
    float* h = H2 + t * kLd2;
    for (int j = lane; j < kH2; j += 32) {
      h[j] = fmaxf(ZP[t * kH2 + j] + ZP[(tl + t) * kH2 + j] + P[L::kB2 + j], 0.0f);
    }
    __syncwarp();
    K7_PART(0);
    float acc = 0.0f, acc2 = 0.0f;  // (two chains)
#pragma unroll
    for (int it = 0; it < (kH2 + 2 * kParts - 1) / (2 * kParts); ++it) {
      const int j = ks + 2 * kParts * it;
      if (j < kH2) acc = fmaf(w[j], h[j], acc);
      if (j + kParts < kH2) acc2 = fmaf(w[j + kParts], h[j + kParts], acc2);
    }
    acc += acc2;
#pragma unroll
    for (int o = S; o < 32; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    const float logit = acc + P[L::kB3 + s];
    float mx = logit;
#pragma unroll
    for (int o = S / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float e = expf(logit - mx);
    float sum = e;
#pragma unroll
    for (int o = S / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float p = __fdiv_rn(e, sum);
    const bool hit = s == label[t];
    const float dl = __fdiv_rn(p - (hit ? 1.0f : 0.0f), n);
    if (ks == 0) {
      DL[t * kLdl + s] = dl;
      if (kKeep) PR[t * kLdl + s] = p;
      if (hit) DL[t * kLdl + S] = (mx + logf(sum)) - logit;
    }
    K7_PART(1);
    float d[S];
#pragma unroll
    for (int r = 0; r < S; ++r) d[r] = __shfl_sync(0xffffffffu, dl, r);
    K7_PART(2);
#pragma unroll
    for (int j = lane; j < lane + 64; j += 32) {
      if (j < kH2) {
        float e2 = 0.0f;
#pragma unroll
        for (int r = 0; r < S; ++r) e2 = fmaf(P[L::kW3 + r * kH2 + j], d[r], e2);
        DZ2[t * kLd2 + j] = h[j] > 0.0f ? e2 : 0.0f;
      }
    }
  }
}

// a column of the R pass on one warp as logits_back's: R h2 = [h2 > 0] (V_W2
// h1 + W2 R h1 + v_b2) from rows_halves' two halves ZP into RH2, the logits
// R z3 = V_W3 h2 + W3 R h2 + v_b3, RDL = p (R z3 - <p, R z3>) / n with p the support's
// softmax PR; then RDZ2[t][j] = [h2 > 0] sum_s (W3[s][j] RDL[t][s] +
// V_W3[s][j] DL[t][s])
template <int S>
__device__ void r_logits_back(const float* P, const float* V, const float* H2, const float* ZP,
                              float* RH2, const float* PR, const float* DL, int tl, float n,
                              float* RDL, float* RDZ2) {
  using L = Layout<S>;
  constexpr int kLdl = L::kLdl, kParts = 32 / S;
  const int lane = threadIdx.x & 31, s = lane % S, ks = lane / S;
  const float* vw = V + L::kW3 + s * kH2;
  const float* w = P + L::kW3 + s * kH2;
  for (int t = threadIdx.x / 32; t < tl; t += kK7Warps) {
    const float* h = H2 + t * kLd2;
    float* rh = RH2 + t * kLd2;
    for (int j = lane; j < kH2; j += 32) {
      rh[j] = h[j] > 0.0f ? ZP[t * kH2 + j] + ZP[(tl + t) * kH2 + j] + V[L::kB2 + j] : 0.0f;
    }
    __syncwarp();
    K7_PART(0);
    float acc = 0.0f, acc2 = 0.0f;  // (two chains)
#pragma unroll
    for (int it = 0; it < (kH2 + 2 * kParts - 1) / (2 * kParts); ++it) {
      const int j = ks + 2 * kParts * it;
      if (j < kH2) acc = fmaf(w[j], rh[j], fmaf(vw[j], h[j], acc));
      if (j + kParts < kH2) {
        acc2 = fmaf(w[j + kParts], rh[j + kParts], fmaf(vw[j + kParts], h[j + kParts], acc2));
      }
    }
    acc += acc2;
#pragma unroll
    for (int o = S; o < 32; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    const float rz = acc + V[L::kB3 + s];
    const float p = PR[t * kLdl + s];
    float dot = p * rz;
#pragma unroll
    for (int o = S / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
    const float rdl = __fdiv_rn(p * (rz - dot), n);
    if (ks == 0) RDL[t * kLdl + s] = rdl;
    const float dl = DL[t * kLdl + s];
    K7_PART(1);
    float rd[S], d[S];
#pragma unroll
    for (int r = 0; r < S; ++r) {
      rd[r] = __shfl_sync(0xffffffffu, rdl, r);
      d[r] = __shfl_sync(0xffffffffu, dl, r);
    }
    K7_PART(2);
#pragma unroll
    for (int j = lane; j < lane + 64; j += 32) {
      if (j < kH2) {
        float e2 = 0.0f;
#pragma unroll
        for (int r = 0; r < S; ++r) {
          e2 = fmaf(P[L::kW3 + r * kH2 + j], rd[r], e2);
          e2 = fmaf(V[L::kW3 + r * kH2 + j], d[r], e2);
        }
        RDZ2[t * kLd2 + j] = h[j] > 0.0f ? e2 : 0.0f;
      }
    }
  }
}

// one phase over the tl columns: the partial gradient of the last two
// layers into G,
//   W2: sum_t Da[t][j] Xa[t][k] (+ Db[t][j] Xb[t][k]), b2: sum_t Da[t][j],
//   W3: sum_t La[t][s] Ha[t][j] (+ Lb[t][s] Hb[t][j]), b3: sum_t La[t][s],
// and the backward into the hidden layer, sum_j Wa[j][k] Ea[t][j] (+ Wb[j][k]
// Eb[t][j]) for four hidden units 4 kq.. of a column, to cols(t, kq, sum):
// tiles of kColCols columns on kColSplit lanes, each over every
// kColSplit-th j, their parts added by shuffles. Wa, Wb [50][100]; Da, Db,
// Ea, Eb, Ha, Hb [t][52]; Xa, Xb [t][100]; La, Lb [t][S + 1]
template <int S, bool kTwo, typename Cols>
__device__ void weight_grads(const float* Wa, const float* Ea, const float* Wb, const float* Eb,
                             const float* Da, const float* Xa, const float* Db, const float* Xb,
                             const float* La, const float* Ha, const float* Lb, const float* Hb,
                             int tl, float* G, Cols cols) {
  using L = Layout<S>;
  constexpr int kLdl = L::kLdl;
  // the W2^T products' tiles by warp: lanes l and l + 8, l + 16, l + 24 split
  // tile 8 w + l's sums, so that a quarter-warp reads eight quads of one row
  const int tiles = kQuads * ((tl + kColCols - 1) / kColCols);
  const int n_cols = 32 * ((tiles + 7) / 8);
  const int n_w2 = n_cols + kGradTiles, n_w3 = n_w2 + S * kW3Quads;
  const int total = n_w3 + S + kH2;
  const int lane = threadIdx.x & 31;
  static_assert(kColSplit == 4 && kK7Threads % 32 == 0, "four lanes 8 apart a tile");
  for (int i = threadIdx.x; i < total; i += kK7Threads) {
    if (i < n_cols) {
      const int jl = lane / 8, tile = i / 32 * 8 + lane % 8;
      const int kq = tile % kQuads, c0 = tile < tiles ? tile / kQuads * kColCols : tl;
      const unsigned group = 0x01010101u << (lane % 8);
      int col[kColCols];
#pragma unroll
      for (int c = 0; c < kColCols; ++c) col[c] = max(min(c0 + c, tl - 1), 0) * kLd2;
      float4 acc[kColCols];
#pragma unroll
      for (int c = 0; c < kColCols; ++c) acc[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int j = jl; j < kH2; j += kColSplit) {
        const float4 wa = f4(Wa + j * kH1 + 4 * kq);
#pragma unroll
        for (int c = 0; c < kColCols; ++c) fma4(acc[c], wa, Ea[col[c] + j]);
        if (kTwo) {
          const float4 wb = f4(Wb + j * kH1 + 4 * kq);
#pragma unroll
          for (int c = 0; c < kColCols; ++c) fma4(acc[c], wb, Eb[col[c] + j]);
        }
      }
      K7_PART(0);
#pragma unroll
      for (int o = 8; o < 32; o <<= 1) {
#pragma unroll
        for (int c = 0; c < kColCols; ++c) {
          acc[c].x += __shfl_xor_sync(group, acc[c].x, o);
          acc[c].y += __shfl_xor_sync(group, acc[c].y, o);
          acc[c].z += __shfl_xor_sync(group, acc[c].z, o);
          acc[c].w += __shfl_xor_sync(group, acc[c].w, o);
        }
      }
      K7_PART(1);
#pragma unroll
      for (int c = 0; c < kColCols; ++c) {
        if (c % kColSplit == jl && c0 + c < tl) cols(c0 + c, kq, acc[c]);
      }
    } else if (i < n_w2) {
      // a tile of kGradRows rows x 4 columns of the W2 gradient
      const int tile = i - n_cols, jg = tile / kQuads, kq = tile - jg * kQuads;
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
    } else if (i < n_w3) {
      // entries 4 jq.. of row s of the W3 gradient (the [t][52] rows' pad
      // gives a fourth lane to the last group, not stored)
      const int e = i - n_w2, s = e / kW3Quads, jq = e - s * kW3Quads;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int t = 0; t < tl; ++t) {
        fma4(acc, f4(Ha + t * kLd2 + 4 * jq), La[t * kLdl + s]);
        if (kTwo) fma4(acc, f4(Hb + t * kLd2 + 4 * jq), Lb[t * kLdl + s]);
      }
      float* g = G + L::kW3 + s * kH2 + 4 * jq;
      g[0] = acc.x;
      g[1] = acc.y;
      if (4 * jq + 2 < kH2) {
        g[2] = acc.z;
        g[3] = acc.w;
      }
    } else if (i < n_w3 + S) {
      const int s = i - n_w3;
      float acc = 0.0f;
      for (int t = 0; t < tl; ++t) acc += La[t * kLdl + s];
      G[L::kB3 + s] = acc;
    } else {
      const int j = i - n_w3 - S;
      float acc = 0.0f;
      for (int t = 0; t < tl; ++t) acc += Da[t * kLd2 + j];
      G[L::kB2 + j] = acc;
    }
  }
}

// the partial gradient's w1 and b1: sum_t d y and sum_t d, with d = D[t][k]
// h1 (1 - h1), the backward through the sigmoid, or, without H1, D[t][k]
template <int S>
__device__ void back1(const float* D, const float* H1, const float* Y, int tl, float* G) {
  using L = Layout<S>;
  for (int k = threadIdx.x; k < kH1; k += kK7Threads) {
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
// into G, from its h1 in H1: the forward into H2 and DL (PR, the softmax,
// with kKeep), the backward through DZ2 and DH1 (W2^T dz2, before the
// sigmoid's derivative)
template <int S, bool kKeep>
__device__ void gradient(const float* P, const float* Y, const int* label, int tl, float n,
                         const float* H1, float* H2, float* PR, float* DL, float* DZ2,
                         float* DH1, float* G) {
  using L = Layout<S>;
#ifdef K7_PHASE_STAMPS
  const int at = kKeep ? kPhase_s_h2_dots : kPhase_q_h2_dots;
#endif
  K7_PARTS(at);
  rows_halves<false>(P + L::kW2, H1, nullptr, nullptr, tl, DH1);  // (DH1 is free until
  K7_STAMP(at + 1);                                                  // weight_grads)
  __syncthreads();
  K7_STAMP(at + 2);
  K7_PARTS(at + 3);
  logits_back<S, kKeep>(P, DH1, H2, label, tl, n, PR, DL, DZ2);
  K7_STAMP(at + 6);
  __syncthreads();
  K7_STAMP(at + 7);
  K7_PARTS(at + 8);
  weight_grads<S, false>(P + L::kW2, DZ2, nullptr, nullptr, DZ2, H1, nullptr, nullptr, DL, H2,
                         nullptr, nullptr, tl, G, [=](int t, int kq, const float4& d) {
                           *reinterpret_cast<float4*>(DH1 + t * kH1 + 4 * kq) = d;
                         });
  K7_PARTS(-1);
  K7_STAMP(at + 10);
  __syncthreads();
  K7_STAMP(at + 11);
  back1<S>(DH1, H1, Y, tl, G);
  K7_STAMP(at + 12);
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

// read the other CTAs' slices of the copy X from their owners' copies, and
// meanwhile the first layer of the tl columns Y at X into H1: h1 =
// sigmoid(w1 y + b1), or with kR (the R pass, X the direction) R h1 = h1 (1
// - h1) (w1 y + b1) from the support's h1 in H1R. w1 and b1 lie in rank 0's
// slice, the first kFirst quads: the threads that pull those store them
// first, and after a barrier every thread computes its share of the layer
// while the rest of the pulls are in flight
template <int S, bool kR>
__device__ void pull_hidden1(cg::cluster_group& cluster, float* X, int rank, const float* Y,
                             int tl, const float* H1R, float* H1) {
  using L = Layout<S>;
  constexpr int kPulls = (L::kPadded / 4 + kK7Threads - 1) / kK7Threads;
  constexpr int kFirst = (L::kB1 + kH1) / 4;
  static_assert(kSlice<S> >= 4 * kFirst && kFirst <= kK7Threads, "w1 and b1: rank 0's");
  float4 got[kPulls];
#pragma unroll
  for (int r = 0; r < kPulls; ++r) {
    const int i = 4 * (threadIdx.x + r * kK7Threads), from = i / kSlice<S>;
    if (i < L::kPadded && from != rank) got[r] = f4(cluster.map_shared_rank(X, from) + i);
  }
  if (rank != 0 && threadIdx.x < kFirst) *reinterpret_cast<float4*>(X + 4 * threadIdx.x) = got[0];
  __syncthreads();
  for (int h = threadIdx.x; h < tl * kH1; h += kK7Threads) {
    const int t = h / kH1, k = h - t * kH1;
    const float z = X[L::kW1 + k] * Y[t] + X[L::kB1 + k];
    if (kR) {
      const float h1 = H1R[h];
      H1[h] = (h1 * (1.0f - h1)) * z;
    } else {
      H1[h] = __fdiv_rn(1.0f, 1.0f + expf(-z));
    }
  }
#pragma unroll
  for (int r = 0; r < kPulls; ++r) {
    const int i = 4 * (threadIdx.x + r * kK7Threads), from = i / kSlice<S>;
    if (i < L::kPadded && from != rank && i >= 4 * kFirst) {
      *reinterpret_cast<float4*>(X + i) = got[r];
    }
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

// the first pair at or after `from` whose take[] holds, or a.chunk: each
// warp reads take[] 32 at a time, the same answer in every thread
__device__ int next_taken(const Args& a, int from) {
  const int lane = threadIdx.x & 31;
  for (int base = from; base < a.chunk; base += 32) {
    const unsigned hits =
        __ballot_sync(0xffffffffu, base + lane < a.chunk && a.take[base + lane]);
    if (hits != 0u) return base + __ffs(hits) - 1;
  }
  return a.chunk;
}

// copy pair i's samples and labels of this CTA's columns into YS, LS, YQ
// and LQ, asynchronously: threads 0.. the support's, kRowLanes.. the
// query's; each thread waits for its copies (__pipeline_wait_prior) before
// the barrier after which they are read
__device__ __forceinline__ void copy_rows(const Args& a, int i, int rank, int cs, int cq, int ts,
                                          int tq, float* YS, int* LS, float* YQ, int* LQ) {
  const int tid = threadIdx.x, t = tid - kRowLanes;
  if (tid < ts) {
    const int o = i * a.n_s + rank * cs + tid;
    __pipeline_memcpy_async(YS + tid, a.s_rx + o, sizeof(float));
    __pipeline_memcpy_async(LS + tid, a.s_states + o, sizeof(int));
  } else if (t >= 0 && t < tq) {
    const int o = i * a.n_q + rank * cq + t;
    __pipeline_memcpy_async(YQ + t, a.q_rx + o, sizeof(float));
    __pipeline_memcpy_async(LQ + t, a.q_states + o, sizeof(int));
  }
  __pipeline_commit();
}

// the pair after i whose take[] holds, from taken_ahead (take[] of the 32
// after i, one a lane) or, past those, take[] itself; its rows copied into
// YS, LS, YQ and LQ, whose current pair no longer reads them
__device__ __forceinline__ int next_pair(const Args& a, int i, int taken_ahead, int rank, int cs,
                                         int cq, int ts, int tq, float* YS, int* LS, float* YQ,
                                         int* LQ) {
  const unsigned hits = __ballot_sync(0xffffffffu, taken_ahead != 0);
  const int next = hits != 0u ? i + __ffs(hits) : next_taken(a, min(i + 33, a.chunk));
  if (next < a.chunk) copy_rows(a, next, rank, cs, cq, ts, tq, YS, LS, YQ, LQ);
  return next;
}

// the bias-correction factors of Adam's step at the count (the factors
// table's last row past its end)
__device__ __forceinline__ void bias_correction(const Args& a, int count, float& bc0,
                                                float& bc1) {
  const int row = min(count, a.n_rows - 1);
  bc0 = a.table[2 * row];
  bc1 = a.table[2 * row + 1];
}

template <int S>
__global__ void __launch_bounds__(kK7Threads, 1) maml_pairs_kernel(const Args a) {
  using L = Layout<S>;
  constexpr int kLdl = L::kLdl;
  static_assert(kSlice<S> <= kK7Threads, "one parameter of the slice per thread");

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

  // this CTA's slice: its quad owners (tid < len / 4) sum the slice's
  // partials; Adam runs on one parameter a thread (tid < len), whose
  // moments stay in registers over the whole chunk
  const int lo = rank * kSlice<S>, len = slice_len<S>(rank);
  const bool owner = 4 * tid < len, mine = tid < len && lo + tid < L::kCount;
  const int quad = lo + 4 * tid;  // first parameter of an owner's quad
  const int e = lo + tid;         // the parameter whose Adam step this thread takes
  // the thread that adds the query's CE to the loss: on rank 0, past the slice
  const bool loss_thread = rank == 0 && tid == kK7Threads - 1;
  float m = 0.0f, v = 0.0f;
  if (mine) {
    m = *element<S>(a.mu, e);
    v = *element<S>(a.nu, e);
  }
  for (int i = tid; i < L::kPadded; i += kK7Threads) {
    P[i] = i < L::kCount ? *element<S>(a.params, i) : 0.0f;
    Q[i] = 0.0f;
    V[i] = 0.0f;
    G[i] = 0.0f;  // (the pad stays 0: no phase writes it)
  }
  if (tid == 0) G[L::kPadded] = 0.0f;
  int count = *a.count;
  float loss = loss_thread ? *a.loss : 0.0f;
  int i = next_taken(a, 0);
  if (i < a.chunk) copy_rows(a, i, rank, cs, cq, ts, tq, YS, LS, YQ, LQ);
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int h = tid; h < ts * kH1; h += kK7Threads) {  // the first pair's h1
    const int t = h / kH1, k = h - t * kH1;
    H1[h] = __fdiv_rn(1.0f, 1.0f + expf(-(P[L::kW1 + k] * YS[t] + P[L::kB1 + k])));
  }
  __syncthreads();
#ifdef K7_PHASE_STAMPS
  k7_probe_begin(rank);
#endif
  K7_STAMP(kPhase_prologue);

  while (i < a.chunk) {  // every thread of the cluster alike; h1 of the support is in H1
    // take[] of the 32 pairs after this one, read now and tested at the
    // pair's last exchange (as a byte: a test now would wait for it)
    const int ahead = i + 1 + (tid & 31);
    const int taken_ahead =
        ahead < a.chunk ? reinterpret_cast<const unsigned char*>(a.take)[ahead] : 0;
    K7_STAMP(kPhase_skip);

    // ---- 1. the support's gradient at theta ----
    gradient<S, true>(P, YS, LS, ts, ns, H1, H2, PR, DL, DZ2, DH1, G);
    cluster.sync();  // every partial g_s is written
    K7_STAMP(kPhase_c1_sync);
    // ---- 2. theta' = theta - meta_lr g_s on my slice ----
    if (owner) {
      const float4 g = reduce_quad(cluster, G, quad);
      const float gs[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) Q[quad + c] = __fsub_rn(P[quad + c], __fmul_rn(a.meta_lr, gs[c]));
    }
    K7_STAMP(kPhase_c1_reduce);
    // every slice of theta' is in its owner's copy, and no owner still reads
    // a partial that the query overwrites
    cluster.sync();
    K7_STAMP(kPhase_c2_sync);
    pull_hidden1<S, false>(cluster, Q, rank, YQ, tq, nullptr, A1);
    K7_STAMP(kPhase_c2_pull);
    __syncthreads();
    K7_STAMP(kPhase_c2_pull_sync);

    // ---- 3. the query's gradient at theta', and its CE ----
    gradient<S, false>(Q, YQ, LQ, tq, nq, A1, A2, nullptr, AL, AD2, AD1, G);
    if (tid == kK7Threads - 1) {  // (a thread past back1's hidden units)
      float ce = 0.0f;
      for (int t = 0; t < tq; ++t) ce += AL[t * kLdl + S];
      G[L::kPadded] = ce;
    }
    cluster.sync();  // every partial g_q and CE is written
    K7_STAMP(kPhase_c3_sync);
    int next = a.chunk;
    float bc0 = 0.0f, bc1 = 0.0f;
    if (!a.second_order) {
      next = next_pair(a, i, taken_ahead, rank, cs, cq, ts, tq, YS, LS, YQ, LQ);
      if (tid < len) bias_correction(a, count, bc0, bc1);
    }
    if (owner) {
      const float4 g = reduce_quad(cluster, G, quad);
      // second order: the direction g_q; first order: g_q for Adam
      *reinterpret_cast<float4*>((a.second_order ? V : G) + quad) = g;
    }
    if (loss_thread) {
      float ce = 0.0f;
      for (int r = 0; r < kCluster; ++r) ce += cluster.map_shared_rank(G, r)[L::kPadded];
      loss = __fadd_rn(loss, __fdiv_rn(ce, nq));
    }
    K7_STAMP(kPhase_c3_reduce);
    if (!a.second_order) {
      __syncthreads();  // the slice's g_q in G
      if (tid < len) P[e] = adam(a, m, v, P[e], G[e], bc0, bc1);
      ++count;
      __pipeline_wait_prior(0);  // the next pair's rows
      cluster.sync();
      pull_hidden1<S, false>(cluster, P, rank, YS, ts, nullptr, H1);
      __syncthreads();
      i = next;
      continue;
    }
    cluster.sync();
    K7_STAMP(kPhase_c4_sync);
    pull_hidden1<S, true>(cluster, V, rank, YS, ts, H1, A1);  // R h1 into A1
    K7_STAMP(kPhase_c4_pull);
    __syncthreads();
    K7_STAMP(kPhase_c4_pull_sync);

    // ---- 4. H_s g_q at theta, forward over reverse through the support's
    // activations: R h1 in A1, R h2 into A2, R dlogits into AL, R dz2 into
    // AD2, then R dz1 into AD1 ----
    K7_PARTS(kPhase_r_h2_dots);
    rows_halves<true>(V + L::kW2, H1, P + L::kW2, A1, ts, AD1);  // (AD1: free until R dz1)
    K7_STAMP(kPhase_r_h2);
    __syncthreads();
    K7_STAMP(kPhase_r_h2_sync);
    K7_PARTS(kPhase_r_logits_h2);
    r_logits_back<S>(P, V, H2, AD1, A2, PR, DL, ts, ns, AL, AD2);
    K7_STAMP(kPhase_r_logits);
    __syncthreads();
    K7_STAMP(kPhase_r_logits_sync);
    K7_PARTS(kPhase_r_grads_cdots);
    weight_grads<S, true>(
        V + L::kW2, DZ2, P + L::kW2, AD2, AD2, H1, DZ2, A1, AL, H2, DL, A2, ts, G,
        [=](int t, int kq, const float4& acc) {
          const int o = t * kH1 + 4 * kq;
          const float4 r = f4(A1 + o), h = f4(H1 + o), d = f4(DH1 + o);
          float4 out;
          out.x = acc.x * (h.x * (1.0f - h.x)) + d.x * (r.x * (1.0f - 2.0f * h.x));
          out.y = acc.y * (h.y * (1.0f - h.y)) + d.y * (r.y * (1.0f - 2.0f * h.y));
          out.z = acc.z * (h.z * (1.0f - h.z)) + d.z * (r.z * (1.0f - 2.0f * h.z));
          out.w = acc.w * (h.w * (1.0f - h.w)) + d.w * (r.w * (1.0f - 2.0f * h.w));
          *reinterpret_cast<float4*>(AD1 + o) = out;
        });
    K7_PARTS(-1);
    K7_STAMP(kPhase_r_grads);
    __syncthreads();
    K7_STAMP(kPhase_r_grads_sync);
    back1<S>(AD1, nullptr, YS, ts, G);
    K7_STAMP(kPhase_r_back1);
    cluster.sync();  // every partial H_s g_q is written
    K7_STAMP(kPhase_c5_sync);
    next = next_pair(a, i, taken_ahead, rank, cs, cq, ts, tq, YS, LS, YQ, LQ);
    if (tid < len) bias_correction(a, count, bc0, bc1);
    K7_STAMP(kPhase_next_read);

    // ---- 5. Adam on g_q - meta_lr H_s g_q ----
    if (owner) *reinterpret_cast<float4*>(G + quad) = reduce_quad(cluster, G, quad);
    K7_STAMP(kPhase_c5_reduce);
    __syncthreads();  // the slice's H_s g_q in G
    K7_STAMP(kPhase_c5_reduce_sync);
    if (tid < len) {
      const float meta = __fsub_rn(V[e], __fmul_rn(a.meta_lr, G[e]));
      P[e] = adam(a, m, v, P[e], meta, bc0, bc1);
    }
    ++count;
    __pipeline_wait_prior(0);  // the next pair's rows
    K7_STAMP(kPhase_c5_adam);
    cluster.sync();
    K7_STAMP(kPhase_c6_sync);
    pull_hidden1<S, false>(cluster, P, rank, YS, ts, nullptr, H1);  // the next pair's h1
    K7_STAMP(kPhase_c6_pull);
    __syncthreads();
    K7_STAMP(kPhase_c6_pull_sync);
    i = next;
  }
  cluster.sync();  // no peer still reads this CTA's copies
  K7_STAMP(kPhase_epilogue);
#ifdef K7_PHASE_STAMPS
  k7_probe_end(rank);
#endif

  if (mine) {
    *element<S>(a.params, e) = P[e];
    *element<S>(a.mu, e) = m;
    *element<S>(a.nu, e) = v;
  }
  if (rank == 0 && tid == 0) *a.count = count;
  if (loss_thread) *a.loss = loss;
}

// the kernel's attributes, set once before its first launch (so not while a
// CUDA graph captures one)
template <int S>
cudaError_t configure() {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, maml_pairs_kernel<S>);
  if (err != cudaSuccess) return err;
  // (the static shared memory is the phase probe's slots, or none)
  err = cudaFuncSetAttribute(maml_pairs_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmemBytes - static_cast<int>(attr.sharedSizeBytes));
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
  config.blockDim = dim3(kK7Threads);
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

#ifdef K7_PHASE_STAMPS
// the probe's phase names, in slot order, and its slots of the last launch:
// cycles [kCluster][kProbeSlots] then span [kCluster][4], as int64
extern "C" const char* k7_phase_names() { return K7_PHASES(K7_NAME); }

extern "C" int k7_phase_cycles(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k7_cycles, sizeof(k7_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaMemcpyFromSymbol(out + kCluster * kProbeSlots, k7_span,
                                               sizeof(k7_span)));
}
#endif
