// Fused online adaptation of ViterbiNet: n Adam steps of cross-entropy over
// the trellis states of one word, in one launch.
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
// HIGHEST precision).
//
// What bounds it on an H100: operations, about 36,300 T f32 operations per
// step for the products, softmax and backward. But the steps are sequential
// and one step's work is small (0.66 M FMAs per product at T = 136), so this
// first version runs the whole loop in ONE thread block on one SM: it can
// reach at most 1/132 of the card's f32 rate. Spreading the products over a
// cluster of SMs is later work.
// What the design does about it: the parameters, the gradients and every
// activation stay in shared memory for all n steps (about 168 KB at T = 136,
// S = 16); only y, the states, the parameters and the moments are read once
// and written once. Each of the 1024 threads owns a fixed slice of at most 6
// parameters for Adam, so that slice's two moments stay in registers across
// all n steps. Phases are separated by __syncthreads(). Activation rows have
// an odd stride, so that a warp reading down a column hits 32 banks.
//
// Rounding: the products are f32 FMAs and sum in another order than the
// plain version; nvcc also contracts a*b+c. The result is held to a
// tolerance, not bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kH1 = 100;
constexpr int kH2 = 50;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

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
  static constexpr int kPerThread = (kCount + kThreads - 1) / kThreads;
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__host__ __device__ constexpr int row_stride(int T) { return T | 1; }

// shared memory of one launch, in floats (kernels/online_sgd.py::smem_bytes
// computes the same to refuse what a block cannot hold)
template <int S>
__host__ __device__ constexpr long smem_floats(int T) {
  return 2L * Layout<S>::kCount + 2L * T + static_cast<long>(kH1 + kH2 + S + kH2) * row_stride(T);
}

template <int S>
__global__ void __launch_bounds__(kThreads)
online_adapt_kernel(const float* __restrict__ y, const int* __restrict__ states,
                    Tensors params, Tensors mu, Tensors nu, int T, int n_iters, float lr,
                    float b1, float b2, float omb1, float omb2, float eps, float inv_t,
                    float pow1, float pow2) {
  using L = Layout<S>;
  extern __shared__ float smem[];
  const int ld = row_stride(T);
  float* P = smem;                                   // parameters, flat
  float* G = P + L::kCount;                          // gradients, flat
  float* Y = G + L::kCount;                          // [T]
  int* label = reinterpret_cast<int*>(Y + T);        // [T]
  float* H1 = reinterpret_cast<float*>(label + T);   // [100][ld] h1, then dz1
  float* H2 = H1 + kH1 * ld;                         // [50][ld] relu(z2)
  float* LG = H2 + kH2 * ld;                         // [S][ld] logits, then dlogits
  float* DZ2 = LG + S * ld;                          // [50][ld]
  const float* W1 = P + L::kW1;
  const float* B1 = P + L::kB1;
  const float* W2 = P + L::kW2;
  const float* B2 = P + L::kB2;
  const float* W3 = P + L::kW3;
  const float* B3 = P + L::kB3;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float m[L::kPerThread], v[L::kPerThread];
#pragma unroll
  for (int r = 0; r < L::kPerThread; ++r) {
    const int i = tid + r * kThreads;
    if (i < L::kCount) {
      P[i] = *element<S>(params, i);
      m[r] = *element<S>(mu, i);
      v[r] = *element<S>(nu, i);
    }
  }
  for (int t = tid; t < T; t += kThreads) {
    Y[t] = y[t];
    label[t] = states[t];
  }
  __syncthreads();

  for (int it = 0; it < n_iters; ++it) {
    pow1 *= b1;
    pow2 *= b2;
    const float c1 = 1.0f - pow1, c2 = 1.0f - pow2;

    // ---- forward ----
    for (int o = tid; o < kH1 * T; o += kThreads) {
      const int k = o / T, t = o - k * T;
      H1[k * ld + t] = 1.0f / (1.0f + expf(-(W1[k] * Y[t] + B1[k])));
    }
    __syncthreads();
    for (int o = tid; o < kH2 * T; o += kThreads) {
      const int j = o / T, t = o - j * T;
      const float* w = W2 + j * kH1;
      float acc = 0.0f;
      for (int k = 0; k < kH1; ++k) acc = fmaf(w[k], H1[k * ld + t], acc);
      H2[j * ld + t] = fmaxf(acc + B2[j], 0.0f);
    }
    __syncthreads();
    for (int o = tid; o < S * T; o += kThreads) {
      const int s = o / T, t = o - s * T;
      const float* w = W3 + s * kH2;
      float acc = 0.0f;
#pragma unroll 10
      for (int j = 0; j < kH2; ++j) acc = fmaf(w[j], H2[j * ld + t], acc);
      LG[s * ld + t] = acc + B3[s];
    }
    __syncthreads();

    // ---- cross-entropy: dlogits = (softmax - onehot) / T, in place ----
    for (int t = tid; t < T; t += kThreads) {
      float mx = LG[t];
#pragma unroll
      for (int s = 1; s < S; ++s) mx = fmaxf(mx, LG[s * ld + t]);
      float e[S];
      float sum = 0.0f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        e[s] = expf(LG[s * ld + t] - mx);
        sum += e[s];
      }
      const int lab = label[t];
#pragma unroll
      for (int s = 0; s < S; ++s) LG[s * ld + t] = (e[s] / sum - (s == lab ? 1.0f : 0.0f)) * inv_t;
    }
    __syncthreads();

    // ---- backward: dW3, db3 and dz2 = [z2 > 0] W3^T dlogits ----
    for (int o = tid; o < S * kH2; o += kThreads) {
      const int s = o / kH2, j = o - s * kH2;
      float acc = 0.0f;
      for (int t = 0; t < T; ++t) acc = fmaf(LG[s * ld + t], H2[j * ld + t], acc);
      G[L::kW3 + o] = acc;
    }
    for (int s = warp; s < S; s += kWarps) {
      float acc = 0.0f;
      for (int t = lane; t < T; t += 32) acc += LG[s * ld + t];
      acc = warp_sum(acc);
      if (lane == 0) G[L::kB3 + s] = acc;
    }
    for (int o = tid; o < kH2 * T; o += kThreads) {
      const int j = o / T, t = o - j * T;
      float acc = 0.0f;
#pragma unroll
      for (int s = 0; s < S; ++s) acc = fmaf(W3[s * kH2 + j], LG[s * ld + t], acc);
      DZ2[j * ld + t] = H2[j * ld + t] > 0.0f ? acc : 0.0f;
    }
    __syncthreads();

    // ---- dW2 = dz2 h1^T, db2 ----
    for (int o = tid; o < kH2 * kH1; o += kThreads) {
      const int j = o / kH1, k = o - j * kH1;
      float acc = 0.0f;
      for (int t = 0; t < T; ++t) acc = fmaf(DZ2[j * ld + t], H1[k * ld + t], acc);
      G[L::kW2 + o] = acc;
    }
    for (int j = warp; j < kH2; j += kWarps) {
      float acc = 0.0f;
      for (int t = lane; t < T; t += 32) acc += DZ2[j * ld + t];
      acc = warp_sum(acc);
      if (lane == 0) G[L::kB2 + j] = acc;
    }
    __syncthreads();

    // ---- dz1 = (W2^T dz2) h1 (1 - h1), over h1 in place ----
    for (int o = tid; o < kH1 * T; o += kThreads) {
      const int k = o / T, t = o - k * T;
      float acc = 0.0f;
#pragma unroll 10
      for (int j = 0; j < kH2; ++j) acc = fmaf(W2[j * kH1 + k], DZ2[j * ld + t], acc);
      const float h = H1[k * ld + t];
      H1[k * ld + t] = acc * h * (1.0f - h);
    }
    __syncthreads();

    // ---- dw1 = sum_t dz1 y, db1 = sum_t dz1 ----
    for (int k = warp; k < kH1; k += kWarps) {
      float dw = 0.0f, db = 0.0f;
      for (int t = lane; t < T; t += 32) {
        const float d = H1[k * ld + t];
        dw = fmaf(d, Y[t], dw);
        db += d;
      }
      dw = warp_sum(dw);
      db = warp_sum(db);
      if (lane == 0) {
        G[L::kW1 + k] = dw;
        G[L::kB1 + k] = db;
      }
    }
    __syncthreads();

    // ---- Adam, each thread on its own slice ----
#pragma unroll
    for (int r = 0; r < L::kPerThread; ++r) {
      const int i = tid + r * kThreads;
      if (i < L::kCount) {
        const float g = G[i];
        m[r] = b1 * m[r] + omb1 * g;
        v[r] = b2 * v[r] + omb2 * g * g;
        P[i] = P[i] - lr * (m[r] / c1) / (sqrtf(v[r] / c2) + eps);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < L::kPerThread; ++r) {
    const int i = tid + r * kThreads;
    if (i < L::kCount) {
      *element<S>(params, i) = P[i];
      *element<S>(mu, i) = m[r];
      *element<S>(nu, i) = v[r];
    }
  }
}

constexpr int kMaxSmemBytes = 232448;  // what one block may use on an H100

template <int S>
cudaError_t launch(const float* y, const int* states, const Tensors& params, const Tensors& mu,
                   const Tensors& nu, int T, int n_iters, float lr, float b1, float b2,
                   float omb1, float omb2, float eps, float inv_t, float pow1, float pow2,
                   cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats<S>(T);
  if (bytes > kMaxSmemBytes) return cudaErrorInvalidValue;
  // raise the kernel's dynamic shared memory limit once, before any launch
  // (so not while a CUDA graph captures one)
  static const cudaError_t configured = cudaFuncSetAttribute(
      online_adapt_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (configured != cudaSuccess) return configured;
  online_adapt_kernel<S><<<1, kThreads, bytes, stream>>>(y, states, params, mu, nu, T, n_iters,
                                                         lr, b1, b2, omb1, omb2, eps, inv_t,
                                                         pow1, pow2);
  return cudaGetLastError();
}

}  // namespace

// y [T] f32, states [T] int32; p_*, m_*, v_* the parameters and their two
// Adam moments, each six f32 tensors (w1 [100, 1], b1 [100], w2 [50, 100],
// b2 [50], w3 [S, 50], b3 [S]), contiguous, on the current device, updated
// in place. pow1, pow2 are b1^count and b2^count before the first step.
// Returns the CUDA error of the launch (0 on success).
extern "C" int online_adapt(const float* y, const int* states, float* p_w1, float* p_b1,
                            float* p_w2, float* p_b2, float* p_w3, float* p_b3, float* m_w1,
                            float* m_b1, float* m_w2, float* m_b2, float* m_w3, float* m_b3,
                            float* v_w1, float* v_b1, float* v_w2, float* v_b2, float* v_w3,
                            float* v_b3, int T, int S, int n_iters, float lr, float b1, float b2,
                            float omb1, float omb2, float eps, float inv_t, float pow1, float pow2,
                            cudaStream_t stream) {
  const Tensors params{{p_w1, p_b1, p_w2, p_b2, p_w3, p_b3}};
  const Tensors mu{{m_w1, m_b1, m_w2, m_b2, m_w3, m_b3}};
  const Tensors nu{{v_w1, v_b1, v_w2, v_b2, v_w3, v_b3}};
  cudaError_t err;
  switch (S) {
    case 2: err = launch<2>(y, states, params, mu, nu, T, n_iters, lr, b1, b2, omb1, omb2, eps, inv_t, pow1, pow2, stream); break;
    case 4: err = launch<4>(y, states, params, mu, nu, T, n_iters, lr, b1, b2, omb1, omb2, eps, inv_t, pow1, pow2, stream); break;
    case 8: err = launch<8>(y, states, params, mu, nu, T, n_iters, lr, b1, b2, omb1, omb2, eps, inv_t, pow1, pow2, stream); break;
    case 16: err = launch<16>(y, states, params, mu, nu, T, n_iters, lr, b1, b2, omb1, omb2, eps, inv_t, pow1, pow2, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
