// The ViterbiNet branch metric of 64 symbols on a warpgroup's tensor cores,
// shared by the detect kernels (viterbinet_detect.cu,
// viterbinet_detect_chunked.cu), so that one symbol's priors are
// bit-identical in both. Per symbol, as the TPU kernel computes it
// (metaviterbinet_tpu/kernels/acs.py::_detect_kernel):
//   h1 = sigmoid(w1 * y + b1)            [100], f32
//   h2 = relu(W2 . bf16(h1) + b2)        [50],  bf16 operands, f32 sums
//   logits = W3 . bf16(h2) + b3          [S],   bf16 operands, f32 sums
//   prior = -logits.
//
// What bounds it on an H100: the two products are 2 (100 x 50 + 50 x S)
// FLOP per symbol, 0.2 ms at 65536 x 136 at the bf16 tensor-core rate but
// 1.5 ms at the f32 rate of the CUDA cores, where the first version ran
// them; with the products on the tensor cores the floor is the 100
// sigmoids per symbol on the special-function units (an exp and a
// reciprocal each, 16 results per clock per SM).
// What the design does about it: both products are wgmma on bf16 operands
// with f32 sums, one warpgroup per 64-symbol tile. The sigmoids are
// computed straight into the A fragment of the first product (each thread
// owns two symbols' rows and 28 of the 112 padded columns, so no sigmoid is
// computed twice), the first product's accumulator becomes the second
// product's A fragment in registers (the layouts coincide), and the weights
// are B operands in shared memory, bf16-rounded and laid out once per block
// by load_mlp. Zero padding is exact: K 100 -> 112 and N 50 -> 56 for W2,
// K 50 -> 64 (relu(0 + 0) = 0) and N S -> max(S, 8) for W3.
//
// Rounding: every add and multiply outside the products is an explicit
// _rn intrinsic, so nvcc contracts nothing; the tensor cores sum the
// products in another order than the plain PyTorch version
// (kernels/acs.py::_bf16_priors), so near-ties may flip rarely.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kH1 = 100;
constexpr int kH2 = 50;
constexpr int kK1 = 112;  // K of the first product: kH1 padded to a multiple of 16
constexpr int kN1 = 56;   // N of the first product: kH2 padded to a multiple of 8
constexpr int kK2 = 64;   // K of the second product: kN1 padded to a multiple of 16
constexpr int kTileRows = 64;  // symbols of one wgmma tile

template <int S>
__host__ __device__ constexpr int kN2() {  // N of the second product
  return S < 8 ? 8 : S;
}

template <int S>
__host__ __device__ constexpr int kPriorCols() {  // prior columns a thread holds per row
  return kN2<S>() / 4;
}

// The sigmoid of the first layer: 0.5 tanh.approx(a / 2) + 0.5, one
// special-function result per unit. h1 is rounded to bf16 right after, which
// absorbs most of the approximation, but not all: measured on an H100 80GB
// HBM3 at 700 W (PERF.md section 6), K1's bit mismatch against the plain
// version reaches 2.45e-4 on chip_smoke.py's seeded network (up to 3.6e-6
// with the IEEE form 1 / (1 + expf(-a)) the plain version takes), and one
// tile's priors lie up to 3.1e-4 from the plain ones (3e-8 with the IEEE
// form). On another seeded network the IEEE form and __expf with an
// approximate reciprocal gave no mismatch and this form 1.1e-7. The trade:
// K1 at 65536 x 136 took 0.567 ms with this form, 0.81 with __expf and 1.51
// with the IEEE form, all well inside the 1e-3 bit contract.
// It takes half its argument, a / 2 = (w1 / 2) y + b1 / 2, which load_mlp's
// halved w1 and b1 give exactly (a multiply by 0.5 rounds nothing outside
// the subnormal range).
__device__ __forceinline__ float sigmoid_of_half(float half_a) {
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(half_a));
  return __fmaf_rn(0.5f, t, 0.5f);
}

// Index of element (n, k) of an N x K bf16 operand in the K-major,
// no-swizzle layout of wgmma: 8 x 8 core matrices of 128 contiguous bytes,
// the core matrices of one 8-row group consecutive along K.
template <int K>
__host__ __device__ constexpr int core_index(int n, int k) {
  return ((n >> 3) * (K >> 3) + (k >> 3)) * 64 + (n & 7) * 8 + (k & 7);
}

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// The network in shared memory: W2 and W3 bf16-rounded in the B layout,
// then w1 and b1 interleaved per column pair, b2 and b3, zero-padded.
template <int S>
struct alignas(128) MlpWeights {
  uint16_t w2[kN1 * kK1];  // bf16 bits
  uint16_t w3[kN2<S>() * kK2];
  float4 w1b1[kK1 / 2];  // {w1[c], b1[c], w1[c + 1], b1[c + 1]} / 2 for c = 2 i
  float b2[kN1];
  float b3[kN2<S>()];
};

// w1 [100] (the [100, 1] weight), b1 [100], w2 [50, 100], b2 [50],
// w3 [S, 50], b3 [S]; all kN threads of the block call it, and the caller
// synchronises the block before the first tile. Each thread issues all of
// its loads before it converts and stores any, so that the block waits for
// one round trip to device memory instead of one per element it owns.
template <int S, int kN>
__device__ __forceinline__ void load_mlp(MlpWeights<S>& s, const float* __restrict__ w1,
                                         const float* __restrict__ b1,
                                         const float* __restrict__ w2,
                                         const float* __restrict__ b2,
                                         const float* __restrict__ w3,
                                         const float* __restrict__ b3, int tid) {
  constexpr int kW2 = kN1 * kK1, kW3 = kN2<S>() * kK2;
  constexpr int kA = (kW2 + kN - 1) / kN, kB = (kW3 + kN - 1) / kN;
  static_assert(kN >= kK1 / 2 && kN >= kN1, "one thread per w1/b1 pair and per b2 entry");
  float a[kA], b[kB];
#pragma unroll
  for (int m = 0; m < kA; ++m) {
    const int i = tid + m * kN, n = i / kK1, k = i % kK1;
    a[m] = i < kW2 && n < kH2 && k < kH1 ? w2[n * kH1 + k] : 0.0f;
  }
#pragma unroll
  for (int m = 0; m < kB; ++m) {
    const int i = tid + m * kN, n = i / kK2, k = i % kK2;
    b[m] = i < kW3 && n < S && k < kH2 ? w3[n * kH2 + k] : 0.0f;
  }
  const int c = 2 * tid;
  const float4 wb = c < kH1 ? make_float4(w1[c], b1[c], w1[c + 1], b1[c + 1])
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float bias2 = tid < kH2 ? b2[tid] : 0.0f;
  const float bias3 = tid < S ? b3[tid] : 0.0f;
#pragma unroll
  for (int m = 0; m < kA; ++m) {
    const int i = tid + m * kN;
    if (i < kW2) s.w2[core_index<kK1>(i / kK1, i % kK1)] = bf16_bits(a[m]);
  }
#pragma unroll
  for (int m = 0; m < kB; ++m) {
    const int i = tid + m * kN;
    if (i < kW3) s.w3[core_index<kK2>(i / kK2, i % kK2)] = bf16_bits(b[m]);
  }
  // w1 and b1 halved (exact): the sigmoid takes tanh of half its argument
  if (tid < kK1 / 2) s.w1b1[tid] = make_float4(0.5f * wb.x, 0.5f * wb.y, 0.5f * wb.z, 0.5f * wb.w);
  if (tid < kN1) s.b2[tid] = bias2;
  if (tid < kN2<S>()) s.b3[tid] = bias3;
  // the tensor cores read W2 and W3 through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major no-swizzle operand: start
// address, leading byte offset (between the two core matrices along K of a
// k16 slice: 128 B) and stride byte offset (between 8-row groups), all in
// 16-byte units; layout type 0 (no swizzle).
template <int K>
__device__ __forceinline__ uint64_t operand_desc(const uint16_t* base) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(base));
  return ((addr & 0x3FFFF) >> 4) | (uint64_t{128 >> 4} << 16) | (uint64_t{(K / 8) * 128 >> 4} << 32);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// keeps the compiler from moving accesses of the accumulator registers
// across the asynchronous product
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// D[64 x 56] += A[64 x 16] (registers) . B[16 x 56] (shared memory)
__device__ __forceinline__ void wgmma_n56(float (&d)[28], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %33, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27}, {%28, %29, %30, %31}, %32, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 8] += A[64 x 16] . B[16 x 8]
__device__ __forceinline__ void wgmma_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %9, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 16] += A[64 x 16] . B[16 x 16]
__device__ __forceinline__ void wgmma_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The priors of one 64-symbol tile; all 128 threads of a warpgroup call it
// together. The thread at warp q, lane l of the warpgroup owns tile rows
// r0 = 16 q + l / 4 and r1 = r0 + 8: it passes their samples y0, y1 and gets
// back p0, p1, their priors at columns prior_col<S>(j, l) (those < S are
// live). Fragment layouts of wgmma: A and D rows as above; A columns
// 2 (l % 4) + {0, 1} and + 8 of each k16 slice; D columns 2 (l % 4) + {0, 1}
// of each 8-column block.
template <int S>
__device__ __forceinline__ int prior_col(int j, int lane) {
  return (j / 2) * 8 + 2 * (lane % 4) + (j % 2);
}

template <int S>
__device__ __forceinline__ void mlp_tile(const MlpWeights<S>& w, float y0, float y1,
                                         float (&p0)[kPriorCols<S>()],
                                         float (&p1)[kPriorCols<S>()]) {
  const int col0 = 2 * (threadIdx.x % 4);  // this thread's first column of a block

  // h1 = sigmoid(w1 y + b1), rounded to bf16, straight into A fragments
  uint32_t a1[kK1 / 16][4];
#pragma unroll
  for (int kk = 0; kk < kK1 / 16; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = 16 * kk + 8 * half + col0;
      if (c >= kK1 - 8 && half == 1) {  // the last slice's upper half is all padding
        a1[kk][2 * half] = a1[kk][2 * half + 1] = 0u;
        continue;
      }
      const float4 wb = w.w1b1[c / 2];
      a1[kk][2 * half] = pack_bf16(sigmoid_of_half(__fadd_rn(__fmul_rn(wb.x, y0), wb.y)),
                                   sigmoid_of_half(__fadd_rn(__fmul_rn(wb.z, y0), wb.w)));
      a1[kk][2 * half + 1] = pack_bf16(sigmoid_of_half(__fadd_rn(__fmul_rn(wb.x, y1), wb.y)),
                                       sigmoid_of_half(__fadd_rn(__fmul_rn(wb.z, y1), wb.w)));
    }
  }
  float d1[kN1 / 2];
#pragma unroll
  for (int i = 0; i < kN1 / 2; ++i) d1[i] = 0.0f;
  const uint64_t b1 = operand_desc<kK1>(w.w2);
  fence_operands(d1);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kK1 / 16; ++kk) wgmma_n56(d1, a1[kk], b1 + kk * (256 >> 4));
  wgmma_commit_and_wait();
  fence_operands(d1);

  // h2 = relu(d1 + b2), rounded to bf16: the accumulator's 8-column blocks
  // 2 kk and 2 kk + 1 are the A fragment of k16 slice kk
  uint32_t a2[kK2 / 16][4];
#pragma unroll
  for (int kk = 0; kk < kK2 / 16; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int blk = 2 * kk + half;
      if (blk >= kN1 / 8) {
        a2[kk][2 * half] = a2[kk][2 * half + 1] = 0u;
        continue;
      }
      const float2 bb = *reinterpret_cast<const float2*>(w.b2 + 8 * blk + col0);
      a2[kk][2 * half] = pack_bf16(fmaxf(__fadd_rn(d1[4 * blk], bb.x), 0.0f),
                                   fmaxf(__fadd_rn(d1[4 * blk + 1], bb.y), 0.0f));
      a2[kk][2 * half + 1] = pack_bf16(fmaxf(__fadd_rn(d1[4 * blk + 2], bb.x), 0.0f),
                                       fmaxf(__fadd_rn(d1[4 * blk + 3], bb.y), 0.0f));
    }
  }
  float d2[kN2<S>() / 2];
#pragma unroll
  for (int i = 0; i < kN2<S>() / 2; ++i) d2[i] = 0.0f;
  const uint64_t b2 = operand_desc<kK2>(w.w3);
  fence_operands(d2);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kK2 / 16; ++kk) {
    if constexpr (kN2<S>() == 8) {
      wgmma_n8(d2, a2[kk], b2 + kk * (256 >> 4));
    } else {
      wgmma_n16(d2, a2[kk], b2 + kk * (256 >> 4));
    }
  }
  wgmma_commit_and_wait();
  fence_operands(d2);

  // prior = -(logits + b3)
#pragma unroll
  for (int blk = 0; blk < kN2<S>() / 8; ++blk) {
    const float2 bb = *reinterpret_cast<const float2*>(w.b3 + 8 * blk + col0);
    p0[2 * blk] = -__fadd_rn(d2[4 * blk], bb.x);
    p0[2 * blk + 1] = -__fadd_rn(d2[4 * blk + 1], bb.y);
    p1[2 * blk] = -__fadd_rn(d2[4 * blk + 2], bb.x);
    p1[2 * blk + 1] = -__fadd_rn(d2[4 * blk + 3], bb.y);
  }
}
