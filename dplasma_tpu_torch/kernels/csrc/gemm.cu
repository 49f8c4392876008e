// K1 on Hopper: fused GEMM  O = alpha * A @ B + beta * C.
//
// Replaces dplasma_tpu/kernels/pallas_kernels.py:gemm (bodies
// _gemm_kernel / _matmul_kernel, pallas_call at :139), the Pallas kernel
// every Cholesky update product is sent to when K1 is enabled.
//
// The TPU kernel walks an (i, j, k) grid in order and carries an f32
// VMEM accumulator across the k steps. Hopper's blocks run in parallel
// and in no order, so nothing carries across blocks here: one block owns
// one 128x128 output tile and loops over K itself, keeping the f32
// accumulator in registers (an 8x8 micro-tile per thread, 256 threads).
// Each K step stages a 128x16 tile of A and a 16x128 tile of B in shared
// memory (converted to f32 there), then every thread runs 16 rank-1
// updates of its micro-tile with FFMA. Products are therefore full f32,
// never TF32, which is what the reference's Precision.HIGHEST asks for.
//
// The kernel takes element strides for A, B, C and O and masks the
// ragged edge itself: transposed views (blas.dot's b.T) need no copy and
// no operand is padded (the reference pads, pallas_kernels.py:91-95).
// The alpha/beta epilogue is fused: C is read once, and the HAS_C=false
// variant (beta = 0) never reads it. Inputs are float or bf16; the output
// has the input's type; accumulation is f32 in both cases.
//
// What bounds it on this card: FP32 CUDA-core FLOP/s. At the update
// products of spotrf (M up to 16384, K up to 14336, N = 1024) the
// arithmetic intensity is hundreds of flops per byte, far above the
// H100's ~20 f32 flops/byte ridge, so the bound is 2MNK over the 67
// TFLOP/s FFMA peak. This simple kernel has no global->shared pipeline
// (no cp.async/TMA double buffering), so it relies on two resident blocks
// per SM to hide load latency. A later design moves the products to the
// tensor cores: wgmma fed by TMA, with 3xTF32 splitting to keep f32
// accuracy, whose bound is about three passes at 495 TFLOP/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;   // output tile rows per block
constexpr int BN = 128;   // output tile cols per block
constexpr int BK = 16;    // K depth staged per step
constexpr int TM = 8;     // micro-tile rows per thread
constexpr int TN = 8;     // micro-tile cols per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int PAD = 4;    // keeps float4 alignment, spreads store banks

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A_KFAST / B_NFAST name the operand axis with unit stride (row-major A,
// row-major B); as template parameters they keep the layout choice out of
// the inner loads, which cut the register spills of a run-time choice.
template <typename T, bool HAS_C, bool A_KFAST, bool B_NFAST>
__global__ void __launch_bounds__(THREADS, 2)
k1_gemm_kernel(int M, int N, int K,
               const T* __restrict__ A, int64_t sam, int64_t sak,
               const T* __restrict__ B, int64_t sbk, int64_t sbn,
               const T* __restrict__ C, int64_t scm, int64_t scn,
               T* __restrict__ O, int64_t som, int64_t son,
               float alpha, float beta) {
  // k-major tiles: As[k][m], Bs[k][n]
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);   // 0..15: column group
  const int ty = tid / (BN / TN);   // 0..15: row group
  const int64_t m0 = (int64_t)blockIdx.y * BM;
  const int64_t n0 = (int64_t)blockIdx.x * BN;

  // Each thread owns rows ty*4 + {0..3} + {0, 64} and columns
  // tx*4 + {0..3} + {0, 64} of the tile, so its shared-memory reads are
  // two float4s per operand per k and a warp's reads hit distinct banks.
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // Global->shared mapping: neighbouring threads take neighbouring
  // addresses along whichever axis of the operand has unit stride.
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int mm = A_KFAST ? e / BK : e % BM;
      const int kk = A_KFAST ? e % BK : e / BM;
      const int64_t gm = m0 + mm;
      const int gk = k0 + kk;
      float v = 0.f;
      if (gm < M && gk < K) v = to_f32(A[gm * sam + (int64_t)gk * sak]);
      As[kk][mm] = v;
    }
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int nn = B_NFAST ? e % BN : e / BK;
      const int kk = B_NFAST ? e / BN : e % BK;
      const int64_t gn = n0 + nn;
      const int gk = k0 + kk;
      float v = 0.f;
      if (gn < N && gk < K) v = to_f32(B[(int64_t)gk * sbk + gn * sbn]);
      Bs[kk][nn] = v;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 4 + 64]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4 + 64]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Fused epilogue: alpha*acc (+ beta*C), rounded once to the output type.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gm = m0 + ty * 4 + (i & 3) + (i >> 2) * 64;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gn = n0 + tx * 4 + (j & 3) + (j >> 2) * 64;
      if (gn >= N) continue;
      float v = alpha * acc[i][j];
      if (HAS_C) v += beta * to_f32(C[gm * scm + gn * scn]);
      store_out(&O[gm * som + gn * son], v);
    }
  }
}

template <typename T, bool HAS_C, typename... Params>
void launch_layout(bool a_kfast, bool b_nfast, dim3 grid, cudaStream_t s,
                   Params... p) {
  if (a_kfast && b_nfast)
    k1_gemm_kernel<T, HAS_C, true, true><<<grid, THREADS, 0, s>>>(p...);
  else if (a_kfast)
    k1_gemm_kernel<T, HAS_C, true, false><<<grid, THREADS, 0, s>>>(p...);
  else if (b_nfast)
    k1_gemm_kernel<T, HAS_C, false, true><<<grid, THREADS, 0, s>>>(p...);
  else
    k1_gemm_kernel<T, HAS_C, false, false><<<grid, THREADS, 0, s>>>(p...);
}

template <typename T>
cudaError_t launch(int has_c, int M, int N, int K,
                   const void* A, int64_t sam, int64_t sak,
                   const void* B, int64_t sbk, int64_t sbn,
                   const void* C, int64_t scm, int64_t scn,
                   void* O, int64_t som, int64_t son,
                   float alpha, float beta, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const bool a_kfast = (sak == 1);
  const bool b_nfast = (sbn == 1) || (sbk != 1);
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  const T* c = static_cast<const T*>(C);
  T* o = static_cast<T*>(O);
  if (has_c)
    launch_layout<T, true>(a_kfast, b_nfast, grid, stream, M, N, K, a, sam,
                           sak, b, sbk, sbn, c, scm, scn, o, som, son, alpha,
                           beta);
  else
    launch_layout<T, false>(a_kfast, b_nfast, grid, stream, M, N, K, a, sam,
                            sak, b, sbk, sbn, c, scm, scn, o, som, son,
                            alpha, beta);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bf16.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int dtt_k1_gemm(int dtype, int has_c, int M, int N, int K,
                           const void* A, long long sam, long long sak,
                           const void* B, long long sbk, long long sbn,
                           const void* C, long long scm, long long scn,
                           void* O, long long som, long long son,
                           float alpha, float beta, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(has_c, M, N, K, A, sam, sak, B, sbk, sbn, C, scm,
                        scn, O, som, son, alpha, beta, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(has_c, M, N, K, A, sam, sak, B, sbk, sbn, C,
                                scm, scn, O, som, son, alpha, beta, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
