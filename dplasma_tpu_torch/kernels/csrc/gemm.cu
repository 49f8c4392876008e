// K1 on Hopper: fused GEMM  O = alpha * A @ B + beta * C.
//
// Replaces dplasma_tpu/kernels/pallas_kernels.py:gemm (bodies
// _gemm_kernel / _matmul_kernel, pallas_call at :139), the Pallas kernel
// every update product of the factorizations is sent to when K1 is
// enabled. The TPU kernel walks an (i, j, k) grid in order and carries an
// f32 VMEM accumulator across the k steps, with Precision.HIGHEST: f32
// operands in several bf16 passes on the MXU. Hopper's blocks run in
// parallel and in no order, so here one block owns one output tile (and
// one range of K) and keeps its accumulator in registers.
//
// Two kernels, chosen per product by the wrapper's plan
// (pallas_kernels.plan, the same predicate):
//
// k1_gemm_wgmma_kernel, the tensor-core kernel, for every operand TMA can
// describe (a unit stride on one axis, 16-byte aligned base and leading
// stride): one producer warp keeps STAGES TMA boxes of A and B in flight
// (mbarrier complete_tx); two consumer warpgroups split each staged tile
// and run wgmma on it, 64 rows of the 128x128 output tile each.
// - f32 is 3xTF32, the Hopper analogue of HIGHEST: x = hi + lo with
//   hi = tf32_rna(x), lo = tf32_rna(x - hi), and the tile's products are
//   lo*hi + hi*lo + hi*hi (small terms first), the lo*lo term dropped
//   (2^-22 relative). Each 32-deep K tile is summed by the tensor cores
//   into fresh registers and added to the f32 accumulator, so no
//   tensor-core sum runs deeper than 32. bf16 is one pass.
// - TF32 wgmma reads both operands K-major from shared memory (its
//   transpose bits exist for 16-bit types only). The split is a pass over
//   every staged tile anyway, so it also transposes: an M/N-major operand
//   (sgeqrf's V^T view, a row-major B) is loaded as TMA finds it and
//   written K-major, hi and lo, into the 128-byte-swizzled layout the
//   descriptors name. The split of tile k+1 is issued while wgmma works
//   on tile k (two split buffers); on the card the two passes still add
//   up rather than overlap (tools/k1_diagnose.py times each alone).
// - Split-K in the same launch, for products whose output tiles are too
//   few to fill the card (the plan picks the split count): each split
//   writes its f32 partial to a workspace the wrapper allocates, adds one
//   to the tile's counter (acq_rel), and the last to arrive sums the
//   partials in split order 0, 1, ... and runs the epilogue, then resets
//   the counter. The order is fixed, so two launches are bitwise equal.
// - The alpha/beta epilogue is fused: C is read once, never when
//   has_c = 0; ragged edges are zero-filled by TMA and masked on store.
//
// k1_gemm_kernel, the FFMA kernel of the first port, for operands TMA
// cannot describe (the ragged K = 777 tests, odd strides): one block per
// 128x128 tile, 128x16x128 steps staged in shared memory, 8x8 micro-tile
// per thread, full f32.
//
// A batched launch (one launch for a stack of products, the serving
// layer's torch.func.vmap over whole problems) runs the same kernels over
// a leading batch axis: each operand has a batch stride (0 broadcasts one
// matrix to every element), the element comes from the grid (FFMA: z;
// tensor cores: z = element * splits + split) and the tensor-core kernel
// reads rank-3 TMA maps, batch outermost with a box of 1. Each element's
// plan (tile, splits) is its 2-D launch's, and split-K workspace and tile
// counters are per element, so every element of a batched launch is
// bitwise its 2-D launch.
//
// What bounds it on this card: operations. The main-path products have
// hundreds of flops per byte; 3xTF32 does three tensor-core passes at
// 495 TFLOP/s (~165 effective), the FFMA kernel runs at most at 67.

#include <cuda.h>
#include <cuda/atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"

namespace {

// ---------------------------------------------------------------------
// The FFMA kernel
// ---------------------------------------------------------------------

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
               float alpha, float beta, int64_t sab, int64_t sbb,
               int64_t scb, int64_t sob) {
  // the batch element (z is 0 for a 2-D launch)
  const int64_t z = blockIdx.z;
  A += z * sab;
  B += z * sbb;
  if (HAS_C) C += z * scb;
  O += z * sob;
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
                   float alpha, float beta, int batch, int64_t sab,
                   int64_t sbb, int64_t scb, int64_t sob,
                   cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  const bool a_kfast = (sak == 1);
  const bool b_nfast = (sbn == 1) || (sbk != 1);
  const T* a = static_cast<const T*>(A);
  const T* b = static_cast<const T*>(B);
  const T* c = static_cast<const T*>(C);
  T* o = static_cast<T*>(O);
  if (has_c)
    launch_layout<T, true>(a_kfast, b_nfast, grid, stream, M, N, K, a, sam,
                           sak, b, sbk, sbn, c, scm, scn, o, som, son, alpha,
                           beta, sab, sbb, scb, sob);
  else
    launch_layout<T, false>(a_kfast, b_nfast, grid, stream, M, N, K, a, sam,
                            sak, b, sbk, sbn, c, scm, scn, o, som, son,
                            alpha, beta, sab, sbb, scb, sob);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------
// The tensor-core kernel: TMA + wgmma, 3xTF32 for f32, split-K in launch
// ---------------------------------------------------------------------
#define K1_D8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define K1_D64                                                        \
  K1_D8(0), K1_D8(8), K1_D8(16), K1_D8(24), K1_D8(32), K1_D8(40),      \
      K1_D8(48), K1_D8(56)

namespace wg {

constexpr int BM = 128;                 // output tile rows per block
constexpr int BN = 128;                 // output tile cols per block
constexpr int CONSUMERS = 256;          // two warpgroups, 64 rows each
constexpr int THREADS = CONSUMERS + 32; // and one producer warp
constexpr int STAGES = 3;               // raw tiles in flight
constexpr int ROWB = 128;               // bytes of one K row (= swizzle span)
constexpr int TILE = BM * ROWB;         // 16 KB: one operand tile (BN == BM)

template <typename T>
struct Cfg {
  static constexpr int BK = ROWB / (int)sizeof(T);   // 32 f32, 64 bf16
  static constexpr int EPC = 16 / (int)sizeof(T);    // elements per 16 B
  static constexpr int PARTS = sizeof(T) == 4 ? 2 : 1;  // hi, lo | values
  static constexpr int HL = 2 * PARTS * TILE;        // one split buffer
  static constexpr int RAW = STAGES * 2 * TILE;
  static constexpr int BAR = RAW + 2 * HL;           // barriers, flag
  static constexpr int SMEM = BAR + 128 + 1024;      // + base alignment
};

__device__ __forceinline__ unsigned saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(saddr(bar))
               : "memory");
}

// One 2-D TMA box into shared memory, counted off `bar` (complete_tx).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* tm,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(saddr(bar))
      : "memory");
}

// One 3-D TMA box (a 2-D box of batch element z) into shared memory.
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* tm,
                                          int c0, int c1, int z,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(z),
      "r"(saddr(bar))
      : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// cvt.rna: round to the nearest TF32 value, ties away from zero (the low
// 13 mantissa bits become zero; Inf and NaN pass through)
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// A wgmma operand descriptor: K-major, 128-byte swizzle, 8-row groups of
// 1024 bytes (SBO), the leading offset unused by this layout.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((saddr(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D (64 x 128 f32 per warpgroup) (+)= A (64 x k) B^T (128 x k), both
// K-major in shared memory; scale_d = 0 overwrites D.
__device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db,
                                    int scale_d, float) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : K1_D64
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db,
                                    int scale_d, __nv_bfloat16) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : K1_D64
      : "l"(da), "l"(db), "r"(scale_d));
}

// One staged raw tile (128 rows of the M or N axis by BK, as TMA left it:
// [row][k] when the operand is K-major in memory, [k][row] when it is
// M/N-major) into the K-major 128-byte-swizzled layout the descriptors
// name: 16-byte chunk c of row r lands at r*128 + ((c ^ (r & 7)) << 4).
// f32 writes hi = tf32_rna(x) to part 0 and lo = tf32_rna(x - hi) to part
// 1 (0 where hi is not finite); bf16 copies. The transpose of an
// M/N-major operand happens here, in the same pass as the split.
template <typename T, bool KMAJ>
__device__ __forceinline__ void stage_tile(const uint8_t* raw, uint8_t* dst,
                                           int t) {
  constexpr int EPC = Cfg<T>::EPC;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = t + i * CONSUMERS;
    const int r = KMAJ ? e >> 3 : e & 127;
    const int c = KMAJ ? e & 7 : e >> 7;
    uint4 v;
    if (KMAJ) {
      v = *reinterpret_cast<const uint4*>(raw + r * ROWB + c * 16);
    } else {
      alignas(16) T x[EPC];
#pragma unroll
      for (int j = 0; j < EPC; ++j)
        x[j] = reinterpret_cast<const T*>(raw)[(c * EPC + j) * BM + r];
      v = *reinterpret_cast<const uint4*>(x);
    }
    const int off = r * ROWB + ((c ^ (r & 7)) << 4);
    if (sizeof(T) == 4) {
      float x[4] = {__uint_as_float(v.x), __uint_as_float(v.y),
                    __uint_as_float(v.z), __uint_as_float(v.w)};
      float hi[4], lo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        hi[j] = tf32_rna(x[j]);
        lo[j] = isfinite(hi[j]) ? tf32_rna(__fsub_rn(x[j], hi[j])) : 0.f;
      }
      *reinterpret_cast<float4*>(dst + off) =
          make_float4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<float4*>(dst + TILE + off) =
          make_float4(lo[0], lo[1], lo[2], lo[3]);
    } else {
      *reinterpret_cast<uint4*>(dst + off) = v;
    }
  }
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One block per (output tile, K split) of one batch element. Warps 0-7
// (two warpgroups) split the staged tiles and run wgmma, one 64-row half
// of the tile each; warp 8 keeps STAGES TMA loads in flight. A_K / B_K:
// the operand is K-major in memory (A row-major; B a b.T view), else
// M/N-major. BATCHED: z = element * nsplit + split, rank-3 maps (a_bat /
// b_bat 0 for a broadcast operand), C and O offset by their batch strides,
// workspace and counters per element.
template <typename T, bool A_K, bool B_K, bool BATCHED>
__global__ void __launch_bounds__(THREADS, 1)
k1_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tmA,
                     const __grid_constant__ CUtensorMap tmB, int M, int N,
                     int K, int kt_per, int has_c,
                     const T* __restrict__ C, long long scm, long long scn,
                     T* __restrict__ O, long long som, long long son,
                     float alpha, float beta, float* __restrict__ ws,
                     int* __restrict__ counters, int nsplit, int a_bat,
                     int b_bat, long long scb, long long sob) {
  using Q = Cfg<T>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Q::BAR);
  uint64_t* empty = full + STAGES;
  int* s_last = reinterpret_cast<int*>(empty + STAGES);

  const int t = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int splits = BATCHED ? nsplit : gridDim.z;
  const int elem = BATCHED ? blockIdx.z / nsplit : 0;
  const int split = BATCHED ? blockIdx.z % nsplit : blockIdx.z;
  if (BATCHED) {
    if (has_c) C += elem * scb;
    O += elem * sob;
  }
  const int ktiles = (K + Q::BK - 1) / Q::BK;
  const int kt0 = split * kt_per;
  const int nk = max(0, min(ktiles, kt0 + kt_per) - kt0);

  if (t == 0) {
    for (int s = 0; s < STAGES; ++s) {
      dtt_cluster::mbar_init(&full[s], 1);
      dtt_cluster::mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  auto raw_a = [&](int s) { return smem + s * 2 * TILE; };
  auto raw_b = [&](int s) { return smem + s * 2 * TILE + TILE; };
  auto hl_a = [&](int j) { return smem + Q::RAW + j * Q::HL; };
  auto hl_b = [&](int j) {
    return smem + Q::RAW + j * Q::HL + Q::PARTS * TILE;
  };

  if (t >= CONSUMERS) {  // the producer warp
    if (t == CONSUMERS) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES, u = i / STAGES;
        if (u > 0) dtt_cluster::mbar_wait(&empty[s], (u - 1) & 1);
        dtt_cluster::mbar_expect(&full[s], 2 * TILE);
        const int k = (kt0 + i) * Q::BK;
        if (BATCHED) {
          tma_load3(raw_a(s), &tmA, A_K ? k : m0, A_K ? m0 : k, elem * a_bat,
                    &full[s]);
          tma_load3(raw_b(s), &tmB, B_K ? k : n0, B_K ? n0 : k, elem * b_bat,
                    &full[s]);
        } else {
          tma_load(raw_a(s), &tmA, A_K ? k : m0, A_K ? m0 : k, &full[s]);
          tma_load(raw_b(s), &tmB, B_K ? k : n0, B_K ? n0 : k, &full[s]);
        }
      }
    }
    return;
  }

  // consumers: tile i is split into buffer i & 1 while wgmma reads the
  // other; each tile's products go to d with a fresh start and are added
  // to acc in f32 afterwards, so the tensor cores' sums stay 32*K deep.
  const int wgi = t >> 7;             // warpgroup: rows 64*wgi..
  float acc[64], d[64];
#pragma unroll
  for (int v = 0; v < 64; ++v) acc[v] = d[v] = 0.f;

  auto stage = [&](int i) {
    const int s = i % STAGES;
    dtt_cluster::mbar_wait(&full[s], (i / STAGES) & 1);
    stage_tile<T, A_K>(raw_a(s), hl_a(i & 1), t);
    stage_tile<T, B_K>(raw_b(s), hl_b(i & 1), t);
    mbar_arrive(&empty[s]);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  };
  if (nk > 0) stage(0);
  consumers_sync();
  for (int i = 0; i < nk; ++i) {
    const int j = i & 1;
    const uint8_t* a = hl_a(j) + wgi * 64 * ROWB;
    const uint8_t* b = hl_b(j);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    if (Q::PARTS == 2) {
      // 3xTF32, small terms first: lo*hi + hi*lo, then hi*hi
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        mma(d, sw128_desc(a + TILE + 32 * q), sw128_desc(b + 32 * q), q > 0,
            T());
        mma(d, sw128_desc(a + 32 * q), sw128_desc(b + TILE + 32 * q), 1,
            T());
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        mma(d, sw128_desc(a + 32 * q), sw128_desc(b + 32 * q), 1, T());
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        mma(d, sw128_desc(a + 32 * q), sw128_desc(b + 32 * q), q > 0, T());
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    if (i + 1 < nk) stage(i + 1);
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    // d is written by the tensor cores until the wait: keep its reads
    // after it
#pragma unroll
    for (int v = 0; v < 64; ++v) asm volatile("" : "+f"(d[v])::"memory");
#pragma unroll
    for (int v = 0; v < 64; ++v) acc[v] += d[v];
    consumers_sync();
  }

  // accumulator fragment of m64n128: register v of lane l in warp w holds
  // row 16w + l/4 + 8*((v>>1)&1), column 8*(v>>2) + 2*(l&3) + (v&1)
  const int w = (t >> 5) & 3, l = t & 31;
  const int rbase = m0 + wgi * 64 + w * 16 + (l >> 2);
  const int cbase = n0 + (l & 3) * 2;

  if (splits > 1) {
    // this split's partial, in fragment order (coalesced by v), then the
    // tile's counter; the last split to arrive sums all in split order
    const int tiles = gridDim.x * gridDim.y;
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    float* mine =
        ws + ((size_t)(elem * splits + split) * tiles + tile) * (64 * CONSUMERS);
#pragma unroll
    for (int v = 0; v < 64; ++v) mine[v * CONSUMERS + t] = acc[v];
    __threadfence();
    consumers_sync();
    if (t == 0) {
      cuda::atomic_ref<int, cuda::thread_scope_device> cnt(
          counters[elem * tiles + tile]);
      const int old = cnt.fetch_add(1, cuda::memory_order_acq_rel);
      *s_last = (old == splits - 1);
      if (old == splits - 1) cnt.store(0, cuda::memory_order_relaxed);
    }
    consumers_sync();
    if (!*s_last) return;
    __threadfence();
    const float* base =
        ws + ((size_t)elem * splits * tiles + tile) * (64 * CONSUMERS);
#pragma unroll
    for (int v = 0; v < 64; ++v) acc[v] = __ldcg(base + v * CONSUMERS + t);
    for (int z = 1; z < splits; ++z) {
      const float* p = base + (size_t)z * tiles * (64 * CONSUMERS);
#pragma unroll
      for (int v = 0; v < 64; ++v) acc[v] += __ldcg(p + v * CONSUMERS + t);
    }
  }

  // fused epilogue: alpha*acc (+ beta*C), rounded once to T, ragged edges
  // masked
#pragma unroll
  for (int v = 0; v < 64; ++v) {
    const int r = rbase + 8 * ((v >> 1) & 1);
    const int c = cbase + 8 * (v >> 2) + (v & 1);
    if (r < M && c < N) {
      float x = alpha * acc[v];
      if (has_c) x += beta * to_f32(C[r * scm + c * scn]);
      O[r * som + c * son] = from_f32<T>(x);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of one operand (rows x cols, element strides s0, s1),
// boxes of 128 rows of the M/N axis by BK along K. `kmajor`: the operand's
// K axis has unit stride. Out-of-range elements of a box read as zero.
// With nbatch > 0 the map is rank 3: a batch axis outermost (stride
// sbatch elements, a box of 1); a broadcast operand (sbatch = 0) is one
// element of a batch of 1.
template <typename T>
int make_map(CUtensorMap* tm, const void* p, long long rows, long long cols,
             long long s0, long long s1, bool k_is_cols, bool kmajor,
             long long nbatch = 0, long long sbatch = 0) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorSymbolNotFound;
  // the axis with unit stride goes first (TMA's innermost dimension)
  const bool inner_cols = (s1 == 1);
  if (!inner_cols && s0 != 1) return (int)cudaErrorInvalidValue;
  const long long inner = inner_cols ? cols : rows;
  const long long outer = inner_cols ? rows : cols;
  const long long ld = inner_cols ? s0 : s1;
  const bool inner_is_k = inner_cols == k_is_cols;
  if (inner_is_k != kmajor) return (int)cudaErrorInvalidValue;
  const long long ldb = ld * (long long)sizeof(T);
  if ((reinterpret_cast<uintptr_t>(p) & 15) || (ldb & 15) || ldb <= 0 ||
      ldb >= (1ll << 40))
    return (int)cudaErrorInvalidValue;
  const long long bb = sbatch * (long long)sizeof(T);
  if (nbatch > 0 && (bb < 0 || (bb & 15) || bb >= (1ll << 40)))
    return (int)cudaErrorInvalidValue;
  cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)outer,
                        (cuuint64_t)(bb ? nbatch : 1)};
  cuuint64_t strides[2] = {(cuuint64_t)ldb,
                           (cuuint64_t)(bb ? bb : ldb * outer)};
  cuuint32_t box[3] = {
      (cuuint32_t)(inner_is_k ? Cfg<T>::BK : BM),
      (cuuint32_t)(inner_is_k ? BM : Cfg<T>::BK), 1};
  cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = enc(tm,
                   sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                   nbatch > 0 ? 3 : 2, const_cast<void*>(p), dims, strides,
                   box, estr,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T, bool A_K, bool B_K, bool BATCHED>
int launch_one(const CUtensorMap& ta, const CUtensorMap& tb, dim3 grid,
               cudaStream_t s, int M, int N, int K, int kt_per, int has_c,
               const T* c, long long scm, long long scn, T* o,
               long long som, long long son, float alpha, float beta,
               float* ws, int* counters, int nsplit, int a_bat, int b_bat,
               long long scb, long long sob) {
  static bool configured = false;
  auto kern = k1_gemm_wgmma_kernel<T, A_K, B_K, BATCHED>;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<T>::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  kern<<<grid, THREADS, Cfg<T>::SMEM, s>>>(ta, tb, M, N, K, kt_per, has_c, c,
                                          scm, scn, o, som, son, alpha, beta,
                                          ws, counters, nsplit, a_bat, b_bat,
                                          scb, sob);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int has_c, int M, int N, int K, const void* A, long long sam,
           long long sak, const void* B, long long sbk, long long sbn,
           const void* C, long long scm, long long scn, void* O,
           long long som, long long son, float alpha, float beta, int splits,
           int kt_per, int a_k, int b_k, float* ws, int* counters,
           int batch, long long sab, long long sbb, long long scb,
           long long sob, cudaStream_t s) {
  CUtensorMap ta, tb;
  const long long nb3 = batch > 1 ? batch : 0;   // rank-3 maps if batched
  int e = make_map<T>(&ta, A, M, K, sam, sak, true, a_k, nb3, sab);
  if (!e) e = make_map<T>(&tb, B, K, N, sbk, sbn, false, b_k, nb3, sbb);
  if (e) return e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM,
                  batch > 1 ? batch * splits : splits);
  const T* c = static_cast<const T*>(C);
  T* o = static_cast<T*>(O);
  const int a_bat = sab != 0, b_bat = sbb != 0;
#define K1_LAUNCH(AK, BKM, BAT)                                             \
  return launch_one<T, AK, BKM, BAT>(ta, tb, grid, s, M, N, K, kt_per, has_c, \
                                     c, scm, scn, o, som, son, alpha, beta,  \
                                     ws, counters, splits, a_bat, b_bat, scb, \
                                     sob)
  if (batch > 1) {
    if (a_k && b_k) K1_LAUNCH(true, true, true);
    if (a_k) K1_LAUNCH(true, false, true);
    if (b_k) K1_LAUNCH(false, true, true);
    K1_LAUNCH(false, false, true);
  }
  if (a_k && b_k) K1_LAUNCH(true, true, false);
  if (a_k) K1_LAUNCH(true, false, false);
  if (b_k) K1_LAUNCH(false, true, false);
  K1_LAUNCH(false, false, false);
#undef K1_LAUNCH
}

}  // namespace wg

}  // namespace

// The arguments of one K1 launch, mirrored by pallas_kernels._K1Args
// (ctypes): the wrapper keeps one per product shape and layout and fills
// only the pointers, alpha and beta per call. dtype: 0 = float32,
// 1 = bf16; kernel: 0 = FFMA, 1 = tensor cores. For the tensor-core
// kernel the plan (pallas_kernels.plan) gives the tile (bm, bn, bk must
// be this build's), the split count and its K tiles per split, and
// whether each operand is K-major in memory; ws (splits * tiles * 16384
// floats) and counters (one int per output tile, zero on entry, left
// zero) are used when splits > 1. batch (>= 1) elements are computed in
// the one launch, each operand advanced by its batch stride (elements; 0
// broadcasts one matrix); ws and counters then hold batch times as much.
struct K1Args {
  int dtype, has_c, M, N, K;
  const void* A;
  long long sam, sak;
  const void* B;
  long long sbk, sbn;
  const void* C;
  long long scm, scn;
  void* O;
  long long som, son;
  float alpha, beta;
  int kernel, bm, bn, bk, splits, kt_per, a_k, b_k;
  void* ws;
  void* counters;
  void* stream;
  int batch;
  long long sab, sbb, scb, sob;
};

// Plain C entry point, bound with ctypes. Returns 0 once launched (or
// when there is nothing to do), else a cudaError_t.
extern "C" int dtt_k1_gemm(const K1Args* p) {
  if (p->M <= 0 || p->N <= 0) return 0;
  if (p->batch < 1 || p->batch > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(p->stream);
  if (p->kernel == 0) {
    if ((p->M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidConfiguration;
    if (p->dtype == 0)
      return (int)launch<float>(p->has_c, p->M, p->N, p->K, p->A, p->sam,
                                p->sak, p->B, p->sbk, p->sbn, p->C, p->scm,
                                p->scn, p->O, p->som, p->son, p->alpha,
                                p->beta, p->batch, p->sab, p->sbb, p->scb,
                                p->sob, s);
    if (p->dtype == 1)
      return (int)launch<__nv_bfloat16>(
          p->has_c, p->M, p->N, p->K, p->A, p->sam, p->sak, p->B, p->sbk,
          p->sbn, p->C, p->scm, p->scn, p->O, p->som, p->son, p->alpha,
          p->beta, p->batch, p->sab, p->sbb, p->scb, p->sob, s);
    return (int)cudaErrorInvalidValue;
  }
  const int want_bk = p->dtype == 0 ? wg::Cfg<float>::BK
                                    : wg::Cfg<__nv_bfloat16>::BK;
  if (p->kernel != 1 || p->bm != wg::BM || p->bn != wg::BN ||
      p->bk != want_bk || p->splits < 1 || p->kt_per < 1 || p->K < 1 ||
      (p->splits > 1 && (!p->ws || !p->counters)) ||
      (p->M + wg::BM - 1) / wg::BM > 65535 ||
      (long long)p->splits * p->batch > 65535)
    return (int)cudaErrorInvalidValue;
  float* w = static_cast<float*>(p->ws);
  int* cnt = static_cast<int*>(p->counters);
  if (p->dtype == 0)
    return wg::launch<float>(p->has_c, p->M, p->N, p->K, p->A, p->sam,
                             p->sak, p->B, p->sbk, p->sbn, p->C, p->scm,
                             p->scn, p->O, p->som, p->son, p->alpha, p->beta,
                             p->splits, p->kt_per, p->a_k, p->b_k, w, cnt,
                             p->batch, p->sab, p->sbb, p->scb, p->sob, s);
  if (p->dtype == 1)
    return wg::launch<__nv_bfloat16>(
        p->has_c, p->M, p->N, p->K, p->A, p->sam, p->sak, p->B, p->sbk,
        p->sbn, p->C, p->scm, p->scn, p->O, p->som, p->son, p->alpha,
        p->beta, p->splits, p->kt_per, p->a_k, p->b_k, w, cnt, p->batch,
        p->sab, p->sbb, p->scb, p->sob, s);
  return (int)cudaErrorInvalidValue;
}
