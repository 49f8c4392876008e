// K2 on Hopper: the whole exact limb product of the f64-equivalent (dd)
// route, closed by its level recombine in the same launch,
//
//   out = base - (sum_l 2^(-w(l+2)) * lv_l) * (sa[i] * sb[j]),
//   lv_l = sum_{p+q=l} A_p @ B_q^T            (exact int32)
//
// or -(sum ...) * (sa[i] * sb[j]) without a base (gemm_f64 passes -sa).
//
// Replaces dplasma_tpu/kernels/pallas_dd.py:recombine_base (body
// _recombine_kernel, pallas_call at :83). On the TPU, XLA fuses the level
// sums into the per-limb int8 dots (dplasma_tpu/kernels/dd.py:156-175)
// and K2 is one VMEM pass over the (nl, M, N) level tensor. Eager PyTorch
// fuses nothing, so the first port wrote the level tensor to device memory
// through torch._int_mm products and strided adds, and read it back. Here
// the level sums never leave the SM: they are wgmma accumulators, and the
// recombine is this kernel's epilogue.
//
// Operands: A_p and B_q are the nl int8 limb planes of each operand,
// K-major ((nl, M, K) and (nl, N, K), unit stride along K, 16-byte aligned
// base, row and plane strides: what TMA can describe). One 3-D TMA box
// over the plane axis stages all nl limbs of a 64-row tile at once.
//
// Design (K-outer, all levels live, 64x64 output tile):
// - One producer warp keeps `stages` K steps in flight. A step is 64 bytes
//   of K for all nl A limbs and all nl B limbs: 2 * nl * 4 KB, landed
//   64-byte swizzled (mbarrier complete_tx).
// - ceil(nl/2) consumer warpgroups. Warpgroup g owns levels g and
//   nl-1-g (one level when they coincide) as m64n64 int32 accumulators,
//   and runs their pairs (p, l-p) on each staged step with
//   wgmma.m64n64k32.s32.s8.s8: at nl = 8 each warpgroup does 9 of the
//   36 pairs, at nl = 5 the groups are {0,4}, {1,3}, {2}. Every staged
//   byte feeds all the pairs it belongs to.
// - Integer sums are exact in any order as long as they stay in int32,
//   which the route's chunk bound (nl * K * 127^2 < 2^31) guarantees.
// - Epilogue: the level tiles go through shared memory; every consumer
//   thread then closes its elements in f64, in level order, with
//   __dmul_rn / __dadd_rn / __dsub_rn (nothing contracted into an FMA):
//   each term lv * 2^(-w(l+2)) is exact and sa * sb is a power of two,
//   so the result is the plain route's (recombine_base_reference of
//   _limb_levels) bit for bit.
// - Products with too few output tiles to fill the card split over K in
//   the same launch: each split adds its partial level tiles into an
//   int32 workspace (red.global.add), then one to the tile's counter
//   (acq_rel); the last split to arrive reads the sums, zeroes the
//   workspace, resets the counter and runs the f64 epilogue. Integer
//   addition is associative, so every arrival order gives the same bits.
//
// A batched launch (the serving layer's torch.func.vmap over whole
// problems: one launch for the residual of every element of a batch) runs
// the same kernel over a leading batch axis: rank-4 TMA maps (batch
// outermost, a box of 1; a broadcast operand is a batch of one), the
// element from the grid (z = element * splits + split), base, scales and
// output advanced by their batch strides, workspace and tile counters per
// element. The integer sums and the epilogue are the 2-D launch's, so
// every element is bitwise its 2-D launch.
//
// What bounds it on this card: operations. nl(nl+1)/2 pair products of
// 2*M*N*K int8 operations each, against the 1979 TOP/s dense int8 peak;
// the limb planes are read once per output tile row or column.

#include <cuda.h>
#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"

namespace {

constexpr int BM = 64;                  // output tile rows
constexpr int BN = 64;                  // output tile cols
constexpr int BK = 64;                  // K bytes per step
constexpr int PLANE = BM * BK;          // 4 KB: one limb's box (BM == BN)
constexpr int MAX_NL = 8;
constexpr int MAX_THREADS = (MAX_NL + 1) / 2 * 128 + 32;
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;      // 227 KB a block can opt into
constexpr int LDS = BN + 8;             // level tile row stride (int32)
constexpr int BAR_BYTES = 256;          // mbarriers and the last-split flag
constexpr int ALIGN = 1024;             // slack to align the base

// Shared memory of an nl-limb launch (mirrored by pallas_dd.plan)
__host__ __device__ inline int stage_bytes(int nl) { return 2 * nl * PLANE; }
__host__ __device__ inline int stages_for(int nl) {
  const int s = (SMEM_LIMIT - ALIGN - BAR_BYTES) / stage_bytes(nl);
  return s < MAX_STAGES ? s : MAX_STAGES;
}
// the stages, later reused for the nl level tiles of the epilogue
__host__ __device__ inline int body_bytes(int nl) {
  const int a = stages_for(nl) * stage_bytes(nl), b = nl * BM * LDS * 4;
  return a > b ? a : b;
}
__host__ __device__ inline int smem_for(int nl) {
  return body_bytes(nl) + BAR_BYTES + ALIGN;
}

__device__ __forceinline__ unsigned saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(saddr(bar))
               : "memory");
}

// One 3-D TMA box (K, rows, limb planes) into shared memory, counted off
// `bar` (complete_tx).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* tm,
                                         int k, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(k), "r"(row), "r"(0),
      "r"(saddr(bar))
      : "memory");
}

// One 4-D TMA box (K, rows, limb planes, batch element z).
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* tm,
                                          int k, int row, int z,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(k), "r"(row), "r"(0), "r"(z),
      "r"(saddr(bar))
      : "memory");
}

// Wait for phase `parity` of `bar`, the retry loop inside the asm: the
// compiler sees no divergent branch around the wgmma that follow.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "K2_WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @p bra K2_DONE;\n"
      " bra K2_WAIT;\n"
      "K2_DONE:\n}" ::"r"(saddr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void consumers_sync(int n) {
  asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
}

// A wgmma operand descriptor: K-major, 64-byte swizzle (one 64-byte K row
// per tile row), 8-row groups of 512 bytes (SBO), the leading offset
// unused by this layout.
__device__ __forceinline__ uint64_t sw64_desc(const void* p) {
  return (uint64_t)((saddr(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

#define K2_D8(i)                                                      \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),          \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// D (64 x 64 int32 per warpgroup) += A (64 x 32) B^T (64 x 32), int8,
// both K-major in shared memory
__device__ __forceinline__ void mma(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p;\n}\n"
      : K2_D8(0), K2_D8(8), K2_D8(16), K2_D8(24)
      : "l"(da), "l"(db), "r"(1));
}

// One limb pair on one staged step: its 64-byte K row in two k32 halves
__device__ __forceinline__ void pair(int* d, const uint8_t* a,
                                     const uint8_t* b) {
  mma(d, sw64_desc(a), sw64_desc(b));
  mma(d, sw64_desc(a + 32), sw64_desc(b + 32));
}

// The accumulator fragment of m64n64 into a level tile [BM][LDS]: register
// v of lane ln in warp wi holds row 16 wi + ln/4 + 8 ((v>>1)&1), column
// 8 (v>>2) + 2 (ln&3) + (v&1)
__device__ __forceinline__ void store_frag(int* tile, const int* d, int t) {
  const int wi = (t >> 5) & 3, ln = t & 31;
  const int r0 = wi * 16 + (ln >> 2), c0 = (ln & 3) * 2;
#pragma unroll
  for (int v = 0; v < 32; v += 2) {
    const int r = r0 + 8 * ((v >> 1) & 1), c = c0 + 8 * (v >> 2);
    *reinterpret_cast<int2*>(tile + r * LDS + c) = make_int2(d[v], d[v + 1]);
  }
}

// One block per (64x64 output tile, K split) of one batch element; see
// the header. BATCHED: z = element * nsplit + split, rank-4 maps (a_bat /
// b_bat 0 for a broadcast operand), base / scales / out advanced by their
// batch strides (elements; 0 broadcasts).
template <bool BATCHED>
__global__ void __launch_bounds__(MAX_THREADS, 1)
k2_limb_gemm_kernel(const __grid_constant__ CUtensorMap tmA,
                    const __grid_constant__ CUtensorMap tmB, int nl, int w,
                    int M, int N, int K, int kt_per,
                    const double* __restrict__ base, long long bs0,
                    long long bs1, const double* __restrict__ sa,
                    long long sas, const double* __restrict__ sb,
                    long long sbs, double* __restrict__ out,
                    int* __restrict__ ws, int* __restrict__ counters,
                    int nsplit, int a_bat, int b_bat, long long base_b,
                    long long sa_b, long long sb_b, long long out_b) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) &
      ~(uintptr_t)(ALIGN - 1));
  const int stages = stages_for(nl);
  const int sbytes = stage_bytes(nl);
  const int consumers = (nl + 1) / 2 * 128;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + body_bytes(nl));
  uint64_t* empty = full + MAX_STAGES;
  int* s_last = reinterpret_cast<int*>(empty + MAX_STAGES);

  const int t = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int splits = BATCHED ? nsplit : gridDim.z;
  const int elem = BATCHED ? blockIdx.z / nsplit : 0;
  const int kz = BATCHED ? blockIdx.z % nsplit : blockIdx.z;
  if (BATCHED) {
    if (base != nullptr) base += elem * base_b;
    sa += elem * sa_b;
    sb += elem * sb_b;
    out += elem * out_b;
  }
  const int ktiles = (K + BK - 1) / BK;
  const int kt0 = kz * kt_per;
  const int nk = max(0, min(ktiles, kt0 + kt_per) - kt0);

  if (t == 0) {
    for (int s = 0; s < stages; ++s) {
      dtt_cluster::mbar_init(&full[s], 1);
      dtt_cluster::mbar_init(&empty[s], consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (t >= consumers) {  // the producer warp
    if (t == consumers) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % stages, u = i / stages;
        if (u > 0) mbar_wait(&empty[s], (u - 1) & 1);
        dtt_cluster::mbar_expect(&full[s], sbytes);
        uint8_t* st = smem + s * sbytes;
        const int k = (kt0 + i) * BK;
        if (BATCHED) {
          tma_load4(st, &tmA, k, m0, elem * a_bat, &full[s]);
          tma_load4(st + nl * PLANE, &tmB, k, n0, elem * b_bat, &full[s]);
        } else {
          tma_load(st, &tmA, k, m0, &full[s]);
          tma_load(st + nl * PLANE, &tmB, k, n0, &full[s]);
        }
      }
    }
    return;
  }

  // consumers: warpgroup g accumulates levels la and lb (g read through a
  // shuffle, so the compiler knows it is the same across each warp and the
  // pair loops below are not divergent)
  const int g = __shfl_sync(0xffffffffu, t >> 7, 0);
  const int la = g, lb = nl - 1 - g;
  int d0[32], d1[32];
#pragma unroll
  for (int v = 0; v < 32; ++v) d0[v] = d1[v] = 0;
  for (int i = 0; i < nk; ++i) {
    const int s = i % stages;
    mbar_wait(&full[s], (i / stages) & 1);
    const uint8_t* a = smem + s * sbytes;      // limb p at a + p * PLANE
    const uint8_t* b = a + nl * PLANE;
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    for (int p = 0; p <= la; ++p)
      pair(d0, a + p * PLANE, b + (la - p) * PLANE);
    if (lb != la)
      for (int p = 0; p <= lb; ++p)
        pair(d1, a + p * PLANE, b + (lb - p) * PLANE);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    mbar_arrive(&empty[s]);
  }
  // the accumulators are written by the tensor cores until the wait: keep
  // their reads after it
#pragma unroll
  for (int v = 0; v < 32; ++v)
    asm volatile("" : "+r"(d0[v]), "+r"(d1[v])::"memory");

  // every stage is read: the level tiles take its place
  consumers_sync(consumers);
  int* lvl = reinterpret_cast<int*>(smem);     // [nl][BM][LDS]
  store_frag(lvl + la * BM * LDS, d0, t);
  if (lb != la) store_frag(lvl + lb * BM * LDS, d1, t);
  consumers_sync(consumers);

  if (splits > 1) {
    // this split's partial sums into the tile's workspace, then the
    // tile's counter; the last split to arrive takes the totals
    const int tiles = gridDim.x * gridDim.y;
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    const int nel = nl * BM * BN;
    int* wt = ws + ((size_t)elem * tiles + tile) * nel;
    for (int e = t; e < nel; e += consumers) {
      const int l = e / (BM * BN), rc = e % (BM * BN);
      const int v = lvl[(l * BM + rc / BN) * LDS + rc % BN];
      if (v != 0) atomicAdd(wt + e, v);
    }
    __threadfence();
    consumers_sync(consumers);
    if (t == 0) {
      cuda::atomic_ref<int, cuda::thread_scope_device> cnt(
          counters[elem * tiles + tile]);
      const int old = cnt.fetch_add(1, cuda::memory_order_acq_rel);
      *s_last = (old == splits - 1);
      if (old == splits - 1) cnt.store(0, cuda::memory_order_relaxed);
    }
    consumers_sync(consumers);
    if (!*s_last) return;
    __threadfence();
    for (int e = t; e < nel; e += consumers) {
      const int l = e / (BM * BN), rc = e % (BM * BN);
      lvl[(l * BM + rc / BN) * LDS + rc % BN] = __ldcg(wt + e);
      __stcg(wt + e, 0);
    }
    consumers_sync(consumers);
  }

  // the f64 epilogue, in the plain route's order: level by level, then the
  // scale, then the base
  const double step = ldexp(1.0, -w);
  for (int e = t; e < BM * BN; e += consumers) {
    const int r = e / BN, c = e % BN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr >= M || gc >= N) continue;
    double wl = ldexp(1.0, -2 * w);            // 2^(-w(l+2)), exact
    double acc = 0.0;
    for (int l = 0; l < nl; ++l) {
      const double term =
          __dmul_rn((double)lvl[(l * BM + r) * LDS + c], wl);
      acc = l == 0 ? term : __dadd_rn(acc, term);
      wl = __dmul_rn(wl, step);
    }
    const double prod =
        __dmul_rn(acc, __dmul_rn(sa[gr * sas], sb[gc * sbs]));
    out[(size_t)gr * N + gc] =
        base != nullptr ? __dsub_rn(base[gr * bs0 + gc * bs1], prod)
                        : -prod;
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

// The tensor map of one operand's limb planes: (nl, rows, K) int8, unit
// stride along K, `row` and `plane` byte strides; boxes of 64 K bytes by
// 64 rows by all nl planes, 64-byte swizzled. Out-of-range elements of a
// box read as zero (adding nothing to an integer sum). With nbatch > 0 the
// map is rank 4, a batch axis outermost (byte stride `bstride`, a box of
// 1; a broadcast operand, bstride 0, is a batch of one).
int make_map(CUtensorMap* tm, const void* p, int nl, long long rows,
             long long K, long long plane, long long row,
             long long nbatch = 0, long long bstride = 0) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorSymbolNotFound;
  if ((reinterpret_cast<uintptr_t>(p) & 15) || (row & 15) || (plane & 15) ||
      row <= 0 || plane <= 0 || row >= (1ll << 40) || plane >= (1ll << 40) ||
      (nbatch > 0 && (bstride < 0 || (bstride & 15) ||
                      bstride >= (1ll << 40))))
    return (int)cudaErrorInvalidValue;
  cuuint64_t dims[4] = {(cuuint64_t)K, (cuuint64_t)rows, (cuuint64_t)nl,
                        (cuuint64_t)(bstride ? nbatch : 1)};
  cuuint64_t strides[3] = {(cuuint64_t)row, (cuuint64_t)plane,
                           (cuuint64_t)(bstride ? bstride : plane * nl)};
  cuuint32_t box[4] = {(cuuint32_t)BK, (cuuint32_t)BM, (cuuint32_t)nl, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = enc(tm, CU_TENSOR_MAP_DATA_TYPE_UINT8, nbatch > 0 ? 4 : 3,
                   const_cast<void*>(p), dims, strides, box, estr,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

// The arguments of one K2 launch, mirrored by pallas_dd._K2Args (ctypes):
// the wrapper keeps one per product shape and layout and fills only the
// pointers per call. Strides are in elements (bytes for the int8 planes).
// base may be null; sas / sbs may be 0 (one scale for every row or
// column). The plan (pallas_dd.plan) gives the tile (bm, bn, bk must be
// this build's), the stage count and shared memory (checked against this
// build's), and the split count with its K steps per split; ws (tiles *
// nl * 4096 int32) and counters (one int per output tile) are zero on
// entry and left zero, used when splits > 1. batch (>= 1) elements are
// computed in the one launch: a_batch / b_batch are the limb planes' batch
// strides in bytes, base_b / sa_b / sb_b / out_b the others' in elements
// (0 broadcasts); ws and counters then hold batch times as much.
struct K2Args {
  int nl, w, M, N, K;
  const void* A;
  long long a_plane, a_row;
  const void* B;
  long long b_plane, b_row;
  const void* base;
  long long bs0, bs1;
  const void* sa;
  long long sas;
  const void* sb;
  long long sbs;
  void* out;
  int bm, bn, bk, stages, smem, splits, kt_per;
  void* ws;
  void* counters;
  void* stream;
  int batch;
  long long a_batch, b_batch, base_b, sa_b, sb_b, out_b;
};

// Plain C entry point, bound with ctypes. Returns 0 once launched (or
// when there is nothing to do), else a cudaError_t.
extern "C" int dtt_k2_limb_gemm(const K2Args* p) {
  if (p->M <= 0 || p->N <= 0) return 0;
  const int nl = p->nl;
  if (nl < 1 || nl > MAX_NL || p->K < 1 || p->bm != BM || p->bn != BN ||
      p->bk != BK || p->stages != stages_for(nl) ||
      p->smem != smem_for(nl) || p->splits < 1 || p->kt_per < 1 ||
      !p->A || !p->B || !p->sa || !p->sb || !p->out ||
      (p->splits > 1 && (!p->ws || !p->counters)) ||
      (p->M + BM - 1) / BM > 65535 || p->batch < 1 ||
      (long long)p->splits * p->batch > 65535)
    return (int)cudaErrorInvalidValue;
  // the splits cover the K steps, none empty
  const long long ktiles = (p->K + BK - 1) / BK;
  if ((long long)p->splits * p->kt_per < ktiles ||
      (long long)(p->splits - 1) * p->kt_per >= ktiles)
    return (int)cudaErrorInvalidValue;
  const bool batched = p->batch > 1;
  const long long nb4 = batched ? p->batch : 0;   // rank-4 maps if batched
  CUtensorMap ta, tb;
  int e = make_map(&ta, p->A, nl, p->M, p->K, p->a_plane, p->a_row, nb4,
                   p->a_batch);
  if (!e)
    e = make_map(&tb, p->B, nl, p->N, p->K, p->b_plane, p->b_row, nb4,
                 p->b_batch);
  if (e) return e;
  static bool configured[2] = {false, false};
  if (!configured[batched]) {
    cudaError_t r = cudaFuncSetAttribute(
        batched ? k2_limb_gemm_kernel<true> : k2_limb_gemm_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (r != cudaSuccess) return (int)r;
    configured[batched] = true;
  }
  const dim3 grid((p->N + BN - 1) / BN, (p->M + BM - 1) / BM,
                  batched ? p->batch * p->splits : p->splits);
  const int threads = (nl + 1) / 2 * 128 + 32;
  auto kern = batched ? k2_limb_gemm_kernel<true> : k2_limb_gemm_kernel<false>;
  kern<<<grid, threads, p->smem, static_cast<cudaStream_t>(p->stream)>>>(
      ta, tb, nl, p->w, p->M, p->N, p->K, p->kt_per,
      static_cast<const double*>(p->base), p->bs0, p->bs1,
      static_cast<const double*>(p->sa), p->sas,
      static_cast<const double*>(p->sb), p->sbs,
      static_cast<double*>(p->out), static_cast<int*>(p->ws),
      static_cast<int*>(p->counters), p->splits, p->a_batch != 0,
      p->b_batch != 0, p->base_b, p->sa_b, p->sb_b, p->out_b);
  return (int)cudaGetLastError();
}
