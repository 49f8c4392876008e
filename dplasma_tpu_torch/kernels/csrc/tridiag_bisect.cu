// KT: eigenvalues of a real symmetric tridiagonal matrix by bisection on
// Sturm counts, the searches sharing one bisection tree (see
// kernels/tridiag.py).
//
// Replaces no Pallas kernel: the reference calls
// jax.scipy.linalg.eigh_tridiagonal (dplasma_tpu/ops/eig.py:205, :317).
// Search k bisects the widened Gershgorin interval [lower, upper] for the
// k-th smallest eigenvalue for max_it levels: at each node it counts the
// eigenvalues below the node's shift mid = 0.5 * (lo + hi) by one Sturm
// sequence over the whole matrix and keeps the half whose count brackets
// k. A node's shift is a pure function of its path from the root, and so
// is its count, so the searches can share nodes and a node can be counted
// before any search reaches it. One persistent cooperative launch in two
// phases:
//
//  A. The top tree: every node of depth < D (heap index h in [1, 2^D),
//     its shift found by walking h's path from the root with the same
//     0.5 * (lo + hi) steps a search takes) gets one Sturm sequence; the
//     2^D - 1 counts go to global memory. A grid barrier.
//  B. The searches: each descends the D levels of the top tree, reading
//     the counts on its path, then runs rounds of s levels: a group of
//     2^s lanes evaluates the 2^s - 1 nodes of the next s levels of its
//     subtree (lane 0 idle) and descends them, the counts exchanged by
//     warp shuffles.
//
// The arithmetic of each Sturm step is the reference's, in its order: q =
// alpha[i] - beta_sq[i-1] / q - x with IEEE division, q <= pivmin counts
// and is clamped to min(q, -pivmin); the first step special-cases x ==
// alpha[0]. Every search runs max_it levels (the reference's global stop
// max(upper - lower) <= eps * t_norm is not taken), so the result at an
// index does not depend on the other targets, on D or s: bitwise the
// bisection run to max_it levels.
//
// What bounds it: the dependent chain of a Sturm sequence (one division a
// step: ~150 cycles a step on an H100, the division's slow-path branch
// included) and, with enough sequences in flight, the rate of the
// divisions (one MUFU reciprocal each in f32, a DFMA sequence in f64).
// The top tree replaces the first D levels of every search by 2^D - 1
// sequences; the speculative rounds give each round of s levels
// (2^s - 1) * targets independent sequences, one a thread (two in one
// thread measured slower: each division branches to its slow path, so
// they do not overlap). The lanes read (alpha_i, beta_sq_{i-1}) as one
// interleaved pair held in shared memory for the whole launch (one
// broadcast load a step, no barrier) where the n pairs fit a block's
// 227 KB, else streamed through it in chunks (two block barriers a
// chunk).
#include <cuda_runtime.h>

namespace {

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

constexpr int kSmemMax = 232448;  // bytes one block may use (H100)
constexpr int kChunk = 4096;      // pairs a chunk on the streamed path
constexpr int kMaxDepth = 20;     // the top tree's depth (4 MB of counts)
constexpr int kMaxThreads = 1024;
// returned (as an int) when the grid cannot be placed: not a cudaError_t
constexpr int kUnschedulable = -1;

template <typename T>
struct Params {
  const typename Pair<T>::type* ab;  // n pairs (alpha_i, beta_sq_{i-1})
  const T* par;                      // lower, upper, pivmin, alpha0_pert
  const int* targets;                // m eigenvalue indices, or null: j
  T* out;                            // m results
  int* counts;                       // 2^depth: the top tree's counts
  unsigned long long* bar;           // zeroed: the grid barrier's counter
  int n, max_it, m, depth, s;
};

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// every block has written its counts, and they are visible to every
// block, before any block reads one (the block barrier orders the
// block's stores before thread 0's release add, thread 0's acquire
// before the block's later loads)
__device__ __forceinline__ void grid_barrier(unsigned long long* bar,
                                             unsigned long long target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u64 [%0], 1;" ::"l"(bar)
                 : "memory");
    while (ld_acquire(bar) < target) {
    }
  }
  __syncthreads();
}

// the shift of heap node h (h >= 1) of the tree over [lo, hi]: the path
// below h's leading one, most significant bit first, 1 = the upper half
template <typename T>
__device__ __forceinline__ T node_shift(T lo, T hi, unsigned h) {
  for (int b = 30 - __clz(h); b >= 0; --b) {
    const T mid = T(0.5) * (lo + hi);
    if ((h >> b) & 1u) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return T(0.5) * (lo + hi);
}

template <typename T>
__device__ __forceinline__ void sturm_step(typename Pair<T>::type ab, T x,
                                           T& q, int& cnt, T pivmin) {
  const T v = ab.x - ab.y / q - x;
  const bool low = v <= pivmin;
  cnt += low ? 1 : 0;
  q = low ? (v < -pivmin ? v : -pivmin) : v;
}

// the count of eigenvalues below the shift x. RESIDENT: the n pairs are
// in sh for the whole launch. Else they are streamed through sh in
// chunks, and every thread of the block must call this together.
template <typename T, bool RESIDENT>
__device__ __forceinline__ int sturm(const Params<T>& p,
                                     typename Pair<T>::type* sh, T a0,
                                     T pivmin, T a0p, T x) {
  T q = a0 - x;
  int cnt = q < T(0) ? 1 : 0;
  if (a0 == x) q = a0p;
  if constexpr (RESIDENT) {
#pragma unroll 4
    for (int i = 1; i < p.n; ++i) sturm_step<T>(sh[i], x, q, cnt, pivmin);
  } else {
    for (int c0 = 0; c0 < p.n; c0 += kChunk) {
      const int len = min(kChunk, p.n - c0);
      __syncthreads();
      for (int i = threadIdx.x; i < len; i += blockDim.x) sh[i] = p.ab[c0 + i];
      __syncthreads();
#pragma unroll 4
      for (int i = c0 == 0 ? 1 : 0; i < len; ++i)
        sturm_step<T>(sh[i], x, q, cnt, pivmin);
    }
  }
  return cnt;
}

template <typename T, bool RESIDENT>
__global__ void __launch_bounds__(kMaxThreads, 1)
    kt_tree_kernel(const Params<T> p) {
  using P2 = typename Pair<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  P2* sh = reinterpret_cast<P2*>(smem_raw);
  if constexpr (RESIDENT) {
    for (int i = threadIdx.x; i < p.n; i += blockDim.x) sh[i] = p.ab[i];
    __syncthreads();
  }
  const T lower = p.par[0], upper = p.par[1], pivmin = p.par[2],
          a0p = p.par[3];
  const T a0 = p.ab[0].x;
  const int lane = threadIdx.x & 31;
  // warps numbered across blocks first, so the first items of a phase
  // land on every SM
  const int wid = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  const int nwarps = (blockDim.x >> 5) * gridDim.x;

  // A. the top tree, 32 nodes a warp item (slot 0 idle)
  if (p.depth > 0) {
    const int slots = 1 << p.depth;
    const int items = (slots + 31) / 32;
    const int rounds = (items + nwarps - 1) / nwarps;
    for (int r = 0; r < rounds; ++r) {
      const int item = r * nwarps + wid;
      if (RESIDENT && item >= items) break;
      const int t = item * 32 + lane;
      const bool node = t >= 1 && t < slots;
      const T x = node_shift<T>(lower, upper, node ? unsigned(t) : 1u);
      const int cnt = sturm<T, RESIDENT>(p, sh, a0, pivmin, a0p, x);
      if (node) p.counts[t] = cnt;
    }
    grid_barrier(p.bar, gridDim.x);
  }

  // B. the searches, 32 / G a warp item
  const int G = 1 << p.s;
  const int per_warp = 32 / G;
  const int gl = lane % G, base = lane - gl;
  const int items = (p.m + per_warp - 1) / per_warp;
  const int rounds = (items + nwarps - 1) / nwarps;
  for (int r = 0; r < rounds; ++r) {
    const int item = r * nwarps + wid;
    if (RESIDENT && item >= items) break;
    const int j = item * per_warp + lane / G;
    const bool valid = j < p.m;
    const int k = !valid ? 0 : (p.targets ? p.targets[j] : j);
    T lo = lower, hi = upper;
    unsigned h = 1;
    for (int l = 0; l < p.depth; ++l) {
      const T mid = T(0.5) * (lo + hi);
      if (__ldcg(p.counts + h) <= k) {
        lo = mid;
        h = 2 * h + 1;
      } else {
        hi = mid;
        h = 2 * h;
      }
    }
    for (int left = p.max_it - p.depth; left > 0;) {
      const int rr = left < p.s ? left : p.s;
      const unsigned t = unsigned(gl);
      const T x = node_shift<T>(lo, hi, t >= 1u && t < (1u << rr) ? t : 1u);
      const int cnt = sturm<T, RESIDENT>(p, sh, a0, pivmin, a0p, x);
      unsigned hh = 1;
      for (int l = 0; l < rr; ++l) {
        const T mid = T(0.5) * (lo + hi);
        if (__shfl_sync(0xffffffffu, cnt, base + int(hh)) <= k) {
          lo = mid;
          hh = 2 * hh + 1;
        } else {
          hi = mid;
          hh = 2 * hh;
        }
      }
      left -= rr;
    }
    if (valid && gl == 0) p.out[j] = T(0.5) * (lo + hi);
  }
}

template <typename T, bool RESIDENT>
int launch(const Params<T>& p, int threads, cudaStream_t s) {
  auto kern = kt_tree_kernel<T, RESIDENT>;
  using P2 = typename Pair<T>::type;
  const size_t smem = (size_t)(RESIDENT ? p.n : kChunk) * sizeof(P2);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return kUnschedulable;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(per_sm * sms, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 0;
  if (p.depth > 0) {  // the grid barrier: every block co-resident
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.numAttrs = 1;
  }
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int run(int n, int max_it, const void* ab, const void* par,
        const int* targets, int m, void* out, int depth, int s,
        int resident, void* counts, void* bar, int threads,
        cudaStream_t stream) {
  Params<T> p;
  p.ab = static_cast<const typename Pair<T>::type*>(ab);
  p.par = static_cast<const T*>(par);
  p.targets = targets;
  p.out = static_cast<T*>(out);
  p.counts = static_cast<int*>(counts);
  p.bar = static_cast<unsigned long long*>(bar);
  p.n = n;
  p.max_it = max_it;
  p.m = m;
  p.depth = depth;
  p.s = s;
  return resident ? launch<T, true>(p, threads, stream)
                  : launch<T, false>(p, threads, stream);
}

}  // namespace

// One launch: the m eigenvalues at ``targets`` (null: 0 .. m-1) of the
// tridiagonal given as n interleaved pairs ab = (alpha_i, beta_sq_{i-1})
// (ab[0].y unused), par = (lower, upper, pivmin, alpha0_perturbation),
// bisected for max_it levels: a top tree of ``depth`` levels (counts: 2^depth
// int32; bar: a zeroed uint64 of this launch alone, both unused at depth
// 0), then rounds of s levels (1 to 5), the pairs resident in shared
// memory (``resident``) or streamed in chunks.
extern "C" int dtt_kt_tree(int dtype, int n, int max_it, const void* ab,
                           const void* par, const void* targets, int m,
                           void* out, int depth, int s, int resident,
                           void* counts, void* bar, int threads,
                           void* stream) {
  const int elem = dtype == 0 ? 4 : 8;
  if ((dtype != 0 && dtype != 1) || n < 2 || max_it < 1 || m < 1 ||
      depth < 0 || depth > kMaxDepth || depth > max_it || s < 1 || s > 5 ||
      threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 ||
      (depth > 0 && (counts == nullptr || bar == nullptr)) ||
      (resident && (size_t)n * 2 * elem > (size_t)kSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tg = static_cast<const int*>(targets);
  if (dtype == 0)
    return run<float>(n, max_it, ab, par, tg, m, out, depth, s, resident,
                      counts, bar, threads, st);
  return run<double>(n, max_it, ab, par, tg, m, out, depth, s, resident,
                     counts, bar, threads, st);
}

// One IEEE double division a thread: the compiled sequence whose DFMA
// count the bound of the f64 Sturm step reads from the SASS.
extern "C" __global__ void kt_ddiv_probe(const double* a, const double* b,
                                         double* c) {
  const int i = threadIdx.x;
  c[i] = a[i] / b[i];
}
