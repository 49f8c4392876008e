// K5 on Hopper: the ring transfers of the block-cyclic factorizations.
//
//   ring_bcast: the root's 2-D block, broadcast along one mesh axis of n
//               ranks as a chunked store-and-forward ring;
//   ring_shift: one neighbour hop, rank r's block into rank (r+1) mod n.
//
// Replaces dplasma_tpu/kernels/pallas_ring.py:ring_bcast (pallas_call at
// :321, body :284-314) and :ring_shift (pallas_call at :357, body
// :347-355). On the TPU those are remote DMAs between chips over ICI with
// DMA semaphores. Here the n ranks of one ring line are block groups of
// ONE cooperative launch (block group r plays rank r), and each rank's
// buffers are passed as plain device pointers, so the device code assumes
// nothing about where they live: the multi-card form passes peer pointers
// and moves the flags' scope to the system, and only host code changes.
//
// The schedule is the reference's. Let d = (r - root) mod n:
//   for each chunk c:  d == 0 : copy chunk c from in to out (the seed)
//                               and on into the right neighbour's out, in
//                               one pass (the forward writes the values
//                               the seed wrote, from registers);
//                      d >  0 : wait until chunk c has arrived in out;
//                      d < n-1: copy chunk c from own out into the right
//                               neighbour's out, then signal it.
// Chunk c+1 streams into a rank while it forwards chunk c, and each hop
// carries the payload once. ring_shift copies in[r] into out[r+1],
// signals, then waits for its own arrival.
//
// The hard parts and what the design does about them:
// - Spin-waits need every rank's blocks on the card at once (blocks run
//   in no order, so a waiting block could starve the block it waits for).
//   The launch is cooperative (cudaLaunchCooperativeKernel), which either
//   makes all n*B blocks co-resident or refuses the launch
//   (cudaErrorCooperativeLaunchTooLarge); the host sizes B from
//   cudaOccupancyMaxActiveBlocksPerMultiprocessor (dtt_k5_coresident).
// - Memory order. A sender's threads store the chunk, fence, meet at
//   __syncthreads(), and one thread does a release add on the receiver's
//   counter for that chunk. The receiver's one thread spins with an
//   acquire load (cuda::atomic_ref, device scope), then __syncthreads().
//   Forwarded data is read with ld.global.cg (L2, never a stale L1 line)
//   or by a bulk copy (L2 as well).
// - How a chunk moves. Block b of a rank owns the b-th contiguous range
//   of the chunk's rows in every copy. Where source and destination are
//   contiguous spans and 16-byte aligned (the forwards between the
//   ranks' outputs, the shift), thread 0 moves the block's bytes with
//   Hopper's bulk copies: cp.async.bulk global->shared (mbarrier
//   complete_tx), then shared->global, NSLOT copies in flight. Before the
//   release that signals them the stores are complete
//   (cp.async.bulk.wait_group 0) and fenced against the generic proxy
//   (fence.proxy.async.global); a receiver fences the other way before
//   its bulk reads. Strided rows (the root's column slice of a slab) and
//   4- or 2-byte units take a thread loop with ILP rows' 16-byte loads in
//   flight per thread.
// - Several blocks send one chunk, so the receiver waits for all of them:
//   every counter gets exactly B adds per launch (the root adds its own
//   after seeding), and the host passes target = B * epoch, epoch being
//   this flag buffer's launch count. Flags are never reset.
// - Strided blocks: each rank's in/out has its own row stride (a column
//   slice of a row-major slab is a view); rows are copied in place, with
//   no contiguous copy first. Columns must be unit-stride.
// - The chunk count divides the rows (the wrapper clamps it down to a
//   divisor, as the reference's _resolve_chunks does).
//
// What bounds it on this card: bytes. A broadcast of S bytes to n ranks
// must read S and write n*S, (n+1)*S; this schedule moves (2n-1)*S (the
// root reads S and writes 2S, each of the n-2 further forwards reads and
// writes S). A shift must move 2*n*S. The
// copy unit is the widest of 16, 4 or 2 bytes that the row bytes, the
// strides and the pointers allow; rows map to warps so that neighbouring
// threads touch neighbouring 16-byte words.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAXN = 16;

typedef unsigned long long flag_t;

struct RingPtrs {
  const char* in[MAXN];
  char* out[MAXN];
  long long ld_in[MAXN];   // row strides, bytes
  long long ld_out[MAXN];
};

__device__ __forceinline__ void wait_flag(flag_t* f, flag_t target) {
  if (threadIdx.x == 0) {
    cuda::atomic_ref<flag_t, cuda::thread_scope_device> a(*f);
    while (a.load(cuda::memory_order_acquire) < target) __nanosleep(64);
  }
  __syncthreads();
}

__device__ __forceinline__ void signal_flag(flag_t* f) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    cuda::atomic_ref<flag_t, cuda::thread_scope_device> a(*f);
    a.fetch_add(1ull, cuda::memory_order_release);
  }
}

// Bulk-copy staging of one block: NSLOT slots of SLOT bytes, one
// mbarrier each, and the parity of each slot's next phase (thread 0's).
constexpr int SLOT = 8192;
constexpr int NSLOT = 4;

__device__ __forceinline__ unsigned saddr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

struct Stage {
  uint4 buf[NSLOT][SLOT / 16];
  uint64_t bar[NSLOT];
};

__device__ __forceinline__ void bulk_load(void* dst, const void* src, int n,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(saddr(dst)),
      "l"(src), "r"(n), "r"(saddr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           int n) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(saddr(src)), "r"(n)
               : "memory");
}

// Bytes [lo, hi) of a contiguous span, by thread 0 of the block with
// Hopper's bulk copies: up to NSLOT global->shared loads in flight, each
// stored back shared->global as it lands. On return the stores are
// complete and ordered before the generic proxy (the caller's release).
__device__ __forceinline__ void bulk_span(const char* src, char* dst,
                                          long long lo, long long hi,
                                          Stage& st, unsigned& parity) {
  // order this thread's acquire (generic proxy) before the async reads
  asm volatile("fence.proxy.async.global;" ::: "memory");
  for (long long off = lo; off < hi; off += (long long)NSLOT * SLOT) {
    int np = 0, sz[NSLOT];
#pragma unroll
    for (int k = 0; k < NSLOT; ++k) {
      const long long o = off + (long long)k * SLOT;
      if (o >= hi) break;
      sz[k] = (int)min((long long)SLOT, hi - o);
      dtt_cluster::mbar_expect(&st.bar[k], sz[k]);
      bulk_load(st.buf[k], src + o, sz[k], &st.bar[k]);
      ++np;
    }
    for (int k = 0; k < np; ++k) {
      dtt_cluster::mbar_wait(&st.bar[k], (parity >> k) & 1);
      parity ^= 1u << k;
      bulk_store(dst + off + (long long)k * SLOT, st.buf[k], sz[k]);
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// Rows [row0, row0 + nrows) of a (.., upr units) block, shared by the B
// blocks of one rank: block b takes the b-th of B contiguous row ranges,
// so every copy of a chunk by one rank gives each block the same rows.
// A contiguous span on both sides with 16-byte units goes by bulk copies,
// the block's bytes by thread 0. Otherwise (strided rows, 4- or 2-byte
// units, or a second destination) the threads split into rpi rows of tpr
// lanes that walk the columns, with ILP rows' loads in flight per thread;
// dst2, when given, receives the same rows (the root's seed and its
// forward in one pass).
constexpr int ILP = 4;

template <typename U>
__device__ __forceinline__ void copy_rows(const char* src, long long lds,
                                          char* dst, long long ldd,
                                          char* dst2, long long ldd2,
                                          long long row0, long long nrows,
                                          long long upr, int b, int B,
                                          Stage& st, unsigned& parity) {
  const long long rowb = upr * (long long)sizeof(U);
  const long long per = (nrows + B - 1) / B;
  const long long lo = row0 + min(nrows, (long long)b * per);
  const long long hi = row0 + min(nrows, (long long)(b + 1) * per);
  if (lo >= hi) return;
  if (sizeof(U) == 16 && !dst2 && lds == rowb && ldd == rowb) {
    if (threadIdx.x == 0)
      bulk_span(src, dst, lo * rowb, hi * rowb, st, parity);
    return;
  }
  const int tpr = upr >= THREADS ? THREADS : (int)upr;
  const int rpi = THREADS / tpr;
  const int sub = threadIdx.x / tpr, lane = threadIdx.x % tpr;
  if (sub >= rpi) return;
  for (long long r = lo + sub; r < hi; r += (long long)rpi * ILP) {
    for (long long c = lane; c < upr; c += tpr) {
      U v[ILP];
#pragma unroll
      for (int j = 0; j < ILP; ++j)
        if (r + j * rpi < hi)
          v[j] = __ldcg(reinterpret_cast<const U*>(src + (r + j * rpi) *
                                                   lds) + c);
#pragma unroll
      for (int j = 0; j < ILP; ++j)
        if (r + j * rpi < hi) {
          __stcg(reinterpret_cast<U*>(dst + (r + j * rpi) * ldd) + c, v[j]);
          if (dst2)
            __stcg(reinterpret_cast<U*>(dst2 + (r + j * rpi) * ldd2) + c,
                   v[j]);
        }
    }
  }
}

// Thread 0 sets up the block's bulk-copy barriers.
__device__ __forceinline__ void init_stage(Stage& st) {
  if (threadIdx.x == 0) {
    for (int k = 0; k < NSLOT; ++k) dtt_cluster::mbar_init(&st.bar[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

template <typename U>
__global__ void __launch_bounds__(THREADS)
k5_ring_bcast_kernel(RingPtrs a, int n, int root, int chunks,
                     long long rows, long long upr, flag_t* flags,
                     flag_t target) {
  const int B = gridDim.x / n;
  const int r = blockIdx.x / B, b = blockIdx.x % B;
  const int d = (r - root + n) % n;
  const int right = (r + 1) % n;
  const long long csz = rows / chunks;
  __shared__ __align__(128) Stage st;
  unsigned parity = 0;
  init_stage(st);
  for (int c = 0; c < chunks; ++c) {
    const long long row0 = (long long)c * csz;
    flag_t* mine = flags + (long long)r * chunks + c;
    flag_t* theirs = flags + (long long)right * chunks + c;
    if (d == 0) {
      // the seed and the first hop in one pass over the root's rows: the
      // forward writes what the seed wrote, from registers
      copy_rows<U>(a.in[r], a.ld_in[r], a.out[r], a.ld_out[r], a.out[right],
                   a.ld_out[right], row0, csz, upr, b, B, st, parity);
      signal_flag(mine);  // the root's own arrival: B adds per launch
      signal_flag(theirs);
      continue;
    }
    wait_flag(mine, target);
    if (d < n - 1) {
      copy_rows<U>(a.out[r], a.ld_out[r], a.out[right], a.ld_out[right],
                   nullptr, 0, row0, csz, upr, b, B, st, parity);
      signal_flag(theirs);
    }
  }
}

template <typename U>
__global__ void __launch_bounds__(THREADS)
k5_ring_shift_kernel(RingPtrs a, int n, long long rows, long long upr,
                     flag_t* flags, flag_t target) {
  const int B = gridDim.x / n;
  const int r = blockIdx.x / B, b = blockIdx.x % B;
  const int right = (r + 1) % n;
  __shared__ __align__(128) Stage st;
  unsigned parity = 0;
  init_stage(st);
  copy_rows<U>(a.in[r], a.ld_in[r], a.out[right], a.ld_out[right], nullptr,
               0, 0, rows, upr, b, B, st, parity);
  signal_flag(flags + right);
  wait_flag(flags + r, target);
}

template <typename K>
int coresident(K kernel, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  const int m = per_sm * sms;
  if (m < *out) *out = m;
  return 0;
}

int fill(RingPtrs* p, int n, const void* const* in, const long long* ld_in,
         void* const* out, const long long* ld_out) {
  if (n < 2 || n > MAXN) return (int)cudaErrorInvalidValue;
  for (int r = 0; r < n; ++r) {
    p->in[r] = static_cast<const char*>(in[r]);
    p->out[r] = static_cast<char*>(out[r]);
    p->ld_in[r] = ld_in[r];
    p->ld_out[r] = ld_out[r];
  }
  return 0;
}

template <typename U>
int launch_bcast(RingPtrs* p, int n, int root, int chunks, int B,
                 long long rows, long long upr, flag_t* flags, flag_t target,
                 cudaStream_t s) {
  void* args[] = {p, &n, &root, &chunks, &rows, &upr, &flags, &target};
  int e = (int)cudaLaunchCooperativeKernel((void*)k5_ring_bcast_kernel<U>,
                                       dim3(n * B), dim3(THREADS), args, 0,
                                       s);
  return e ? e : (int)cudaGetLastError();
}

template <typename U>
int launch_shift(RingPtrs* p, int n, int B, long long rows, long long upr,
                 flag_t* flags, flag_t target, cudaStream_t s) {
  void* args[] = {p, &n, &rows, &upr, &flags, &target};
  int e = (int)cudaLaunchCooperativeKernel((void*)k5_ring_shift_kernel<U>,
                                       dim3(n * B), dim3(THREADS), args, 0,
                                       s);
  return e ? e : (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes. Pointer arrays are host arrays
// of n entries; strides are in bytes; ``unit`` (16, 4 or 2) is the copy
// width, which must divide row_bytes, every stride and every pointer.
// Each returns 0 once launched, else a cudaError_t.

// The most blocks of any K5 instantiation that fit on the current device
// at once (the cooperative launch's limit for n * blocks_per_rank).
extern "C" int dtt_k5_coresident(int* out) {
  int m = 1 << 30, e = 0;
  if (!e) e = coresident(k5_ring_bcast_kernel<uint4>, &m);
  if (!e) e = coresident(k5_ring_bcast_kernel<unsigned int>, &m);
  if (!e) e = coresident(k5_ring_bcast_kernel<unsigned short>, &m);
  if (!e) e = coresident(k5_ring_shift_kernel<uint4>, &m);
  if (!e) e = coresident(k5_ring_shift_kernel<unsigned int>, &m);
  if (!e) e = coresident(k5_ring_shift_kernel<unsigned short>, &m);
  *out = m;
  return e;
}

extern "C" int dtt_k5_ring_bcast(int n, int root, int chunks,
                                 int blocks_per_rank, long long rows,
                                 long long row_bytes, int unit,
                                 const void* const* in,
                                 const long long* ld_in, void* const* out,
                                 const long long* ld_out, void* flags,
                                 unsigned long long target, void* stream) {
  RingPtrs p;
  int e = fill(&p, n, in, ld_in, out, ld_out);
  if (e) return e;
  if (root < 0 || root >= n || chunks < 1 || rows % chunks ||
      blocks_per_rank < 1 || row_bytes % unit)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0 || row_bytes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  flag_t* f = static_cast<flag_t*>(flags);
  const long long upr = row_bytes / unit;
  if (unit == 16)
    return launch_bcast<uint4>(&p, n, root, chunks, blocks_per_rank, rows,
                               upr, f, target, s);
  if (unit == 4)
    return launch_bcast<unsigned int>(&p, n, root, chunks, blocks_per_rank,
                                      rows, upr, f, target, s);
  if (unit == 2)
    return launch_bcast<unsigned short>(&p, n, root, chunks,
                                        blocks_per_rank, rows, upr, f,
                                        target, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int dtt_k5_ring_shift(int n, int blocks_per_rank, long long rows,
                                 long long row_bytes, int unit,
                                 const void* const* in,
                                 const long long* ld_in, void* const* out,
                                 const long long* ld_out, void* flags,
                                 unsigned long long target, void* stream) {
  RingPtrs p;
  int e = fill(&p, n, in, ld_in, out, ld_out);
  if (e) return e;
  if (blocks_per_rank < 1 || row_bytes % unit)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0 || row_bytes <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  flag_t* f = static_cast<flag_t*>(flags);
  const long long upr = row_bytes / unit;
  if (unit == 16)
    return launch_shift<uint4>(&p, n, blocks_per_rank, rows, upr, f, target,
                               s);
  if (unit == 4)
    return launch_shift<unsigned int>(&p, n, blocks_per_rank, rows, upr, f,
                                      target, s);
  if (unit == 2)
    return launch_shift<unsigned short>(&p, n, blocks_per_rank, rows, upr, f,
                                        target, s);
  return (int)cudaErrorInvalidValue;
}
