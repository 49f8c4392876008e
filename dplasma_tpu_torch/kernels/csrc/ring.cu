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
//   for each chunk c:  d == 0 : copy chunk c from in to out (the seed);
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
//   Forwarded data is read with ld.global.cg (L2, never a stale L1 line).
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
// must read S and write n*S, (n+1)*S; this schedule moves 2*n*S (the
// seed copy and n-1 forwards, each a read and a write). A shift must
// move 2*n*S. The copy unit is the widest of 16, 4 or 2 bytes that the row
// bytes, the strides and the pointers allow; rows map to warps so that
// neighbouring threads touch neighbouring 16-byte words.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Rows [row0, row0 + nrows) of a (.., upr units) block, shared by the B
// blocks of one rank: block b takes every B-th group of rpi rows, its
// threads split into rpi rows of tpr lanes that walk the columns.
template <typename U>
__device__ __forceinline__ void copy_rows(const char* src, long long lds,
                                          char* dst, long long ldd,
                                          long long row0, long long nrows,
                                          long long upr, int b, int B) {
  const int tpr = upr >= THREADS ? THREADS : (int)upr;
  const int rpi = THREADS / tpr;
  const int sub = threadIdx.x / tpr, lane = threadIdx.x % tpr;
  if (sub >= rpi) return;
  const long long end = row0 + nrows;
  for (long long r = row0 + (long long)b * rpi + sub; r < end;
       r += (long long)B * rpi) {
    const U* s = reinterpret_cast<const U*>(src + r * lds);
    U* o = reinterpret_cast<U*>(dst + r * ldd);
    for (long long c = lane; c < upr; c += tpr) __stcg(o + c, __ldcg(s + c));
  }
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
  for (int c = 0; c < chunks; ++c) {
    const long long row0 = (long long)c * csz;
    flag_t* mine = flags + (long long)r * chunks + c;
    if (d == 0) {
      copy_rows<U>(a.in[r], a.ld_in[r], a.out[r], a.ld_out[r], row0, csz,
                   upr, b, B);
      signal_flag(mine);  // the root's own arrival: B adds per launch
    } else {
      wait_flag(mine, target);
    }
    if (d < n - 1) {
      copy_rows<U>(a.out[r], a.ld_out[r], a.out[right], a.ld_out[right],
                   row0, csz, upr, b, B);
      signal_flag(flags + (long long)right * chunks + c);
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
  copy_rows<U>(a.in[r], a.ld_in[r], a.out[right], a.ld_out[right], 0, rows,
               upr, b, B);
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
