// Host and device helpers shared by the cluster panel kernels (K3
// lu_panel.cu, K4 geqrt_panel.cu): one thread-block cluster per panel.
//
// Launch: grid = one cluster of C blocks (C <= 16; above 8 only with
// cudaFuncAttributeNonPortableClusterSizeAllowed), `smem` bytes of
// dynamic shared memory per block. Before each launch the occupancy
// query says whether such a cluster can be placed on the card at all;
// if it cannot, the launch is refused with kClusterUnschedulable
// instead of failing later.

#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

namespace dtt_cluster {

constexpr int kMaxCluster = 16;
// returned (as an int) when no cluster of the requested shape fits on the
// card: not a cudaError_t value
constexpr int kClusterUnschedulable = -1;

// Per-column exchange by push (the panel kernels' slots): every block
// writes its record into a slot of EVERY block's shared memory with
// st.async, which counts the bytes off that block's mbarrier when they
// land (complete_tx); a block posts the bytes it expects (arrive +
// expect_tx on its own mbarrier) and waits until all C records of the
// column are in, then reads them locally. Data and signal travel
// together, one way, where a barrier.cluster followed by remote reads
// is two round trips. Two mbarriers alternate by column parity (one
// arrival each phase); the u-th use of one completes its phase u, so
// the wait parity is u & 1. A record may land before its phase's
// expect_tx is posted: the phase cannot complete while that arrival is
// missing.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(a),
               "r"(count)
               : "memory");
}

// after every block's mbar_init, before any remote operation (then a
// cluster barrier)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// this block's arrival on its own mbarrier, expecting `bytes` to land
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(a),
      "r"(bytes)
      : "memory");
}

// The shared::cluster address of `p` (this block's shared memory) in
// block `rank`.
__device__ __forceinline__ unsigned remote_addr(const void* p, int rank) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  unsigned ra;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(ra)
               : "r"(a), "r"(rank));
  return ra;
}

// 16 bytes into block-remote shared memory at `dst`, counted off the
// mbarrier at `bar` (both remote_addr values of the same block)
__device__ __forceinline__ void push16(unsigned dst, unsigned bar, float x,
                                       float y, float z, float w) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32"
      " [%0], {%1, %2, %3, %4}, [%5];" ::"r"(dst),
      "f"(x), "f"(y), "f"(z), "f"(w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void push8(unsigned dst, unsigned bar,
                                      unsigned x, unsigned y) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32"
      " [%0], {%1, %2}, [%3];" ::"r"(dst),
      "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1],"
        " %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// The first row at or after lo of the rows l == tid (mod stride).
__device__ __forceinline__ int first_at(int tid, int lo, int stride) {
  return lo <= tid ? tid : tid + ((lo - tid + stride - 1) / stride) * stride;
}

template <typename Kernel>
cudaError_t configure(Kernel kernel, int cluster, int threads, int smem,
                      cudaStream_t stream, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  if (cluster > 8) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster, 1, 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int cluster, int threads, int smem,
           cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(kernel, cluster, threads, smem, stream, &cfg,
                            &attr);
  if (e != cudaSuccess) return (int)e;
  int fits = 0;
  e = cudaOccupancyMaxActiveClusters(&fits, (void*)kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (fits < 1) return kClusterUnschedulable;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace dtt_cluster
