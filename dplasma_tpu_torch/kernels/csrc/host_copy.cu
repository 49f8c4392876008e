// The host link of the out-of-HBM tiers: one pitched 2-D copy between
// pinned host memory and the device, asynchronous on the caller's stream.
//
// Not a kernel and no TPU counterpart: the reference ships each streamed
// chunk of its host matrix as a strided numpy slice through jnp.asarray
// (dplasma_tpu/ops/potrf.py:322-330, lu.py:838-843, qr.py:466-476). In
// PyTorch such a slice (rows r0:, columns c0:c1 of a row-major matrix) is
// not contiguous, and Tensor.copy_ first gathers it into pageable memory,
// which loses both the pinned transfer rate and the asynchrony. One
// cudaMemcpy2DAsync moves the block as `height` rows of `width` bytes at
// the source's and destination's own pitches, straight from (or into) the
// pinned host matrix, so each chunk is one DMA transfer of exactly its
// bytes. What bounds it: the host link (PCIe), bytes each way.
#include <cuda_runtime.h>
#include <cstddef>

// kind: 1 host to device, 2 device to host (cudaMemcpyKind's values).
// Returns the cudaError_t of the enqueue (0 on success).
extern "C" int dtt_copy2d(void* dst, size_t dpitch, const void* src,
                          size_t spitch, size_t width, size_t height,
                          int kind, void* stream) {
  cudaError_t e = cudaMemcpy2DAsync(dst, dpitch, src, spitch, width, height,
                                    static_cast<cudaMemcpyKind>(kind),
                                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}
