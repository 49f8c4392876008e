// KT: eigenvalues of a real symmetric tridiagonal matrix by bisection on
// Sturm counts, one thread per eigenvalue index (see kernels/tridiag.py).
//
// Replaces no Pallas kernel: the reference calls
// jax.scipy.linalg.eigh_tridiagonal (dplasma_tpu/ops/eig.py:205, :317).
// Thread k searches the k-th smallest eigenvalue: starting from the
// widened Gershgorin interval [lower, upper] it runs max_it bisection
// steps, each a Sturm sequence over the whole matrix counting the
// eigenvalues below mid, and keeps the half whose count brackets k. The
// diagonal alpha and the squared off-diagonal beta_sq are streamed
// through shared memory in chunks; every thread of the block reads the
// same element, so each shared load is a broadcast.
//
// The arithmetic is the reference's, in its order: q = alpha[i] -
// beta_sq[i-1] / q - x with IEEE division, q <= pivmin counts and is
// clamped to min(q, -pivmin); the first step special-cases x == alpha[0].
// The reference stops all searches together once max(upper - lower) <=
// eps * t_norm; here every search runs max_it steps (the later ones stay
// inside the interval that stop leaves).
//
// What bounds it: the dependent chain of divisions in each thread.
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 2048;

template <typename T>
__global__ void kt_bisect_kernel(int n, int max_it, const T* __restrict__ alpha,
                                 const T* __restrict__ beta_sq,
                                 const T* __restrict__ params,
                                 T* __restrict__ out) {
  __shared__ T s_alpha[CHUNK];
  __shared__ T s_bsq[CHUNK];
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = k < n;
  const T lo0 = params[0], hi0 = params[1], pivmin = params[2],
          a0p = params[3];
  T lower = lo0, upper = hi0;
  T mid = T(0.5) * (upper + lower);
  const T a0 = alpha[0];
  for (int it = 0; it < max_it; ++it) {
    // step 0
    T q = a0 - mid;
    int count = q < T(0) ? 1 : 0;
    if (a0 == mid) q = a0p;
    for (int c0 = 0; c0 < n; c0 += CHUNK) {
      const int len = min(CHUNK, n - c0);
      __syncthreads();
      for (int i = threadIdx.x; i < len; i += blockDim.x) {
        s_alpha[i] = alpha[c0 + i];
        // beta_sq holds n entries, the last unused
        s_bsq[i] = c0 + i > 0 ? beta_sq[c0 + i - 1] : T(0);
      }
      __syncthreads();
      if (live) {
        for (int i = (c0 == 0 ? 1 : 0); i < len; ++i) {
          q = s_alpha[i] - s_bsq[i] / q - mid;
          if (q <= pivmin) {
            ++count;
            q = q < -pivmin ? q : -pivmin;
          }
        }
      }
    }
    if (count <= k) {
      lower = mid;
    } else {
      upper = mid;
    }
    mid = T(0.5) * (lower + upper);
  }
  if (live) out[k] = mid;
}

}  // namespace

extern "C" int dtt_kt_bisect(int dtype, int n, int max_it, const void* alpha,
                             const void* beta_sq, const void* params, void* out,
                             int threads, void* stream) {
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    kt_bisect_kernel<float><<<blocks, threads, 0, s>>>(
        n, max_it, static_cast<const float*>(alpha),
        static_cast<const float*>(beta_sq), static_cast<const float*>(params),
        static_cast<float*>(out));
  } else if (dtype == 1) {
    kt_bisect_kernel<double><<<blocks, threads, 0, s>>>(
        n, max_it, static_cast<const double*>(alpha),
        static_cast<const double*>(beta_sq),
        static_cast<const double*>(params), static_cast<double*>(out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
