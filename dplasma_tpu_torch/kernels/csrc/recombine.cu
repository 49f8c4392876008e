// K2 on Hopper: the level recombine + epilogue that closes every exact
// limb product of the f64-equivalent (dd) route,
//
//     out[i, j] = base[i, j] - (sum_l lv[l, i, j] * 2^(-w(l+2))) * (sa[i] * sb[j])
//
// or -(sum ...) * (sa[i] * sb[j]) without a base (gemm_f64 passes -sa).
//
// Replaces dplasma_tpu/kernels/pallas_dd.py:recombine_base (body
// _recombine_kernel, pallas_call at :83). On the TPU, f64 is an f32 pair,
// so the Pallas body splits each int32 level into exact hi16/lo16 f32
// terms and sums them by Knuth two-sum in double-single (~2^-48). Hopper
// has f64 ALUs, so this kernel computes the same function in f64, in the
// order of the reference's exact route (kernels/dd.py _level_recombine,
// then base - U * (sa * sb)):
//   - each term lv * 2^(-w(l+2)) is exact (an int32 times a power of two
//     fits in 53 bits), and the scale sa * sb is a power of two;
//   - every operation is __dmul_rn / __dadd_rn / __dsub_rn, so ptxas
//     contracts nothing into an FMA. The result therefore equals the
//     plain PyTorch version (recombine_base_reference) bit for bit, also
//     where a product is subnormal and an FMA would round differently.
//
// Layout: the levels are one contiguous (nl, M, N) int32 array (the dd
// route accumulates them in place, so no stack copy is made); base is f64
// with element strides (a view of A in the trailing update); sa (M) and
// sb (N) are contiguous f64; out is a contiguous (M, N) f64 array.
//
// What bounds it on this card: bytes. Per element it reads 4*nl bytes of
// levels and 8 of base and writes 8, about one f64 multiply-add per 2.5
// bytes, far below the ridge of the f64 units. The design is one thread
// per element of a row segment: blockIdx.y walks rows, threads walk
// columns, so every level plane, the base row and the output row are read
// and written coalesced, and sa[i] is one broadcast load per row. The nl
// loads of an element are independent; the kernel is instantiated for
// nl = 8 (53 bits) and nl = 5 (32 bits) so they are unrolled and in
// flight together. No shared memory, no synchronisation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int NL>
__global__ void __launch_bounds__(THREADS)
k2_recombine_kernel(int nl_rt, int w, long long M, long long N,
                    const int32_t* __restrict__ lv,
                    const double* __restrict__ base, long long bs0,
                    long long bs1, const double* __restrict__ sa,
                    const double* __restrict__ sb,
                    double* __restrict__ out) {
  const int nl = NL > 0 ? NL : nl_rt;
  const long long plane = M * N;
  double c[NL > 0 ? NL : 1];  // the level weights 2^(-w(l+2)), exact
#pragma unroll
  for (int l = 0; l < (NL > 0 ? NL : 1); ++l) c[l] = ldexp(1.0, -w * (l + 2));
  for (long long i = blockIdx.y; i < M; i += gridDim.y) {
    const double sai = sa[i];
    const int32_t* row = lv + i * N;
    for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         j < N; j += (long long)gridDim.x * blockDim.x) {
      double acc = 0.0;
      if (NL > 0) {
        int32_t v[NL > 0 ? NL : 1];
#pragma unroll
        for (int l = 0; l < NL; ++l) v[l] = __ldg(row + l * plane + j);
#pragma unroll
        for (int l = 0; l < NL; ++l) {
          const double t = __dmul_rn((double)v[l], c[l]);
          acc = l == 0 ? t : __dadd_rn(acc, t);
        }
      } else {
        for (int l = 0; l < nl; ++l) {
          const double t = __dmul_rn((double)__ldg(row + l * plane + j),
                                     ldexp(1.0, -w * (l + 2)));
          acc = l == 0 ? t : __dadd_rn(acc, t);
        }
      }
      const double prod = __dmul_rn(acc, __dmul_rn(sai, sb[j]));
      out[i * N + j] = base != nullptr
                           ? __dsub_rn(base[i * bs0 + j * bs1], prod)
                           : -prod;
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. ``base`` may be null (no base).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int dtt_k2_recombine(int nl, int w, long long M, long long N,
                                const void* lv, const void* base,
                                long long bs0, long long bs1, const void* sa,
                                const void* sb, void* out, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (nl <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long gx = (N + THREADS - 1) / THREADS;
  if (gx > 64) gx = 64;
  long long gy = M < 65535 ? M : 65535;
  dim3 grid((unsigned)gx, (unsigned)gy);
  const int32_t* l = static_cast<const int32_t*>(lv);
  const double* b = static_cast<const double*>(base);
  const double* a_s = static_cast<const double*>(sa);
  const double* b_s = static_cast<const double*>(sb);
  double* o = static_cast<double*>(out);
  if (nl == 8)
    k2_recombine_kernel<8><<<grid, THREADS, 0, s>>>(nl, w, M, N, l, b, bs0,
                                                    bs1, a_s, b_s, o);
  else if (nl == 5)
    k2_recombine_kernel<5><<<grid, THREADS, 0, s>>>(nl, w, M, N, l, b, bs0,
                                                    bs1, a_s, b_s, o);
  else
    k2_recombine_kernel<0><<<grid, THREADS, 0, s>>>(nl, w, M, N, l, b, bs0,
                                                    bs1, a_s, b_s, o);
  return (int)cudaGetLastError();
}
