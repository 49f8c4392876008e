// KW: one step of a narrow successive-band-reduction sweep (b <= 32), all
// window slots of the step in one launch (see kernels/sbr.py).
//
// Replaces no Pallas kernel: the reference runs the step as plain JAX,
// vmapped over the slots, inside lax.scan (dplasma_tpu/ops/band.py, `one`
// of herm_sbr_sweep_banded :460-482, `qr_one` / `lq_one` of
// bidiag_sbr_sweep :291-307).
//
// One thread block per slot g. The block copies its strips into shared
// memory, runs the Householder QR of its block column by column with
// LAPACK larfg conventions (beta = -sign(Re alpha) * ||(alpha, x)||,
// tau = (beta - alpha) / beta, v = x / (alpha - beta); tau = 0 when x = 0
// and Im alpha = 0), applies each reflector as it is made, and writes the
// strips back in place:
//
//  herm    F is column-major full-band storage, F[L0 + c][D + r - c] =
//          A[r, c], row width H; slot g's anchor column c0 is F row
//          bs + g*S. Row strip R[i][t] = A[c0+b+i][c0+t] (b x V); column
//          strip C[t][i] = conj(R[i][t]) but for rows t in [b, 2b), which
//          take the left-updated R1[t-b][b+i]. The u reflectors come from
//          columns b-u .. b-1 of R (u = 0: no reflector, the column strip
//          is still rewritten as the mirror, as the reference's does).
//          R <- Q^H R, C <- C Q, R[:, b:2b] <- C[b:2b, :]^T-untransposed.
//  bidiag  X dense, row stride ld; slot g's window at (c0, c0). The QR
//          step factors R = X[c0:c0+b, c0:c0+V]'s leading b x b block and
//          applies Q^H to R; the LQ step factors the conjugate transpose
//          of the b x b block of C = X[c0:c0+V, c0+off:c0+off+b] with its
//          rows >= u masked (the reflectors come from C's rows 0..u-1)
//          and applies Q to C from the right. u = 0: a parked slot of
//          zeros, left alone.
//
// What bounds it: the chain of b reflectors per block, each a warp
// reduction and two barriers, and the launch; not bytes or operations.
#include <cuda_runtime.h>

namespace {

template <typename R>
struct Cx {
  R re, im;
};

template <typename R>
__device__ __forceinline__ Cx<R> operator+(Cx<R> a, Cx<R> b) {
  return {a.re + b.re, a.im + b.im};
}
template <typename R>
__device__ __forceinline__ Cx<R> operator-(Cx<R> a, Cx<R> b) {
  return {a.re - b.re, a.im - b.im};
}
template <typename R>
__device__ __forceinline__ Cx<R> operator*(Cx<R> a, Cx<R> b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

__device__ __forceinline__ float conj_(float x) { return x; }
__device__ __forceinline__ double conj_(double x) { return x; }
template <typename R>
__device__ __forceinline__ Cx<R> conj_(Cx<R> x) {
  return {x.re, -x.im};
}
__device__ __forceinline__ float re_(float x) { return x; }
__device__ __forceinline__ double re_(double x) { return x; }
template <typename R>
__device__ __forceinline__ R re_(Cx<R> x) {
  return x.re;
}
__device__ __forceinline__ float im_(float) { return 0.f; }
__device__ __forceinline__ double im_(double) { return 0.0; }
template <typename R>
__device__ __forceinline__ R im_(Cx<R> x) {
  return x.im;
}
__device__ __forceinline__ float abs2_(float x) { return x * x; }
__device__ __forceinline__ double abs2_(double x) { return x * x; }
template <typename R>
__device__ __forceinline__ R abs2_(Cx<R> x) {
  return x.re * x.re + x.im * x.im;
}

template <typename T>
struct Real {
  using type = T;
};
template <typename R>
struct Real<Cx<R>> {
  using type = R;
};

template <typename T>
__device__ __forceinline__ T make_(typename Real<T>::type re,
                                   typename Real<T>::type im);
template <>
__device__ __forceinline__ float make_<float>(float re, float) {
  return re;
}
template <>
__device__ __forceinline__ double make_<double>(double re, double) {
  return re;
}
template <>
__device__ __forceinline__ Cx<float> make_<Cx<float>>(float re, float im) {
  return {re, im};
}
template <>
__device__ __forceinline__ Cx<double> make_<Cx<double>>(double re,
                                                        double im) {
  return {re, im};
}

// 1 / z (complex: as LAPACK's zladiv(1, z) up to rounding)
__device__ __forceinline__ float recip_(float z) { return 1.f / z; }
__device__ __forceinline__ double recip_(double z) { return 1.0 / z; }
template <typename R>
__device__ __forceinline__ Cx<R> recip_(Cx<R> z) {
  const R d = z.re * z.re + z.im * z.im;
  return {z.re / d, -z.im / d};
}

// The reflector of the column x[0..len) (x[0] = alpha), LAPACK larfg:
// writes v (v[0] = 1) and tau. Warp 0 of the block calls it; x and v may
// be strided shared arrays, and `conjx` reads x conjugated (the LQ step's
// rows). Returns nothing; the caller synchronises the block after.
template <typename T>
__device__ void larfg_warp(int len, const T* x, int sx, bool conjx, T* v,
                           int sv, T* tau) {
  using R = typename Real<T>::type;
  const int lane = threadIdx.x & 31;
  R ss = R(0);
  for (int i = 1 + lane; i < len; i += 32) {
    ss += abs2_(x[i * sx]);
  }
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  T alpha = x[0];
  if (conjx) alpha = conj_(alpha);
  const R ar = re_(alpha), ai = im_(alpha);
  T t, scal;
  if (ss == R(0) && ai == R(0)) {
    t = make_<T>(R(0), R(0));
    scal = make_<T>(R(0), R(0));
  } else {
    const R nrm = sqrt(ar * ar + ai * ai + ss);
    const R beta = ar >= R(0) ? -nrm : nrm;
    t = make_<T>((beta - ar) / beta, -ai / beta);
    scal = recip_(alpha - make_<T>(beta, R(0)));
  }
  for (int i = lane; i < len; i += 32) {
    T xi = x[i * sx];
    if (conjx) xi = conj_(xi);
    v[i * sv] = i == 0 ? make_<T>(R(1), R(0)) : xi * scal;
  }
  if (lane == 0) *tau = t;
}

// rows [j, b) of the b x n strip A (row stride lda, column stride 1):
// A <- (I - tau v v^H)^H A = A - conj(tau) v (v^H A), one column a thread
template <typename T>
__device__ void apply_left(int j, int b, int n, T* A, int lda, const T* v,
                           int sv, T tau) {
  const T ct = conj_(tau);
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    T s = make_<T>(0, 0);
    for (int i = j; i < b; ++i) s = s + conj_(v[i * sv]) * A[i * lda + c];
    s = ct * s;
    for (int i = j; i < b; ++i) A[i * lda + c] = A[i * lda + c] - v[i * sv] * s;
  }
}

// columns [j, b) of the m x b strip C (row stride b):
// C <- C (I - tau v v^H) = C - tau (C v) v^H, one row a thread
template <typename T>
__device__ void apply_right(int j, int b, int m, T* C, const T* v, int sv,
                            T tau) {
  for (int r = threadIdx.x; r < m; r += blockDim.x) {
    T s = make_<T>(0, 0);
    for (int i = j; i < b; ++i) s = s + C[r * b + i] * v[i * sv];
    s = tau * s;
    for (int i = j; i < b; ++i) C[r * b + i] = C[r * b + i] - s * conj_(v[i * sv]);
  }
}

template <typename T>
__global__ void kw_herm_kernel(T* F, long long bs, const int* __restrict__ u_t,
                               int S, int V, int b, int H, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* R = reinterpret_cast<T*>(smem_raw);  // b x V
  T* C = R + b * V;                       // V x b
  T* Vr = C + V * b;                      // b x b, reflector j in column j
  T* tau = Vr + b * b;                    // b
  const int g = blockIdx.x;
  const int u = u_t[g];
  const long long row0 = bs + static_cast<long long>(g) * S;
  for (int e = threadIdx.x; e < b * V; e += blockDim.x) {
    const int i = e / V, t = e % V;
    const T val = F[(row0 + t) * H + D + b + i - t];
    R[i * V + t] = val;
    C[t * b + i] = conj_(val);
  }
  __syncthreads();
  for (int j = 0; j < u; ++j) {
    const int cj = b - u + j;
    if (threadIdx.x < 32) {
      larfg_warp(b - j, R + j * V + cj, V, false, Vr + j * b + j, b, tau + j);
    }
    __syncthreads();
    apply_left(j, b, V, R, V, Vr + j, b, tau[j]);
    __syncthreads();
  }
  // the column strip's mixed rows: C[b + x][i] = R1[x][b + i]
  for (int e = threadIdx.x; e < b * b; e += blockDim.x) {
    const int x = e / b, i = e % b;
    C[(b + x) * b + i] = R[x * V + b + i];
  }
  __syncthreads();
  for (int j = 0; j < u; ++j) {
    apply_right(j, b, V, C, Vr + j, b, tau[j]);
    __syncthreads();
  }
  for (int e = threadIdx.x; e < b * b; e += blockDim.x) {
    const int x = e / b, i = e % b;
    R[x * V + b + i] = C[(b + x) * b + i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < b * V; e += blockDim.x) {
    const int i = e / V, t = e % V;
    F[(row0 + t) * H + D + b + i - t] = R[i * V + t];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < V * b; e += blockDim.x) {
    const int r = e / b, j = e % b;
    F[(row0 + b + j) * H + D + r - b - j] = C[r * b + j];
  }
}

template <typename T>
__global__ void kw_bidiag_kernel(T* X, long long ld, int qr,
                                 const int* __restrict__ c0_t,
                                 const int* __restrict__ u_t,
                                 const int* __restrict__ off_t, int V, int b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* W = reinterpret_cast<T*>(smem_raw);  // b x V (QR) or V x b (LQ)
  T* Vr = W + b * V;                      // b x b
  T* tau = Vr + b * b;
  const int g = blockIdx.x;
  const int u = u_t[g];
  if (u == 0) return;
  const long long c0 = c0_t[g];
  if (qr) {
    T* Xw = X + c0 * ld + c0;
    for (int e = threadIdx.x; e < b * V; e += blockDim.x) {
      const int i = e / V, t = e % V;
      W[i * V + t] = Xw[i * ld + t];
    }
    __syncthreads();
    for (int j = 0; j < b; ++j) {
      if (threadIdx.x < 32) {
        larfg_warp(b - j, W + j * V + j, V, false, Vr + j * b + j, b, tau + j);
      }
      __syncthreads();
      apply_left(j, b, V, W, V, Vr + j, b, tau[j]);
      __syncthreads();
    }
    for (int e = threadIdx.x; e < b * V; e += blockDim.x) {
      const int i = e / V, t = e % V;
      Xw[i * ld + t] = W[i * V + t];
    }
  } else {
    T* Xw = X + c0 * ld + c0 + off_t[g];
    for (int e = threadIdx.x; e < V * b; e += blockDim.x) {
      const int r = e / b, j = e % b;
      W[r * b + j] = Xw[r * ld + j];
    }
    __syncthreads();
    const int nref = u < b ? u : b;
    for (int j = 0; j < nref; ++j) {
      if (threadIdx.x < 32) {
        larfg_warp(b - j, W + j * b + j, 1, true, Vr + j * b + j, b, tau + j);
      }
      __syncthreads();
      apply_right(j, b, V, W, Vr + j, b, tau[j]);
      __syncthreads();
    }
    for (int e = threadIdx.x; e < V * b; e += blockDim.x) {
      const int r = e / b, j = e % b;
      Xw[r * ld + j] = W[r * b + j];
    }
  }
}

constexpr int THREADS = 128;

template <typename T>
int launch_herm(void* F, long long bs, const int* u, int G, int S, int V,
                int b, int H, int D, cudaStream_t s) {
  const size_t smem = (2 * b * V + b * b + b) * sizeof(T);
  // raise the block's shared-memory limit once per instance and size
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kw_herm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  kw_herm_kernel<T><<<G, THREADS, smem, s>>>(static_cast<T*>(F), bs, u, S, V,
                                              b, H, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bidiag(void* X, long long ld, int qr, const int* c0, const int* u,
                  const int* off, int G, int V, int b, cudaStream_t s) {
  const size_t smem = (b * V + b * b + b) * sizeof(T);
  // raise the block's shared-memory limit once per instance and size
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kw_bidiag_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  kw_bidiag_kernel<T><<<G, THREADS, smem, s>>>(static_cast<T*>(X), ld, qr, c0,
                                                u, off, V, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dtt_kw_herm_step(int dtype, void* F, long long bs,
                                const void* u, int G, int S, int V, int b,
                                int H, int D, void* stream) {
  if (b < 1 || b > 32 || V > 4 * b || G < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ut = static_cast<const int*>(u);
  switch (dtype) {
    case 0: return launch_herm<float>(F, bs, ut, G, S, V, b, H, D, s);
    case 1: return launch_herm<double>(F, bs, ut, G, S, V, b, H, D, s);
    case 2: return launch_herm<Cx<float>>(F, bs, ut, G, S, V, b, H, D, s);
    case 3: return launch_herm<Cx<double>>(F, bs, ut, G, S, V, b, H, D, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int dtt_kw_bidiag_step(int dtype, int qr, void* X, long long ld,
                                  const void* c0, const void* u,
                                  const void* off, int G, int V, int b,
                                  void* stream) {
  if (b < 1 || b > 32 || V > 4 * b || G < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(c0);
  const int* uu = static_cast<const int*>(u);
  const int* o = static_cast<const int*>(off);
  switch (dtype) {
    case 0: return launch_bidiag<float>(X, ld, qr, c, uu, o, G, V, b, s);
    case 1: return launch_bidiag<double>(X, ld, qr, c, uu, o, G, V, b, s);
    case 2: return launch_bidiag<Cx<float>>(X, ld, qr, c, uu, o, G, V, b, s);
    case 3: return launch_bidiag<Cx<double>>(X, ld, qr, c, uu, o, G, V, b, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
