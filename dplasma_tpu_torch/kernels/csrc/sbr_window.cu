// KW: the successive-band-reduction (SBR) sweeps with b <= 128, a range of
// steps [t0, t1) of one sweep in one persistent launch (see kernels/sbr.py).
//
// Replaces no Pallas kernel: the reference runs each step as plain JAX,
// vmapped over the window slots, inside one lax.scan over the sweep
// (dplasma_tpu/ops/band.py, `one` of herm_sbr_sweep_banded :460-482,
// `qr_one` / `lq_one` of bidiag_sbr_sweep :291-307). This launch is the
// counterpart of that scan: the steps run in order inside the kernel, a
// grid barrier between two steps, and the host passes only t0, t1 and the
// geometry. Every table (window anchors, elimination widths, offsets, the
// Hermitian sweep's bases) is on the device.
//
// A window is a set of V "lines" of b elements each, held line by line in
// shared memory (line stride LS: whole 16-byte vectors, odd, zero past
// b), and one Householder QR runs over it: reflector j comes from elements
// [j, b) of pivot line p0 + j (LAPACK larfg: beta = -sign(Re alpha) *
// ||(alpha, x)||, tau = (beta - alpha) / beta, v = x / (alpha - beta);
// tau = 0 when x = 0 and Im alpha = 0), is stored in place (beta on the
// diagonal, v below it: the pivot line's later elements are exact zeros,
// written back as such) and is applied as it is made, from the left, to
// every other line. The three step kinds are one computation:
//
//  herm    F is column-major full-band storage, F[L0 + c][D + r - c] =
//          A[r, c], row width H; slot g's anchor column c0 is F row
//          base[t] + g*S. Line l (l < V) is the row strip's column
//          R[:, l] = A[c0+b .. c0+2b, c0+l], contiguous in F. Pivot lines
//          b-u .. b-1 (u = 0: no reflector). After the left pass the
//          trailing block B = R[:, b:2b] takes the right pass B <- B Q (one
//          row of B a thread, every reflector in order). The column strip
//          is then written as the Hermitian mirror of the row strip
//          (C Q = (Q^H R)^H on its rows outside [b, 2b), and its rows
//          [b, 2b) are the same storage as B), so no V x b column strip is
//          held: a b = 64 window is 213 KB in complex128.
//  QR      (bidiag, odd t) X dense, row stride ld, slot g's window at
//          (c0, c0); line l is column l of the b x V row strip
//          X[c0:c0+b, c0:c0+V]; pivot lines 0 .. b-1.
//  LQ      (bidiag, even t) line r is row r of the V x b column strip
//          X[c0:c0+V, c0+off:c0+off+b], held CONJUGATED: C Q from the right
//          is the conjugate of Q^H conj(C) from the left; pivot lines
//          0 .. min(u, b)-1 (rows >= u masked). u = 0: a parked slot, left
//          alone.
//
// Launch forms (chosen by kernels/sbr.py `plan` from b, V and the type; the
// arithmetic of a window is the same in all three, so they agree bitwise):
//  WARP     b <= 8: one warp a window, several windows a block; the
//           reflector chain synchronises with __syncwarp (taken where it
//           measured faster than BLOCK: sbr.WARP_FORM).
//  BLOCK    one block a window (V <= 512 lines, a thread a line).
//  CLUSTER  a bidiagonal window too large for one block's 227 KB (b = 127
//           in f64 / c64: 2 CTAs, c128: 4): the lines split between the
//           cluster's CTAs; the CTA owning pivot line j builds reflector j,
//           the others copy it through distributed shared memory after one
//           cluster barrier per reflector.
// Blocks (clusters) stride over the G window slots of a step. Between two
// steps a grid barrier: a completion counter in global memory, added to
// with release and read with acquire at gpu scope, so every window of step
// t+1 sees every write of step t. The grid must be co-resident: it is sized
// by cudaOccupancyMaxActiveBlocksPerMultiprocessor (cudaOccupancyMax-
// ActiveClusters for clusters) and a launch of more than one step is
// cooperative (with the cluster dimension for clusters: CUDA 12.8 takes the
// pair); a refused launch returns its error. The counter is the launch's
// own (kernels/sbr.py allocates it on the launch's stream), so launches on
// two streams never share one.
// Strips reach shared memory by cp.async, one element a copy (the lines
// start at arbitrary element offsets of F and X).
//
// Sums run in a fixed order (one thread a line, the warp's larfg reduction
// by lane), so a launch over [0, T) is bitwise equal to T launches of one
// step, and the forms agree bitwise with one another.
//
// What bounds it: neither bytes nor operations. A window step moves its
// strips once each way and does under 4 b^2 V flops (x4 complex); the chain
// of b reflectors per window, each a warp reduction and two barriers, is the
// time (PERF.md has the numbers).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace cg = cooperative_groups;

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
  static constexpr bool complex = false;
};
template <typename R>
struct Real<Cx<R>> {
  using type = R;
  static constexpr bool complex = true;
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

template <typename T>
__device__ __forceinline__ bool is_zero_(T x) {
  return re_(x) == 0 && im_(x) == 0;
}

// 1 / z (complex: as LAPACK's zladiv(1, z) up to rounding)
__device__ __forceinline__ float recip_(float z) { return 1.f / z; }
__device__ __forceinline__ double recip_(double z) { return 1.0 / z; }
template <typename R>
__device__ __forceinline__ Cx<R> recip_(Cx<R> z) {
  const R d = z.re * z.re + z.im * z.im;
  return {z.re / d, -z.im / d};
}

enum Form { WARP = 0, BLOCK = 1, CLUSTER = 2 };

// one launch: a step range of one sweep
struct Params {
  void* A;                 // F (herm) or X (bidiag), in place
  const long long* base;   // herm: (T,) F row of slot 0's anchor per step
  const int* c0;           // bidiag: (T, G) window anchors
  const int* u;            // (T, G) elimination widths (0: inactive)
  const int* off;          // bidiag: (T, G) the LQ block's column offset
  unsigned long long* bar;  // the grid barrier's counter: zero at launch,
                           // this launch's alone
  long long ld;            // bidiag: row stride of X
  int herm;                // 1: Hermitian band storage, 0: bidiagonal
  int t0, t1, G, V, b, LS;
  int S, H, D;             // herm: slot stride, F row width, centre
  int wpb;                 // WARP: windows a block
  int ncta;                // CLUSTER: CTAs a window
};

// one window in global memory: line l, element i at g[l * ls + i * es]
template <typename T>
struct Win {
  T* g;
  long long ls, es;
  int p0, nref;  // pivot lines [p0, p0 + nref)
  bool conj;     // lines held conjugated (the LQ step)
};

// element i of line l holds a stored reflector (an exact zero of the result)
__device__ __forceinline__ bool packed(int l, int i, int p0, int nref) {
  return l >= p0 && l < p0 + nref && i > l - p0;
}

template <int N>
__device__ __forceinline__ void cp_async(void* s, const void* g) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(s);
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(a),
                 "l"(g)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(a),
                 "l"(g), "n"(N)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

template <int FORM>
__device__ __forceinline__ void gsync() {
  if constexpr (FORM == WARP) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Lines [l0, l0 + nl) of w into sm (line stride LS), by cp.async; each
// thread conjugates (LQ) the elements it copied once they have landed.
template <typename T>
__device__ void load_lines(const Win<T>& w, T* sm, int l0, int nl, int b,
                           int LS, int tid, int nthr) {
  const int n = nl * b;
  const bool rows = w.es == 1;  // a line contiguous: element fastest
  for (int e = tid; e < n; e += nthr) {
    const int l = rows ? e / b : e % nl;
    const int i = rows ? e - l * b : e / nl;
    cp_async<sizeof(T)>(sm + l * LS + i,
                        w.g + (l0 + l) * w.ls + i * w.es);
  }
  // the lines' padding [b, LS): zeros, so whole 16-byte vectors can be
  // read past b
  const int pad = LS - b;
  for (int e = tid; e < nl * pad; e += nthr) {
    sm[(e / pad) * LS + b + e % pad] = make_<T>(0, 0);
  }
  cp_async_wait();
  if constexpr (Real<T>::complex) {
    if (w.conj) {
      for (int e = tid; e < n; e += nthr) {
        const int l = rows ? e / b : e % nl;
        const int i = rows ? e - l * b : e / nl;
        sm[l * LS + i] = conj_(sm[l * LS + i]);
      }
    }
  }
}

template <typename T>
__device__ void store_lines(const Win<T>& w, const T* sm, int l0, int nl,
                            int b, int LS, int tid, int nthr) {
  const int n = nl * b;
  const bool rows = w.es == 1;
  for (int e = tid; e < n; e += nthr) {
    const int l = rows ? e / b : e % nl;
    const int i = rows ? e - l * b : e / nl;
    T v = packed(l0 + l, i, w.p0, w.nref) ? make_<T>(0, 0) : sm[l * LS + i];
    if (w.conj) v = conj_(v);
    w.g[(l0 + l) * w.ls + i * w.es] = v;
  }
}

// The herm column strip outside its rows [b, 2b): C[r][j] = conj(R[j][r]),
// at F[(row0 + b + j) * H + D - b - j + r], a contiguous run over r.
template <typename T>
__device__ void store_mirror(T* F, long long row0, int H, int D,
                             const T* sm, int V, int b, int LS, int p0,
                             int nref, int tid, int nthr) {
  const int nr = V - b;
  for (int e = tid; e < b * nr; e += nthr) {
    const int j = e / nr;
    int r = e - j * nr;
    if (r >= b) r += b;
    const T v = packed(r, j, p0, nref) ? make_<T>(0, 0) : sm[r * LS + j];
    F[(row0 + b + j) * H + D - b - j + r] = conj_(v);
  }
}

// larfg on elements [j, b) of the pivot line x, by one whole warp: beta
// into x[j], v into x[j+1 .. b), tau into *tau.
template <typename T>
__device__ void larfg_line(T* x, int j, int b, T* tau) {
  using R = typename Real<T>::type;
  const int lane = threadIdx.x & 31;
  const T alpha = x[j];
  R ss = R(0);
  for (int i = j + 1 + lane; i < b; i += 32) ss += abs2_(x[i]);
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const R ar = re_(alpha), ai = im_(alpha);
  T t, scal, beta;
  if (ss == R(0) && ai == R(0)) {
    t = make_<T>(R(0), R(0));
    scal = make_<T>(R(0), R(0));
    beta = alpha;
  } else {
    const R nrm = sqrt(ar * ar + ai * ai + ss);
    const R be = ar >= R(0) ? -nrm : nrm;
    t = make_<T>((be - ar) / be, -ai / be);
    scal = recip_(alpha - make_<T>(be, R(0)));
    beta = make_<T>(be, R(0));
  }
  __syncwarp();  // every lane has read alpha
  for (int i = j + 1 + lane; i < b; i += 32) x[i] = x[i] * scal;
  if (lane == 0) {
    x[j] = beta;
    *tau = t;
  }
}

__device__ __forceinline__ float shfl_xor_(float x, int o) {
  return __shfl_xor_sync(0xffffffffu, x, o);
}
__device__ __forceinline__ double shfl_xor_(double x, int o) {
  return __shfl_xor_sync(0xffffffffu, x, o);
}
template <typename R>
__device__ __forceinline__ Cx<R> shfl_xor_(Cx<R> x, int o) {
  return {shfl_xor_(x.re, o), shfl_xor_(x.im, o)};
}

// 16 bytes of T: the unit of a line's shared-memory accesses
template <typename T>
struct alignas(16) V16 {
  static constexpr int E = 16 / sizeof(T);
  T x[E];
};

template <typename T>
__device__ __forceinline__ V16<T> ld16(const T* p) {
  V16<T> r;
  *reinterpret_cast<uint4*>(&r) = *reinterpret_cast<const uint4*>(p);
  return r;
}

template <typename T>
__device__ __forceinline__ void st16(T* p, const V16<T>& r) {
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&r);
}

// y <- (I - tau v v^H)^H y on elements [j, b) (v[j] = 1 implied; ct =
// conj(tau)), one line by one thread, 16 bytes a shared-memory access.
// Lines start 16-byte aligned and are zero past b (so are v's), so only
// the vector holding element j selects its coefficients (elements < j:
// 0, j: 1); the others multiply as they stand. The dot product keeps one
// sum per element of a vector and two vector sets (alternate vectors),
// joined in a fixed order.
template <typename T>
__device__ __forceinline__ void reflect(T* y, const T* v, int j, int b,
                                        T ct) {
  constexpr int E = V16<T>::E;
  const T one = make_<T>(1, 0), z = make_<T>(0, 0);
  const int a0 = j & ~(E - 1);
  const int end = (b + E - 1) & ~(E - 1);
  T s0[E], s1[E];
  {
    const V16<T> va = ld16(v + a0), ya = ld16(y + a0);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int i = a0 + k;
      const T c = i > j ? conj_(va.x[k]) : (i == j ? one : z);
      s0[k] = c * ya.x[k];
      s1[k] = z;
    }
  }
  int a = a0 + E;
  for (; a + E < end; a += 2 * E) {
    const V16<T> va = ld16(v + a), ya = ld16(y + a);
    const V16<T> vb = ld16(v + a + E), yb = ld16(y + a + E);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      s0[k] = s0[k] + conj_(va.x[k]) * ya.x[k];
      s1[k] = s1[k] + conj_(vb.x[k]) * yb.x[k];
    }
  }
  if (a < end) {
    const V16<T> va = ld16(v + a), ya = ld16(y + a);
#pragma unroll
    for (int k = 0; k < E; ++k) s0[k] = s0[k] + conj_(va.x[k]) * ya.x[k];
  }
  T s = s0[0] + s1[0];
#pragma unroll
  for (int k = 1; k < E; ++k) s = s + (s0[k] + s1[k]);
  s = ct * s;
  {
    const V16<T> va = ld16(v + a0);
    V16<T> ya = ld16(y + a0);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int i = a0 + k;
      const T c = i > j ? va.x[k] : (i == j ? one : z);
      ya.x[k] = ya.x[k] - c * s;
    }
    st16(y + a0, ya);
  }
  for (a = a0 + E; a < end; a += E) {
    const V16<T> va = ld16(v + a);
    V16<T> ya = ld16(y + a);
#pragma unroll
    for (int k = 0; k < E; ++k) ya.x[k] = ya.x[k] - va.x[k] * s;
    st16(y + a, ya);
  }
}

// The herm right pass B <- B Q (row x of B is element x of lines b ..
// 2b-1), four lanes a row: lane r of a row holds its elements i = r
// (mod 4) through every reflector, and the row's sum is joined by two
// shuffles, (s0 + s1) + (s2 + s3) on every lane. nthr is a multiple of
// 32; every lane of the group runs every shuffle.
template <typename T>
__device__ void right_pass(T* sm, const T* tau, int p0, int nref, int b,
                           int LS, int tid, int nthr) {
  const int sub = tid & 3, rows = nthr >> 2;
  const T z = make_<T>(0, 0);
  for (int x0 = 0; x0 < b; x0 += rows) {
    const int x = x0 + (tid >> 2);
    const bool on = x < b;
    T* y = sm + b * LS + (on ? x : 0);
    for (int j = 0; j < nref; ++j) {
      const T tj = tau[j];
      if (is_zero_(tj)) continue;
      const T* v = sm + (p0 + j) * LS;
      const int i0 = j + 1 + ((sub - j - 1) & 3);  // first i > j, i = sub
      T s = (j & 3) == sub ? y[j * LS] : z;
      for (int i = i0; i < b; i += 4) s = s + y[i * LS] * v[i];
      s = s + shfl_xor_(s, 1);
      s = s + shfl_xor_(s, 2);
      s = tj * s;
      if (on) {
        if ((j & 3) == sub) y[j * LS] = y[j * LS] - s;
        for (int i = i0; i < b; i += 4)
          y[i * LS] = y[i * LS] - s * conj_(v[i]);
      }
    }
  }
}

template <typename T, int FORM>
__device__ void window(const Params& p, int t, int g, T* sm, T* tau,
                       T* vbuf, int tid, int nthr, int rank) {
  const int b = p.b, V = p.V, LS = p.LS, G = p.G;
  const long long tg = static_cast<long long>(t) * G + g;
  const int u = p.u[tg];
  T* A = static_cast<T*>(p.A);
  Win<T> w;
  long long row0 = 0;
  if (p.herm) {
    row0 = p.base[t] + static_cast<long long>(g) * p.S;
    w = {A + row0 * p.H + p.D + b, p.H - 1, 1, b - u, u, false};
  } else {
    if (u == 0) return;  // a parked slot
    const long long c0 = p.c0[tg];
    if (t & 1) {
      w = {A + c0 * p.ld + c0, 1, p.ld, 0, b, false};
    } else {
      w = {A + c0 * p.ld + c0 + p.off[tg], p.ld, 1, 0, u < b ? u : b, true};
    }
  }
  const int P = (V + p.ncta - 1) / p.ncta;
  const int l0 = rank * P;
  const int nl = max(0, min(V, l0 + P) - l0);
  load_lines(w, sm, l0, nl, b, LS, tid, nthr);
  gsync<FORM>();
  if constexpr (FORM != CLUSTER) {
    // one barrier a reflector: after applying reflector j to its lines,
    // the warp holding the next pivot line builds reflector j + 1 from it
    if (w.nref > 0 && tid < 32) larfg_line(sm + w.p0 * LS, 0, b, tau);
    gsync<FORM>();
    for (int j = 0; j < w.nref; ++j) {
      const int pl = w.p0 + j;
      const T* v = sm + pl * LS;
      const T tj = tau[j];
      if (!is_zero_(tj)) {
        const T ct = conj_(tj);
        for (int l = tid; l < V; l += nthr) {
          if (l < w.p0 || l > pl) reflect(sm + l * LS, v, j, b, ct);
        }
      }
      const int nx = pl + 1;  // the next pivot line
      if (j + 1 < w.nref && (tid >> 5) == ((nx % nthr) >> 5)) {
        __syncwarp();
        larfg_line(sm + nx * LS, j + 1, b, tau + j + 1);
      }
      gsync<FORM>();
    }
    if (p.herm) {
      right_pass(sm, tau, w.p0, w.nref, b, LS, tid, nthr);
      gsync<FORM>();
    }
  } else {
    cg::cluster_group cl = cg::this_cluster();
    for (int j = 0; j < w.nref; ++j) {
      const int pl = w.p0 + j;
      const int owner = pl / P;
      if (rank == owner && tid < 32) {
        larfg_line(sm + (pl - l0) * LS, j, b, tau + j);
      }
      cl.sync();
      const T* rv = cl.map_shared_rank(sm + (pl - owner * P) * LS, owner);
      for (int i = j + 1 + tid; i < b; i += nthr) vbuf[i] = rv[i];
      if (tid == 0) tau[b] = *cl.map_shared_rank(tau + j, owner);
      __syncthreads();
      const T tj = tau[b];
      if (!is_zero_(tj)) {
        const T ct = conj_(tj);
        for (int l = tid; l < nl; l += nthr) {
          const int gl = l0 + l;
          if (gl < w.p0 || gl > pl) reflect(sm + l * LS, vbuf, j, b, ct);
        }
      }
      __syncthreads();
    }
  }
  store_lines(w, sm, l0, nl, b, LS, tid, nthr);
  if (p.herm) {
    store_mirror(A, row0, p.H, p.D, sm, V, b, LS, w.p0, w.nref, tid, nthr);
  }
  if constexpr (FORM == CLUSTER) {
    cg::this_cluster().sync();  // no CTA reads a window the others reuse
  } else {
    gsync<FORM>();
  }
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// every block of the grid has finished the step, and its writes are
// visible to every block, before any block starts the next: the block's
// writes are ordered before thread 0's release add by the block barrier,
// and every thread's later reads after thread 0's acquire by the next
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

template <typename T, int FORM>
__global__ void __launch_bounds__(512) kw_sweep_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* base = reinterpret_cast<T*>(smem_raw);
  T* sm = base;
  T* tau;
  T* vbuf = nullptr;
  int tid = threadIdx.x, nthr = blockDim.x, first, stride, rank = 0;
  if constexpr (FORM == WARP) {
    constexpr int E = V16<T>::E;
    const int wid = threadIdx.x >> 5;
    tid = threadIdx.x & 31;
    nthr = 32;
    sm = base + wid * (p.V * p.LS + (p.b + E - 1) / E * E);
    tau = sm + p.V * p.LS;
    first = blockIdx.x * p.wpb + wid;
    stride = gridDim.x * p.wpb;
  } else if constexpr (FORM == BLOCK) {
    tau = sm + p.V * p.LS;
    first = blockIdx.x;
    stride = gridDim.x;
  } else {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    const int P = (p.V + p.ncta - 1) / p.ncta;
    vbuf = sm + P * p.LS;  // reflector j's copy, 16-byte aligned
    tau = vbuf + p.LS;     // taus, and tau[b] the copy of tau_j
    for (int i = p.b + tid; i < p.LS; i += nthr) vbuf[i] = make_<T>(0, 0);
    first = blockIdx.x / p.ncta;
    stride = gridDim.x / p.ncta;
  }
  for (int t = p.t0; t < p.t1; ++t) {
    for (int g = first; g < p.G; g += stride) {
      window<T, FORM>(p, t, g, sm, tau, vbuf, tid, nthr, rank);
    }
    if (t + 1 < p.t1) {
      grid_barrier(p.bar,
                   static_cast<unsigned long long>(t - p.t0 + 1) * gridDim.x);
    }
  }
}

// The line stride: a whole number of 16-byte vectors, odd, so the eight
// threads of a 16-byte access phase reach eight distinct bank groups
template <typename T>
int line_stride(int b) {
  constexpr int E = V16<T>::E;
  int m = (b + E - 1) / E;
  if (m % 2 == 0) ++m;
  return m * E;
}

// the shared memory one block needs (the same sum as sbr.plan's)
template <typename T>
size_t smem_bytes(const Params& p, int form) {
  constexpr int E = V16<T>::E;
  if (form == WARP) {
    return (size_t)p.wpb * (p.V * p.LS + (p.b + E - 1) / E * E) * sizeof(T);
  }
  if (form == BLOCK) return (size_t)(p.V * p.LS + p.b) * sizeof(T);
  const int P = (p.V + p.ncta - 1) / p.ncta;
  return (size_t)(P * p.LS + p.LS + p.b + 1) * sizeof(T);
}

constexpr int kSmemMax = 232448;  // bytes one block may use (H100)
// returned (as an int) when the grid cannot be placed: not a cudaError_t
constexpr int kUnschedulable = -1;

template <typename T, int FORM>
int launch(const Params& p, int threads, cudaStream_t s) {
  auto kern = kw_sweep_kernel<T, FORM>;
  const size_t smem = smem_bytes<T>(p, FORM);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  int na = 0;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  int grid;
  if constexpr (FORM == CLUSTER) {
    attr[na].id = cudaLaunchAttributeClusterDimension;
    attr[na].val.clusterDim.x = p.ncta;
    attr[na].val.clusterDim.y = 1;
    attr[na].val.clusterDim.z = 1;
    ++na;
    cfg.numAttrs = na;
    cfg.gridDim = dim3(p.ncta * p.G, 1, 1);
    int fits = 0;
    e = cudaOccupancyMaxActiveClusters(&fits, (void*)kern, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (fits < 1) return kUnschedulable;
    grid = p.ncta * (p.G < fits ? p.G : fits);
  } else {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return kUnschedulable;
    const int wpb = FORM == WARP ? p.wpb : 1;
    const int need = (p.G + wpb - 1) / wpb;
    grid = need < per_sm * sms ? need : per_sm * sms;
  }
  cfg.gridDim = dim3(grid, 1, 1);
  if (p.t1 - p.t0 > 1) {  // the grid barrier: every block co-resident
    attr[na].id = cudaLaunchAttributeCooperative;
    attr[na].val.cooperative = 1;
    ++na;
  }
  cfg.numAttrs = na;
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_form(Params p, int form, int threads, cudaStream_t s) {
  p.LS = line_stride<T>(p.b);
  switch (form) {
    case WARP: return launch<T, WARP>(p, threads, s);
    case BLOCK: return launch<T, BLOCK>(p, threads, s);
    case CLUSTER: return launch<T, CLUSTER>(p, threads, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Steps [t0, t1) of one sweep. herm: A = F, base (T,) int64, u (T, G),
// S/H/D its geometry; bidiag: A = X with row stride ld, c0/u/off (T, G).
// form 0 WARP (wpb windows a block, threads = 32 wpb), 1 BLOCK, 2 CLUSTER
// (ncta CTAs a window, bidiag only); bar: a zeroed uint64 of this launch
// alone (none for one step), the grid barrier's counter.
extern "C" int dtt_kw_sweep(int dtype, int herm, void* A, long long ld,
                            const void* base, const void* c0, const void* u,
                            const void* off, int t0, int t1, int G, int V,
                            int b, int S, int H, int D, int form, int ncta,
                            int threads, int wpb, void* bar, void* stream) {
  const bool cluster = form == CLUSTER;
  if (b < 1 || b > 128 || V < b || V > 4 * b || G < 1 || t0 < 0 ||
      t1 <= t0 || threads < 32 || threads > 512 || threads % 32 != 0 ||
      (form == WARP && (wpb < 1 || threads != 32 * wpb)) ||
      (cluster != (ncta > 1)) || ncta < 1 || ncta > 8 ||
      (cluster && herm) || (herm && (V > D + b || H != 2 * D + 1)) ||
      (t1 - t0 > 1 && bar == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.A = A;
  p.base = static_cast<const long long*>(base);
  p.c0 = static_cast<const int*>(c0);
  p.u = static_cast<const int*>(u);
  p.off = static_cast<const int*>(off);
  p.bar = static_cast<unsigned long long*>(bar);
  p.ld = ld;
  p.herm = herm;
  p.t0 = t0;
  p.t1 = t1;
  p.G = G;
  p.V = V;
  p.b = b;
  p.S = S;
  p.H = H;
  p.D = D;
  p.wpb = form == WARP ? wpb : 1;
  p.ncta = ncta;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_form<float>(p, form, threads, s);
    case 1: return launch_form<double>(p, form, threads, s);
    case 2: return launch_form<Cx<float>>(p, form, threads, s);
    case 3: return launch_form<Cx<double>>(p, form, threads, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
