// K4 on Hopper: blocked Householder QR of one (M, nb) f32 panel.
//
// Replaces dplasma_tpu/kernels/pallas_qr.py:geqrt_panel (body
// _geqrt_kernel, pallas_call at :123), the kernel every eligible geqrf
// panel is sent to under MCA panel.kernel=pallas (kernels/panels.py
// qr_panel).
//
// What it computes, as the TPU kernel does: columns advance in JB = 8
// wide blocks. Per column j: alpha = a[j,j], ssq = sum of a[i,j]^2 below
// the diagonal, norm = sqrt(alpha^2 + ssq), beta = -norm if alpha >= 0
// (-0.0 included) else +norm, tau = (beta - alpha) / beta if norm > 0
// else 0, v = a[i,j] / (alpha - beta) below the diagonal (0 when that
// difference is 0) and 1 on it. H_j = I - tau v v^T is applied to the
// strip columns right of j only; then beta goes on the diagonal and v
// below it. A column with nothing below its diagonal and alpha != 0 gets
// tau = 2 (LAPACK's larfg would give 0): the reference's rule, kept.
// Per block: G = Vb^T Vb, the 8 x 8 T_blk by the larft recurrence
// T[:i, i] = -tau_i T[:i, :i] G[:i, i], and one rank-8 update of the
// trailing columns, trail -= Vb (T_blk^T (Vb^T trail)). Outputs: the
// packed R\V in place and the nb taus (the wrapper rebuilds the full T
// with householder.larft, as the reference's wrapper does).
//
// Why the design differs from the Pallas body. The TPU kernel keeps the
// whole panel resident in VMEM (up to 8 MiB). A Hopper block has at most
// 227 KB of shared memory, so here one block of 512 threads owns the
// panel, which stays in device memory in column-major order (the wrapper
// transposes it in); at 8 MiB it stays inside the 50 MB L2. Thread t
// owns rows t, t + 512, ...: every pass over the panel reads and writes
// only its own rows, coalesced, and the threads meet only in reductions.
// 512 threads and not K3's 1024: a thread of the trailing update holds
// an 8 x 8 accumulator, its Vb row and the partial sums of G, which take
// more than the 64 registers a thread may have in a 1024-thread block;
// at 512 it may have 128.
//
// Per column, ONE block-wide reduction: the sum of squares below the
// diagonal and the dot products x . a[:, c] with the strip columns c to
// its right (w_c = a[j, c] + d_c / (alpha - beta) is the reflector's
// v^T a[:, c]), while the owner of row j publishes that row through
// shared memory. Reductions are warp shuffles, then each thread sums the
// 16 warp partials in the same order, so all threads hold the same
// values; the partial buffers are double-buffered by column parity, so
// one barrier per column suffices. Per block: G (36 sums), then the
// trailing columns in chunks of CW = 8: W = Vb^T trail (64 sums reduced
// the same way), Y = T_blk^T W by 8 threads, and each thread updates its
// own rows of the chunk.
//
// Agreement with the plain version (pallas_qr.geqrt_panel_reference):
// the arithmetic is the same, the order of summation is not (and the dot
// products are formed from x before it is scaled by 1/(alpha - beta)),
// so the two agree to rounding, not bitwise. The gate is a tolerance.
//
// What bounds it on this card: neither FLOP/s nor HBM bandwidth. One SM
// of 132 does the work, the nb reflectors are sequential, each with a
// block-wide barrier, and each block's trailing update streams the panel
// through that one SM's L2 bandwidth (Vb once per chunk of 8 columns).
// A later design spreads a panel over many SMs (a TSQR-like split of the
// rows over blocks, or clusters with distributed shared memory).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int JB = 8;                     // column block width
constexpr int THREADS = 512;              // one block per panel
constexpr int WARPS = THREADS / 32;
constexpr int CW = 8;                     // trailing columns per chunk
constexpr int NG = JB * (JB + 1) / 2;     // entries of the symmetric G

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The first row at or after lo that thread tid owns.
__device__ __forceinline__ int first_row(int tid, int lo) {
  return lo <= tid ? tid : tid + ((lo - tid + THREADS - 1) / THREADS) * THREADS;
}

// Row i of the block's unit-lower Vb: the stored v below row j0 + a, 1 on
// it, 0 above. strip points at column j0.
__device__ __forceinline__ void load_vb(const float* strip, int64_t M, int i,
                                        int j0, float (&vb)[JB]) {
#pragma unroll
  for (int a = 0; a < JB; ++a) {
    const int d = j0 + a;
    vb[a] = i > d ? strip[(int64_t)a * M + i] : (i == d ? 1.f : 0.f);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
k4_geqrt_panel_kernel(float* __restrict__ P, int M, int nb,
                      float* __restrict__ taus) {
  __shared__ float red[2][WARPS][JB];      // per-column partials
  __shared__ float s_row[2][JB];           // strip row j
  __shared__ float s_tau[JB];
  __shared__ float gred[WARPS][NG];
  __shared__ float s_T[JB][JB];
  __shared__ float wred[WARPS][JB * CW];
  __shared__ float s_Y[JB][CW];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t Ml = M;

  for (int j0 = 0; j0 < nb; j0 += JB) {
    float* strip = P + (int64_t)j0 * Ml;

#pragma unroll
    for (int jj = 0; jj < JB; ++jj) {
      const int j = j0 + jj;
      const int buf = jj & 1;

      // 1. partials over the own rows below j: slot jj the sum of
      // squares, slot c > jj the dot product with strip column c
      float part[JB];
#pragma unroll
      for (int c = 0; c < JB; ++c) part[c] = 0.f;
      for (int i = first_row(tid, j + 1); i < M; i += THREADS) {
        const float x = strip[(int64_t)jj * Ml + i];
        part[jj] += x * x;
#pragma unroll
        for (int c = jj + 1; c < JB; ++c)
          part[c] += x * strip[(int64_t)c * Ml + i];
      }
      if (tid == j % THREADS) {
#pragma unroll
        for (int c = 0; c < JB; ++c)
          s_row[buf][c] = strip[(int64_t)c * Ml + j];
      }
#pragma unroll
      for (int c = jj; c < JB; ++c) {
        const float v = warp_sum(part[c]);
        if (lane == 0) red[buf][warp][c] = v;
      }
      __syncthreads();

      // 2. the reflector, computed alike by every thread
      float ssq = 0.f;
      float w[JB];
#pragma unroll
      for (int c = 0; c < JB; ++c) w[c] = 0.f;
      for (int q = 0; q < WARPS; ++q) {
        ssq += red[buf][q][jj];
#pragma unroll
        for (int c = jj + 1; c < JB; ++c) w[c] += red[buf][q][c];
      }
      const float alpha = s_row[buf][jj];
      const float norm = sqrtf(alpha * alpha + ssq);
      const float beta = alpha >= 0.f ? -norm : norm;
      const float tau = norm > 0.f ? (beta - alpha) / beta : 0.f;
      const float denom = alpha - beta;
      const float vinv = denom != 0.f ? 1.f / denom : 0.f;
#pragma unroll
      for (int c = jj + 1; c < JB; ++c) w[c] = s_row[buf][c] + vinv * w[c];
      if (tid == 0) {
        taus[j] = tau;
        s_tau[jj] = tau;
      }

      // 3. H_j on the strip columns right of jj, own rows at or below j;
      // then beta on the diagonal and v below it
      for (int i = first_row(tid, j); i < M; i += THREADS) {
        float* p = strip + i;
        const float v = (i == j) ? 1.f : p[(int64_t)jj * Ml] * vinv;
        const float tv = tau * v;
#pragma unroll
        for (int c = jj + 1; c < JB; ++c) p[(int64_t)c * Ml] -= tv * w[c];
        p[(int64_t)jj * Ml] = (i == j) ? beta : v;
      }
    }

    const int wt = nb - j0 - JB;           // trailing columns
    if (wt <= 0) break;

    // 4. G = Vb^T Vb (upper triangle, packed) over the own rows
    float g[NG];
#pragma unroll
    for (int q = 0; q < NG; ++q) g[q] = 0.f;
    for (int i = first_row(tid, j0); i < M; i += THREADS) {
      float vb[JB];
      load_vb(strip, Ml, i, j0, vb);
      int q = 0;
#pragma unroll
      for (int a = 0; a < JB; ++a) {
#pragma unroll
        for (int b = a; b < JB; ++b) g[q++] += vb[a] * vb[b];
      }
    }
#pragma unroll
    for (int q = 0; q < NG; ++q) {
      const float v = warp_sum(g[q]);
      if (lane == 0) gred[warp][q] = v;
    }
    __syncthreads();

    // 5. T_blk by the larft recurrence (one thread; the others go on to
    // the first chunk, whose barrier precedes every read of s_T)
    if (tid == 0) {
      float G[JB][JB];
      int q = 0;
#pragma unroll
      for (int a = 0; a < JB; ++a) {
#pragma unroll
        for (int b = a; b < JB; ++b) {
          float s = 0.f;
          for (int r = 0; r < WARPS; ++r) s += gred[r][q];
          G[a][b] = s;
          G[b][a] = s;
          ++q;
        }
      }
      float T[JB][JB];
#pragma unroll
      for (int a = 0; a < JB; ++a) {
#pragma unroll
        for (int b = 0; b < JB; ++b) T[a][b] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < JB; ++i) {
        const float ti = s_tau[i];
#pragma unroll
        for (int a = 0; a < i; ++a) {
          float m = 0.f;
#pragma unroll
          for (int b = a; b < i; ++b) m += T[a][b] * G[b][i];
          T[a][i] = -ti * m;
        }
        T[i][i] = ti;
      }
#pragma unroll
      for (int a = 0; a < JB; ++a) {
#pragma unroll
        for (int b = 0; b < JB; ++b) s_T[a][b] = T[a][b];
      }
    }

    // 6. per chunk of CW trailing columns: W = Vb^T trail, Y = T^T W,
    // trail -= Vb Y
    float* trail = strip + (int64_t)JB * Ml;
    for (int c0 = 0; c0 < wt; c0 += CW) {
      const int cw = min(CW, wt - c0);
      float* tc = trail + (int64_t)c0 * Ml;
      float acc[JB][CW];
#pragma unroll
      for (int a = 0; a < JB; ++a) {
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[a][c] = 0.f;
      }
      for (int i = first_row(tid, j0); i < M; i += THREADS) {
        float vb[JB];
        load_vb(strip, Ml, i, j0, vb);
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          if (c < cw) {
            const float x = tc[(int64_t)c * Ml + i];
#pragma unroll
            for (int a = 0; a < JB; ++a) acc[a][c] += vb[a] * x;
          }
        }
      }
#pragma unroll
      for (int a = 0; a < JB; ++a) {
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          const float v = warp_sum(acc[a][c]);
          if (lane == 0) wred[warp][a * CW + c] = v;
        }
      }
      __syncthreads();
      if (tid < cw) {
        float W[JB];
#pragma unroll
        for (int b = 0; b < JB; ++b) {
          float s = 0.f;
          for (int r = 0; r < WARPS; ++r) s += wred[r][b * CW + tid];
          W[b] = s;
        }
#pragma unroll
        for (int a = 0; a < JB; ++a) {
          float y = 0.f;
#pragma unroll
          for (int b = 0; b < JB; ++b) y += s_T[b][a] * W[b];
          s_Y[a][tid] = y;
        }
      }
      __syncthreads();
      for (int i = first_row(tid, j0); i < M; i += THREADS) {
        float vb[JB];
        load_vb(strip, Ml, i, j0, vb);
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          if (c < cw) {
            float s = 0.f;
#pragma unroll
            for (int a = 0; a < JB; ++a) s += vb[a] * s_Y[a][c];
            tc[(int64_t)c * Ml + i] -= s;
          }
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. P: the (M, nb) panel in
// column-major order (element (i, j) at P[j * M + i]), factored in place;
// taus: nb floats. Requires M >= nb > 0, nb % 8 == 0. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int dtt_k4_geqrt_panel(int M, int nb, void* P, void* taus,
                                  void* stream) {
  if (nb <= 0 || M < nb || nb % JB != 0)
    return (int)cudaErrorInvalidValue;
  k4_geqrt_panel_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(P), M, nb, static_cast<float*>(taus));
  return (int)cudaGetLastError();
}
