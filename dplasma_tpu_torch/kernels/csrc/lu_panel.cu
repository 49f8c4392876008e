// K3 on Hopper: partial-pivoting LU of one (M, nb) f32 panel.
//
// Replaces dplasma_tpu/kernels/pallas_lu.py:lu_panel (body _panel_kernel,
// pallas_call at :121), the kernel every LU panel is sent to under MCA
// panel.kernel=pallas (ops/lu.py _base_lu).
//
// What it computes, as the TPU kernel does: columns advance in JB = 8 wide
// blocks; per column a lowest-index max-|a| pivot, a physical two-row
// swap, the scale by the pivot's reciprocal (0 for a zero pivot) and a
// rank-1 update inside the block's strip; per block the unit-lower solve
// for the block's U12 rows and the rank-JB update of the trailing columns.
// Outputs: the packed L\U in place, the LAPACK-style swap sequence and the
// permutation it gives (a[perm] = L U).
//
// Why the design differs from the Pallas body. The TPU kernel keeps the
// whole panel resident in VMEM (up to 8 MiB). A Hopper block has at most
// 227 KB of shared memory, and at M = 8192 even one JB strip (256 KB)
// does not fit. Here one block of 1024 threads owns the panel, which stays
// in device memory in column-major order (the wrapper transposes it in);
// at 8 MiB it stays inside the 50 MB L2. Thread t owns rows t, t + 1024,
// ...; the strip values of its first RREG rows sit in registers, the rest
// are read from the panel. A thread of a 1024-thread block has 64
// registers: RREG = 2 and CB = 4 (below) were the fastest of the budgets
// tried on the card, the larger ones spill. Tall panels (the gate admits
// nb = 8 up to M = 262144) loop over row slots.
//
// Per column: a block-wide (|a|, row) reduction whose order breaks ties to
// the LOWER row (warp shuffles, then one warp over the 32 warp winners);
// the swap of the two strip rows through shared memory; the scale and the
// rank-1 update of the strip. The swaps of the columns outside the strip
// are deferred to the end of the block (one thread per column applies the
// block's 8 swaps in order, as LAPACK's laswp). Per block: L11 and a chunk
// of U12 (8 x 1024 floats, 32 KB) are staged in shared memory, and each
// thread updates its own rows of the trailing columns: coalesced, since
// neighbouring threads hold neighbouring rows of a column.
//
// Rounding: every update is a rounded product followed by a rounded
// difference (__fmul_rn / __fsub_rn, never contracted into an FMA), in the
// column order of the unblocked loop, and the reciprocal is IEEE-rounded.
// That is exactly what the plain PyTorch version (pallas_lu.
// lu_panel_reference) computes, so the two agree bitwise, pivots included.
//
// What bounds it on this card: neither FLOP/s nor HBM bandwidth. One SM of
// 132 does the work, and the nb pivot steps are sequential, each with
// three block-wide barriers. The trailing rank-8 updates stream the panel
// through that one SM's L2 bandwidth once per block (nb/8 times in all).
// A later design spreads a panel over many SMs: a cooperative launch with
// a grid-wide pivot election per column, or clusters with distributed
// shared memory.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int JB = 8;             // column block width (the reference's JB)
constexpr int THREADS = 1024;     // one block per panel
constexpr int WARPS = THREADS / 32;
constexpr int RREG = 2;           // row slots whose strip row is in registers
constexpr int UCHUNK = 1024;      // trailing columns of U12 staged per pass

// (v, i) beats (bv, bi): larger |a|, or equal |a| at a lower row. A NaN
// never wins, so an all-NaN column keeps the "no candidate" row INT_MAX.
__device__ __forceinline__ bool wins(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// x - a*b with the product rounded first, as two separate torch ops do.
__device__ __forceinline__ float sub_prod(float x, float a, float b) {
  return __fsub_rn(x, __fmul_rn(a, b));
}

__device__ __forceinline__ void warp_best(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (wins(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
}

// One row of the trailing update, A22[i, :] -= L21[i, :] U12, over the
// cw staged columns of U12, each column as JB rank-1 steps. The columns of
// a row lie M apart; CB of them are loaded before any is updated, so a
// thread keeps CB loads in flight instead of one.
constexpr int CB = 4;

__device__ __forceinline__ void update_row(float* p, int M, int cw,
                                           const float (&l)[JB],
                                           const float (*sU)[UCHUNK]) {
  int cc = 0;
  for (; cc + CB <= cw; cc += CB) {
    float v[CB];
#pragma unroll
    for (int q = 0; q < CB; ++q) v[q] = p[(int64_t)(cc + q) * M];
#pragma unroll
    for (int q = 0; q < CB; ++q) {
#pragma unroll
      for (int t = 0; t < JB; ++t) v[q] = sub_prod(v[q], l[t], sU[t][cc + q]);
    }
#pragma unroll
    for (int q = 0; q < CB; ++q) p[(int64_t)(cc + q) * M] = v[q];
  }
  for (; cc < cw; ++cc) {
    float v = p[(int64_t)cc * M];
#pragma unroll
    for (int t = 0; t < JB; ++t) v = sub_prod(v, l[t], sU[t][cc]);
    p[(int64_t)cc * M] = v;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
k3_lu_panel_kernel(float* __restrict__ P, int M, int nb,
                   int* __restrict__ swaps, int64_t* __restrict__ perm) {
  __shared__ float red_v[WARPS];
  __shared__ int red_i[WARPS];
  __shared__ int s_piv;
  __shared__ float s_jrow[JB];     // strip row j before the swap
  __shared__ float s_prow[JB];     // strip row piv before it: the pivot row
  __shared__ float s_L[JB][JB];    // the block's unit-lower L11
  __shared__ float s_U[JB][UCHUNK];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int R = (M + THREADS - 1) / THREADS;   // row slots per thread

  for (int j0 = 0; j0 < nb; j0 += JB) {
    // column j0 + c, row i of the strip: strip[c * M + i]
    float* strip = P + (int64_t)j0 * M;
    float s[RREG][JB];
#pragma unroll
    for (int r = 0; r < RREG; ++r) {
      const int i = tid + r * THREADS;
#pragma unroll
      for (int c = 0; c < JB; ++c)
        s[r][c] = (i < M) ? strip[(int64_t)c * M + i] : 0.f;
    }

#pragma unroll
    for (int jj = 0; jj < JB; ++jj) {
      const int j = j0 + jj;

      // 1. pivot: the lowest row among those of largest |a| at or below j
      float bv = -1.f;
      int bi = INT_MAX;
#pragma unroll
      for (int r = 0; r < RREG; ++r) {
        const int i = tid + r * THREADS;
        if (i >= j && i < M) {
          const float v = fabsf(s[r][jj]);
          if (wins(v, i, bv, bi)) {
            bv = v;
            bi = i;
          }
        }
      }
      for (int r = RREG; r < R; ++r) {
        const int i = tid + r * THREADS;
        if (i >= j && i < M) {
          const float v = fabsf(strip[(int64_t)jj * M + i]);
          if (wins(v, i, bv, bi)) {
            bv = v;
            bi = i;
          }
        }
      }
      warp_best(bv, bi);
      if (lane == 0) {
        red_v[warp] = bv;
        red_i[warp] = bi;
      }
      __syncthreads();
      if (warp == 0) {
        bv = red_v[lane];
        bi = red_i[lane];
        warp_best(bv, bi);
        if (lane == 0) {
          const int p = (bi == INT_MAX) ? j : bi;
          s_piv = p;
          swaps[j] = p;
        }
      }
      __syncthreads();
      const int piv = s_piv;

      // 2. the owners of rows j and piv publish their strip rows ...
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const int row = w ? piv : j;
        float* dst = w ? s_prow : s_jrow;
        if (tid == row % THREADS) {
          const int rr = row / THREADS;
          if (rr < RREG) {
#pragma unroll
            for (int r = 0; r < RREG; ++r) {
              if (r == rr) {
#pragma unroll
                for (int c = 0; c < JB; ++c) dst[c] = s[r][c];
              }
            }
          } else {
#pragma unroll
            for (int c = 0; c < JB; ++c) dst[c] = strip[(int64_t)c * M + row];
          }
        }
      }
      __syncthreads();
      // ... and take each other's (the swap inside the strip)
      if (piv != j) {
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          const int row = w ? piv : j;
          const float* src = w ? s_jrow : s_prow;
          if (tid == row % THREADS) {
            const int rr = row / THREADS;
            if (rr < RREG) {
#pragma unroll
              for (int r = 0; r < RREG; ++r) {
                if (r == rr) {
#pragma unroll
                  for (int c = 0; c < JB; ++c) s[r][c] = src[c];
                }
              }
            } else {
#pragma unroll
              for (int c = 0; c < JB; ++c)
                strip[(int64_t)c * M + row] = src[c];
            }
          }
        }
      }

      // 3. scale column j below the pivot, rank-1 update of the strip
      const float d = s_prow[jj];
      const float inv = (d != 0.f) ? __frcp_rn(d) : 0.f;
#pragma unroll
      for (int r = 0; r < RREG; ++r) {
        const int i = tid + r * THREADS;
        if (i > j && i < M) {
          const float l = __fmul_rn(s[r][jj], inv);
          s[r][jj] = l;
#pragma unroll
          for (int c = jj + 1; c < JB; ++c)
            s[r][c] = sub_prod(s[r][c], l, s_prow[c]);
        }
      }
      for (int r = RREG; r < R; ++r) {
        const int i = tid + r * THREADS;
        if (i > j && i < M) {
          const float l = __fmul_rn(strip[(int64_t)jj * M + i], inv);
          strip[(int64_t)jj * M + i] = l;
#pragma unroll
          for (int c = jj + 1; c < JB; ++c) {
            float* p = strip + (int64_t)c * M + i;
            *p = sub_prod(*p, l, s_prow[c]);
          }
        }
      }
    }

    // the strip's register rows back to the panel (rows above j0 are
    // untouched by this block)
#pragma unroll
    for (int r = 0; r < RREG; ++r) {
      const int i = tid + r * THREADS;
      if (i >= j0 && i < M) {
#pragma unroll
        for (int c = 0; c < JB; ++c) strip[(int64_t)c * M + i] = s[r][c];
      }
    }
    __syncthreads();

    // 4. L11 to shared memory; the block's swaps applied, in order, to
    // every column outside the strip (one thread per column)
    if (tid < JB * JB) {
      const int a = tid / JB, b = tid % JB;
      s_L[a][b] = strip[(int64_t)b * M + j0 + a];
    }
    for (int c = tid; c < nb; c += THREADS) {
      if (c >= j0 && c < j0 + JB) continue;
      float* col = P + (int64_t)c * M;
#pragma unroll
      for (int t = 0; t < JB; ++t) {
        const int p = swaps[j0 + t];
        if (p != j0 + t) {
          const float x = col[j0 + t];
          col[j0 + t] = col[p];
          col[p] = x;
        }
      }
    }
    __syncthreads();

    // 5. per chunk of trailing columns: U12 = L11^-1 A12 (one thread per
    // column, staged in shared memory), then A22 -= L21 U12 as JB rank-1
    // steps, each thread on its own rows
    const int c0 = j0 + JB;
    for (int cb = c0; cb < nb; cb += UCHUNK) {
      const int cw = min(UCHUNK, nb - cb);
      for (int cc = tid; cc < cw; cc += THREADS) {
        float* col = P + (int64_t)(cb + cc) * M + j0;
        float u[JB];
#pragma unroll
        for (int t = 0; t < JB; ++t) u[t] = col[t];
#pragma unroll
        for (int a = 1; a < JB; ++a) {
#pragma unroll
          for (int b = 0; b < a; ++b) u[a] = sub_prod(u[a], s_L[a][b], u[b]);
        }
#pragma unroll
        for (int t = 0; t < JB; ++t) {
          col[t] = u[t];
          s_U[t][cc] = u[t];
        }
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < RREG; ++r) {
        const int i = tid + r * THREADS;
        if (i >= c0 && i < M)
          update_row(P + (int64_t)cb * M + i, M, cw, s[r], s_U);
      }
      for (int r = RREG; r < R; ++r) {
        const int i = tid + r * THREADS;
        if (i >= c0 && i < M) {
          float l[JB];
#pragma unroll
          for (int t = 0; t < JB; ++t) l[t] = strip[(int64_t)t * M + i];
          update_row(P + (int64_t)cb * M + i, M, cw, l, s_U);
        }
      }
      __syncthreads();
    }
  }

  // the permutation of the swap sequence: one thread, nb sequential swaps
  __syncthreads();
  for (int i = tid; i < M; i += THREADS) perm[i] = i;
  __syncthreads();
  if (tid == 0) {
    for (int j = 0; j < nb; ++j) {
      const int p = swaps[j];
      if (p != j) {
        const int64_t x = perm[j];
        perm[j] = perm[p];
        perm[p] = x;
      }
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. P: the (M, nb) panel in
// column-major order (element (i, j) at P[j * M + i]), factored in place;
// swaps: nb int32; perm: M int64. Requires M >= nb > 0, nb % 8 == 0.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int dtt_k3_lu_panel(int M, int nb, void* P, void* swaps,
                               void* perm, void* stream) {
  if (nb <= 0 || M < nb || nb % JB != 0)
    return (int)cudaErrorInvalidValue;
  k3_lu_panel_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(P), M, nb, static_cast<int*>(swaps),
      static_cast<int64_t*>(perm));
  return (int)cudaGetLastError();
}
