// K4 on Hopper: blocked Householder QR of one (M, nb) f32 panel, spread
// over the SMs of one thread-block cluster.
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
// What bounds it on this card: not FLOP/s and not bytes (a top panel is
// ~1e9 flop and 16 MB, 0.016 ms at the FP32 peak) but the chain of nb
// sequential reflectors: each needs a reduction over every row of the
// panel before any row can be updated, so each costs a round of
// communication between the SMs that hold the rows. The first version
// ran the chain inside one block (one SM of 132), so every column also
// streamed its rows through one SM.
//
// The design: one cluster of C blocks (2 <= C <= 16, from the wrapper's
// launch_geometry) per panel; block r owns the contiguous rows
// [r*R, min(M, (r+1)*R)). Each block keeps its rows of the current
// 8-column strip in its own shared memory (the first smem_rows of them;
// rows past that, in the gate's tall narrow panels, are read from device
// memory in the same loops). The rest of the panel stays in device
// memory (L2-resident), column-major; a block only ever touches its own
// rows there, so no block reads device memory that another wrote.
//
// Per column, one exchange and no cluster barrier: every block reduces
// its rows' sum of squares and dot products with the strip columns to
// its right over its threads (warp shuffles, then a fixed shuffle tree
// over the warp partials) and pushes them, with row j from its owner,
// into a slot of EVERY block's shared memory with st.async, which counts
// the bytes off that block's mbarrier (cluster.cuh). Every thread waits
// on its own block's mbarrier until the C records are in; every warp sums
// them by the same fixed shuffle tree, so all warps of all blocks derive
// the same reflector, bitwise, launch after launch; then each block
// applies H_j to its own rows. Slots and mbarriers alternate by column
// parity (see lu_panel.cu for why two suffice).
//
// Per 8-column block, two cluster barriers. Each block forms its
// partials of [G | W] = Vb^T [Vb | trail] over its rows (threads as 8 row
// groups x 64 groups of 4 columns, Vb from shared memory, 4 rows' loads
// in flight at once, the reduction over the row groups by shuffles).
// Barrier. Every block sums G's C partials in rank order and builds
// T_blk alike (larft, lane a of warp 0 keeping row a of T); block r sums
// its slice of W's columns and forms Y = T_blk^T W for it. Barrier. Each
// block reads all of Y through distributed shared memory and updates its
// own rows, trail -= Vb Y. A last barrier keeps every block resident
// until no other block can touch its shared memory.
//
// Agreement with the plain version (pallas_qr.geqrt_panel_reference):
// the arithmetic is the same, the order of summation is not (and the dot
// products are formed from x before it is scaled by 1/(alpha - beta)),
// so the two agree to rounding, not bitwise. The gate is a tolerance.
// Two launches on the same panel agree bitwise (fixed reduction orders).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int JB = 8;                     // column block width
constexpr int THREADS = 512;              // per block of the cluster
constexpr int WARPS = THREADS / 32;
constexpr int NG = JB * (JB + 1) / 2;     // entries of the symmetric G
constexpr int MAXC = dtt_cluster::kMaxCluster;
// the block-update layout: RG row groups x (THREADS / RG) groups of CG
// columns; the RG threads of a column group are neighbouring lanes
constexpr int RG = 8;
constexpr int CG = 4;
constexpr int PASS = (THREADS / RG) * CG; // columns per pass (256)
constexpr int UB = 4;                     // rows a thread loads at once

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct alignas(16) Slot {  // one block's record for one column
  float part[JB];      // [jj] sum of squares below j, [c > jj] x . a[:, c]
  float row[JB];       // strip row j (its owner only)
};

// The block's rows of the 8-column strip at j0: local row l of column c
// lies in shared memory for l < nsm, in the panel past that.
struct Strip {
  float* s;            // shared: s[c * srows + l]
  float* g;            // device: g[c * M + l] (row r0 + l of column j0 + c)
  int64_t M;
  int srows, nsm;
  __device__ __forceinline__ float* at(int c, int l) const {
    return l < nsm ? s + c * srows + l : g + c * M + l;
  }
};

// Row i (local l) of the block's unit-lower Vb: the stored v below row
// j0 + a, 1 on it, 0 above.
__device__ __forceinline__ void load_vb(const Strip& st, int i, int l,
                                        int j0, float (&vb)[JB]) {
  if (l < st.nsm) {
#pragma unroll
    for (int a = 0; a < JB; ++a) vb[a] = st.s[a * st.srows + l];
  } else {
#pragma unroll
    for (int a = 0; a < JB; ++a) vb[a] = st.g[a * st.M + l];
  }
  if (i < j0 + JB) {   // only the strip's diagonal block needs masks
#pragma unroll
    for (int a = 0; a < JB; ++a) {
      const int d = j0 + a;
      vb[a] = i > d ? vb[a] : (i == d ? 1.f : 0.f);
    }
  }
}

// The block's strip rows [lo, nsm) into shared memory, UB loads in
// flight per thread.
__device__ __forceinline__ void load_strip(const Strip& st, int lo,
                                           int tid) {
  const int n = max(0, st.nsm - lo);
  for (int i0 = tid; i0 < JB * n; i0 += THREADS * UB) {
    float v[UB];
#pragma unroll
    for (int b = 0; b < UB; ++b) {
      const int idx = i0 + b * THREADS;
      v[b] = idx < JB * n ? st.g[(idx / n) * st.M + lo + idx % n] : 0.f;
    }
#pragma unroll
    for (int b = 0; b < UB; ++b) {
      const int idx = i0 + b * THREADS;
      if (idx < JB * n) st.s[(idx / n) * st.srows + lo + idx % n] = v[b];
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
k4_geqrt_panel_kernel(float* __restrict__ P, int M, int nb, int R,
                      int srows, float* __restrict__ taus) {
  extern __shared__ float4 dyn4[];
  float* const s_strip = reinterpret_cast<float*>(dyn4);  // JB * srows
  float* const s_wp = s_strip + JB * srows;  // JB * nb: [G|W] partials, Y
  float* const s_y = s_wp + JB * nb;         // JB * nb: this block's Y

  // slots[par][q]: block q's record for the columns of parity par
  __shared__ Slot slots[2][MAXC];
  __shared__ uint64_t bars[2];      // their arrivals, by column parity
  __shared__ float red[WARPS][JB];
  __shared__ float s_tau[JB];
  __shared__ float s_G[JB][JB];
  __shared__ float s_T[JB][JB];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = tid % RG;           // row group of the block update
  const int h = tid / RG;           // column group of the block update
  const int64_t Ml = M;
  const int r0 = rank * R;
  const int nrows = max(0, min(M, r0 + R) - r0);
  if (tid == 0) {
    dtt_cluster::mbar_init(&bars[0], 1);
    dtt_cluster::mbar_init(&bars[1], 1);
    dtt_cluster::mbar_init_fence();
  }
  cluster.sync();

  for (int j0 = 0; j0 < nb; j0 += JB) {
    const Strip st{s_strip, P + (int64_t)j0 * Ml + r0, Ml, srows,
                   min(nrows, srows)};
    const int lo = max(0, j0 - r0);   // first own row at or below j0

    load_strip(st, lo, tid);
    __syncthreads();

#pragma unroll
    for (int jj = 0; jj < JB; ++jj) {
      const int j = j0 + jj;
      const int par = jj & 1;

      // 1. partials over the own rows below j: slot jj the sum of
      // squares, slot c > jj the dot product with strip column c
      float part[JB];
#pragma unroll
      for (int c = 0; c < JB; ++c) part[c] = 0.f;
      for (int l = dtt_cluster::first_at(tid, max(0, j + 1 - r0), THREADS);
           l < nrows; l += THREADS) {
        const float x = *st.at(jj, l);
#pragma unroll
        for (int c = 0; c < JB; ++c)
          if (c >= jj) part[c] += x * *st.at(c, l);
      }
#pragma unroll
      for (int c = 0; c < JB; ++c) {
        if (c < jj) continue;
        const float v = warp_sum(part[c]);
        if (lane == 0) red[warp][c] = v;
      }
      __syncthreads();
      if (warp == 0) {
        // the record: the block's sums over its 16 warps (lane w holds
        // warp w's partials; a fixed shuffle tree, ending in lanes 0..15)
        // and row j (its owner only, lanes 8..15, gathered into every lane)
        float rec[2 * JB];
#pragma unroll
        for (int c = 0; c < JB; ++c) {
          rec[c] = (lane < WARPS && c >= jj) ? red[lane][c] : 0.f;
          if (c < jj) continue;
#pragma unroll
          for (int off = 1; off < WARPS; off <<= 1) {
            const float o = __shfl_xor_sync(0xffffffffu, rec[c], off);
            if (lane < WARPS) rec[c] += o;
          }
        }
        const int lj = j - r0;
        const float mine = (lane >= JB && lane < 2 * JB && lj >= 0
                            && lj < nrows) ? *st.at(lane - JB, lj) : 0.f;
#pragma unroll
        for (int c = JB; c < 2 * JB; ++c)
          rec[c] = __shfl_sync(0xffffffffu, mine, c);

        // 2. pushed into slot [par][rank] of every block of the cluster
        // (lane q to block q), then the wait for all C records; the sums
        // over the records (lane q < C holds block q's) by a fixed
        // shuffle tree, so every block gets the same bits, and row j
        // from its owner's record
        if (lane == 0)
          dtt_cluster::mbar_expect(&bars[par], C * (int)sizeof(Slot));
        if (lane < C) {
          const unsigned d = dtt_cluster::remote_addr(&slots[par][rank],
                                                      lane);
          const unsigned b = dtt_cluster::remote_addr(&bars[par], lane);
          dtt_cluster::push16(d, b, rec[0], rec[1], rec[2], rec[3]);
          dtt_cluster::push16(d + 16, b, rec[4], rec[5], rec[6], rec[7]);
          dtt_cluster::push16(d + 32, b, rec[8], rec[9], rec[10], rec[11]);
          dtt_cluster::push16(d + 48, b, rec[12], rec[13], rec[14],
                              rec[15]);
        }
      }
      // every thread: the wait for the column's C records; every warp:
      // the sums over them (lane q < C holds block q's) by a fixed
      // shuffle tree, so every warp of every block gets the same bits,
      // and row j from its owner's record
      dtt_cluster::mbar_wait(&bars[par], (j >> 1) & 1);
      float4 p0 = make_float4(0.f, 0.f, 0.f, 0.f), p1 = p0;
      if (lane < C) {
        p0 = reinterpret_cast<const float4*>(slots[par][lane].part)[0];
        p1 = reinterpret_cast<const float4*>(slots[par][lane].part)[1];
      }
      float sum[JB] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int c = 0; c < JB; ++c) {
        if (c < jj) continue;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1)   // lanes >= C add zeros
          sum[c] += __shfl_xor_sync(0xffffffffu, sum[c], off);
      }
      const float* rowj = slots[par][j / R].row;

      // 3. the reflector, computed alike by every thread of every block
      const float ssq = sum[jj];
      const float alpha = rowj[jj];
      const float norm = sqrtf(alpha * alpha + ssq);
      const float beta = alpha >= 0.f ? -norm : norm;
      const float tau = norm > 0.f ? (beta - alpha) / beta : 0.f;
      const float denom = alpha - beta;
      const float vinv = denom != 0.f ? 1.f / denom : 0.f;
      float w[JB];
#pragma unroll
      for (int c = 0; c < JB; ++c)
        w[c] = c > jj ? rowj[c] + vinv * sum[c] : 0.f;
      if (tid == 0) {
        s_tau[jj] = tau;
        if (rank == 0) taus[j] = tau;
      }

      // 4. H_j on the strip columns right of jj, own rows at or below j;
      // then beta on the diagonal and v below it
      for (int l = dtt_cluster::first_at(tid, max(0, j - r0), THREADS);
           l < nrows; l += THREADS) {
        const int i = r0 + l;
        float* pj = st.at(jj, l);
        const float v = (i == j) ? 1.f : *pj * vinv;
        const float tv = tau * v;
#pragma unroll
        for (int c = 0; c < JB; ++c)
          if (c > jj) *st.at(c, l) -= tv * w[c];
        *pj = (i == j) ? beta : v;
      }
    }
    __syncthreads();

    // the strip's shared rows back to the panel (rows above j0 are
    // untouched by this block)
    for (int idx = tid; idx < JB * max(0, st.nsm - lo); idx += THREADS) {
      const int c = idx / (st.nsm - lo), l = lo + idx % (st.nsm - lo);
      st.g[c * Ml + l] = s_strip[c * srows + l];
    }

    const int wt = nb - j0 - JB;           // trailing columns
    if (wt <= 0) break;

    // 5. this block's partials of [G | W] = Vb^T [Vb | trail]: column e
    // of the extended block is Vb's column e for e < JB, else trailing
    // column e - JB; kept as s_wp[a * ne + e]
    const int ne = JB + wt;
    for (int e0 = 0; e0 < ne; e0 += PASS) {
      const int eb = e0 + h * CG;
      float acc[JB][CG];
#pragma unroll
      for (int a = 0; a < JB; ++a) {
#pragma unroll
        for (int q = 0; q < CG; ++q) acc[a][q] = 0.f;
      }
      if (eb < ne) {
        const float* colp[CG];
#pragma unroll
        for (int q = 0; q < CG; ++q)
          colp[q] = P + (int64_t)(j0 + max(eb, JB) + min(q, ne - 1 - eb)) * Ml
                    + r0;
        for (int l0 = lo + g; l0 < nrows; l0 += RG * UB) {
          // UB rows' trailing values in flight at once (the groups of
          // Vb's own columns, eb = 0 or 4, load none)
          float x[UB][CG];
#pragma unroll
          for (int b = 0; b < UB; ++b) {
            const int l = min(l0 + b * RG, nrows - 1);
#pragma unroll
            for (int q = 0; q < CG; ++q)
              x[b][q] = eb >= JB ? colp[q][l] : 0.f;
          }
#pragma unroll
          for (int b = 0; b < UB; ++b) {
            const int l = l0 + b * RG;
            if (l >= nrows) break;
            float vb[JB];
            load_vb(st, r0 + l, l, j0, vb);
            if (eb < JB) {
#pragma unroll
              for (int q = 0; q < CG; ++q)
                x[b][q] = eb == 0 ? vb[q] : vb[CG + q];
            } else if (eb + CG > ne) {
#pragma unroll
              for (int q = 0; q < CG; ++q)
                if (eb + q >= ne) x[b][q] = 0.f;
            }
#pragma unroll
            for (int a = 0; a < JB; ++a) {
#pragma unroll
              for (int q = 0; q < CG; ++q) acc[a][q] += vb[a] * x[b][q];
            }
          }
        }
      }
#pragma unroll
      for (int a = 0; a < JB; ++a) {
#pragma unroll
        for (int q = 0; q < CG; ++q) {
          float v = acc[a][q];
#pragma unroll
          for (int off = 1; off < RG; off <<= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
          acc[a][q] = v;
        }
      }
      if (g == 0 && eb < ne) {
#pragma unroll
        for (int a = 0; a < JB; ++a) {
#pragma unroll
          for (int q = 0; q < CG; ++q)
            if (eb + q < ne) s_wp[a * ne + eb + q] = acc[a][q];
        }
      }
    }
    cluster.sync();

    // 6. G summed in rank order by every block; this block's slice of
    // W's columns summed the same way, into s_y[a * wt + c]
    const int slice = (wt + C - 1) / C;
    const int c_lo = min(wt, rank * slice);
    const int c_hi = min(wt, c_lo + slice);
    if (tid < NG) {
      int a = 0, q = tid;
      while (q >= JB - a) {
        q -= JB - a;
        ++a;
      }
      const int b = a + q;
      float v[MAXC];
#pragma unroll
      for (int r = 0; r < MAXC; ++r)
        v[r] = r < C ? cluster.map_shared_rank(s_wp, r)[a * ne + b] : 0.f;
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < MAXC; ++r)
        if (r < C) s += v[r];
      s_G[a][b] = s;
      s_G[b][a] = s;
    }
    for (int p = tid; p < JB * (c_hi - c_lo); p += THREADS) {
      const int a = p % JB, c = c_lo + p / JB;
      float v[MAXC];
#pragma unroll
      for (int r = 0; r < MAXC; ++r)
        v[r] = r < C ? cluster.map_shared_rank(s_wp, r)[a * ne + JB + c]
                     : 0.f;
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < MAXC; ++r)
        if (r < C) s += v[r];
      s_y[a * wt + c] = s;
    }
    __syncthreads();

    // 7. T_blk by the larft recurrence, alike in every block: lane a of
    // warp 0 keeps row a of T, and T[a][i] needs only row a and G
    if (warp == 0 && lane < JB) {
      float T[JB];
#pragma unroll
      for (int b = 0; b < JB; ++b) T[b] = 0.f;
#pragma unroll
      for (int i = 0; i < JB; ++i) {
        const float ti = s_tau[i];
        if (lane < i) {
          float m = 0.f;
#pragma unroll
          for (int b = 0; b < i; ++b)
            if (b >= lane) m += T[b] * s_G[b][i];
          T[i] = -ti * m;
        } else if (lane == i) {
          T[i] = ti;
        }
      }
#pragma unroll
      for (int b = 0; b < JB; ++b) s_T[lane][b] = T[b];
    }
    __syncthreads();

    // 8. Y = T_blk^T W on this block's slice, in place
    for (int c = c_lo + tid; c < c_hi; c += THREADS) {
      float W[JB];
#pragma unroll
      for (int b = 0; b < JB; ++b) W[b] = s_y[b * wt + c];
#pragma unroll
      for (int a = 0; a < JB; ++a) {
        float y = 0.f;
#pragma unroll
        for (int b = 0; b < JB; ++b) y += s_T[b][a] * W[b];
        s_y[a * wt + c] = y;
      }
    }
    cluster.sync();

    // 9. all of Y from the slices' owners into s_wp[a * wt + c] ...
    for (int p = tid; p < JB * wt; p += THREADS) {
      const int a = p / wt, c = p % wt;
      s_wp[p] = cluster.map_shared_rank(s_y, c / slice)[a * wt + c];
    }
    __syncthreads();

    // ... and trail -= Vb Y on the own rows
    for (int cb0 = 0; cb0 < wt; cb0 += PASS) {
      const int cb = cb0 + h * CG;
      if (cb >= wt) continue;
      float y[JB][CG];
#pragma unroll
      for (int a = 0; a < JB; ++a) {
#pragma unroll
        for (int q = 0; q < CG; ++q)
          y[a][q] = cb + q < wt ? s_wp[a * wt + cb + q] : 0.f;
      }
      float* colp[CG];
#pragma unroll
      for (int q = 0; q < CG; ++q)
        colp[q] = P + (int64_t)(j0 + JB + cb + min(q, wt - 1 - cb)) * Ml
                  + r0;
      for (int l0 = lo + g; l0 < nrows; l0 += RG * UB) {
        float x[UB][CG];
#pragma unroll
        for (int b = 0; b < UB; ++b) {
          const int l = min(l0 + b * RG, nrows - 1);
#pragma unroll
          for (int q = 0; q < CG; ++q) x[b][q] = colp[q][l];
        }
#pragma unroll
        for (int b = 0; b < UB; ++b) {
          const int l = l0 + b * RG;
          if (l >= nrows) break;
          float vb[JB];
          load_vb(st, r0 + l, l, j0, vb);
#pragma unroll
          for (int q = 0; q < CG; ++q) {
            float s = 0.f;
#pragma unroll
            for (int a = 0; a < JB; ++a) s += vb[a] * y[a][q];
            if (cb + q < wt) colp[q][l] = x[b][q] - s;
          }
        }
      }
    }
    __syncthreads();
  }
  // no block leaves while another may still touch its shared memory
  cluster.sync();
}

}  // namespace

// Plain C entry points, bound with ctypes. P: the (M, nb) panel in
// column-major order (element (i, j) at P[j * M + i]), factored in place;
// taus: nb floats. The launch geometry comes from the wrapper
// (pallas_qr.launch_geometry): a cluster of `cluster` blocks, block r
// owning rows [r * rows_per_block, ...), its first `smem_rows` strip rows
// in `smem_bytes` of dynamic shared memory. Returns 0 when launched, a
// cudaError_t, or -1 when no such cluster fits on the card.
extern "C" int dtt_k4_geqrt_panel(int M, int nb, int cluster,
                                  int rows_per_block, int smem_rows,
                                  int smem_bytes, void* P, void* taus,
                                  void* stream) {
  if (nb <= 0 || M < nb || nb % JB != 0 || cluster < 1 || cluster > MAXC
      || rows_per_block < 1 || (int64_t)cluster * rows_per_block < M
      || smem_rows < 0 || smem_rows > rows_per_block
      || (int64_t)smem_bytes < 4 * ((int64_t)JB * smem_rows
                                    + 2 * (int64_t)JB * nb))
    return (int)cudaErrorInvalidValue;
  return dtt_cluster::launch(k4_geqrt_panel_kernel, cluster, THREADS,
                             smem_bytes, static_cast<cudaStream_t>(stream),
                             static_cast<float*>(P), M, nb, rows_per_block,
                             smem_rows, static_cast<float*>(taus));
}
