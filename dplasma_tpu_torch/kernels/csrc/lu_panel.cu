// K3 on Hopper: partial-pivoting LU of one (M, nb) f32 panel, spread
// over the SMs of one thread-block cluster.
//
// Replaces dplasma_tpu/kernels/pallas_lu.py:lu_panel (body _panel_kernel,
// pallas_call at :121), the kernel every LU panel is sent to under MCA
// panel.kernel=pallas (ops/lu.py _base_lu).
//
// What it computes, as the TPU kernel does: columns advance in JB = 8
// wide blocks; per column a lowest-index max-|a| pivot, a physical
// two-row swap, the scale by the pivot's reciprocal (0 for a zero pivot)
// and a rank-1 update inside the block's strip; per block the unit-lower
// solve for the block's U12 rows and the rank-JB update of the trailing
// columns. Outputs: the packed L\U in place, the LAPACK-style swap
// sequence and the permutation it gives (a[perm] = L U).
//
// What bounds it on this card: not FLOP/s and not bytes (a top panel is
// ~5e8 flop and 16 MB, 0.008 ms at the FP32 peak) but the chain of nb
// sequential pivot steps: each needs a search over every row of the
// panel before any row can be updated, so each costs a round of
// communication between the SMs that hold the rows. The first version
// ran the chain inside one block (one SM of 132) with three block
// barriers a column, and streamed every trailing update through that
// one SM.
//
// The design: one cluster of C blocks (2 <= C <= 16, from the wrapper's
// launch_geometry) per panel; block r owns the contiguous rows
// [r*R, min(M, (r+1)*R)) and keeps them of the current 8-column strip in
// its shared memory (the first smem_rows; rows past that, in the gate's
// tall narrow panels, are read from device memory in the same loops).
// The rest of the panel stays in device memory (L2-resident),
// column-major.
//
// Per column, one exchange and no cluster barrier. Each block finds its
// best candidate among its rows at or below j (each thread's best is
// kept by the previous column's update; then warp and block reductions
// of an order-preserving key, __reduce_max/min_sync) and pushes it, with
// that row's 8 strip values and, from the owner of row j, row j's, into
// a slot of EVERY block's shared memory with st.async, which counts the
// bytes off that block's mbarrier (cluster.cuh). Every thread waits on
// its own block's mbarrier until the C records are in, and every warp
// elects the pivot from the local slots: larger |a|, ties to the lower
// row, a NaN never wins. That order is strict and total, so every block
// elects the same row. Slots and mbarriers alternate by column parity: a
// block can push column j+2's record only after every block has pushed
// column j+1's, which each does after reading column j's. The pivot
// row's values travel with its candidate: the owner of row piv writes
// row j's old values into it, the owner of row j the pivot row's, each
// in its own strip, and every block scales and updates its own rows.
// The push replaces a barrier.cluster and the remote reads after it:
// data and signal travel together, one way.
//
// The column chain runs on the first CHAIN threads of each block (their
// own barrier 1). Meanwhile the other warps apply the previous strip's
// rank-8 update to the columns right of the current strip, and write
// the previous strip back to the panel: that work is off the chain's
// path. The current strip's own columns had their update first (the
// look-ahead below), into the second of two strip buffers.
//
// Per 8-column block, two cluster barriers. Every block knows the 8
// pivots and the 8 pivot rows (L11\U11), so the block's row moves are
// composed alike in every block (at most 16 rows, each traced back
// through the 8 swaps: new row x = old row src[x]). Barrier: every
// block's overlapped update is done. The cluster's threads take one
// column outside the strip each (block r the columns r, r + C, ...):
// they gather the moved rows, scatter them, and for a trailing column
// also solve its U12 = L11^-1 A12 rows in registers. Barrier. Each block
// stages U12 in shared memory and updates the next strip's 8 columns on
// its own rows into the other strip buffer (the look-ahead); the rest of
// the trailing columns are updated during the next strip's chain
// (threads as 8 row groups x groups of 4 columns, 4 rows' loads in
// flight at once). Device memory that another block wrote (moved rows,
// U12) is read with ld.global.cg (L2; never a stale line in this SM's
// L1), after a barrier's release/acquire at cluster scope. The second
// barrier is also each block's last: no slot is written or read after
// it. The permutation is traced per row from the swap sequence (every
// block knows it).
//
// Rounding: every update is a rounded product followed by a rounded
// difference (__fmul_rn / __fsub_rn, never contracted into an FMA), in
// the column order of the unblocked loop, and the reciprocal is
// IEEE-rounded. Each element's chain of operations is the same whichever
// block owns its row, and it is exactly what the plain PyTorch version
// (pallas_lu.lu_panel_reference) computes, so the two agree bitwise,
// pivots included. That rule also sets the floor of the rank-8 update:
// two FP32 instructions per multiply-subtract on at most 16 SMs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "cluster.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int JB = 8;             // column block width (the reference's JB)
constexpr int THREADS = 512;      // per block of the cluster
constexpr int MAXC = dtt_cluster::kMaxCluster;
// the rank-8 update's layout: RG row groups x groups of CG columns
constexpr int RG = 8;
constexpr int CG = 4;
constexpr int UB = 4;             // rows a thread loads before updating
// the first CHAIN threads run the column chain of strip s while the
// others apply strip s-1's rank-8 update to the columns right of it
constexpr int CHAIN = 256;
// whole warps, and some left over for the update (else no warp applies it)
static_assert(CHAIN % 32 == 0 && CHAIN < THREADS, "CHAIN");

// The pivot order: larger |a| wins, equal |a| goes to the lower row, a
// NaN never wins. As a key: 0 for a NaN or no candidate (row INT_MAX),
// else the bits of |a| plus one (monotonic for non-negative floats), so
// (key, row) beats (bk, br) when its key is larger or, equal, its row
// lower; an all-NaN column keeps key 0 and row INT_MAX.
__device__ __forceinline__ unsigned pivot_key(float a) {
  const float v = fabsf(a);
  return v != v ? 0u : __float_as_uint(v) + 1u;
}

__device__ __forceinline__ void keep_best(unsigned k, int i, unsigned& bk,
                                          int& bi) {
  if (k > bk || (k == bk && i < bi)) {
    bk = k;
    bi = i;
  }
}

// x - a*b with the product rounded first, as two separate torch ops do.
__device__ __forceinline__ float sub_prod(float x, float a, float b) {
  return __fsub_rn(x, __fmul_rn(a, b));
}

// The warp's best (key, row), in every lane: the largest key, then the
// lowest row holding it.
__device__ __forceinline__ void warp_best(unsigned& bk, int& bi) {
  const unsigned m = __reduce_max_sync(0xffffffffu, bk);
  bi = (int)__reduce_min_sync(0xffffffffu,
                              bk == m ? (unsigned)bi : 0xffffffffu);
  bk = m;
}

struct alignas(16) Slot {  // one block's record for one column
  float cand[JB];      // its candidate row's strip values
  float jrow[JB];      // strip row j (its owner only)
  unsigned key;        // its best pivot_key at or below row j
  int i;               // that row (INT_MAX: none)
};
constexpr int kRecordBytes = 4 * (2 * JB + 2);   // what a block pushes

// The block's rows of the 8-column strip at j0: local row l of column c
// lies in shared memory for l < nsm, in the panel past that (read
// through L2: another block may have moved it there).
struct Strip {
  float* s;            // shared: s[c * srows + l]
  float* g;            // device: g[c * M + l] (row r0 + l of column j0 + c)
  int64_t M;
  int srows, nsm;
  __device__ __forceinline__ float get(int c, int l) const {
    return l < nsm ? s[c * srows + l] : __ldcg(g + c * M + l);
  }
  // the JB strip values of local row l
  __device__ __forceinline__ void row(int l, float (&x)[JB]) const {
    if (l < nsm) {
#pragma unroll
      for (int c = 0; c < JB; ++c) x[c] = s[c * srows + l];
    } else {
#pragma unroll
      for (int c = 0; c < JB; ++c) x[c] = __ldcg(g + c * M + l);
    }
  }
  __device__ __forceinline__ void set(int c, int l, float x) const {
    if (l < nsm)
      s[c * srows + l] = x;
    else
      g[c * M + l] = x;
  }
};

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
      v[b] = idx < JB * n
                 ? __ldcg(st.g + (idx / n) * st.M + lo + idx % n) : 0.f;
    }
#pragma unroll
    for (int b = 0; b < UB; ++b) {
      const int idx = i0 + b * THREADS;
      if (idx < JB * n) st.s[(idx / n) * st.srows + lo + idx % n] = v[b];
    }
  }
}

// The rank-8 update A[:, cols] -= L21 U12 on the own rows [lo2, nrows)
// of the trailing columns [c_lo, c_hi): U12 staged in s_u (column c at
// s_u[t * ldu + c - u0]), L21 from strip `st`; `nt` threads numbered
// t = 0.. as RG row groups x (nt / RG) groups of CG columns, UB rows'
// loads in flight at once; each element's JB rank-1 steps in order.
__device__ __forceinline__ void rank8_update(float* P, int64_t Ml, int r0,
                                             int nrows, int lo2,
                                             const Strip& st,
                                             const float* s_u, int ldu,
                                             int u0, int c_lo, int c_hi,
                                             int t, int nt) {
  const int g = t % RG, h = t / RG;
  const int pass = (nt / RG) * CG;
  for (int cb = c_lo + h * CG; cb < c_hi; cb += pass) {
    float u[JB][CG];
#pragma unroll
    for (int k = 0; k < JB; ++k) {
#pragma unroll
      for (int q = 0; q < CG; ++q)
        u[k][q] = cb + q < c_hi ? s_u[k * ldu + cb + q - u0] : 0.f;
    }
    float* colp[CG];
#pragma unroll
    for (int q = 0; q < CG; ++q)
      colp[q] = P + (int64_t)min(cb + q, c_hi - 1) * Ml + r0;
    for (int l0 = lo2 + g; l0 < nrows; l0 += RG * UB) {
      float x[UB][CG];
#pragma unroll
      for (int b = 0; b < UB; ++b) {
        const int l = min(l0 + b * RG, nrows - 1);
#pragma unroll
        for (int q = 0; q < CG; ++q) x[b][q] = __ldcg(colp[q] + l);
      }
#pragma unroll
      for (int b = 0; b < UB; ++b) {
        const int l = l0 + b * RG;
        if (l >= nrows) break;
        float lr[JB];
        st.row(l, lr);
#pragma unroll
        for (int q = 0; q < CG; ++q) {
#pragma unroll
          for (int k = 0; k < JB; ++k)
            x[b][q] = sub_prod(x[b][q], lr[k], u[k][q]);
        }
#pragma unroll
        for (int q = 0; q < CG; ++q)
          if (cb + q < c_hi) colp[q][l] = x[b][q];
      }
    }
  }
}

// The strip's shared rows [lo, nsm) back to the panel (rows above the
// strip's diagonal block are untouched by it), by `nt` threads t = 0..
__device__ __forceinline__ void write_back(const Strip& st, int lo, int t,
                                           int nt) {
  const int n = max(0, st.nsm - lo);
  for (int idx = t; idx < JB * n; idx += nt) {
    const int c = idx / n, l = lo + idx % n;
    st.g[c * st.M + l] = st.s[c * st.srows + l];
  }
}

// The column chain's own barrier (its CHAIN threads, barrier 1; the
// other warps are updating meanwhile).
__device__ __forceinline__ void chain_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CHAIN) : "memory");
}

__global__ void __launch_bounds__(THREADS, 1)
k3_lu_panel_kernel(float* __restrict__ P, int M, int nb, int R, int srows,
                   int* __restrict__ swaps, int64_t* __restrict__ perm) {
  extern __shared__ float4 dyn4[];
  float* const s_buf = reinterpret_cast<float*>(dyn4);  // 2 * JB * srows
  float* const s_u = s_buf + 2 * JB * srows;    // JB * nb: U12 staged
  int* const s_sw = reinterpret_cast<int*>(s_u + 2 * JB * nb);  // nb

  // slots[par][q]: block q's record for the columns of parity par
  __shared__ Slot slots[2][MAXC];
  __shared__ uint64_t bars[2];      // their arrivals, by column parity
  __shared__ unsigned red_k[CHAIN / 32];
  __shared__ int red_i[CHAIN / 32];
  __shared__ float s_L[JB][JB];     // the block's pivot rows: L11 \ U11
  __shared__ int s_dst[2 * JB];     // the block's row moves:
  __shared__ int s_src[2 * JB];     //   new row dst = old row src

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t Ml = M;
  const int r0 = rank * R;
  const int nrows = max(0, min(M, r0 + R) - r0);
  const int nsm = min(nrows, srows);
  // strip s (columns 8s..8s+7) lives in shared buffer s & 1
  auto strip = [&](int s) {
    return Strip{s_buf + (s & 1) * JB * srows,
                 P + (int64_t)(JB * s) * Ml + r0, Ml, srows, nsm};
  };
  if (tid == 0) {
    dtt_cluster::mbar_init(&bars[0], 1);
    dtt_cluster::mbar_init(&bars[1], 1);
    dtt_cluster::mbar_init_fence();
  }
  load_strip(strip(0), 0, tid);
  cluster.sync();

  for (int j0 = 0; j0 < nb; j0 += JB) {
    const int s = j0 / JB;
    const Strip st = strip(s);
    const int lo = max(0, j0 - r0);   // first own row at or below j0

    if (warp < CHAIN / 32) {
      // the column chain of strip s, on the first CHAIN threads: each
      // thread's best candidate for the next column among its rows is
      // kept by the previous column's update (by a scan for column j0)
      unsigned bk = 0u;
      int bi = INT_MAX;
      for (int l = dtt_cluster::first_at(tid, lo, CHAIN); l < nrows;
           l += CHAIN)
        keep_best(pivot_key(st.get(0, l)), r0 + l, bk, bi);

#pragma unroll 1
      for (int jj = 0; jj < JB; ++jj) {
        const int j = j0 + jj;
        const int par = jj & 1;

        // 1. this block's candidate: the lowest row among its rows of
        // largest |a| at or below j
        warp_best(bk, bi);
        if (lane == 0) {
          red_k[warp] = bk;
          red_i[warp] = bi;
        }
        chain_sync();
        if (warp == 0) {
          bk = lane < CHAIN / 32 ? red_k[lane] : 0u;
          bi = lane < CHAIN / 32 ? red_i[lane] : INT_MAX;
          warp_best(bk, bi);
          // the record: lanes 0..7 the candidate row, lanes 8..15 row j
          // (its owner only), gathered into every lane
          const int lj = j - r0;
          float mine = 0.f;
          if (lane < JB && bi != INT_MAX)
            mine = st.get(lane, bi - r0);
          else if (lane >= JB && lane < 2 * JB && lj >= 0 && lj < nrows)
            mine = st.get(lane - JB, lj);
          float rec[2 * JB];
#pragma unroll
          for (int c = 0; c < 2 * JB; ++c)
            rec[c] = __shfl_sync(0xffffffffu, mine, c);
          // 2. pushed into slot [par][rank] of every block of the
          // cluster (lane q to block q)
          if (lane == 0)
            dtt_cluster::mbar_expect(&bars[par], C * kRecordBytes);
          if (lane < C) {
            const unsigned d = dtt_cluster::remote_addr(&slots[par][rank],
                                                        lane);
            const unsigned b = dtt_cluster::remote_addr(&bars[par], lane);
            dtt_cluster::push16(d, b, rec[0], rec[1], rec[2], rec[3]);
            dtt_cluster::push16(d + 16, b, rec[4], rec[5], rec[6], rec[7]);
            dtt_cluster::push16(d + 32, b, rec[8], rec[9], rec[10],
                                rec[11]);
            dtt_cluster::push16(d + 48, b, rec[12], rec[13], rec[14],
                                rec[15]);
            dtt_cluster::push8(d + 64, b, bk, (unsigned)bi);
          }
        }
        // every chain thread: the wait for the column's C records, then,
        // in every warp, the cluster's winner from the local slots (the
        // pivot order is strict and total, so every block elects the
        // same row)
        dtt_cluster::mbar_wait(&bars[par], (j >> 1) & 1);
        unsigned ck = 0u;
        int ci = INT_MAX;
        if (lane < C) {
          const uint2 ki = *reinterpret_cast<const uint2*>(
              &slots[par][lane].key);
          ck = ki.x;
          ci = (int)ki.y;
        }
        warp_best(ck, ci);
        const int piv = ci == INT_MAX ? j : ci;
        // the pivot row: the winner's candidate, or row j itself when
        // row j wins or no row does
        const float* sj = slots[par][j / R].jrow;
        const float* pr = piv == j ? sj : slots[par][piv / R].cand;
        float prow[JB], jrow[JB];
#pragma unroll
        for (int c = 0; c < JB; ++c) {
          prow[c] = pr[c];
          jrow[c] = sj[c];
        }
        if (tid < JB) s_L[jj][tid] = pr[tid];
        if (tid == 0) {
          s_sw[j] = piv;
          if (rank == 0) swaps[j] = piv;
        }

        // 3. the swap inside the strip: row piv takes row j's values,
        // row j the pivot row's, each written by the thread that owns it
        if (piv != j) {
          const int lp = piv - r0, lj = j - r0;
          if (lp >= 0 && lp < nrows && tid == lp % CHAIN) {
#pragma unroll
            for (int c = 0; c < JB; ++c) st.set(c, lp, jrow[c]);
          }
          if (lj >= 0 && lj < nrows && tid == lj % CHAIN) {
#pragma unroll
            for (int c = 0; c < JB; ++c) st.set(c, lj, prow[c]);
          }
        }

        // 4. scale column j below the pivot, rank-1 update of the strip,
        // and each thread's best candidate for column j + 1
        const float d = pr[jj];
        const float inv = (d != 0.f) ? __frcp_rn(d) : 0.f;
        bk = 0u;
        bi = INT_MAX;
        for (int l = dtt_cluster::first_at(tid, max(0, j + 1 - r0), CHAIN);
             l < nrows; l += CHAIN) {
          const float lv = __fmul_rn(st.get(jj, l), inv);
          st.set(jj, l, lv);
#pragma unroll
          for (int c = 0; c < JB; ++c) {
            if (c > jj) {
              const float x = sub_prod(st.get(c, l), lv, prow[c]);
              st.set(c, l, x);
              if (c == jj + 1) keep_best(pivot_key(x), r0 + l, bk, bi);
            }
          }
        }
      }
    } else if (j0 > 0) {
      // meanwhile the other warps: strip s-1's shared rows back to the
      // panel (no one reads them there before strip s's row moves), and
      // its rank-8 update of the columns right of strip s (strip s's own
      // columns had theirs before its chain began)
      write_back(strip(s - 1), max(0, j0 - JB - r0), tid - CHAIN,
                 THREADS - CHAIN);
      rank8_update(P, Ml, r0, nrows, lo, strip(s - 1), s_u, nb - j0, j0,
                   j0 + JB, nb, tid - CHAIN, THREADS - CHAIN);
    }
    __syncthreads();

    // the block's row moves, composed alike in every block
    if (warp == 0 && lane < 2 * JB) {
      // lane t < JB: row j0 + t; lane JB + t: pivot row t. The value that
      // ends on row x came from the row found by undoing the block's
      // swaps, last first (duplicates repeat the same move: harmless)
      const int x = lane < JB ? j0 + lane : s_sw[j0 + lane - JB];
      int from = x;
#pragma unroll
      for (int t = JB - 1; t >= 0; --t) {
        const int p = s_sw[j0 + t];
        from = from == j0 + t ? p : (from == p ? j0 + t : from);
      }
      s_dst[lane] = x;
      s_src[lane] = from;
    }
    __syncthreads();
    // every block's updates of the columns right of strip s are done
    // before any block moves rows in them
    cluster.sync();

    // 5. one thread of the cluster per column outside the strip (block r
    // takes the columns r, r + C, ...): the row moves, and for a trailing
    // column its U12 rows, solved with L11
    for (int c = tid * C + rank; c < nb; c += C * THREADS) {
      if (c >= j0 && c < j0 + JB) continue;
      float* col = P + (int64_t)c * Ml;
      float val[2 * JB];
#pragma unroll
      for (int k = 0; k < 2 * JB; ++k) val[k] = __ldcg(col + s_src[k]);
      if (c < j0) {
#pragma unroll
        for (int k = 0; k < 2 * JB; ++k) col[s_dst[k]] = val[k];
        continue;
      }
      // rows j0..j0+7 are lanes 0..7 of the move list
      float u[JB];
#pragma unroll
      for (int t = 0; t < JB; ++t) u[t] = val[t];
#pragma unroll
      for (int k = JB; k < 2 * JB; ++k)
        if (s_dst[k] >= j0 + JB) col[s_dst[k]] = val[k];
#pragma unroll
      for (int a = 1; a < JB; ++a) {
#pragma unroll
        for (int b = 0; b < a; ++b) u[a] = sub_prod(u[a], s_L[a][b], u[b]);
      }
#pragma unroll
      for (int t = 0; t < JB; ++t) col[j0 + t] = u[t];
    }
    cluster.sync();

    // 6. U12 staged in shared memory (s_u[t * wt + c - j0 - JB]), then
    // the rank-8 update of the next strip's columns on the own rows below
    // this strip, into the next strip's buffer (the chain of strip s + 1
    // starts from it; the other columns are updated during that chain)
    const int wt = nb - j0 - JB;
    if (wt > 0) {
      for (int idx = tid; idx < JB * wt; idx += THREADS) {
        const int t = idx % JB, c = idx / JB;
        s_u[t * wt + c] = __ldcg(P + (int64_t)(j0 + JB + c) * Ml + j0 + t);
      }
      __syncthreads();
      const Strip nx = strip(s + 1);
      const int lo2 = max(0, j0 + JB - r0);
      float u[JB][CG];
      const int half = tid & 1;      // columns 4 * half .. 4 * half + 3
#pragma unroll
      for (int t = 0; t < JB; ++t) {
#pragma unroll
        for (int q = 0; q < CG; ++q) u[t][q] = s_u[t * wt + CG * half + q];
      }
      for (int l = lo2 + (tid >> 1); l < nrows; l += THREADS / 2) {
        float x[CG], lr[JB];
#pragma unroll
        for (int q = 0; q < CG; ++q)
          x[q] = __ldcg(nx.g + (CG * half + q) * Ml + l);
        st.row(l, lr);
#pragma unroll
        for (int q = 0; q < CG; ++q) {
#pragma unroll
          for (int t = 0; t < JB; ++t) x[q] = sub_prod(x[q], lr[t], u[t][q]);
          nx.set(CG * half + q, l, x[q]);
        }
      }
    }
    __syncthreads();
  }

  // the last strip's shared rows back to the panel; the permutation of
  // the swap sequence, traced back per own row
  write_back(strip(nb / JB - 1), max(0, nb - JB - r0), tid, THREADS);
  for (int l = tid; l < nrows; l += THREADS) {
    int x = r0 + l;
    for (int j = nb - 1; j >= 0; --j) {
      const int p = s_sw[j];
      x = x == j ? p : (x == p ? j : x);
    }
    perm[r0 + l] = x;
  }
}

}  // namespace

// Plain C entry points, bound with ctypes. P: the (M, nb) panel in
// column-major order (element (i, j) at P[j * M + i]), factored in place;
// swaps: nb int32; perm: M int64. The launch geometry comes from the
// wrapper (pallas_qr.launch_geometry, shared with K4): a cluster of
// `cluster` blocks, block r owning rows [r * rows_per_block, ...), its
// first `smem_rows` strip rows in `smem_bytes` of dynamic shared memory.
// Returns 0 when launched, a cudaError_t, or -1 when no such cluster
// fits on the card.
extern "C" int dtt_k3_lu_panel(int M, int nb, int cluster,
                               int rows_per_block, int smem_rows,
                               int smem_bytes, void* P, void* swaps,
                               void* perm, void* stream) {
  if (nb <= 0 || M < nb || nb % JB != 0 || cluster < 1 || cluster > MAXC
      || rows_per_block < 1 || (int64_t)cluster * rows_per_block < M
      || smem_rows < 0 || smem_rows > rows_per_block
      || (int64_t)smem_bytes < 4 * (2 * (int64_t)JB * smem_rows
                                    + 2 * (int64_t)JB * nb + nb))
    return (int)cudaErrorInvalidValue;
  return dtt_cluster::launch(k3_lu_panel_kernel, cluster, THREADS,
                             smem_bytes, static_cast<cudaStream_t>(stream),
                             static_cast<float*>(P), M, nb, rows_per_block,
                             smem_rows, static_cast<int*>(swaps),
                             static_cast<int64_t*>(perm));
}
