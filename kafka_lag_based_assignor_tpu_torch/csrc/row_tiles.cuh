// The row-tile pass of the implicit transport plan's marginals, with the
// ordered sums of its tile partials, for Hopper (sm_90a).  Shared by
// plan_stats.cu (K3: dense Sinkhorn, rows = deduplicated lag values) and
// linear_ot.cu (K5 and K4: linear mode, rows = partitions).
//
// For each row r the plan row is X_r[j] = softmax_j(-lw_r * A_j + B_j) over
// the C consumers, and a tile of rows contributes
//   part_load[t, j] = sum_r load_w[r]  * X_r[j]
//   part_col[t, j]  = sum_r count_w[r] * X_r[j]
// in row order.  Tiles form groups of `per` tiles; each group's tiles are
// summed in order from zero (the carry of JAX's lax.scan) and the groups
// left to right from the first (JAX's _ordered_sum).  K3 passes (ws_u,
// wsum_u, count_u) as (lw, load_w, count_w); K4 and K5 pass (ws, ws, cnt).
//
// What bounds it: the exp rate and the FP32 / shared-memory issue around
// each plan entry (rows x C of them); the bytes are O(rows + C) plus the
// partials, which stay in L2.  The design, per plan entry:
//   * one exp.  A warp per row takes the row max over logits kept in
//     registers (no exp), then computes 2^(l - max) once, writes it into a
//     shared tile x[R][ldx] and sums it; one reciprocal per row gives the
//     coefficients load_w / sum and count_w / sum.  The column phase reads x
//     and does two FMAs per entry into register accumulators (up to four
//     columns a thread, vector loads, four rows unrolled).  For C <= 1024
//     each lane keeps its columns of A and B, scaled by log2(e), in
//     registers for the whole block, so a logit is one FMA and an exp one
//     MUFU.EX2: this departs from the plain version's rounding (its logit is
//     a rounded product, then a rounded sum) by about |w * A| * 2^-24 an
//     entry, relative 2e-6 at BASELINE config 5's largest weights, within
//     the 1e-5 the kernels are held to.  Above 1024 consumers A and B come
//     through L1/L2, the logit is rounded as the plain version rounds it, x
//     takes up to the 227 KB a block may use (R = 3 at C = 16,384, down to
//     R = 1 near C = 57,000) and the accumulators live in the item's row.
//   * the scratch form, where not even one row of x fits shared memory
//     (C above about 57,000): x is kScratchRows rows in a per-block
//     scratch of device memory ([grid][R][ldx], which the wrapper sizes
//     with klba_row_tile_x_floats), written by the row phase and read back
//     with __ldcg in the column phase; the grid is at most one block an SM,
//     so the scratch stays at SMs x R x C floats.  The row count R and the
//     place of x change no sum: each entry is the same exp, and each
//     column's accumulator takes the item's live rows one after the other,
//     in row order, however they are chunked.
//   * no padding rows.  Rows whose weights are both 0 (only the load weight
//     when the pass has no colsum) add exact zeros to non-negative sums, so
//     a block first compacts the live rows of its next 256 in order (a
//     ballot per warp), staging their weights in shared memory, and
//     computes only those; an item with none writes zeros.
//   * a full card.  The grid is as many blocks as fit at once (two an SM at
//     C <= 1024: 128 registers a thread and 69 KB of shared memory); each
//     takes work items from a ticket in order until none is left.  An item
//     is 1/split of a tile (split 4 at tile 1024: 256 rows), so the
//     busy tiles spread evenly over the SMs however many rows are padding.
//   * one launch.  The last item of a tile to finish (a __threadfence and an
//     integer atomic ticket, the tickets zeroed by the host function with
//     cudaMemsetAsync on the same stream) sums the tile's item rows in
//     order, the last tile of a group the group's tile rows, and the last
//     group the groups.  Those reads bypass L1 (__ldcg).  The caller learns
//     whether its block wrote the totals, so that K4 can finish its step in
//     the same launch.
// No float atomics: every sum runs in a fixed order whichever block
// computes it, so two runs give the same bits, which the duals loops need
// (they branch on spread > prev_spread and stop on delta > tol).

#pragma once

#include <cmath>
#include <cstddef>
#include <mutex>
#include <tuple>
#include <vector>

#include <cuda_runtime.h>

namespace klba {

constexpr int kThreads = 256;          // every block of the pass
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 16;          // rows of x a chunk (R) at most
constexpr int kScratchRows = kWarps;   // rows of x a chunk in the scratch form
constexpr int kRegCols = 1024;         // C up to this: A, B and logits in registers
constexpr int kMaxSplit = 8;           // work items a tile at most
constexpr int kSmemLimit = 232448;     // dynamic shared memory a block may use
constexpr int kSmemFixed = kThreads * 12 + 256;  // live rows' weights + flags and scratch

// One pass.  Rows [t * tile, min((t + 1) * tile, rows)) form tile t; tile
// t belongs to group t / per.  part_col, group_load/col and total_load/col
// may be null (part_col null: the load only, count_w not read).  Groups
// beyond the first need group_load (and group_col with part_col).
struct Pass {
  const float* lw;
  const float* load_w;
  const float* count_w;
  const float* A;
  const float* B;
  float* item_load;   // [n_tiles * split, C] item rows (the tile rows when split is 1)
  float* item_col;
  float* part_load;   // [n_tiles, C] tile rows
  float* part_col;
  float* group_load;  // [groups, C]
  float* group_col;
  float* total_load;  // [C]
  float* total_col;
  unsigned* tickets;  // [pass_tickets(n_tiles, groups)], zero at launch
  float* x_scratch;   // the scratch form's x, [grid][kScratchRows][ldx]; else null
  long long rows;
  int tile, split, per, groups, n_tiles, C;
};

// Columns a lane holds in registers (a power of two), 0 above kRegCols.
__host__ __device__ inline int reg_cols(int C) {
  if (C > kRegCols) return 0;
  int kw = 1;
  while (32 * kw < C) kw <<= 1;
  return kw;
}

// Row stride of the shared tile x.
__host__ __device__ inline int row_stride(int C) {
  const int kw = reg_cols(C);
  return kw ? 32 * kw : (C + 31) / 32 * 32;
}

// Rows of x that shared memory holds: kMaxChunk, or as many as fit (0:
// not one).  32-bit arithmetic, as the kernels compute it once a block.
__host__ __device__ inline int shared_rows(int C) {
  const int ldx = row_stride(C);
  if (ldx > kSmemLimit / 4) return 0;
  const int fit = (kSmemLimit - kSmemFixed) / (ldx * 4 + 8);
  return fit < kMaxChunk ? fit : kMaxChunk;
}

// Whether x lives in device scratch: not one row of it fits shared memory.
__host__ __device__ inline bool scratch_form(int C) { return shared_rows(C) < 1; }

// Rows a chunk.
__host__ __device__ inline int chunk_rows(int C) {
  return scratch_form(C) ? kScratchRows : shared_rows(C);
}

inline size_t smem_bytes(int C) {
  const size_t x_row = scratch_form(C) ? 0 : static_cast<size_t>(row_stride(C)) * 4;
  return static_cast<size_t>(chunk_rows(C)) * (x_row + 8) + kSmemFixed;
}

// The KW of the scratch form's kernel instantiation.
constexpr int kScratchKW = -1;

// Index of the kernel instantiation for C in a table built with
// KLBA_PASS_TABLE: KW = 0, 1, 2, 4, 8, 16, 32, then the scratch form's.
inline int kw_index(int C) {
  if (scratch_form(C)) return 7;
  const int kw = reg_cols(C);
  int i = 0;
  while (kw >> i) ++i;
  return i;
}

#define KLBA_PASS_TABLE(kernel)                                                      \
  {                                                                                 \
    kernel<0>, kernel<1>, kernel<2>, kernel<4>, kernel<8>, kernel<16>, kernel<32>, \
        kernel<klba::kScratchKW>                                                    \
  }

__device__ __forceinline__ float logit(float w, float a, float b) {
  // -w * a + b with each operation rounded on its own (no fused
  // multiply-add), as the plain PyTorch version computes it.
  return __fadd_rn(__fmul_rn(-w, a), b);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory of a block of `Threads` threads: x [R][ldx], coef float2
// [R], the live rows' weights (lw, load_w, count_w) float [Threads] each,
// then 64 words: warp counts (0 to Threads / 32 - 1), the last-block flag
// (9) and the work item (10) of the pass (whose blocks have 8 warps) and,
// from word 16, 33 floats of reduction scratch.
struct Smem {
  float* x;
  float2* coef;
  float *live_w, *live_load, *live_count;
  int* misc;
  float* scratch;
};

template <int Threads = kThreads>
__device__ __forceinline__ Smem smem_layout(int R, int ldx) {
  extern __shared__ float4 smem_raw[];
  Smem s;
  s.x = reinterpret_cast<float*>(smem_raw);
  s.coef = reinterpret_cast<float2*>(s.x + static_cast<size_t>(R) * ldx);
  s.live_w = reinterpret_cast<float*>(s.coef + R);
  s.live_load = s.live_w + Threads;
  s.live_count = s.live_load + Threads;
  s.misc = reinterpret_cast<int*>(s.live_count + Threads);
  s.scratch = reinterpret_cast<float*>(s.misc + 16);
  return s;
}

// The shared-memory layout of a pass block (no x in the scratch form, whose
// x lives in device scratch: row_tile_pass points s.x there).  Every
// pointer derives from the shared base, so the compiler keeps shared-memory
// accesses for them.
__device__ __forceinline__ Smem pass_smem(const Pass& p) {
  return smem_layout(chunk_rows(p.C), scratch_form(p.C) ? 0 : row_stride(p.C));
}

// Writes, in order, the weights of the live rows of [r0, r1) (r1 - r0 <=
// Threads, the block's size) to live_w / live_load / live_count; returns
// their count.  The row phase then reads them from shared memory.
template <int Threads = kThreads>
__device__ __forceinline__ int compact_rows(const Pass& p, long long r0, long long r1,
                                            const Smem& s) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const long long i = r0 + t;
  const bool on = i < r1 && (p.load_w[i] != 0.f || (p.part_col && p.count_w[i] != 0.f));
  const unsigned mask = __ballot_sync(0xffffffffu, on);
  if (lane == 0) s.misc[warp] = __popc(mask);
  __syncthreads();
  int base = 0, total = 0;
  for (int w = 0; w < Threads / 32; ++w) {
    const int n = s.misc[w];
    base += w < warp ? n : 0;
    total += n;
  }
  if (on) {
    const int at = base + __popc(mask & ((1u << lane) - 1u));
    s.live_w[at] = p.lw[i];
    s.live_load[at] = p.load_w[i];
    s.live_count[at] = p.part_col ? p.count_w[i] : 0.f;
  }
  __syncthreads();
  return total;
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x, one MUFU.EX2 (flushes subnormal results to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The row's max over the warp: redux.sync on the floats' order-preserving
// integer keys, one instruction instead of a shuffle butterfly; exact.
__device__ __forceinline__ float warp_max_redux(float v) {
  const int bits = __float_as_int(v);
  int key = bits >= 0 ? bits : bits ^ 0x7fffffff;
  key = __reduce_max_sync(0xffffffffu, key);
  return __int_as_float(key >= 0 ? key : key ^ 0x7fffffff);
}

// A live row's weights.
struct RowW {
  float w, load, count;
};

// The row's coefficients from its sum of exps: one reciprocal.
__device__ __forceinline__ void row_coef(const RowW& rw, float sum, float2* c) {
  const float inv = __frcp_rn(sum);
  *c = make_float2(__fmul_rn(rw.load, inv), __fmul_rn(rw.count, inv));
}

// A row with the lane's A and B (times log2 e) in registers: the exps into
// xr[0, 32 * KW).  Pad columns hold a = 0, b = -inf, so their logit is
// -inf and their exp 0.
// The lane's max and sum run as four chains, then (in that order) across
// the warp.
template <int KW>
__device__ __forceinline__ void row_exps_reg(const RowW& rw, const float (&a)[KW],
                                             const float (&b)[KW], float* xr, float2* c) {
  const int lane = threadIdx.x & 31;
  float m4[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  float l[KW];
#pragma unroll
  for (int k = 0; k < KW; ++k) {
    l[k] = fmaf(-rw.w, a[k], b[k]);
    m4[k & 3] = fmaxf(m4[k & 3], l[k]);
  }
  const float m = warp_max_redux(fmaxf(fmaxf(m4[0], m4[1]), fmaxf(m4[2], m4[3])));
  float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < KW; ++k) {
    const float e = exp2_approx(l[k] - m);
    xr[lane + 32 * k] = e;
    s4[k & 3] += e;
  }
  const float s = warp_sum((s4[0] + s4[1]) + (s4[2] + s4[3]));
  if (lane == 0) row_coef(rw, s, c);
}

// A row for any C: A and B through L1/L2, the logit computed twice (max,
// then exp), the exp once.
__device__ __forceinline__ void row_exps_any(const Pass& p, const RowW& rw, float* xr,
                                             float2* c) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
  for (int j = lane; j < p.C; j += 32)
    m = fmaxf(m, logit(rw.w, __ldg(p.A + j), __ldg(p.B + j)));
  m = warp_max_redux(m);
  float s = 0.f;
  for (int j = lane; j < p.C; j += 32) {
    const float e = __expf(logit(rw.w, __ldg(p.A + j), __ldg(p.B + j)) - m);
    xr[j] = e;
    s += e;
  }
  s = warp_sum(s);
  if (lane == 0) row_coef(rw, s, c);
}

// kCg: x lives in device scratch; read it past L1 (__ldcg).
template <int N, bool kCg = false>
__device__ __forceinline__ void load_cols(const float* src, float (&v)[N]) {
  if constexpr (kCg) {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = __ldcg(src + k);
  } else if constexpr (N == 4) {
    const float4 q = *reinterpret_cast<const float4*>(src);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (N == 2) {
    const float2 q = *reinterpret_cast<const float2*>(src);
    v[0] = q.x, v[1] = q.y;
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = src[k];
  }
}

// The column phase over n rows of a chunk (x, coef): the thread's CPT
// columns from col0 (kCg: x in device scratch).
template <int CPT, bool kCg = false>
__device__ __forceinline__ void columns(const float* x, const float2* coef, int n, int ldx,
                                        int col0, bool col, float (&al)[CPT],
                                        float (&ac)[CPT]) {
  float v[CPT];
  if (col) {
#pragma unroll 4
    for (int r = 0; r < n; ++r) {
      const float2 c = coef[r];
      load_cols<CPT, kCg>(x + static_cast<size_t>(r) * ldx + col0, v);
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        al[k] = fmaf(c.x, v[k], al[k]);
        ac[k] = fmaf(c.y, v[k], ac[k]);
      }
    }
  } else {
#pragma unroll 4
    for (int r = 0; r < n; ++r) {
      const float cl = coef[r].x;
      load_cols<CPT, kCg>(x + static_cast<size_t>(r) * ldx + col0, v);
#pragma unroll
      for (int k = 0; k < CPT; ++k) al[k] = fmaf(cl, v[k], al[k]);
    }
  }
}

// Work item u: part u % split of tile u / split, a contiguous share of the
// tile's rows, summed in row order into item row u (for KW > 0 from
// register accumulators; for KW = 0 in place).  a, b hold the lane's
// columns of A and B (KW > 0).
template <int KW, int CPT, bool kScratch>
__device__ __forceinline__ void item_rows(const Pass& p, const Smem& s, int R, int ldx, int u,
                                          const float (&a)[KW > 0 ? KW : 1],
                                          const float (&b)[KW > 0 ? KW : 1]) {
  const int t = threadIdx.x, warp = t >> 5;
  const bool col = p.part_col != nullptr;
  const int tile = u / p.split, part = u % p.split;
  const long long t0 = static_cast<long long>(tile) * p.tile;
  const long long t1 = t0 + p.tile < p.rows ? t0 + p.tile : p.rows;
  const long long sub = (p.tile + p.split - 1) / p.split;
  const long long r_begin = t0 + part * sub < t1 ? t0 + part * sub : t1;
  const long long r_end = r_begin + sub < t1 ? r_begin + sub : t1;
  float* row_l = p.item_load + static_cast<size_t>(u) * p.C;
  float* row_c = col ? p.item_col + static_cast<size_t>(u) * p.C : nullptr;

  float al[CPT], ac[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) al[k] = ac[k] = 0.f;
  if constexpr (KW == 0) {
    for (int j = t; j < p.C; j += kThreads) {
      row_l[j] = 0.f;
      if (col) row_c[j] = 0.f;
    }
  }
  for (long long w0 = r_begin; w0 < r_end; w0 += kThreads) {
    const long long w1 = w0 + kThreads < r_end ? w0 + kThreads : r_end;
    const int n_live = compact_rows(p, w0, w1, s);
    for (int c0 = 0; c0 < n_live; c0 += R) {
      const int n = n_live - c0 < R ? n_live - c0 : R;
      for (int r = warp; r < n; r += kWarps) {
        const RowW rw = {s.live_w[c0 + r], s.live_load[c0 + r], s.live_count[c0 + r]};
        if constexpr (KW > 0)
          row_exps_reg<KW>(rw, a, b, s.x + static_cast<size_t>(r) * ldx, s.coef + r);
        else
          row_exps_any(p, rw, s.x + static_cast<size_t>(r) * ldx, s.coef + r);
      }
      __syncthreads();
      if constexpr (KW > 0) {
        if (t * CPT < ldx) columns<CPT>(s.x, s.coef, n, ldx, t * CPT, col, al, ac);
      } else {
        for (int j = t; j < p.C; j += kThreads) {
          float l1[1] = {row_l[j]}, c1[1] = {col ? row_c[j] : 0.f};
          columns<1, kScratch>(s.x, s.coef, n, ldx, j, col, l1, c1);
          row_l[j] = l1[0];
          if (col) row_c[j] = c1[0];
        }
      }
      __syncthreads();
    }
  }
  if constexpr (KW > 0) {
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int j = t * CPT + k;
      if (j < p.C) {
        row_l[j] = al[k];
        if (col) row_c[j] = ac[k];
      }
    }
  }
}

// True in the one thread block that is the last of `count` to arrive at
// ticket `*ticket`; that block then sees every block's writes made before
// its arrival.
__device__ __forceinline__ bool last_to_arrive(unsigned* ticket, unsigned count, const Smem& s) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s.misc[9] = atomicAdd(ticket, 1u) == count - 1u;
  __syncthreads();
  const bool last = s.misc[9] != 0;
  if (last) __threadfence();
  return last;
}

// The ordered sums after item u: the tile's items (when the last of them),
// the group's tiles (when the last tile of the group), the groups (when
// the last group).  True when this block wrote the totals.
__device__ __forceinline__ bool finish_item(const Pass& p, const Smem& s, int u) {
  const bool col = p.part_col != nullptr;
  const int tile = u / p.split;
  if (p.split > 1) {
    if (!last_to_arrive(p.tickets + tile, static_cast<unsigned>(p.split), s)) return false;
    for (int j = threadIdx.x; j < p.C; j += kThreads) {
      float sl = 0.f, sc = 0.f;
      for (int q = 0; q < p.split; ++q) {
        const size_t at = static_cast<size_t>(tile * p.split + q) * p.C + j;
        sl += __ldcg(p.item_load + at);
        if (col) sc += __ldcg(p.item_col + at);
      }
      p.part_load[static_cast<size_t>(tile) * p.C + j] = sl;
      if (col) p.part_col[static_cast<size_t>(tile) * p.C + j] = sc;
    }
  }
  const int g = tile / p.per;
  const int tiles_g = p.n_tiles - g * p.per < p.per ? p.n_tiles - g * p.per : p.per;
  unsigned* group_tickets = p.tickets + p.n_tiles;
  if (!last_to_arrive(group_tickets + g, static_cast<unsigned>(tiles_g), s)) return false;
  const bool one = p.groups == 1;
  for (int j = threadIdx.x; j < p.C; j += kThreads) {
    float sl = 0.f, sc = 0.f;
    for (int q = 0; q < tiles_g; ++q) {
      const size_t at = static_cast<size_t>(g * p.per + q) * p.C + j;
      sl += __ldcg(p.part_load + at);
      if (col) sc += __ldcg(p.part_col + at);
    }
    const size_t at = static_cast<size_t>(g) * p.C + j;
    if (p.group_load) p.group_load[at] = sl;
    if (col && p.group_col) p.group_col[at] = sc;
    if (one && p.total_load) p.total_load[j] = sl;
    if (one && col && p.total_col) p.total_col[j] = sc;
  }
  if (!p.total_load) return false;
  if (!one) {
    if (!last_to_arrive(group_tickets + p.groups, static_cast<unsigned>(p.groups), s))
      return false;
    for (int j = threadIdx.x; j < p.C; j += kThreads) {
      float sl = 0.f, sc = 0.f;
      for (int q = 0; q < p.groups; ++q) {
        const size_t at = static_cast<size_t>(q) * p.C + j;
        const float vl = __ldcg(p.group_load + at);
        sl = q ? sl + vl : vl;
        if (col) {
          const float vc = __ldcg(p.group_col + at);
          sc = q ? sc + vc : vc;
        }
      }
      p.total_load[j] = sl;
      if (col && p.total_col) p.total_col[j] = sc;
    }
  }
  __syncthreads();
  return true;
}

// The whole pass in one form (kScratch: x in the block's rows of the device
// scratch, KW = 0 only): each block takes work items in order from the
// queue ticket until none is left.  The form is fixed a kernel
// instantiation, so that each addresses x in one memory space (a pointer
// that may be either is a generic one: that slowed the shared form by
// 20-70 %) and keeps its own registers.
template <int KW, bool kScratch>
__device__ bool row_tile_pass_in(const Pass& p) {
  static_assert(KW == 0 || !kScratch, "the scratch form has no register columns");
  const int ldx = row_stride(p.C);
  const int R = kScratch ? kScratchRows : shared_rows(p.C);
  Smem s = smem_layout(R, kScratch ? 0 : ldx);
  if constexpr (kScratch) s.x = p.x_scratch + static_cast<size_t>(blockIdx.x) * R * ldx;
  constexpr int CPT = KW >= 8 ? KW / 8 : 1;  // columns a thread in the column phase
  float a[KW > 0 ? KW : 1], b[KW > 0 ? KW : 1];
  if constexpr (KW > 0) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      const int j = lane + 32 * k;
      a[k] = j < p.C ? __fmul_rn(p.A[j], kLog2e) : 0.f;
      b[k] = j < p.C ? __fmul_rn(p.B[j], kLog2e) : -INFINITY;
    }
  }
  unsigned* queue = p.tickets + p.n_tiles + p.groups + 1;
  const int n_items = p.n_tiles * p.split;
  bool wrote_totals = false;
  for (;;) {
    if (threadIdx.x == 0) s.misc[10] = static_cast<int>(atomicAdd(queue, 1u));
    __syncthreads();
    const int u = s.misc[10];
    if (u >= n_items) break;
    item_rows<KW, CPT, kScratch>(p, s, R, ldx, u, a, b);
    wrote_totals |= finish_item(p, s, u);
  }
  return wrote_totals;
}

// The whole pass of the instantiation KW (kScratchKW: the scratch form,
// taken where not one row of x fits shared memory; kw_index picks).
// Returns true in the one block that wrote total_load / total_col (after a
// __syncthreads, so the block may read them); false in every other block
// and when the pass has no totals.
template <int KW>
__device__ bool row_tile_pass(const Pass& p) {
  if constexpr (KW == kScratchKW) {
    return row_tile_pass_in<0, true>(p);
  } else {
    return row_tile_pass_in<KW, false>(p);
  }
}

// Tickets a pass needs: one a tile, one a group, the last group's and the
// work queue.
inline int pass_tickets(int n_tiles, int groups) { return n_tiles + groups + 2; }

// Blocks of `kernel` that fit on the current card at once with `smem`
// bytes of dynamic shared memory.  The KW = 0 instantiation's smem grows
// with C, so the first call for a kernel and card lets it take kSmemLimit,
// the most any C needs; the occupancy is found once for each kernel, card
// and smem (the queries cost microseconds of host time), then kept.
template <typename... Params>
inline cudaError_t resident_blocks(void (*kernel)(Params...), size_t smem, int* blocks) {
  static std::mutex mu;
  static std::vector<std::tuple<void (*)(Params...), int, size_t, int>> known;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  bool seen = false;
  for (const auto& [k, d, b, n] : known) {
    if (k != kernel || d != device) continue;
    if (b == smem) return *blocks = n, cudaSuccess;
    seen = true;
  }
  if (!seen && (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kSmemLimit)) != cudaSuccess)
    return err;
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  known.emplace_back(kernel, device, smem, per_sm * sms);
  *blocks = per_sm * sms;
  return cudaSuccess;
}

// The current card's SM count.
inline cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

// Floats of the scratch form's x at C consumers on the current card (one
// block an SM, kScratchRows rows of ldx floats each); 0 in the shared form.
inline cudaError_t x_scratch_floats(int C, long long* floats) {
  *floats = 0;
  if (!scratch_form(C)) return cudaSuccess;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  *floats = static_cast<long long>(sms) * kScratchRows * row_stride(C);
  return cudaSuccess;
}

// Launches `kernel` (an instantiation picked with kw_index) on `stream`:
// as many blocks as fit on the card at once, at most one a work item.  The
// caller has zeroed the tickets on the same stream.  Returns the launch's
// error.
template <typename... Params, typename... Args>
inline cudaError_t launch_pass(void (*kernel)(Params...), const Pass& p, cudaStream_t stream,
                               Args... args) {
  const size_t smem = smem_bytes(p.C);
  int fit = 0;
  cudaError_t err = resident_blocks(kernel, smem, &fit);
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>(p.n_tiles) * p.split;
  if (scratch_form(p.C)) {
    // One block an SM at most: the scratch holds that many blocks' x.
    int sms = 0;
    if ((err = sm_count(&sms)) != cudaSuccess) return err;
    if (p.x_scratch == nullptr) return cudaErrorInvalidValue;
    fit = fit < sms ? fit : sms;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(items < fit ? items : fit));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, kernel, p, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// A tile's split: work items of at least 256 rows (4 at tile 1024, the
// fastest of 1, 2, 4 and 8 at BASELINE config 5), at most kMaxSplit.
inline int auto_split(int tile) {
  int s = 1;
  while (s < kMaxSplit && tile / (2 * s) >= 256) s <<= 1;
  return s;
}

}  // namespace klba

extern "C" const char* klba_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory a pass block takes at C consumers (bytes).
extern "C" long long klba_row_tile_smem_bytes(int C) {
  return static_cast<long long>(klba::smem_bytes(C));
}

// Floats of device scratch the pass's x takes at C consumers on the
// current card: 0 where x fits shared memory, -1 on a CUDA error.
extern "C" long long klba_row_tile_x_floats(int C) {
  long long floats = 0;
  return klba::x_scratch_floats(C, &floats) == cudaSuccess ? floats : -1;
}
