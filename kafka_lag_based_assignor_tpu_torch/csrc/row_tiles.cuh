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
// What bounds it: the exp rate (16 MUFU.EX2 results a clock an SM, 4.18 T/s
// on the H100) and the FP32 issue around each plan entry (rows x C of
// them); the bytes are O(rows + C) plus the partials, which stay in L2.
// Two forms, picked from C alone:
//
// * the register forms (C <= kRegCols = 1024; KW = 1 ... 32 columns a
//   lane): one exp an entry.  Each lane keeps its columns of A and B,
//   scaled by log2(e), in registers for the whole block, so a logit is one
//   FMA and an exp one MUFU.EX2 (this departs from the plain version's
//   rounding, a rounded product then a rounded sum, by about |w * A| *
//   2^-24 an entry: relative 2e-6 at BASELINE config 5's largest weights,
//   within the 1e-5 the kernels are held to).  A warp per row takes the row
//   max over its logits, computes 2^(l - max) once into a shared tile
//   x[16][ldx] and sums it; one reciprocal per row gives the coefficients
//   load_w / sum and count_w / sum.  The column phase reads x and does two
//   FMAs per entry into register accumulators (up to four columns a
//   thread, vector loads, four rows unrolled).
// * the column form (C > kRegCols).  There A and B no longer fit a warp's
//   registers, a thread's share of the columns' accumulators no longer
//   fits its registers, and a plan row is 4C bytes, so shared memory holds
//   only a few (two at 20,000 consumers): a block that kept whole plan
//   rows would leave most of its warps waiting on the few computing them.
//   Instead the consumers are cut into column tiles of kColTile, and the
//   pass is two launches, each over (rows, column tile) units that fill
//   the card several blocks an SM:
//     - the row statistics (row_stats_pass): a lane a row, 256 rows a
//       block, the tile's A and B staged in shared memory (one broadcast
//       load a column pair).  A lane takes its row's max over the tile and
//       its sum of 2^((l - max) log2 e), 16 columns at a time, rescaling
//       the sum when the max rises.  The last tile of a row block to
//       arrive merges each row's tile partials in tile order (the largest
//       max, each sum rescaled to it) and writes the row's (-w, -max log2
//       e, load_w / sum, count_w / sum): 16 bytes a row, no row of the plan.
//     - the columns (col_pass): a thread owns kColCPT consumers of a tile,
//       their A and B in registers.  The item's live rows are compacted in
//       order with their row data in shared memory, and each entry is
//       computed again against its row's max (the logit rounded as the
//       plain version rounds it, one FMA, one MUFU.EX2) and added into the
//       thread's register accumulators, row after row in row order.  The
//       item row's segment is written once, and the ordered sums run per
//       column tile (their tickets per tile and column tile), so each
//       block sums only the columns it owns.
//   That costs two exps an entry, one in each launch (the bound is twice
//   the register forms' at the same shape), against a plan tile in shared
//   memory or device scratch at any C.  Every warp of a block has rows or
//   columns of its own in both launches; no barrier holds warps idle while
//   a few finish their rows.  At 200,000 rows by 20,000 consumers on the
//   H100 the statistics run at about two thirds of the exp rate and the
//   columns at about half (PERF.md).
// Both forms:
//   * no padding rows.  Rows whose weights are both 0 (only the load weight
//     when the pass has no colsum) add exact zeros to non-negative sums, so
//     a block first compacts the live rows of its next 256 in order (a
//     ballot per warp) and computes only those; an item with none writes
//     zeros.
//   * a full card.  The grid is as many blocks as fit at once (register
//     forms: two an SM, 128 registers a thread and 69 KB of shared memory;
//     column form: four an SM); a register-form block takes work items from
//     a ticket in order, a column-form block every grid-th unit.  An item is
//     1/split of a tile (split 4 at tile 1024: 256 rows), so the busy tiles
//     spread evenly over the SMs however many rows are padding.
//   * the ordered sums in the same launch.  The last item of a tile to
//     finish (a __threadfence and an integer atomic ticket, the tickets
//     zeroed on the same stream before the launch) sums the tile's item
//     rows in order, the last tile of a group the group's tile rows, and the
//     last group the groups.  Those reads bypass L1 (__ldcg).  The caller
//     learns whether its block wrote the totals (in the column form: the
//     last of the column tiles' totals), so that K4 can finish its step in
//     the same launch.
// No float atomics: every sum runs in a fixed order whichever block
// computes it, so two runs give the same bits, which the duals loops need
// (they branch on spread > prev_spread and stop on delta > tol).

#pragma once

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <mutex>
#include <tuple>
#include <vector>

#include <cuda_runtime.h>

namespace klba {

constexpr int kThreads = 256;          // every block of the pass
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 16;          // rows of x a chunk (R) at most
constexpr int kRegCols = 1024;         // C up to this: A, B and logits in registers
constexpr int kMaxSplit = 8;           // work items a tile at most
constexpr int kSmemLimit = 232448;     // dynamic shared memory a block may use
constexpr int kSmemFixed = kThreads * 12 + 256;  // live rows' weights + flags and scratch
constexpr int kColTile = 1024;         // consumers a column tile (C > kRegCols)
constexpr int kColCPT = kColTile / kThreads;  // consumers a thread of the column launch
constexpr int kStatsChunk = 16;        // columns a lane takes between rescales of its sum
constexpr int kColBlocks = 4;          // column-form blocks an SM (the launch bounds)

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
  unsigned* tickets;  // [pass_tickets or col_pass_tickets], zero at launch
  float4* row_data;   // column form: [rows] (-w, -max log2 e, load_w / sum, count_w / sum)
  float2* row_part;   // column form: [col_tiles][rows] (max log2 e, sum) of each tile
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

// Column tiles of the column form at C consumers; 0: a register form.
__host__ __device__ inline int col_tiles(int C) {
  return C > kRegCols ? (C + kColTile - 1) / kColTile : 0;
}

// Row stride of the shared tile x.  The register forms' kernels compute
// it, and shared_rows, once a block from C as written here, 32-bit
// arithmetic and branches included: their code, and so their times, hang
// on these expressions.
__host__ __device__ inline int row_stride(int C) {
  const int kw = reg_cols(C);
  return kw ? 32 * kw : (C + 31) / 32 * 32;
}

// Rows of x that shared memory holds: kMaxChunk, or as many as fit (0:
// not one).
__host__ __device__ inline int shared_rows(int C) {
  const int ldx = row_stride(C);
  if (ldx > kSmemLimit / 4) return 0;
  const int fit = (kSmemLimit - kSmemFixed) / (ldx * 4 + 8);
  return fit < kMaxChunk ? fit : kMaxChunk;
}

// Dynamic shared memory of a register-form block (0 in the column form,
// whose kernels use static shared memory only).
inline size_t smem_bytes(int C) {
  if (col_tiles(C)) return 0;
  return static_cast<size_t>(shared_rows(C)) * (static_cast<size_t>(row_stride(C)) * 4 + 8) +
         kSmemFixed;
}

// Index of the register-form kernel instantiation for C in a table built
// with KLBA_PASS_TABLE: KW = 1, 2, 4, 8, 16, 32.
inline int kw_index(int C) {
  const int kw = reg_cols(C);
  int i = 0;
  while (kw >> (i + 1)) ++i;
  return i;
}

#define KLBA_PASS_TABLE(kernel) \
  { kernel<1>, kernel<2>, kernel<4>, kernel<8>, kernel<16>, kernel<32> }

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

// The shared-memory layout of a register-form pass block.  Every pointer
// derives from the shared base, so the compiler keeps shared-memory
// accesses for them.
__device__ __forceinline__ Smem pass_smem(const Pass& p) {
  return smem_layout(shared_rows(p.C), row_stride(p.C));
}

// Whether row i (< rows) adds to the pass: a load weight, or a count
// weight when the pass has a colsum.
__device__ __forceinline__ bool live_row(const Pass& p, long long i) {
  return p.load_w[i] != 0.f || (p.part_col && p.count_w[i] != 0.f);
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

template <int N>
__device__ __forceinline__ void load_cols(const float* src, float (&v)[N]) {
  if constexpr (N == 4) {
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
// columns from col0.
template <int CPT>
__device__ __forceinline__ void columns(const float* x, const float2* coef, int n, int ldx,
                                        int col0, bool col, float (&al)[CPT],
                                        float (&ac)[CPT]) {
  float v[CPT];
  if (col) {
#pragma unroll 4
    for (int r = 0; r < n; ++r) {
      const float2 c = coef[r];
      load_cols<CPT>(x + static_cast<size_t>(r) * ldx + col0, v);
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
      load_cols<CPT>(x + static_cast<size_t>(r) * ldx + col0, v);
#pragma unroll
      for (int k = 0; k < CPT; ++k) al[k] = fmaf(cl, v[k], al[k]);
    }
  }
}

// Work item u of a register form, summed in row order into item row u from
// register accumulators.  a, b hold the lane's columns of A and B.
template <int KW, int CPT>
__device__ __forceinline__ void item_rows(const Pass& p, const Smem& s, int R, int ldx, int u,
                                          const float (&a)[KW], const float (&b)[KW]) {
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
  for (long long w0 = r_begin; w0 < r_end; w0 += kThreads) {
    const long long w1 = w0 + kThreads < r_end ? w0 + kThreads : r_end;
    const int n_live = compact_rows(p, w0, w1, s);
    for (int c0 = 0; c0 < n_live; c0 += R) {
      const int n = n_live - c0 < R ? n_live - c0 : R;
      for (int r = warp; r < n; r += kWarps) {
        const RowW rw = {s.live_w[c0 + r], s.live_load[c0 + r], s.live_count[c0 + r]};
        row_exps_reg<KW>(rw, a, b, s.x + static_cast<size_t>(r) * ldx, s.coef + r);
      }
      __syncthreads();
      if (t * CPT < ldx) columns<CPT>(s.x, s.coef, n, ldx, t * CPT, col, al, ac);
      __syncthreads();
    }
  }
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int j = t * CPT + k;
    if (j < p.C) {
      row_l[j] = al[k];
      if (col) row_c[j] = ac[k];
    }
  }
}

// True in the one thread block that is the last of `count` to arrive at
// ticket `*ticket`; that block then sees every block's writes made before
// its arrival.  `flag` is a word of the block's shared memory.
__device__ __forceinline__ bool last_to_arrive(unsigned* ticket, unsigned count, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(ticket, 1u) == count - 1u;
  __syncthreads();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

__device__ __forceinline__ bool last_to_arrive(unsigned* ticket, unsigned count, const Smem& s) {
  return last_to_arrive(ticket, count, s.misc + 9);
}

// The ordered sums after item u of a register form: the tile's items
// (when the last of them), the group's tiles (when the last tile of the
// group), the groups (when the last group).  True when this block wrote the
// totals.  finish_cols does the same a column tile at a time.  They stay
// two functions: one for both, with this one's tile and columns as
// constants, changed how the register forms' row phase compiles (their
// SASS), and those kernels keep the code of their hot loops.
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

// finish_item for the column form: the ordered sums of columns [c0, c1),
// column tile ct of n_ct, after item u.  The tickets: [n_tiles][n_ct]
// tiles, then [groups][n_ct] groups, then [n_ct] the last group's.  True
// when this block wrote the totals of its columns.
__device__ __forceinline__ bool finish_cols(const Pass& p, int* flag, int u, int ct, int n_ct,
                                            int c0, int c1) {
  const bool col = p.part_col != nullptr;
  const int tile = u / p.split;
  if (p.split > 1) {
    if (!last_to_arrive(p.tickets + static_cast<long long>(tile) * n_ct + ct,
                        static_cast<unsigned>(p.split), flag))
      return false;
    for (int j = c0 + threadIdx.x; j < c1; j += kThreads) {
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
  unsigned* group_tickets = p.tickets + static_cast<long long>(p.n_tiles) * n_ct;
  if (!last_to_arrive(group_tickets + static_cast<long long>(g) * n_ct + ct,
                      static_cast<unsigned>(tiles_g), flag))
    return false;
  const bool one = p.groups == 1;
  for (int j = c0 + threadIdx.x; j < c1; j += kThreads) {
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
    if (!last_to_arrive(group_tickets + static_cast<long long>(p.groups) * n_ct + ct,
                        static_cast<unsigned>(p.groups), flag))
      return false;
    for (int j = c0 + threadIdx.x; j < c1; j += kThreads) {
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

// The whole pass of register-form instantiation KW: each block takes work
// items in order from the queue ticket until none is left.  Returns true
// in the one block that wrote total_load / total_col (after a
// __syncthreads, so the block may read them); false in every other block
// and when the pass has no totals.
template <int KW>
__device__ bool row_tile_pass(const Pass& p) {
  const int ldx = row_stride(p.C);
  const int R = shared_rows(p.C);
  const Smem s = smem_layout(R, ldx);
  constexpr int CPT = KW >= 8 ? KW / 8 : 1;  // columns a thread in the column phase
  float a[KW], b[KW];
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < KW; ++k) {
    const int j = lane + 32 * k;
    a[k] = j < p.C ? __fmul_rn(p.A[j], kLog2e) : 0.f;
    b[k] = j < p.C ? __fmul_rn(p.B[j], kLog2e) : -INFINITY;
  }
  unsigned* queue = p.tickets + p.n_tiles + p.groups + 1;
  const int n_items = p.n_tiles * p.split;
  bool wrote_totals = false;
  for (;;) {
    if (threadIdx.x == 0) s.misc[10] = static_cast<int>(atomicAdd(queue, 1u));
    __syncthreads();
    const int u = s.misc[10];
    if (u >= n_items) break;
    item_rows<KW, CPT>(p, s, R, ldx, u, a, b);
    wrote_totals |= finish_item(p, s, u);
  }
  return wrote_totals;
}

// Tickets a register-form pass needs: one a tile, one a group, the last
// group's and the work queue.
inline int pass_tickets(int n_tiles, int groups) { return n_tiles + groups + 2; }

// The column form's tickets: finish_cols's ((n_tiles + groups + 1) x
// n_ct), then the ticket of the column tiles' totals (at col_ticket_done),
// then one a row block of the statistics (256 rows).
__host__ __device__ inline long long col_ticket_done(int n_tiles, int groups, int n_ct) {
  return (static_cast<long long>(n_tiles) + groups + 1) * n_ct;
}

__host__ __device__ inline long long row_blocks(long long rows) {
  return (rows + kThreads - 1) / kThreads;
}

inline long long col_pass_tickets(long long rows, int n_tiles, int groups, int C) {
  return col_ticket_done(n_tiles, groups, col_tiles(C)) + 1 + row_blocks(rows);
}

// Floats of the column form's row data and tile statistics: 4 a row, 2 a
// row and column tile, and 4 of slack to align the row data to 16 bytes.
inline long long col_row_floats(long long rows, int C) {
  return 4 + rows * (4 + 2LL * col_tiles(C));
}

// The column form's row data and tile statistics in `floats`
// (col_row_floats of them); returns the first float past them.
inline float* carve_rows(float* floats, Pass* p) {
  const uintptr_t at = (reinterpret_cast<uintptr_t>(floats) + 15) & ~static_cast<uintptr_t>(15);
  p->row_data = reinterpret_cast<float4*>(at);
  p->row_part = reinterpret_cast<float2*>(p->row_data + p->rows);
  return floats + col_row_floats(p->rows, p->C);
}

// The column form's first launch: each live row's statistics over the C
// consumers, from (256-row block, column tile) units, into p.row_data.
__device__ __forceinline__ void row_stats_pass(const Pass& p) {
  __shared__ __align__(16) float2 ab[kColTile];
  __shared__ int flag;
  const int n_ct = col_tiles(p.C);
  const long long units = row_blocks(p.rows) * n_ct;
  unsigned* rb_tickets = p.tickets + col_ticket_done(p.n_tiles, p.groups, n_ct) + 1;
  for (long long unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const long long rb = unit / n_ct;
    const int ct = static_cast<int>(unit - rb * n_ct);
    const int c0 = ct * kColTile, width = p.C - c0 < kColTile ? p.C - c0 : kColTile;
    // Pad columns (0, -inf): their logit is -inf and their exp 0.
    for (int j = threadIdx.x; j < kColTile; j += kThreads)
      ab[j] = j < width ? make_float2(p.A[c0 + j], p.B[c0 + j]) : make_float2(0.f, -INFINITY);
    __syncthreads();
    const long long i = rb * kThreads + threadIdx.x;
    const bool on = i < p.rows && live_row(p, i);
    if (__any_sync(0xffffffffu, on)) {
      const float nw = on ? -p.lw[i] : 0.f;
      float mk = -INFINITY, sum = 0.f;  // the max logit times log2 e; the sum below it
      for (int j0 = 0; j0 < width; j0 += kStatsChunk) {
        float l[kStatsChunk];
#pragma unroll
        for (int k = 0; k < kStatsChunk; k += 2) {
          const float4 q = *reinterpret_cast<const float4*>(ab + j0 + k);
          l[k] = __fadd_rn(__fmul_rn(nw, q.x), q.y);
          l[k + 1] = __fadd_rn(__fmul_rn(nw, q.z), q.w);
        }
        float m8[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) m8[k] = fmaxf(l[k], l[k + 8]);
        const float cm = fmaxf(fmaxf(fmaxf(m8[0], m8[4]), fmaxf(m8[2], m8[6])),
                               fmaxf(fmaxf(m8[1], m8[5]), fmaxf(m8[3], m8[7])));
        const float cmk = __fmul_rn(cm, kLog2e);
        if (cmk > mk) {
          sum = __fmul_rn(sum, exp2_approx(__fsub_rn(mk, cmk)));
          mk = cmk;
        }
        float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < kStatsChunk; ++k) s4[k & 3] += exp2_approx(fmaf(l[k], kLog2e, -mk));
        sum += (s4[0] + s4[1]) + (s4[2] + s4[3]);
      }
      if (on) p.row_part[static_cast<size_t>(ct) * p.rows + i] = make_float2(mk, sum);
    }
    // The last tile of the row block merges its rows' tiles in tile order.
    if (last_to_arrive(rb_tickets + rb, static_cast<unsigned>(n_ct), &flag) && on) {
      const float2* part = p.row_part + i;
      float mk = -INFINITY;
      for (int q = 0; q < n_ct; ++q) mk = fmaxf(mk, __ldcg(part + static_cast<size_t>(q) * p.rows).x);
      float sum = 0.f;
      for (int q = 0; q < n_ct; ++q) {
        const float2 v = __ldcg(part + static_cast<size_t>(q) * p.rows);
        sum = fmaf(v.y, v.x < mk ? exp2_approx(__fsub_rn(v.x, mk)) : 1.f, sum);
      }
      const float inv = __frcp_rn(sum);
      p.row_data[i] = make_float4(-p.lw[i], -mk, __fmul_rn(p.load_w[i], inv),
                                  p.part_col ? __fmul_rn(p.count_w[i], inv) : 0.f);
    }
  }
}

// The rows [r_begin, r_end) of work item u: part u % split of tile u /
// split, a contiguous share of the tile's rows.
__device__ __forceinline__ void item_range(const Pass& p, int u, long long* r_begin,
                                           long long* r_end) {
  const int tile = u / p.split, part = u % p.split;
  const long long t0 = static_cast<long long>(tile) * p.tile;
  const long long t1 = t0 + p.tile < p.rows ? t0 + p.tile : p.rows;
  const long long sub = (p.tile + p.split - 1) / p.split;
  *r_begin = t0 + part * sub < t1 ? t0 + part * sub : t1;
  *r_end = *r_begin + sub < t1 ? *r_begin + sub : t1;
}

// Copies, in order, the row data of the live rows of [r0, r1) (r1 - r0 <=
// kThreads) to rowd; returns their count.
__device__ __forceinline__ int compact_row_data(const Pass& p, long long r0, long long r1,
                                                float4* rowd, int* misc) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const long long i = r0 + t;
  const bool on = i < r1 && live_row(p, i);
  const unsigned mask = __ballot_sync(0xffffffffu, on);
  if (lane == 0) misc[warp] = __popc(mask);
  __syncthreads();
  int base = 0, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int n = misc[w];
    base += w < warp ? n : 0;
    total += n;
  }
  if (on) rowd[base + __popc(mask & ((1u << lane) - 1u))] = p.row_data[i];
  __syncthreads();
  return total;
}

// The column form's second launch: (work item, column tile) units, each
// item's rows in row order into the thread's accumulators, then the
// ordered sums of the tile's columns.  Returns true in the one block that
// completed the last column tile's totals (after which every column's
// total is written and visible to it); false elsewhere and when the pass
// has no totals.
__device__ __forceinline__ bool col_pass(const Pass& p) {
  __shared__ __align__(16) float4 rowd[kThreads];
  __shared__ int misc[16];
  const int n_ct = col_tiles(p.C);
  const bool col = p.part_col != nullptr;
  const long long units = static_cast<long long>(p.n_tiles) * p.split * n_ct;
  bool wrote_all = false;
  for (long long unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int u = static_cast<int>(unit / n_ct);
    const int ct = static_cast<int>(unit - static_cast<long long>(u) * n_ct);
    const int c0 = ct * kColTile, c1 = p.C - c0 < kColTile ? p.C : c0 + kColTile;
    const int j0 = c0 + threadIdx.x * kColCPT;
    float a[kColCPT], b[kColCPT], al[kColCPT], ac[kColCPT];
#pragma unroll
    for (int k = 0; k < kColCPT; ++k) {
      const int j = j0 + k;
      a[k] = j < c1 ? p.A[j] : 0.f;
      b[k] = j < c1 ? p.B[j] : -INFINITY;
      al[k] = ac[k] = 0.f;
    }
    long long r_begin, r_end;
    item_range(p, u, &r_begin, &r_end);
    for (long long w0 = r_begin; w0 < r_end; w0 += kThreads) {
      const long long w1 = w0 + kThreads < r_end ? w0 + kThreads : r_end;
      const int n = compact_row_data(p, w0, w1, rowd, misc);
      if (j0 < c1) {
        // rowd[r] = (-w, -max log2 e, load_w / sum, count_w / sum).
        if (col) {
#pragma unroll 4
          for (int r = 0; r < n; ++r) {
            const float4 q = rowd[r];
#pragma unroll
            for (int k = 0; k < kColCPT; ++k) {
              const float e =
                  exp2_approx(fmaf(__fadd_rn(__fmul_rn(q.x, a[k]), b[k]), kLog2e, q.y));
              al[k] = fmaf(q.z, e, al[k]);
              ac[k] = fmaf(q.w, e, ac[k]);
            }
          }
        } else {
#pragma unroll 4
          for (int r = 0; r < n; ++r) {
            const float4 q = rowd[r];
#pragma unroll
            for (int k = 0; k < kColCPT; ++k)
              al[k] = fmaf(q.z,
                           exp2_approx(fmaf(__fadd_rn(__fmul_rn(q.x, a[k]), b[k]), kLog2e, q.y)),
                           al[k]);
          }
        }
      }
      __syncthreads();
    }
    float* row_l = p.item_load + static_cast<size_t>(u) * p.C;
#pragma unroll
    for (int k = 0; k < kColCPT; ++k) {
      const int j = j0 + k;
      if (j < c1) {
        row_l[j] = al[k];
        if (col) p.item_col[static_cast<size_t>(u) * p.C + j] = ac[k];
      }
    }
    if (finish_cols(p, misc + 9, u, ct, n_ct, c0, c1) &&
        last_to_arrive(p.tickets + col_ticket_done(p.n_tiles, p.groups, n_ct),
                       static_cast<unsigned>(n_ct), misc + 9))
      wrote_all = true;
  }
  return wrote_all;
}

// Blocks of `kernel` that fit on the current card at once with `smem`
// bytes of dynamic shared memory.  A register-form kernel's smem grows with
// C, so the first call for such a kernel and card lets it take kSmemLimit,
// the most any C needs (`grow`; the column form's kernels use static
// shared memory only); the occupancy is found once for each kernel, card
// and smem (the queries cost microseconds of host time), then kept.
template <typename... Params>
inline cudaError_t resident_blocks(void (*kernel)(Params...), size_t smem, int* blocks,
                                   bool grow = true) {
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
  if (grow && !seen &&
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
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

// Launches `kernel` on `stream` with `smem` bytes of dynamic shared memory:
// as many blocks as fit on the card at once, at most `units`.
template <typename... Params, typename... Args>
inline cudaError_t launch_grid(void (*kernel)(Params...), long long units, size_t smem,
                               bool grow, cudaStream_t stream, Args... args) {
  int fit = 0;
  cudaError_t err = resident_blocks(kernel, smem, &fit, grow);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(units < fit ? units : fit));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Launches the register-form `kernel` (an instantiation picked with
// kw_index) on `stream`.  The caller has zeroed the tickets on the same
// stream.  Returns the launch's error.
template <typename... Params, typename... Args>
inline cudaError_t launch_pass(void (*kernel)(Params...), const Pass& p, cudaStream_t stream,
                               Args... args) {
  return launch_grid(kernel, static_cast<long long>(p.n_tiles) * p.split, smem_bytes(p.C), true,
                     stream, p, args...);
}

// Launches the column form's two kernels on `stream`: `stats` (a
// row_stats_pass) and `cols` (a col_pass, given `args` after the pass).
// The caller has zeroed the tickets on the same stream.
template <typename... Params, typename... Args>
inline cudaError_t launch_col_pass(void (*stats)(Pass), void (*cols)(Params...), const Pass& p,
                                   cudaStream_t stream, Args... args) {
  const int n_ct = col_tiles(p.C);
  if (n_ct < 1 || p.row_data == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = launch_grid(stats, row_blocks(p.rows) * n_ct, 0, false, stream, p);
  if (err != cudaSuccess) return err;
  return launch_grid(cols, static_cast<long long>(p.n_tiles) * p.split * n_ct, 0, false, stream,
                     p, args...);
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

// Dynamic shared memory a pass block takes at C consumers (bytes; 0 in the
// column form, whose kernels use static shared memory only).
extern "C" long long klba_row_tile_smem_bytes(int C) {
  return static_cast<long long>(klba::smem_bytes(C));
}

// Column tiles of the pass at C consumers: 0 in the register forms.
extern "C" int klba_row_tile_col_tiles(int C) { return klba::col_tiles(C); }
