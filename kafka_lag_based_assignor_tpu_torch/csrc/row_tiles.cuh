// The row-tile pass of the implicit transport plan's marginals and the
// ordered sum of its tile partials, for Hopper (sm_90a).  Shared by
// plan_stats.cu (K3: dense Sinkhorn, rows = deduplicated lag values) and
// linear_ot.cu (K5 and K4: linear mode, rows = partitions).
//
// For each row r the plan row is X_r[j] = softmax_j(-lw_r * A_j + B_j) over
// the C consumers, and a tile of rows contributes
//   part_load[t, j] = sum_r load_w[r]  * X_r[j]
//   part_col[t, j]  = sum_r count_w[r] * X_r[j]
// in row order.  K3 passes (ws_u, wsum_u, count_u) as (lw, load_w,
// count_w); K4 and K5 pass (ws, ws, cnt).
//
// tile_partials: one block per tile.  Rows go in chunks of kRowChunk: one
// warp per row reduces the row's max and sum of exps over the C consumers
// with a fixed shuffle butterfly; then one thread per consumer walks the
// chunk's rows in order, recomputes each exp and accumulates both weighted
// sums in registers, carried from chunk to chunk in the tile's partial row.
// combine: one thread per consumer sums the partial rows of each group in
// order from zero (the carry of JAX's lax.scan) and the groups from the
// first (JAX's _ordered_sum).  No atomics: every sum runs in a fixed order,
// so two runs give the same bits, which the duals loops need (they branch
// on spread > prev_spread and stop on delta > tol).
//
// What bounds it: exp throughput.  A pass evaluates each of the rows x C
// exps twice (row statistics, then weights); the bytes are O(rows + C)
// plus the tiles x C partials.

#pragma once

#include <cmath>
#include <cstddef>

#include <cuda_runtime.h>

namespace klba {

constexpr int kMaxConsumers = 16384;
constexpr int kRowChunk = 128;
constexpr int kCombineThreads = 256;

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

// Tile t holds rows [t * tile, min((t + 1) * tile, rows)).  The partials
// are float[n_tiles, ld], ld >= C; columns C..ld-1 are written as zeros.
// part_col may be null (the load only); count_w is then not read.
__global__ void tile_partials(const float* __restrict__ lw,
                              const float* __restrict__ load_w,
                              const float* __restrict__ count_w,
                              const float* __restrict__ A,
                              const float* __restrict__ B,
                              float* __restrict__ part_load,
                              float* __restrict__ part_col, int rows,
                              int tile, int C, int ld) {
  __shared__ float s_w[kRowChunk], s_l[kRowChunk], s_c[kRowChunk];
  __shared__ float s_max[kRowChunk], s_den[kRowChunk];
  const long long row0 = static_cast<long long>(blockIdx.x) * tile;
  const int n_rows = rows - row0 < tile ? static_cast<int>(rows - row0) : tile;
  const size_t out = static_cast<size_t>(blockIdx.x) * ld;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;

  for (int r0 = 0; r0 < n_rows; r0 += kRowChunk) {
    const int n = min(kRowChunk, n_rows - r0);
    for (int r = warp; r < n; r += n_warps) {
      const long long i = row0 + r0 + r;
      const float w = lw[i];
      float m = -INFINITY;
      for (int j = lane; j < C; j += 32) m = fmaxf(m, logit(w, A[j], B[j]));
      m = warp_max(m);
      float s = 0.f;
      for (int j = lane; j < C; j += 32) s += expf(logit(w, A[j], B[j]) - m);
      s = warp_sum(s);
      if (lane == 0) {
        s_w[r] = w;
        s_l[r] = load_w[i];
        s_c[r] = part_col ? count_w[i] : 0.f;
        s_max[r] = m;
        s_den[r] = s;
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < ld; j += blockDim.x) {
      float acc_l = r0 ? part_load[out + j] : 0.f;
      float acc_c = (r0 && part_col) ? part_col[out + j] : 0.f;
      if (j < C) {
        const float a = A[j], b = B[j];
        for (int r = 0; r < n; ++r) {
          const float x = expf(logit(s_w[r], a, b) - s_max[r]) / s_den[r];
          acc_l += s_l[r] * x;
          acc_c += s_c[r] * x;
        }
      }
      part_load[out + j] = acc_l;
      if (part_col) part_col[out + j] = acc_c;
    }
    __syncthreads();
  }
}

// Ordered sum of column j of float[groups * per, ld] partials: each group's
// rows in order from zero, the groups left to right from the first.
// Writes each group's sum to group_out[g * C + j] when group_out is not
// null.
__device__ __forceinline__ float ordered_sum(const float* __restrict__ part,
                                             int groups, int per, int ld,
                                             int C, int j,
                                             float* __restrict__ group_out) {
  float total = 0.f;
  for (int g = 0; g < groups; ++g) {
    float acc = 0.f;
    for (int t = 0; t < per; ++t)
      acc += part[static_cast<size_t>(g * per + t) * ld + j];
    if (group_out) group_out[static_cast<size_t>(g) * C + j] = acc;
    total = g ? total + acc : acc;
  }
  return total;
}

// blockIdx.y selects the array: 0 = load, 1 = colsum.  Any output may be
// null.
__global__ void combine(const float* __restrict__ part_load,
                        const float* __restrict__ part_col, int groups,
                        int per, int C, int ld, float* __restrict__ group_load,
                        float* __restrict__ group_col,
                        float* __restrict__ total_load,
                        float* __restrict__ total_col) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= C) return;
  const bool col = blockIdx.y == 1;
  const float total = ordered_sum(col ? part_col : part_load, groups, per, ld,
                                  C, j, col ? group_col : group_load);
  float* dst = col ? total_col : total_load;
  if (dst) dst[j] = total;
}

// Both passes on `stream`: the tiles' partials into part_load / part_col
// (float[n_tiles, ld] scratch), then their ordered sums by group (per =
// tiles a group).  A null part_col skips the colsum throughout.  Returns
// cudaGetLastError().
inline cudaError_t marginals(const float* lw, const float* load_w,
                             const float* count_w, const float* A,
                             const float* B, float* part_load,
                             float* part_col, int rows, int tile, int threads,
                             int groups, int per, int C, int ld,
                             float* group_load, float* group_col,
                             float* total_load, float* total_col,
                             cudaStream_t stream) {
  tile_partials<<<groups * per, threads, 0, stream>>>(
      lw, load_w, count_w, A, B, part_load, part_col, rows, tile, C, ld);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((C + kCombineThreads - 1) / kCombineThreads, part_col ? 2 : 1);
  combine<<<grid, kCombineThreads, 0, stream>>>(part_load, part_col, groups, per,
                                               C, ld, group_load, group_col,
                                               total_load, total_col);
  return cudaGetLastError();
}

}  // namespace klba

extern "C" const char* klba_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
