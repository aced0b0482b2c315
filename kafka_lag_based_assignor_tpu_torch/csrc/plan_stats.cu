// Implicit transport-plan marginals of the dense Sinkhorn solver, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel kafka_lag_based_assignor_tpu/ops/plan_stats.py
// ::plan_stats_pallas.  For each unique scaled lag u (ws_u) the plan row is
// X_u = softmax_j(-ws_u * A_j + B_j) over the C consumers, and
//   load_j   = sum_u wsum_u  * X_u[j]
//   colsum_j = sum_u count_u * X_u[j].
//
// Layout: ws, count, wsum float[U]; A, B float[C]; part_load, part_col
// float[n_tiles, C] scratch; load, colsum float[C].
//
// Design.  The TPU kernel walked value tiles in order inside one grid-less
// invocation and carried the sums in VMEM.  Blocks on the card run in no
// order, so the work is row_tiles.cuh's two passes and nothing carries
// between blocks: tile_partials over value tiles of kValTile = 16 values
// (so that even U_pad = 1024 fills 64 blocks), then one ordered sum of all
// the tiles.
//
// What bounds it: exp throughput.  It evaluates 2 * U * C exps; the bytes
// are O(U + C) plus the n_tiles * C partials.  At BASELINE config 4
// (U_pad 1024, C 512) that is about 1 M exps, a fraction of a microsecond
// of the card's exp rate, so the two launches' latency is what the kernel
// costs there.

#include "row_tiles.cuh"

namespace {

constexpr int kValTile = 16;
constexpr int kThreads = 256;

}  // namespace

// Value tiles the scratch partials need: ceil(U / kValTile).
extern "C" int klba_plan_stats_tiles(int U) { return (U + kValTile - 1) / kValTile; }

// Launches both passes on `stream`; returns cudaGetLastError() (0 = ok).
// part_load / part_col hold klba_plan_stats_tiles(U) * C floats each.
extern "C" int klba_plan_stats(const void* ws, const void* count,
                               const void* wsum, const void* A, const void* B,
                               void* part_load, void* part_col, void* load,
                               void* colsum, int U, int C, void* stream) {
  if (U < 1 || C < 1 || C > klba::kMaxConsumers)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(klba::marginals(
      static_cast<const float*>(ws), static_cast<const float*>(wsum),
      static_cast<const float*>(count), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<float*>(part_load),
      static_cast<float*>(part_col), U, kValTile, kThreads, 1,
      klba_plan_stats_tiles(U), C, C, nullptr, nullptr,
      static_cast<float*>(load), static_cast<float*>(colsum),
      static_cast<cudaStream_t>(stream)));
}
