// Implicit transport-plan marginals of the dense Sinkhorn solver, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel kafka_lag_based_assignor_tpu/ops/plan_stats.py
// ::plan_stats_pallas.  For each unique scaled lag u (ws_u) the plan row is
// X_u = softmax_j(-ws_u * A_j + B_j) over the C consumers, and
//   load_j   = sum_u wsum_u  * X_u[j]
//   colsum_j = sum_u count_u * X_u[j].
//
// Layout: ws, count, wsum float[U]; A, B float[C]; load, colsum float[C];
// scratch float[klba_plan_stats_scratch(U, C)]: the tile rows, the group
// rows and the tickets.
//
// Design.  The TPU kernel walked value tiles in order inside one grid-less
// invocation and carried the sums in VMEM.  Blocks on the card run in no
// order, so the work is row_tiles.cuh's single-launch pass over value tiles
// of kValTile = 16 values, one work item each (so that even U_pad = 1024
// keeps 64 blocks busy; rows with count = wsum = 0, the padding, are
// skipped), the tiles in groups of about sqrt(tiles): the last tile of
// each group sums the group's tile rows in order, the last group the
// groups.

// What bounds it: at BASELINE config 4 (U_pad 1024, C 512) it evaluates
// about 1 M exps, a fraction of a microsecond of the card's exp rate, so
// the launch's latency and the ordered sums' dependent reads are what the
// kernel costs there.

#include "row_tiles.cuh"

namespace {

constexpr int kValTile = 16;

template <int KW>
__global__ void __launch_bounds__(klba::kThreads, 2) klba_plan_stats_pass(klba::Pass p) {
  klba::row_tile_pass<KW>(p);
}

using Kernel = void (*)(klba::Pass);
const Kernel kKernels[] = KLBA_PASS_TABLE(klba_plan_stats_pass);

int tiles(int U) { return (U + kValTile - 1) / kValTile; }

// Tiles a group: the least n with n * n >= tiles.
int per_group(int U) {
  int n = 1;
  while (n * n < tiles(U)) ++n;
  return n;
}

int groups(int U) { return (tiles(U) + per_group(U) - 1) / per_group(U); }

}  // namespace

// Floats of scratch: tile rows and group rows for both marginals, then
// the tickets.
extern "C" long long klba_plan_stats_scratch(int U, int C) {
  return 2LL * (tiles(U) + groups(U)) * C + klba::pass_tickets(tiles(U), groups(U));
}

// One launch on `stream`; returns the CUDA error (0 = ok).
extern "C" int klba_plan_stats(const void* ws, const void* count, const void* wsum,
                               const void* A, const void* B, void* scratch, void* load,
                               void* colsum, int U, int C, void* stream) {
  if (U < 1 || C < 1 || C > klba::kMaxConsumers) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t rows = static_cast<size_t>(tiles(U)) * C, grp = static_cast<size_t>(groups(U)) * C;
  float* f = static_cast<float*>(scratch);
  klba::Pass p = {};
  p.lw = static_cast<const float*>(ws);
  p.load_w = static_cast<const float*>(wsum);
  p.count_w = static_cast<const float*>(count);
  p.A = static_cast<const float*>(A);
  p.B = static_cast<const float*>(B);
  p.item_load = p.part_load = f;
  p.item_col = p.part_col = f + rows;
  p.group_load = f + 2 * rows;
  p.group_col = f + 2 * rows + grp;
  p.total_load = static_cast<float*>(load);
  p.total_col = static_cast<float*>(colsum);
  p.tickets = reinterpret_cast<unsigned*>(f + 2 * (rows + grp));
  p.rows = U;
  p.tile = kValTile;
  p.split = 1;
  p.per = per_group(U);
  p.groups = groups(U);
  p.n_tiles = tiles(U);
  p.C = C;
  const cudaError_t err = cudaMemsetAsync(
      p.tickets, 0, klba::pass_tickets(p.n_tiles, p.groups) * sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(klba::launch_pass(kKernels[klba::kw_index(C)], p, st));
}
