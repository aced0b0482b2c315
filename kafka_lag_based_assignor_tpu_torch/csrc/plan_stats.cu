// Implicit transport-plan marginals of the dense Sinkhorn solver, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel kafka_lag_based_assignor_tpu/ops/plan_stats.py
// ::plan_stats_pallas.  For each unique scaled lag u (ws_u) the plan row is
// X_u = softmax_j(-ws_u * A_j + B_j) over the C consumers, and a call
// computes one or two weighted column sums of the plan,
//   first_j  = sum_u w1_u * X_u[j]
//   second_j = sum_u w2_u * X_u[j]      (when w2 is given)
// The wrapper passes (wsum, count) for both marginals, (wsum) for the load
// alone and (count) for the colsum alone: the duals loop consumes one
// marginal a call, and a marginal computed alone has the bits it has beside
// the other (its rows, chunks, FMAs and sums are the same; a row whose
// weight is 0 adds an exact 0).
//
// Layout: ws, w1, w2 float[U]; A, B float[C]; out1, out2 float[C].
//
// What bounds it: at BASELINE config 4 (U_pad 1024, C 512) the exps take
// about 0.12 us of the whole card's exp rate and the bytes less, so the
// launch's latency and the dependent steps inside it set the time.  Two
// forms, the wrapper choosing by shape (ops/plan_stats_cuda.form_for):
//
// * the cluster form (C <= 1024 and up to 2,048 value rows: the main path's
//   shapes): one launch of one thread-block cluster of kCluster blocks of
//   kBlock threads, no global scratch, no memset.  Block b takes the b-th
//   contiguous share of the value rows and runs row_tiles.cuh's row phase
//   on it (A and B in registers pre-scaled by log2 e, one FMA a logit, one
//   ex2.approx an entry, one reciprocal a row; a warp's two rows of a chunk
//   side by side, so that their dependent chains overlap; one or two FMAs
//   an entry in the column phase), leaving its partial marginals in its
//   shared memory.  After cluster.sync() block b sums column slice b over
//   the blocks' partials in block order through distributed shared memory
//   (the kCluster loads issued together) and writes the totals.  Its cost
//   is the launch, a few dependent round trips and, at C = 512, the exps of
//   16 SMs' multi-function units: the whole card's ordered sums cost more
//   below 4,096 value rows (PERF.md §6).
// * the pass form (C <= 1024 beyond the cluster form's rows):
//   row_tiles.cuh's persistent row-tile pass over value tiles of `tile`
//   rows on the whole card, the tiles in groups of `per` (about
//   sqrt(tiles)), the ordered sums finished by the last block to arrive.
// * the column form (C > 1024): row_tiles.cuh's column form, the value
//   rows' statistics over 1,024-consumer column tiles, then the columns
//   (two launches, two exps an entry, no plan tile anywhere), over value
//   tiles of 64 rows so that a small U still gives the card (tiles x
//   column tiles) blocks.
//   The pass and column forms keep their tickets (and the column form its
//   row statistics) in scratch the wrapper zeroes once; the last block to
//   leave re-zeroes the tickets, so no call needs a memset.
//
// No float atomics: every sum runs in a fixed order, so two runs give the
// same bits, which the duals loop needs (it branches on spread >
// prev_spread and stops on delta > tol).

#include <utility>

#include <cooperative_groups.h>

#include "row_tiles.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kCluster = 16;  // blocks of the cluster form (non-portable above 8)
constexpr int kBlock = 512;   // threads of a cluster-form block
constexpr int kRows = 2 * kBlock / 32;  // rows a chunk: two a warp

// Shared memory of a cluster-form block: the row phase's (x, coef, the
// live rows' weights, 64 words), then its two partial rows.
size_t cluster_smem(int C) {
  const size_t ldx = klba::row_stride(C);
  return kRows * (ldx * 4 + 8) + kBlock * 12 + 256 + 2 * sizeof(float) * ldx;
}

template <int KW>
__global__ void __launch_bounds__(kBlock) klba_plan_stats_cluster(klba::Pass p) {
  constexpr int CPT = KW >= 8 ? KW / 8 : 1;  // columns a thread in the column phase
  constexpr int kWarpsB = kBlock / 32;
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ldx = klba::row_stride(p.C);
  const klba::Smem s = klba::smem_layout<kBlock>(kRows, ldx);
  float* part1 = reinterpret_cast<float*>(s.misc + 64);
  float* part2 = part1 + ldx;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const bool two = p.part_col != nullptr;

  float a[KW], b[KW];
#pragma unroll
  for (int k = 0; k < KW; ++k) {
    const int j = lane + 32 * k;
    a[k] = j < p.C ? __fmul_rn(p.A[j], klba::kLog2e) : 0.f;
    b[k] = j < p.C ? __fmul_rn(p.B[j], klba::kLog2e) : -INFINITY;
  }
  float acc1[CPT], acc2[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) acc1[k] = acc2[k] = 0.f;

  const long long share = (p.rows + kCluster - 1) / kCluster;
  const long long r0 = rank * share < p.rows ? rank * share : p.rows;
  const long long r1 = r0 + share < p.rows ? r0 + share : p.rows;
  for (long long w0 = r0; w0 < r1; w0 += kBlock) {
    const long long w1 = w0 + kBlock < r1 ? w0 + kBlock : r1;
    const int n_live = klba::compact_rows<kBlock>(p, w0, w1, s);
    for (int c0 = 0; c0 < n_live; c0 += kRows) {
      const int n = n_live - c0 < kRows ? n_live - c0 : kRows;
      // A warp's two rows side by side (the second, past the chunk's end,
      // on a copy of its last row, into a row of x the columns skip).
      if (warp < n) {
        const int i = c0 + warp, i2 = c0 + min(warp + kWarpsB, n - 1);
        const klba::RowW rw = {s.live_w[i], s.live_load[i], s.live_count[i]};
        const klba::RowW rw2 = {s.live_w[i2], s.live_load[i2], s.live_count[i2]};
        klba::row_exps_reg<KW>(rw, a, b, s.x + static_cast<size_t>(warp) * ldx, s.coef + warp);
        klba::row_exps_reg<KW>(rw2, a, b, s.x + static_cast<size_t>(warp + kWarpsB) * ldx,
                               s.coef + warp + kWarpsB);
      }
      __syncthreads();
      if (t * CPT < ldx) klba::columns<CPT>(s.x, s.coef, n, ldx, t * CPT, two, acc1, acc2);
      __syncthreads();
    }
  }
  if (t * CPT < ldx) {
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      part1[t * CPT + k] = acc1[k];
      part2[t * CPT + k] = acc2[k];
    }
  }
  cluster.sync();
  // Column slice `rank`, summed over the blocks in block order (the loads
  // issued together, then added in order).
  const int per = (p.C + kCluster - 1) / kCluster;
  const int j1 = (rank + 1) * per < p.C ? (rank + 1) * per : p.C;
  for (int j = rank * per + t; j < j1; j += kBlock) {
    float v1[kCluster], v2[kCluster];
#pragma unroll
    for (int q = 0; q < kCluster; ++q) {
      v1[q] = *cluster.map_shared_rank(part1 + j, q);
      v2[q] = two ? *cluster.map_shared_rank(part2 + j, q) : 0.f;
    }
    float s1 = v1[0], s2 = v2[0];
#pragma unroll
    for (int q = 1; q < kCluster; ++q) {
      s1 += v1[q];
      s2 += v2[q];
    }
    p.total_load[j] = s1;
    if (two) p.total_col[j] = s2;
  }
  cluster.sync();  // no block leaves while another reads its partials
}

// The last block of the launch to leave re-zeroes the `n_tickets` tickets
// (the pass's and this exit count, the last of them).
__device__ __forceinline__ void leave(const klba::Pass& p, int n_tickets, int* flag) {
  if (klba::last_to_arrive(p.tickets + n_tickets - 1, gridDim.x, flag))
    for (int i = threadIdx.x; i < n_tickets; i += klba::kThreads) p.tickets[i] = 0u;
}

// The pass form, then leave().
template <int KW>
__global__ void __launch_bounds__(klba::kThreads, 2)
    klba_plan_stats_pass(klba::Pass p, int n_tickets) {
  klba::row_tile_pass<KW>(p);
  const klba::Smem s = klba::pass_smem(p);
  leave(p, n_tickets, s.misc + 9);
}

// The column form: the value rows' statistics, then the columns and
// leave() (which zeroes the statistics' tickets too).
__global__ void __launch_bounds__(klba::kThreads, klba::kColBlocks)
    klba_plan_stats_rows(klba::Pass p) {
  klba::row_stats_pass(p);
}

__global__ void __launch_bounds__(klba::kThreads, klba::kColBlocks)
    klba_plan_stats_cols(klba::Pass p, int n_tickets) {
  __shared__ int flag;
  klba::col_pass(p);
  leave(p, n_tickets, &flag);
}

using ClusterKernel = void (*)(klba::Pass);
using PassKernel = void (*)(klba::Pass, int);
const ClusterKernel kClusterKernels[] = KLBA_PASS_TABLE(klba_plan_stats_cluster);
const PassKernel kPassKernels[] = KLBA_PASS_TABLE(klba_plan_stats_pass);

// Sets, once for each kernel and device, the cluster kernel's shared-memory
// limit and its permission to take more than 8 blocks a cluster.
cudaError_t prepare_cluster(ClusterKernel kernel) {
  static std::mutex mu;
  static std::vector<std::pair<ClusterKernel, int>> done;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  for (const auto& [k, d] : done)
    if (k == kernel && d == device) return cudaSuccess;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  klba::kSmemLimit)) != cudaSuccess)
    return err;
  if (kCluster > 8 &&
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
          cudaSuccess)
    return err;
  done.emplace_back(kernel, device);
  return cudaSuccess;
}

cudaError_t launch_cluster(const klba::Pass& p, cudaStream_t stream) {
  const ClusterKernel kernel = kClusterKernels[klba::kw_index(p.C)];
  cudaError_t err = prepare_cluster(kernel);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kBlock);
  cfg.dynamicSmemBytes = cluster_smem(p.C);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&cfg, kernel, p)) != cudaSuccess) return err;
  return cudaGetLastError();
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// One launch on `stream` (two in the column form); returns the CUDA error
// (0 = ok).  w2 and out2 are null for one marginal.  tickets null: the
// cluster form (C <= 1024); else the pass form (C <= 1024) or the column
// form (C > 1024) over tiles of `tile` rows in groups of `per` tiles, with
// `n_tickets` zero tickets and `n_rows` floats of partial rows (and, in the
// column form, row statistics), at least what the shape takes
// (ops/plan_stats_cuda.pass_geometry computes the same sizes).
extern "C" int klba_plan_stats(const void* ws, const void* w1, const void* w2, const void* A,
                               const void* B, void* out1, void* out2, void* tickets,
                               int n_tickets, void* rows, long long n_rows, int U, int C,
                               int tile, int per, void* stream) {
  if (U < 1 || C < 1 || (w2 == nullptr) != (out2 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool two = w2 != nullptr;
  klba::Pass p = {};
  p.lw = static_cast<const float*>(ws);
  p.load_w = static_cast<const float*>(w1);
  p.count_w = static_cast<const float*>(w2);
  p.A = static_cast<const float*>(A);
  p.B = static_cast<const float*>(B);
  p.total_load = static_cast<float*>(out1);
  p.total_col = static_cast<float*>(out2);
  p.rows = U;
  p.C = C;
  if (tickets == nullptr) {
    if (C > klba::kRegCols) return static_cast<int>(cudaErrorInvalidValue);
    p.part_col = two ? p.total_col : nullptr;  // only its being set is read
    return static_cast<int>(launch_cluster(p, st));
  }
  if (tile < 1 || per < 1 || rows == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = static_cast<int>(cdiv(U, tile)), groups = static_cast<int>(cdiv(tiles, per));
  const bool cols = klba::col_tiles(C) > 0;
  const long long used = (cols ? klba::col_pass_tickets(U, tiles, groups, C)
                               : klba::pass_tickets(tiles, groups)) + 1;
  const size_t tile_rows = static_cast<size_t>(tiles) * C, grp = static_cast<size_t>(groups) * C;
  const size_t partials = 2 * tile_rows + (groups > 1 ? 2 * grp : 0);
  const long long stats = cols ? klba::col_row_floats(U, C) : 0;
  if (n_tickets < used || n_rows < static_cast<long long>(partials) + stats)
    return static_cast<int>(cudaErrorInvalidValue);
  float* f = static_cast<float*>(rows);
  p.tickets = static_cast<unsigned*>(tickets);
  p.item_load = p.part_load = f;
  p.item_col = p.part_col = two ? f + tile_rows : nullptr;
  p.group_load = groups > 1 ? f + 2 * tile_rows : nullptr;
  p.group_col = two && groups > 1 ? f + 2 * tile_rows + grp : nullptr;
  p.tile = tile;
  p.split = 1;
  p.per = per;
  p.groups = groups;
  p.n_tiles = tiles;
  if (cols) {
    klba::carve_rows(f + partials, &p);
    return static_cast<int>(
        klba::launch_col_pass(klba_plan_stats_rows, klba_plan_stats_cols, p, st,
                                static_cast<int>(used)));
  }
  return static_cast<int>(
      klba::launch_pass(kPassKernels[klba::kw_index(C)], p, st, static_cast<int>(used)));
}
