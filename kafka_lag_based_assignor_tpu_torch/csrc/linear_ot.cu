// Linear-space OT quality mode: superblock partial marginals (K5) and the
// mirror-prox step (K4), for Hopper (sm_90a).
//
// Replaces the TPU kernels of kafka_lag_based_assignor_tpu/ops/
// linear_ot_pallas.py:
//   ::superblock_partials_pallas (K5): per-superblock partial marginals of
//     the implicit plan X[p, j] = softmax_j(-ws_p * A_j + B_j), the tiles of
//     a superblock summed in tile order;
//   ::mirror_prox_step_pallas (K4): one extragradient step, predictor load
//     at (A, B), the step-scale damping and the extrapolated A_half, and the
//     corrector load and colsum at (A_half, B).
//
// Layout: ws, cnt float[Sb, tpb, tile] (rows; padding rows carry weight 0);
// A, B float[C]; scratch float[klba_linear_ot_scratch(...)]: the item rows,
// the tile rows, the superblock rows, A_half, above 1,024 consumers the
// column form's row data and tile statistics (row_tiles.cuh; both passes
// of a step use them in turn), then the tickets.
//
// Design.  The TPU kernels walked all tiles in order inside one grid-less
// invocation.  Here each pass is row_tiles.cuh's pass: at BASELINE config
// 5 ([8, 16, 1024] rows by 1000 consumers) one launch of 264 blocks, two an
// SM, taking the 512 work items of 256 rows in order (the 24 % of them that
// are padding end at once); then the last item of each tile sums the tile,
// the last tile of each superblock the superblock and the last superblock
// their total (left to right from the first, JAX's _ordered_sum).  K5 is
// one pass with both marginals.  K4 is two passes: the predictor (the load
// only, so rows with ws = 0 are skipped too), whose final block goes on to
// the step (the predictor load's max, min and sum over the real consumers,
// the damping from sc and prev_spread, the padded-lane mean and A_half);
// then the corrector at (A_half, B) with both marginals.  One host call
// zeroes both passes' tickets and launches both.
//
// What bounds it: the exp rate and the FP32 issue per plan entry
// (row_tiles.cuh).  Up to 1,024 consumers (the register forms): one exp per
// live row and consumer (1e8 at config 5, 24 us at 16 ex2 a clock an SM),
// about eight other instructions and two shared-memory accesses beside it.
// Above (the column form, the wide groups): a pass is two launches, the
// rows' statistics over 1,024-consumer column tiles, then the columns, so
// two exps per live row and consumer (8e9 a step at 200,000 partitions by
// 20,000 consumers, 1.9 ms at the card's exp rate; K4's step is four
// launches), with every warp of a block on rows or columns of its own.  The
// bytes are O(P2 + C) plus the partials: ws and cnt are 1 MB at config 5
// and stay in L2 between passes.

#include "row_tiles.cuh"

namespace {

// The K4 step's inputs for the predictor pass's final block; a_half null
// in every other pass.
struct Mirror {
  const float* A;
  const float* sc;
  const float* prev_spread;
  float eta;
  float* a_half;
};

// Block-wide reduction: per-warp butterfly, then warp 0 over the warps'
// results.  A fixed tree, so the same bits every run.  op: 0 max, 1 min,
// 2 sum.
__device__ float block_reduce(float v, int op, float* scratch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = op == 0 ? klba::warp_max(v) : op == 1 ? klba::warp_min(v) : klba::warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const float ident = op == 0 ? -INFINITY : op == 1 ? INFINITY : 0.f;
    float w = lane < klba::kWarps ? scratch[lane] : ident;
    w = op == 0 ? klba::warp_max(w) : op == 1 ? klba::warp_min(w) : klba::warp_sum(w);
    if (lane == 0) scratch[32] = w;
  }
  __syncthreads();
  const float out = scratch[32];
  __syncthreads();
  return out;
}

// The step after the predictor load (load1 float[C], written by this
// block): the damped step scale and a_half.
__device__ void mirror_step(const float* load1, int C, const Mirror& m, float* scratch) {
  float lmax = -INFINITY, lmin = INFINITY, lsum = 0.f;
  for (int j = threadIdx.x; j < C; j += klba::kThreads) {
    const float l = __ldcg(load1 + j);
    lmax = fmaxf(lmax, l);
    lmin = fminf(lmin, l);
    lsum += l;
  }
  lmax = block_reduce(lmax, 0, scratch);
  lmin = block_reduce(lmin, 1, scratch);
  lsum = block_reduce(lsum, 2, scratch);
  // Step-scale damping: halve after an overshoot, else recover by 1.2x
  // up to 1 (the duals loop re-derives the same value from load1).
  const float spread = lmax - lmin;
  const float s = *m.sc;
  const float sc_new = spread > *m.prev_spread ? __fmul_rn(s, 0.5f)
                                               : fminf(__fmul_rn(s, 1.2f), 1.f);
  const float mean = __fdiv_rn(lsum, static_cast<float>(C));
  const float step = __fmul_rn(m.eta, sc_new);
  for (int j = threadIdx.x; j < C; j += klba::kThreads)
    m.a_half[j] = __fadd_rn(m.A[j], __fmul_rn(step, __fsub_rn(__ldcg(load1 + j), mean)));
}

template <int KW>
__global__ void __launch_bounds__(klba::kThreads, 2)
    klba_linear_ot_pass(klba::Pass p, Mirror m) {
  if (klba::row_tile_pass<KW>(p) && m.a_half) {
    const klba::Smem s = klba::pass_smem(p);
    mirror_step(p.total_load, p.C, m, s.scratch);
  }
}

// The column form (C > 1,024): the rows' statistics, then the columns,
// whose final block goes on to K4's step as the register form's does.
__global__ void __launch_bounds__(klba::kThreads, klba::kColBlocks)
    klba_linear_ot_pass_rows(klba::Pass p) {
  klba::row_stats_pass(p);
}

__global__ void __launch_bounds__(klba::kThreads, klba::kColBlocks)
    klba_linear_ot_pass_cols(klba::Pass p, Mirror m) {
  __shared__ float scratch[40];
  if (klba::col_pass(p) && m.a_half) mirror_step(p.total_load, p.C, m, scratch);
}

using Kernel = void (*)(klba::Pass, Mirror);
const Kernel kKernels[] = KLBA_PASS_TABLE(klba_linear_ot_pass);

// Scratch layout (floats): item rows for the load and the colsum
// [n_tiles * split * C] each when split > 1, tile rows [n_tiles * C] each,
// superblock rows [n_sb * C] each, A_half [C], in the column form the row
// data and tile statistics [klba::col_row_floats], then the two passes'
// tickets.
struct Scratch {
  float *item_load, *item_col, *part_load, *part_col, *sb_load, *sb_col, *a_half, *rows;
  unsigned* tickets;
};

Scratch carve(void* scratch, int n_sb, int tpb, int tile, int C, int split) {
  float* f = static_cast<float*>(scratch);
  const size_t tiles = static_cast<size_t>(n_sb) * tpb * C, sb = static_cast<size_t>(n_sb) * C;
  const size_t items = split > 1 ? tiles * split : 0;
  const long long rows = static_cast<long long>(n_sb) * tpb * tile;
  Scratch s;
  s.item_load = f;
  s.item_col = f + items;
  s.part_load = f + 2 * items;
  s.part_col = s.part_load + tiles;
  s.sb_load = s.part_col + tiles;
  s.sb_col = s.sb_load + sb;
  s.a_half = s.sb_col + sb;
  s.rows = s.a_half + C;
  s.tickets = reinterpret_cast<unsigned*>(
      s.rows + (klba::col_tiles(C) ? klba::col_row_floats(rows, C) : 0));
  if (split == 1) s.item_load = s.part_load, s.item_col = s.part_col;
  return s;
}

klba::Pass base_pass(const void* ws, const void* cnt, const void* A, const void* B,
                     const Scratch& s, int n_sb, int tpb, int tile, int C, int split) {
  klba::Pass p = {};
  p.lw = p.load_w = static_cast<const float*>(ws);
  p.count_w = static_cast<const float*>(cnt);
  p.A = static_cast<const float*>(A);
  p.B = static_cast<const float*>(B);
  p.item_load = s.item_load;
  p.part_load = s.part_load;
  p.tickets = s.tickets;
  p.rows = static_cast<long long>(n_sb) * tpb * tile;
  p.tile = tile;
  p.split = split;
  p.per = tpb;
  p.groups = n_sb;
  p.n_tiles = n_sb * tpb;
  p.C = C;
  if (klba::col_tiles(C)) klba::carve_rows(s.rows, &p);
  return p;
}

// Adds the colsum to a pass.
void with_colsum(klba::Pass& p, const Scratch& s) {
  p.item_col = s.item_col;
  p.part_col = s.part_col;
}

bool bad_shape(int n_sb, int tpb, int tile, int C) {
  return n_sb < 1 || tpb < 1 || tile < 1 || C < 1 ||
         static_cast<long long>(n_sb) * tpb * tile > (1LL << 31) ||
         static_cast<long long>(n_sb) * tpb * klba::kMaxSplit > (1LL << 30);
}

// Tickets of one pass.
long long tickets(int n_sb, int tpb, int tile, int C) {
  if (!klba::col_tiles(C)) return klba::pass_tickets(n_sb * tpb, n_sb);
  return klba::col_pass_tickets(static_cast<long long>(n_sb) * tpb * tile, n_sb * tpb, n_sb, C);
}

cudaError_t launch(const klba::Pass& p, const Mirror& m, cudaStream_t stream) {
  if (klba::col_tiles(p.C))
    return klba::launch_col_pass(klba_linear_ot_pass_rows, klba_linear_ot_pass_cols, p, stream,
                                 m);
  return klba::launch_pass(kKernels[klba::kw_index(p.C)], p, stream, m);
}

}  // namespace

// Floats of scratch either entry point needs.
extern "C" long long klba_linear_ot_scratch(int n_sb, int tpb, int tile, int C) {
  const long long tiles = static_cast<long long>(n_sb) * tpb;
  const int sp = klba::auto_split(tile);
  const long long rows =
      klba::col_tiles(C) ? klba::col_row_floats(tiles * tile, C) : 0;
  return (2 * tiles * (sp > 1 ? sp : 0) + 2 * tiles + 2LL * n_sb + 1) * C + rows +
         2 * tickets(n_sb, tpb, tile, C);
}

// K5: per-superblock partials sb_load, sb_col float[Sb, C]: one launch (two
// in the column form).  Returns the CUDA error (0 = ok).
extern "C" int klba_superblock_partials(const void* ws, const void* cnt, const void* A,
                                        const void* B, void* scratch, void* sb_load,
                                        void* sb_col, int n_sb, int tpb, int tile, int C,
                                        void* stream) {
  if (bad_shape(n_sb, tpb, tile, C)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int split = klba::auto_split(tile);
  const Scratch s = carve(scratch, n_sb, tpb, tile, C, split);
  cudaError_t err =
      cudaMemsetAsync(s.tickets, 0, tickets(n_sb, tpb, tile, C) * sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  klba::Pass p = base_pass(ws, cnt, A, B, s, n_sb, tpb, tile, C, split);
  with_colsum(p, s);
  p.group_load = static_cast<float*>(sb_load);
  p.group_col = static_cast<float*>(sb_col);
  return static_cast<int>(launch(p, Mirror{}, st));
}

// K4: one step in two passes (two launches; four in the column form).
// load1, load2, colsum2 float[C]; sc and prev_spread float scalars on the
// card.  Returns the CUDA error (0 = ok).
extern "C" int klba_mirror_prox_step(const void* ws, const void* cnt, const void* A,
                                     const void* B, const void* sc, const void* prev_spread,
                                     float eta, void* scratch, void* load1, void* load2,
                                     void* colsum2, int n_sb, int tpb, int tile, int C,
                                     void* stream) {
  if (bad_shape(n_sb, tpb, tile, C)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int split = klba::auto_split(tile);
  const Scratch s = carve(scratch, n_sb, tpb, tile, C, split);
  const long long n_tickets = tickets(n_sb, tpb, tile, C);
  cudaError_t err = cudaMemsetAsync(s.tickets, 0, 2 * n_tickets * sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);

  klba::Pass pred = base_pass(ws, cnt, A, B, s, n_sb, tpb, tile, C, split);
  pred.group_load = s.sb_load;
  pred.total_load = static_cast<float*>(load1);
  const Mirror m = {static_cast<const float*>(A), static_cast<const float*>(sc),
                    static_cast<const float*>(prev_spread), eta, s.a_half};
  err = launch(pred, m, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  klba::Pass corr = base_pass(ws, cnt, s.a_half, B, s, n_sb, tpb, tile, C, split);
  with_colsum(corr, s);
  corr.group_load = s.sb_load;
  corr.group_col = s.sb_col;
  corr.total_load = static_cast<float*>(load2);
  corr.total_col = static_cast<float*>(colsum2);
  corr.tickets = s.tickets + n_tickets;
  return static_cast<int>(launch(corr, Mirror{}, st));
}
