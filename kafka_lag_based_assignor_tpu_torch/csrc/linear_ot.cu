// Linear-space OT quality mode: superblock partial marginals and the
// extrapolation of the mirror-prox step, for Hopper (sm_90a).
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
// A, B float[C]; tile partials float[Sb * tpb, C_pad] scratch, C_pad the
// lane-padded consumer count (pad columns hold exact zeros).
//
// Design.  The TPU kernels walked all tiles in order inside one grid-less
// invocation.  Here K5 is row_tiles.cuh's two passes: tile_partials with one
// block per tile (128 blocks at BASELINE config 5, [8, 16, 1024] rows by
// 1000 consumers; running a superblock as one sequential block would leave
// 124 of the 132 SMs idle), then the ordered combine, which writes each
// superblock's sum and their total (superblocks left to right from the
// first, JAX's _ordered_sum).  K4 is K5 at (A, B) for the load only,
// mirror_step, and K5 at (A_half, B); the wrapper
// (ops/linear_ot_cuda.py) launches the three on one stream.  mirror_step is
// one block: the predictor load's max, min and sum over the real consumers,
// the damping from sc and prev_spread, the padded-lane mean and A_half.
//
// What bounds it: exp throughput.  A pass over P2 rows and C consumers
// needs P2 * C exps (134 M at config 5); tile_partials evaluates each twice
// (row statistics, then weights).  The bytes are O(P2 + C) plus the
// partials: ws and cnt are 1 MB at config 5 and stay in L2 between passes.

#include "row_tiles.cuh"

namespace {

constexpr int kTileThreads = 512;
constexpr int kStepThreads = 1024;

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
    float w = lane < (blockDim.x >> 5) ? scratch[lane] : ident;
    w = op == 0 ? klba::warp_max(w) : op == 1 ? klba::warp_min(w) : klba::warp_sum(w);
    if (lane == 0) scratch[32] = w;
  }
  __syncthreads();
  const float out = scratch[32];
  __syncthreads();
  return out;
}

__global__ void mirror_step(const float* __restrict__ load1, int C,
                            const float* __restrict__ A,
                            const float* __restrict__ sc,
                            const float* __restrict__ prev_spread, float eta,
                            float* __restrict__ a_half) {
  __shared__ float scratch[33];
  float lmax = -INFINITY, lmin = INFINITY, lsum = 0.f;
  for (int j = threadIdx.x; j < C; j += blockDim.x) {
    const float l = load1[j];
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
  const float s = *sc;
  const float sc_new = spread > *prev_spread ? __fmul_rn(s, 0.5f)
                                             : fminf(__fmul_rn(s, 1.2f), 1.f);
  const float mean = __fdiv_rn(lsum, static_cast<float>(C));
  const float step = __fmul_rn(eta, sc_new);
  for (int j = threadIdx.x; j < C; j += blockDim.x)
    a_half[j] = __fadd_rn(A[j], __fmul_rn(step, __fsub_rn(load1[j], mean)));
}

}  // namespace

// K5: per-superblock partials sb_load, sb_col float[Sb, C] and their
// ordered totals load, colsum float[C]; part_load and part_col are
// float[Sb * tpb, C_pad] scratch.  part_col, sb_col and colsum may all be
// null: the load only.  Returns cudaGetLastError() (0 = ok).
extern "C" int klba_superblock_partials(const void* ws, const void* cnt,
                                        const void* A, const void* B,
                                        void* part_load, void* part_col,
                                        void* sb_load, void* sb_col,
                                        void* load, void* colsum, int n_sb,
                                        int tpb, int tile, int C, int c_pad,
                                        void* stream) {
  if (n_sb < 1 || tpb < 1 || tile < 1 || C < 1 || C > klba::kMaxConsumers ||
      c_pad < C)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* w = static_cast<const float*>(ws);
  return static_cast<int>(klba::marginals(
      w, w, static_cast<const float*>(cnt), static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<float*>(part_load),
      static_cast<float*>(part_col), n_sb * tpb * tile, tile, kTileThreads,
      n_sb, tpb, C, c_pad, static_cast<float*>(sb_load),
      static_cast<float*>(sb_col), static_cast<float*>(load),
      static_cast<float*>(colsum), static_cast<cudaStream_t>(stream)));
}

// K4's own kernel: from the predictor load1 float[C], the damped step scale
// (sc, prev_spread: float scalars on the card) and a_half float[C].
// Returns cudaGetLastError().
extern "C" int klba_mirror_extrapolate(const void* load1, const void* A,
                                       const void* sc, const void* prev_spread,
                                       float eta, void* a_half, int C,
                                       void* stream) {
  if (C < 1 || C > klba::kMaxConsumers)
    return static_cast<int>(cudaErrorInvalidValue);
  mirror_step<<<1, kStepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(load1), C, static_cast<const float*>(A),
      static_cast<const float*>(sc), static_cast<const float*>(prev_spread),
      eta, static_cast<float*>(a_half));
  return static_cast<int>(cudaGetLastError());
}
