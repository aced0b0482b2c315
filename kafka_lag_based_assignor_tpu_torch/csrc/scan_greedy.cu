// P-step greedy scan of the lag-based assignor, for Hopper (sm_90a),
// computed as rounds.
//
// Replaces no Pallas kernel: the JAX package computes this loop with
// lax.scan in kafka_lag_based_assignor_tpu/ops/scan_kernel.py::
// assign_topic_scan (the `step` body).  It is the reference's hot loop
// (LagBasedPartitionAssignor.java:237-277) as written: partitions in
// processing order, each to the eligible consumer with the least (assigned
// count, total assigned lag, consumer index), the index standing for the
// member id under the rank convention.
//
// Layout: sorted_lags int64[T, P] and sorted_valid uint8[T, P] (each topic's
// rows in processing order and their validity), eligible uint8[C] or null
// (all eligible); sorted_choice int32[T, P], counts int32[T, C], totals
// int64[T, C].  Grid = T: one block per topic, every topic starting from
// zero counts and totals.
//
// What it computes, and how: the round decomposition of count-primary
// greedy LPT (ops/rounds_kernel.py), with an eligible mask and invalid rows
// anywhere.  The eligible set is fixed and every eligible consumer starts at
// count 0, so the steps fill rounds of E valid rows, E the number of
// eligible consumers: in a round every eligible consumer takes exactly one
// row, and those still to be served keep the totals they had when the
// round began.  So the (j+1)-th valid row of round r (valid rows ranked in
// processing order) goes to the eligible consumer at position j of the
// (total at the round's start, index) order.  An invalid row changes
// nothing: it gets -1 and only shifts which rows are a round's.
//
// What bounds it: its depth, as K1's (rounds_scan.cu): ceil(n / E) rounds
// of log2(N) * (log2(N) + 1) / 2 dependent network stages, N =
// next_pow2(E), n the topic's valid rows (config 5: 100 rounds of 55
// stages, where the step form was 100,000 dependent argmins); bytes (13 a
// row) and compares are far below it.  The design:
//
// - The eligible consumers are compacted once, in index order, by a block
//   prefix sum over the mask (none given: all C, ids 0..C-1).  Sorted
//   position p < E starts as (total 0, the p-th eligible id); the ids
//   ascend with p, so the (total, id) order is the (total, index) order.
// - Each round's sort is slot_sort.cuh's network over N slots, K1's: keys
//   in registers, shuffles for the short strides, shared memory only for
//   the long ones.  The key is the packed (total << rank_bits) | id where
//   the wrapper admits it (K1's rule over each topic's valid lags) or the
//   two-key (total, id); the two-key totals add as unsigned int64, so they
//   wrap as the JAX arithmetic does, and compare as signed.  Pad slots
//   (positions >= E) hold a key above every real one (the packed
//   ((INT64_MAX >> rank_bits) << rank_bits) | p, or total INT64_MAX with id
//   C + p, above every consumer index), so they sort last and never take a
//   row.
// - The rows are staged a tile at a time (2,048 rows, fewer below 256
//   threads): a block prefix sum over the tile's validity bytes ranks its
//   valid rows, whose lags and row indices go to shared memory in rank
//   order; an invalid row gets -1 at once.  The next tile's rows are loaded
//   into registers before this tile's rounds and read after them.
// - A round sorts the slots at its position 0; the thread holding position
//   j seats the round's (j+1)-th valid row: it writes its slot's id to
//   choice and adds the lag.  A round may span tiles: its position carries
//   over.  Counts need no register: after n valid rows every eligible
//   consumer holds n / E of them, plus one for the n % E positions seated
//   in the last round.
// - Three forms by N = next_pow2(E), slot_sort.cuh's (see its header):
//   * Registers, N <= 16,384 (scan_greedy_kernel, one instantiation a power
//     of two): one block, its slots in registers.
//   * Cluster, 16,384 < N <= 131,072 (scan_greedy_kernel_cluster, one
//     instantiation a power of two): one thread-block cluster of 16 blocks a
//     topic, block r holding positions r * N / 16 ... in registers, sorted by
//     cluster_sort.  Every block stages the same tile and runs the same
//     prefix sums (the work is repeated, so no block waits on another to
//     learn a rank); only the block that owns position pos + j seats a
//     round's j-th row, only block 0 writes -1 for invalid rows and zeros
//     for ineligible consumers, and each block compacts the eligible ids
//     the same way and keeps those of its own positions.
//   * Scratch, N > 131,072 (scan_greedy_kernel_wide, one instantiation a
//     key form for every N): the slots live in a per-block scratch of
//     device memory, as K1's scratch form keeps them: a round's sort is
//     slot_sort.cuh's wide_sort, the compacted eligible ids go straight into
//     the scratch's id column, and the block's threads seat the round's
//     positions there in turn.  The wrapper allocates the scratch, T * N *
//     12 bytes.
//   The rows are staged as above in every form.
// - Up to 64 slots the network is one warp's shuffles: the block is one
//   warp and a round has no barrier.  With one slot (E <= 1) there are no
//   rounds to keep apart: the one eligible consumer takes every valid row,
//   and the warp writes the choices and sums the lags directly.

#include <climits>
#include <cstdint>
#include <mutex>
#include <utility>

#include <cuda_runtime.h>

#include "slot_sort.cuh"

namespace {

using klba::Exchange;
using klba::kMaxClusterSlots;
using klba::kMaxLogCluster;
using klba::kMaxLogSlots;

constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

template <int kLogN, bool kPacked>
struct Plan : klba::SlotPlan<kLogN, kPacked> {
  using Net = klba::SlotPlan<kLogN, kPacked>;
  // The block: the network's threads, at least one warp.
  static constexpr int kBlock = Net::kThreads < 32 ? 32 : Net::kThreads;
  // Rows a thread stages a tile, and the tile.
  static constexpr int kRows = kBlock <= 256 ? 8 : 2048 / kBlock;
  static constexpr int kTile = kBlock * kRows;
  // Dynamic shared memory: the exchange buffer, which first holds the
  // compacted eligible ids, then the tile's ranked lags and row indices.
  static constexpr int kIdBytes = 4 * Net::kSlots;
  static constexpr int kHead =
      ((Net::kExchangeBytes > kIdBytes ? Net::kExchangeBytes : kIdBytes) + 15) / 16 * 16;
  static constexpr int kSmem = kHead + kTile * (8 + 4);
  static_assert(kSmem + 32 * 4 <= klba::kSmemPerBlock, "shared memory of a block");
};

// The exclusive prefix sum of v over the block's threads, in thread order,
// and (in `total`) their sum.  Every thread of the block calls it; a barrier
// must come between two calls (they share `warp_sums`).
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  int w = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : 0;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, w, d);
    if (lane >= d) w += y;
  }
  total = __shfl_sync(kFull, w, 31);
  const int before = __shfl_sync(kFull, w, warp > 0 ? warp - 1 : 0);
  return (warp > 0 ? before : 0) + inc - v;
}

// A thread's R consecutive rows of a tile as loaded: fetch_rows() issues
// the loads and the tile loop reads them one tile later, so that no tile
// waits on device memory.
template <int R>
struct Rows {
  long long lag[R];
  int ok[R];  // the validity bytes (0 past the topic's end)
};

template <int R>
__device__ __forceinline__ void fetch_rows(const long long* __restrict__ g,
                                           const unsigned char* __restrict__ v, int first,
                                           int P, Rows<R>& rows) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = first + i;
    rows.lag[i] = r < P ? __ldg(g + r) : 0;
    rows.ok[i] = r < P ? __ldg(v + r) : 0;
  }
}

template <int kLogN, bool kPacked>
__global__ void __launch_bounds__(Plan<kLogN, kPacked>::kBlock, 1)
    scan_greedy_kernel(const long long* __restrict__ lags,
                       const unsigned char* __restrict__ valid,
                       const unsigned char* __restrict__ eligible, int* __restrict__ choice,
                       int* __restrict__ counts_out, long long* __restrict__ totals_out, int P,
                       int C, int E, int rank_bits) {
  using Pl = Plan<kLogN, kPacked>;
  constexpr int K = Pl::kK;
  constexpr int R = Pl::kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sums[32];
  const int buffers = Pl::kDouble ? 2 : 1;
  Exchange x{reinterpret_cast<long long*>(smem),
             reinterpret_cast<int*>(smem + static_cast<size_t>(buffers) * Pl::kSlots * 8), 0};
  int* ids = reinterpret_cast<int*>(smem);  // until the first sort
  long long* tile_lag = reinterpret_cast<long long*>(smem + Pl::kHead);
  int* tile_row = reinterpret_cast<int*>(smem + Pl::kHead + Pl::kTile * 8);

  const int t = threadIdx.x;
  // Below one warp of network threads the other lanes sit the sort out
  // (it has no barrier there).
  const bool sorts = Pl::kThreads >= 32 || t < Pl::kThreads;
  const long long row0 = static_cast<long long>(blockIdx.x) * P;
  const long long* g = lags + row0;
  const unsigned char* v = valid + row0;
  int* ch = choice + row0;
  int* cnt_out = counts_out + static_cast<long long>(blockIdx.x) * C;
  long long* tot_out = totals_out + static_cast<long long>(blockIdx.x) * C;

  // The eligible consumers' ids in index order; the others hold nothing.
  if (eligible != nullptr) {
    const int per = (C + blockDim.x - 1) / blockDim.x;
    const int c0 = min(t * per, C);
    const int c1 = min(c0 + per, C);
    int mine = 0;
    for (int c = c0; c < c1; ++c) mine += eligible[c] != 0;
    int total;
    int rank = block_scan(mine, warp_sums, total);
    for (int c = c0; c < c1; ++c) {
      if (eligible[c]) {
        if (rank < E) ids[rank] = c;
        ++rank;
      } else {
        cnt_out[c] = 0;
        tot_out[c] = 0;
      }
    }
    __syncthreads();
  }
  if constexpr (kLogN == 0) {
    // At most one eligible consumer: it takes every valid row, whatever
    // the order, so the block's one warp sums them directly.
    const int who = E == 0 ? -1 : eligible != nullptr ? ids[0] : 0;
    unsigned long long sum = 0;
    int n = 0;
    for (int r = t; r < P; r += Pl::kBlock) {
      const bool take = who >= 0 && v[r] != 0;
      ch[r] = take ? who : -1;
      if (take) {
        sum += static_cast<unsigned long long>(g[r]);
        ++n;
      }
    }
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) {
      sum += __shfl_xor_sync(kFull, sum, m);
      n += __shfl_xor_sync(kFull, n, m);
    }
    if (t == 0 && who >= 0) {
      cnt_out[who] = n;
      tot_out[who] = static_cast<long long>(sum);
    }
    return;
  }

  // From here on N >= 2, so E >= 2 (N = next_pow2(E)).
  Rows<R> next;
  fetch_rows<R>(g, v, t * R, P, next);
  const long long id_mask = (1LL << rank_bits) - 1;
  long long key[K];
  int id[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = t * K + k;
    const int who = p < E ? (eligible != nullptr ? ids[p] : p) : C + p;
    if constexpr (kPacked) {
      key[k] = p < E ? who : ((LLONG_MAX >> rank_bits) << rank_bits) | p;
    } else {
      key[k] = p < E ? 0 : LLONG_MAX;
    }
    id[k] = who;
  }

  int pos = 0;     // the current round's next position
  int seated = 0;  // valid rows seated so far
  for (int s0 = 0; s0 < P; s0 += Pl::kTile) {
    const Rows<R> cur = next;
    int mine = 0;
#pragma unroll
    for (int i = 0; i < R; ++i) mine += cur.ok[i] != 0;
    int m;
    // Its barrier also ends the previous tile's rounds.
    int rank = block_scan(mine, warp_sums, m);
    const int first = s0 + t * R;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = first + i;
      if (r < P && cur.ok[i] != 0) {
        tile_lag[rank] = cur.lag[i];
        tile_row[rank] = r;
        ++rank;
      } else if (r < P) {
        ch[r] = -1;
      }
    }
    __syncthreads();
    if (s0 + Pl::kTile < P) fetch_rows<R>(g, v, s0 + Pl::kTile + t * R, P, next);

    for (int q = 0; q < m;) {
      const int take = min(E - pos, m - q);
      // The rows this thread's positions take, read before the sort (up to
      // 4 slots a thread) so that the network hides the shared loads.
      long long lag[K];
      int row[K];
      const auto read = [&] {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int j = t * K + k - pos;
          row[k] = j >= 0 && j < take ? tile_row[q + j] : -1;
          lag[k] = row[k] >= 0 ? tile_lag[q + j] : 0;
        }
      };
      if constexpr (K <= 4) read();
      if (pos == 0 && sorts) klba::sort_slots<Pl>(key, id, x);
      if constexpr (K > 4) read();
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (row[k] >= 0) {
          ch[row[k]] = kPacked ? static_cast<int>(key[k] & id_mask) : id[k];
          if constexpr (kPacked) {
            key[k] += lag[k] << rank_bits;
          } else {
            key[k] = static_cast<long long>(static_cast<unsigned long long>(key[k]) +
                                            static_cast<unsigned long long>(lag[k]));
          }
        }
      }
      q += take;
      pos += take;
      if (pos == E) pos = 0;
    }
    seated += m;
  }

  const int full = seated / E;
  const int part = seated % E;  // positions seated in the last round
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = t * K + k;
    if (p < E) {
      const int who = kPacked ? static_cast<int>(key[k] & id_mask) : id[k];
      cnt_out[who] = full + (p < part ? 1 : 0);
      tot_out[who] = kPacked ? key[k] >> rank_bits : key[k];
    }
  }
}

// The cluster form's block: the block's share of the slots' network, the
// tile of the register form's large blocks, and the dynamic shared memory:
// the exchange buffers (two, which first hold the compacted ids of the
// block's positions), then the tile's ranked lags and row indices.
template <int kLogN, bool kPacked>
struct ClusterScanPlan {
  using CP = klba::ClusterPlan<kLogN, kPacked>;
  using Net = typename CP::Block;
  static constexpr int kBlock = Net::kThreads;
  static constexpr int kRows = 2048 / kBlock;
  static constexpr int kTile = kBlock * kRows;
  static constexpr int kHead = (Net::kExchangeBytes + 15) / 16 * 16;
  static constexpr int kSmem = kHead + kTile * (8 + 4);
  static_assert(4 * Net::kSlots <= Net::kExchangeBytes, "the ids in the exchange buffers");
  static_assert(kSmem + 32 * 4 <= klba::kSmemPerBlock, "shared memory of a block");
};

// The scan with N = 2^kLogN slots, kMaxSlots < N <= kMaxClusterSlots, on
// one cluster of ClusterPlan::kBlocks blocks a topic (grid = T * blocks):
// scan_greedy_kernel's rounds, block r holding positions r * N / blocks ...
template <int kLogN, bool kPacked>
__global__ void __launch_bounds__(ClusterScanPlan<kLogN, kPacked>::kBlock, 1)
    scan_greedy_kernel_cluster(const long long* __restrict__ lags,
                               const unsigned char* __restrict__ valid,
                               const unsigned char* __restrict__ eligible,
                               int* __restrict__ choice, int* __restrict__ counts_out,
                               long long* __restrict__ totals_out, int P, int C, int E,
                               int rank_bits) {
  using Pl = ClusterScanPlan<kLogN, kPacked>;
  using Net = typename Pl::Net;
  constexpr int K = Net::kK;
  constexpr int R = Pl::kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sums[32];
  Exchange x{reinterpret_cast<long long*>(smem),
             reinterpret_cast<int*>(smem + static_cast<size_t>(2) * Net::kSlots * 8), 0};
  int* ids = reinterpret_cast<int*>(smem);  // until the first sort
  long long* tile_lag = reinterpret_cast<long long*>(smem + Pl::kHead);
  int* tile_row = reinterpret_cast<int*>(smem + Pl::kHead + Pl::kTile * 8);

  const int t = threadIdx.x;
  const unsigned rank = cooperative_groups::this_cluster().block_rank();
  const bool lead = rank == 0;
  const int base = static_cast<int>(rank) * Net::kSlots;  // the block's first position
  const long long topic = static_cast<long long>(blockIdx.x >> Pl::CP::kLogBlocks);
  const long long row0 = topic * P;
  const long long* g = lags + row0;
  const unsigned char* v = valid + row0;
  int* ch = choice + row0;
  int* cnt_out = counts_out + topic * C;
  long long* tot_out = totals_out + topic * C;

  // The eligible consumers' ids in index order, those of this block's
  // positions kept; the others hold nothing.
  if (eligible != nullptr) {
    const int per = (C + blockDim.x - 1) / blockDim.x;
    const int c0 = min(t * per, C);
    const int c1 = min(c0 + per, C);
    int mine = 0;
    for (int c = c0; c < c1; ++c) mine += eligible[c] != 0;
    int total;
    int at = block_scan(mine, warp_sums, total);
    for (int c = c0; c < c1; ++c) {
      if (eligible[c]) {
        if (at >= base && at < base + Net::kSlots && at < E) ids[at - base] = c;
        ++at;
      } else if (lead) {
        cnt_out[c] = 0;
        tot_out[c] = 0;
      }
    }
    __syncthreads();
  }

  Rows<R> next;
  fetch_rows<R>(g, v, t * R, P, next);
  const long long id_mask = (1LL << rank_bits) - 1;
  long long key[K];
  int id[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = base + t * K + k;
    const int who = p < E ? (eligible != nullptr ? ids[p - base] : p) : C + p;
    if constexpr (kPacked) {
      key[k] = p < E ? who : ((LLONG_MAX >> rank_bits) << rank_bits) | p;
    } else {
      key[k] = p < E ? 0 : LLONG_MAX;
    }
    id[k] = who;
  }

  int pos = 0;     // the current round's next position
  int seated = 0;  // valid rows seated so far
  for (int s0 = 0; s0 < P; s0 += Pl::kTile) {
    const Rows<R> cur = next;
    int mine = 0;
#pragma unroll
    for (int i = 0; i < R; ++i) mine += cur.ok[i] != 0;
    int m;
    // Its barrier also ends the previous tile's rounds.
    int at = block_scan(mine, warp_sums, m);
    const int first = s0 + t * R;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = first + i;
      if (r < P && cur.ok[i] != 0) {
        tile_lag[at] = cur.lag[i];
        tile_row[at] = r;
        ++at;
      } else if (r < P && lead) {
        ch[r] = -1;
      }
    }
    __syncthreads();
    if (s0 + Pl::kTile < P) fetch_rows<R>(g, v, s0 + Pl::kTile + t * R, P, next);

    for (int q = 0; q < m;) {
      const int take = min(E - pos, m - q);
      // The rows this thread's positions take, read before the sort (up to
      // 4 slots a thread) so that the network hides the shared loads.
      long long lag[K];
      int row[K];
      const auto read = [&] {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int j = base + t * K + k - pos;
          row[k] = j >= 0 && j < take ? tile_row[q + j] : -1;
          lag[k] = row[k] >= 0 ? tile_lag[q + j] : 0;
        }
      };
      if constexpr (K <= 4) read();
      if (pos == 0) klba::cluster_sort<typename Pl::CP>(key, id, x, rank);
      if constexpr (K > 4) read();
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (row[k] >= 0) {
          ch[row[k]] = kPacked ? static_cast<int>(key[k] & id_mask) : id[k];
          if constexpr (kPacked) {
            key[k] += lag[k] << rank_bits;
          } else {
            key[k] = static_cast<long long>(static_cast<unsigned long long>(key[k]) +
                                            static_cast<unsigned long long>(lag[k]));
          }
        }
      }
      q += take;
      pos += take;
      if (pos == E) pos = 0;
    }
    seated += m;
  }

  const int full = seated / E;
  const int part = seated % E;  // positions seated in the last round
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = base + t * K + k;
    if (p < E) {
      const int who = kPacked ? static_cast<int>(key[k] & id_mask) : id[k];
      cnt_out[who] = full + (p < part ? 1 : 0);
      tot_out[who] = kPacked ? key[k] >> rank_bits : key[k];
    }
  }
  // No block's shared memory goes while a partner may still read it.
  klba::cluster_arrive();
  klba::cluster_wait();
}

// The wide form's staging: the 16,384-slot network's exchange buffer
// (the ids go to the scratch), then the tile's ranked lags and row indices.
template <bool kPacked>
struct WidePlan {
  using Net = klba::ChunkPlan<kPacked>;
  static constexpr int kBlock = Net::kThreads;
  static constexpr int kRows = 2048 / kBlock;
  static constexpr int kTile = kBlock * kRows;
  static constexpr int kHead = (Net::kExchangeBytes + 15) / 16 * 16;
  static constexpr int kSmem = kHead + kTile * (8 + 4);
  static_assert(kSmem + 32 * 4 <= klba::kSmemPerBlock, "shared memory of a block");
};

// The scan with N = 2^log_n > kMaxClusterSlots slots for E > kMaxClusterSlots
// eligible consumers, the slots in the block's scratch (keys [T, N], ids [T, N]);
// otherwise scan_greedy_kernel's rounds.
template <bool kPacked>
__global__ void __launch_bounds__(WidePlan<kPacked>::kBlock, 1)
    scan_greedy_kernel_wide(const long long* __restrict__ lags,
                            const unsigned char* __restrict__ valid,
                            const unsigned char* __restrict__ eligible,
                            int* __restrict__ choice, int* __restrict__ counts_out,
                            long long* __restrict__ totals_out, int P, int C, int E,
                            int rank_bits, int log_n, long long* scratch_key,
                            int* scratch_id) {
  using Pl = WidePlan<kPacked>;
  using Net = typename Pl::Net;
  constexpr int R = Pl::kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_sums[32];
  Exchange x{reinterpret_cast<long long*>(smem),
             reinterpret_cast<int*>(smem + static_cast<size_t>(Net::kDouble ? 2 : 1) *
                                              Net::kSlots * 8),
             0};
  long long* tile_lag = reinterpret_cast<long long*>(smem + Pl::kHead);
  int* tile_row = reinterpret_cast<int*>(smem + Pl::kHead + Pl::kTile * 8);

  const int t = threadIdx.x;
  const long long N = 1LL << log_n;
  const klba::WideSlots w{scratch_key + static_cast<long long>(blockIdx.x) * N,
                          scratch_id + static_cast<long long>(blockIdx.x) * N, log_n};
  const long long row0 = static_cast<long long>(blockIdx.x) * P;
  const long long* g = lags + row0;
  const unsigned char* v = valid + row0;
  int* ch = choice + row0;
  int* cnt_out = counts_out + static_cast<long long>(blockIdx.x) * C;
  long long* tot_out = totals_out + static_cast<long long>(blockIdx.x) * C;

  // The eligible consumers' ids in index order, into the id column.
  if (eligible != nullptr) {
    const int per = (C + blockDim.x - 1) / blockDim.x;
    const int c0 = min(t * per, C);
    const int c1 = min(c0 + per, C);
    int mine = 0;
    for (int c = c0; c < c1; ++c) mine += eligible[c] != 0;
    int total;
    int rank = block_scan(mine, warp_sums, total);
    for (int c = c0; c < c1; ++c) {
      if (eligible[c]) {
        if (rank < E) w.id[rank] = c;
        ++rank;
      } else {
        cnt_out[c] = 0;
        tot_out[c] = 0;
      }
    }
    __syncthreads();
  }
  for (long long p = t; p < N; p += Pl::kBlock) {
    const int pi = static_cast<int>(p);
    const int who = pi < E ? (eligible != nullptr ? w.id[pi] : pi) : C + pi;
    if constexpr (kPacked) {
      w.key[p] = pi < E ? who : ((LLONG_MAX >> rank_bits) << rank_bits) | p;
    } else {
      w.key[p] = pi < E ? 0 : LLONG_MAX;
      w.id[p] = who;
    }
  }

  Rows<R> next;
  fetch_rows<R>(g, v, t * R, P, next);
  const long long id_mask = (1LL << rank_bits) - 1;
  const auto no_seat = [](long long, long long(&)[Net::kK], int(&)[Net::kK]) {};
  int pos = 0;     // the current round's next position
  int seated = 0;  // valid rows seated so far
  for (int s0 = 0; s0 < P; s0 += Pl::kTile) {
    const Rows<R> cur = next;
    int mine = 0;
#pragma unroll
    for (int i = 0; i < R; ++i) mine += cur.ok[i] != 0;
    int m;
    // Its barrier also ends the previous tile's rounds.
    int rank = block_scan(mine, warp_sums, m);
    const int first = s0 + t * R;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = first + i;
      if (r < P && cur.ok[i] != 0) {
        tile_lag[rank] = cur.lag[i];
        tile_row[rank] = r;
        ++rank;
      } else if (r < P) {
        ch[r] = -1;
      }
    }
    __syncthreads();
    if (s0 + Pl::kTile < P) fetch_rows<R>(g, v, s0 + Pl::kTile + t * R, P, next);

    for (int q = 0; q < m;) {
      const int take = min(E - pos, m - q);
      if (pos == 0) klba::wide_sort<kPacked>(w, x, no_seat);
      for (int j = t; j < take; j += Pl::kBlock) {
        const long long p = pos + j;
        const long long k = w.key[p];
        const long long lag = tile_lag[q + j];
        ch[tile_row[q + j]] = kPacked ? static_cast<int>(k & id_mask) : w.id[p];
        w.key[p] = kPacked ? k + (lag << rank_bits)
                           : static_cast<long long>(static_cast<unsigned long long>(k) +
                                                    static_cast<unsigned long long>(lag));
      }
      q += take;
      pos += take;
      if (pos == E) pos = 0;
    }
    seated += m;
  }

  __syncthreads();
  const int full = seated / E;
  const int part = seated % E;  // positions seated in the last round
  for (int p = t; p < E; p += Pl::kBlock) {
    const long long k = w.key[p];
    const int who = kPacked ? static_cast<int>(k & id_mask) : w.id[p];
    cnt_out[who] = full + (p < part ? 1 : 0);
    tot_out[who] = kPacked ? k >> rank_bits : k;
  }
}

struct Instance {
  const void* fn;
  int threads;
  int smem;
  int blocks;  // of a cluster; 1 for the register and scratch forms
};

template <int kLogN, bool kPacked>
Instance cluster_instance() {
  using Pl = ClusterScanPlan<kLogN, kPacked>;
  return {reinterpret_cast<const void*>(scan_greedy_kernel_cluster<kLogN, kPacked>), Pl::kBlock,
          Pl::kSmem, Pl::CP::kBlocks};
}

constexpr int kClusterForms = kMaxLogCluster - kMaxLogSlots;

// One instantiation a slot count 2^0 ... 2^14, one a slot count 2^15 ...
// 2^17 of the cluster form, then the scratch form's.
template <bool kPacked, int... Ls, int... Cs>
const Instance* instances(std::integer_sequence<int, Ls...>,
                          std::integer_sequence<int, Cs...>) {
  static const Instance table[] = {
      {reinterpret_cast<const void*>(scan_greedy_kernel<Ls, kPacked>),
       Plan<Ls, kPacked>::kBlock, Plan<Ls, kPacked>::kSmem, 1}...,
      cluster_instance<kMaxLogSlots + 1 + Cs, kPacked>()...,
      {reinterpret_cast<const void*>(scan_greedy_kernel_wide<kPacked>),
       WidePlan<kPacked>::kBlock, WidePlan<kPacked>::kSmem, 1}};
  return table;
}

// The index of the instantiation for 2^log_n slots: the scratch form's
// above kMaxLogCluster.
int form_of(int log_n) { return log_n > kMaxLogCluster ? kMaxLogCluster + 1 : log_n; }

const Instance& instance(int log_n, bool packed) {
  constexpr auto narrow = std::make_integer_sequence<int, kMaxLogSlots + 1>{};
  constexpr auto cluster = std::make_integer_sequence<int, kClusterForms>{};
  const int i = form_of(log_n);
  return packed ? instances<true>(narrow, cluster)[i] : instances<false>(narrow, cluster)[i];
}

// What a device says of each instantiation, once a device: whether its
// dynamic shared-memory limit could be set to what it uses (also at 48 KB
// and below: the static warp sums count against the default limit too),
// and, for each cluster form, whether it is launchable and the device holds
// one of its clusters.  A form that fails keeps its error; the other forms
// still launch.
struct Limits {
  cudaError_t form[2][kMaxLogCluster + 2];
};

void set_smem_limits(Limits& out) {
  for (int packed = 0; packed < 2; ++packed) {
    for (int log_n = 0; log_n <= kMaxLogCluster + 1; ++log_n) {
      const Instance& in = instance(log_n, packed != 0);
      out.form[packed][log_n] =
          in.blocks > 1
              ? klba::prepare_cluster(in.fn, in.blocks, in.threads, in.smem)
              : cudaFuncSetAttribute(in.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, in.smem);
    }
  }
}

int log2_of(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

}  // namespace

// Launches the scan on `stream`; returns the CUDA error (0 = ok).  T topics,
// each over P rows of C consumers, E of them eligible (all C when
// `eligible` is null: the count of its nonzero bytes otherwise), sorted in
// next_pow2(E) slots.  rank_bits > 0 runs the packed key (the caller has
// checked that each topic's valid lags are >= 0 and their shifted sum
// fits, and C <= 2^rank_bits), 0 the two-key network.  Up to 16,384 slots
// a topic is one block; up to 131,072 one cluster of blocks (a device that
// cannot hold one gives its error); above, one block whose slots are in
// `scratch`, T * next_pow2(E) * 12 bytes (the keys, then the ids), which
// the kernel overwrites.  Below 131,072 slots `scratch` is not read.
extern "C" int klba_scan_greedy(const void* lags, const void* valid, const void* eligible,
                                void* choice, void* counts, void* totals, int T, int P, int C,
                                int E, int rank_bits, void* scratch, void* stream) {
  if (T < 0 || P < 0 || C < 1 || C > (1 << 30) || E < 0 || E > C ||
      (eligible == nullptr && E != C) || rank_bits < 0 || rank_bits > 61 ||
      (rank_bits > 0 && C > (1LL << rank_bits)) || (E > kMaxClusterSlots && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  static std::once_flag once[kMaxDevices];
  static Limits limits[kMaxDevices];
  std::call_once(once[device], [device] { set_smem_limits(limits[device]); });

  int log_n = log2_of(E);
  const Instance& in = instance(log_n, rank_bits > 0);
  err = limits[device].form[rank_bits > 0][form_of(log_n)];
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long* g = static_cast<const long long*>(lags);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  const unsigned char* e = static_cast<const unsigned char*>(eligible);
  int* ch = static_cast<int*>(choice);
  int* cn = static_cast<int*>(counts);
  long long* tt = static_cast<long long*>(totals);
  long long* sk = static_cast<long long*>(scratch);
  int* si = log_n > kMaxLogCluster
                ? reinterpret_cast<int*>(sk + (static_cast<long long>(T) << log_n))
                : nullptr;
  void* args[] = {&g, &v, &e, &ch, &cn, &tt, &P, &C, &E, &rank_bits, &log_n, &sk, &si};
  void* narrow[] = {&g, &v, &e, &ch, &cn, &tt, &P, &C, &E, &rank_bits};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in.blocks > 1) {
    err = klba::launch_cluster(in.fn, T, in.blocks, in.threads, in.smem, narrow, s);
  } else {
    err = cudaLaunchKernel(in.fn, dim3(T), dim3(in.threads),
                           log_n > kMaxLogCluster ? args : narrow, in.smem, s);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" const char* klba_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
