// Integrity digest of the streaming engine's resident state, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel kafka_lag_based_assignor_tpu/ops/
// linear_ot_pallas.py::state_digest_pallas (the int64[4] digest), and folds in
// the row-table lane that the JAX package computes beside it with XLA
// (ops/refine.py::_row_tab_lane_xla), so one call returns int64[5]:
//
//   out[0] = sum(counts)
//   out[1] = #{i : choice[i] < -1 or choice[i] >= C}
//   out[2] = sum(lags)                               (wraps modulo 2**64)
//   out[3] = sum_c |#{i : choice[i] == c} - counts[c]|
//   out[4] = #{valid slots (j < min(counts[c], M)) whose row r is outside
//              [0, B) or has choice[clamp(r)] != c}
//          + #{empty slots not holding the sentinel B}
//          + |sum(clamped valid-slot rows) - sum(rows with 0 <= choice < C)|
//
// Inputs: lags int64[B], choice int32[B] (-1 on padding rows, whose lag is
// 0, so padding is neutral), counts int32[C], row_tab int32[C, M] (or none,
// M = 0; lane 4 is then meaningless and the wrapper drops it).
//
// klba_state_digest_rows digests N such states in one launch (the
// coalescer's wave: the JAX package vmaps state_digest_pallas over it): the
// inputs are [N, B], [N, B], [N, C] and [N, C, M], the rows on the grid's y
// axis, each row with its own scratch (accumulators, ticket, histogram) and
// its own int64[5] of the [N, 5] output.  No block reads another row's data,
// so each row's lanes are the one-row launch's, bit for bit.
//
// klba_state_digest_shard digests one row shard [lo, lo + Bs) of a state
// whose B rows are split over the devices of a mesh (the engine's placed
// resident state): lags int64[Bs] and choice int32[Bs] are the shard's own
// rows, counts int32[C] and row_tab int32[C, M] the replicated tables.  It
// writes the shard's PARTIAL lanes, int64[5]
//
//   part[0] = sum(lags of the shard)              part[1] = its violations
//   part[2] = sum of the global row ids i with 0 <= choice[i] < C
//   part[3] = sum(clamped valid-slot rows)        (lead shard only, else 0)
//   part[4] = #{valid slots whose clamped row r lies in [lo, lo + Bs) and
//              has choice[r] != c}
//           + #{valid slots with r outside [0, B)} + #{empty slots not
//              holding B}                          (these two: lead only)
//
// and the shard's occupancy histogram hist int32[C].  Summed over the
// shards (ops/refine.state_digest_sharded), part and hist give every lane
// of the one-device digest of the gathered state: out[0] = sum(counts),
// out[1] = part[1], out[2] = part[0], out[3] = |hist - counts|_1 and
// out[4] = part[4] + |part[3] - part[2]|.  Every clamped row falls in
// exactly one shard, so each valid slot's owner is checked once.  The
// kernel is the one-state kernel's body with the shard's row offset: the
// same per-block histograms merged per cluster; its last block copies the
// histogram out instead of taking the L1.
//
// What bounds it: bytes, and at the streaming engine's shapes the latency.
// At 100k partitions / 1k consumers (B = 131,072, M = 133) it reads 2.5 MB
// (lags 1 MB, choice 0.5 MB, the table 0.53 MB, the gathered choices of the
// valid slots 0.4 MB), 0.75 us at 3.35 TB/s: the launch and a chain of
// dependent memory round trips cost more than the bytes.  The design:
//   * one launch, no memset.  Every block adds its five 64-bit sums, and
//     every cluster its histogram, into global accumulators with integer
//     atomics;
//     the last block to arrive (a __threadfence and an integer ticket)
//     computes sum(counts) and the L1 distance of the histogram to counts,
//     writes the five lanes and re-zeroes the accumulators, the histogram
//     and the ticket, which the wrapper zeroed once.
//   * enough blocks for the work, on a full card: a thread takes four rows
//     at a time with 16-byte loads (lags as longlong2, choice as int4; a
//     ragged tail or an unaligned buffer one row at a time), a warp takes
//     one consumer row of the table (counts[c] read once, lanes over j, the
//     slots' loads and then their gathers issued in batches of kBatch, no
//     division).  A thread's first rows are loaded before its table walk,
//     so that their round trips overlap.
//   * a histogram in each block's shared memory, merged across a cluster of
//     kCluster blocks: after cluster.sync() block b of the cluster sums the
//     bins c = b (mod kCluster) over the cluster's blocks through
//     distributed shared memory and adds each nonzero one to the global
//     histogram, so a bin takes one global atomic a cluster, not a block.
//     Every global atomic is issued after the block's last cluster barrier
//     arrival, so no cluster barrier waits for one to complete.
//     (Adding each row straight into the bin's owner block through
//     distributed shared memory was slower on the H100: PERF.md §6.)
//   * above kMaxSharedBins consumers (57,856: an int32 bin each no longer
//     fits the 227 KB of shared memory a block may use) the histogram is
//     the global one in the scratch, which every row adds to with a global
//     atomic; there is no shared histogram and no cluster merge.  At that
//     width the rows spread over so many bins that the atomics rarely meet.
//     Every entry (one state, N rows, a shard) takes the same form at the
//     same C: the wrapper picks nothing, the launch picks by C alone.
// Integer addition is exact in any order, so the atomics give the same bits
// on every run; every sum is taken as unsigned long long, which wraps
// exactly as the JAX package's and numpy's int64 sums do.

#include <cstdint>
#include <mutex>
#include <tuple>
#include <utility>
#include <vector>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

// Most consumers whose int32 histogram a block's shared memory holds (the
// 227 KB a block may use, less 1 KB for the static shared memory).
constexpr int kMaxSharedBins = (232448 - 1024) / 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;
constexpr int kBatch = 8;  // table slots a lane loads before it gathers

// 64-bit words of the scratch buffer before the histogram: the five sums,
// then the ticket (an unsigned int in word kTicket).
enum { kLagSum = 0, kViol, kRowSum, kSlotSum, kBad, kNumAcc };
constexpr int kTicket = 7;
constexpr int kAccWords = 8;

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

struct Rows {
  unsigned long long lag_sum = 0, viol = 0, row_sum = 0;
};

// One row: its lag, its choice into the block's histogram.
__device__ __forceinline__ void add_row(Rows& v, unsigned* hist, int i, long long lag, int ch,
                                        int C) {
  v.lag_sum += static_cast<unsigned long long>(lag);
  if (ch < -1 || ch >= C) {
    v.viol += 1ULL;
  } else if (ch >= 0) {
    atomicAdd(hist + ch, 1u);
    v.row_sum += static_cast<unsigned long long>(i);
  }
}

// The digest of B rows, or (kShard) the partial lanes of the row shard
// [lo, lo + B) of a state of Bg rows; `lead` adds the replicated terms of
// the table.  The one-state entry passes lo = 0, Bg = B, lead = true.
// kShared: the histogram in each block's shared memory, merged per
// cluster; else the rows add straight into the global one.
template <bool kShard, bool kShared>
__device__ __forceinline__ void digest_body(const long long* __restrict__ lags,
                                            const int* __restrict__ choice,
                                            const int* __restrict__ counts,
                                            const int* __restrict__ row_tab, int B, int C, int M,
                                            int lo, int Bg, bool lead,
                                            unsigned long long* __restrict__ acc,
                                            long long* __restrict__ out, int* __restrict__ hist_out) {
  extern __shared__ unsigned sh_hist[];  // int32[C]
  __shared__ unsigned long long part[kNumAcc][kWarps];
  __shared__ bool last;
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  unsigned* hist = reinterpret_cast<unsigned*>(acc + kAccWords);
  unsigned* bins = kShared ? sh_hist : hist;  // where the rows add
  if constexpr (kShared) {
    for (int c = threadIdx.x; c < C; c += kThreads) sh_hist[c] = 0u;
  }

  const int tid = blockIdx.x * kThreads + threadIdx.x, n_threads = gridDim.x * kThreads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool vec = ((reinterpret_cast<uintptr_t>(lags) | reinterpret_cast<uintptr_t>(choice)) &
                    15) == 0;
  const int quads = vec ? B / 4 : 0;
  int4 ch = make_int4(0, 0, 0, 0);
  longlong2 l0 = make_longlong2(0, 0), l1 = make_longlong2(0, 0);
  if (tid < quads) {
    ch = __ldg(reinterpret_cast<const int4*>(choice) + tid);
    l0 = __ldg(reinterpret_cast<const longlong2*>(lags) + 2 * tid);
    l1 = __ldg(reinterpret_cast<const longlong2*>(lags) + 2 * tid + 1);
  }

  // The table: a warp a consumer row.
  unsigned long long slot_sum = 0, bad = 0;
  for (int c = tid >> 5; c < C && M > 0; c += n_threads >> 5) {
    const int k = min(__ldg(counts + c), M);
    const int* tab = row_tab + static_cast<size_t>(c) * M;
    for (int j0 = lane; j0 < M; j0 += 32 * kBatch) {
      int rt[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + 32 * u;
        rt[u] = j < M ? __ldg(tab + j) : Bg;
      }
      int owner[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int r = rt[u] < 0 ? 0 : (rt[u] >= Bg ? Bg - 1 : rt[u]);
        if constexpr (kShard) {
          // Only the rows of this shard are checked here.
          const bool mine = static_cast<unsigned>(r - lo) < static_cast<unsigned>(B);
          owner[u] = j0 + 32 * u < k && mine ? __ldg(choice + (r - lo)) : c;
        } else {
          owner[u] = j0 + 32 * u < k ? __ldg(choice + r) : c;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + 32 * u;
        if (j < k) {
          const int r = rt[u] < 0 ? 0 : (rt[u] >= Bg ? Bg - 1 : rt[u]);
          bad += static_cast<unsigned long long>(owner[u] != c);
          if (!kShard || lead) {
            bad += static_cast<unsigned long long>(rt[u] < 0 || rt[u] >= Bg);
            slot_sum += static_cast<unsigned long long>(r);
          }
        } else if (j < M && (!kShard || lead)) {
          bad += static_cast<unsigned long long>(rt[u] != Bg);
        }
      }
    }
  }

  __syncthreads();  // the block's bins are zero before any add
  const int base = kShard ? lo : 0;  // the global id of the shard's row 0
  Rows v;
  for (int q = tid; q < quads; q += n_threads) {
    if (q != tid) {
      ch = __ldg(reinterpret_cast<const int4*>(choice) + q);
      l0 = __ldg(reinterpret_cast<const longlong2*>(lags) + 2 * q);
      l1 = __ldg(reinterpret_cast<const longlong2*>(lags) + 2 * q + 1);
    }
    add_row(v, bins, base + 4 * q, l0.x, ch.x, C);
    add_row(v, bins, base + 4 * q + 1, l0.y, ch.y, C);
    add_row(v, bins, base + 4 * q + 2, l1.x, ch.z, C);
    add_row(v, bins, base + 4 * q + 3, l1.y, ch.w, C);
  }
  for (int i = 4 * quads + tid; i < B; i += n_threads)
    add_row(v, bins, base + i, __ldg(lags + i), __ldg(choice + i), C);

  // The sums: a warp's into shared memory, then the block's.
  unsigned long long sums[kNumAcc] = {v.lag_sum, v.viol, v.row_sum, slot_sum, bad};
#pragma unroll
  for (int k = 0; k < kNumAcc; ++k) {
    sums[k] = warp_sum(sums[k]);
    if (lane == 0) part[k][warp] = sums[k];
  }
  cluster.sync();  // every block's histogram is complete
  // Block `rank` of the cluster owns the bins c = rank (mod kCluster): it
  // sums them over the cluster's blocks into its own slots, which no other
  // block reads.
  if constexpr (kShared) {
    for (int c = rank + kCluster * threadIdx.x; c < C; c += kCluster * kThreads) {
      unsigned h[kCluster];
#pragma unroll
      for (int q = 0; q < kCluster; ++q) h[q] = *cluster.map_shared_rank(sh_hist + c, q);
      unsigned total = 0;
#pragma unroll
      for (int q = 0; q < kCluster; ++q) total += h[q];
      sh_hist[c] = total;
    }
  }
  // Done reading the other blocks' shared memory; the global atomics come
  // after this arrival, so the cluster barriers never wait for them.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  if (threadIdx.x < kNumAcc) {
    unsigned long long t = 0;
    for (int w = 0; w < kWarps; ++w) t += part[threadIdx.x][w];
    if (t) atomicAdd(&acc[threadIdx.x], t);
  }
  if constexpr (kShared) {
    for (int c = rank + kCluster * threadIdx.x; c < C; c += kCluster * kThreads)
      if (sh_hist[c]) atomicAdd(&hist[c], sh_hist[c]);
  }

  // The last block to arrive finishes the digest and re-zeroes the scratch.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(reinterpret_cast<unsigned*>(acc + kTicket), 1u) == gridDim.x - 1;
  __syncthreads();
  // No block leaves while another of its cluster may read its histogram.
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (!last) return;
  __threadfence();
  unsigned long long a[kNumAcc];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kNumAcc; ++k) a[k] = __ldcg(acc + k);
  }
  if constexpr (kShard) {
    // The shard's partial lanes and its histogram; the sums over the
    // shards finish the digest (see the header).
    for (int c = threadIdx.x; c < C; c += kThreads) {
      hist_out[c] = static_cast<int>(__ldcg(hist + c));
      hist[c] = 0u;
    }
    if (threadIdx.x == 0) {
      out[0] = static_cast<long long>(a[kLagSum]);
      out[1] = static_cast<long long>(a[kViol]);
      out[2] = static_cast<long long>(a[kRowSum]);
      out[3] = static_cast<long long>(a[kSlotSum]);
      out[4] = static_cast<long long>(a[kBad]);
#pragma unroll
      for (int k = 0; k < kNumAcc; ++k) acc[k] = 0ULL;
      acc[kTicket] = 0ULL;
    }
    return;
  }
  unsigned long long fin[2] = {0ULL, 0ULL};  // sum(counts), L1
#pragma unroll 4
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const long long k = counts[c];
    const long long d = static_cast<long long>(__ldcg(hist + c)) - k;
    hist[c] = 0u;
    fin[0] += static_cast<unsigned long long>(k);
    fin[1] += static_cast<unsigned long long>(d < 0 ? -d : d);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    fin[k] = warp_sum(fin[k]);
    if (lane == 0) part[k][warp] = fin[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    fin[0] = fin[1] = 0ULL;
    for (int w = 0; w < kWarps; ++w) {
      fin[0] += part[0][w];
      fin[1] += part[1][w];
    }
#pragma unroll
    for (int k = 0; k < kNumAcc; ++k) acc[k] = 0ULL;
    acc[kTicket] = 0ULL;
    // |slot_sum - row_sum| in wrapping int64, as jnp.abs gives it.
    const long long diff = static_cast<long long>(a[kSlotSum] - a[kRowSum]);
    const unsigned long long adiff = diff < 0 ? 0ULL - static_cast<unsigned long long>(diff)
                                              : static_cast<unsigned long long>(diff);
    out[0] = static_cast<long long>(fin[0]);
    out[1] = static_cast<long long>(a[kViol]);
    out[2] = static_cast<long long>(a[kLagSum]);
    out[3] = static_cast<long long>(fin[1]);
    out[4] = static_cast<long long>(a[kBad] + adiff);
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads) klba_state_digest_kernel(
    const long long* __restrict__ lags, const int* __restrict__ choice,
    const int* __restrict__ counts, const int* __restrict__ row_tab, int B, int C, int M,
    unsigned long long* __restrict__ acc, long long* __restrict__ out) {
  // This block's row of a batched launch (0 for one state): its inputs,
  // scratch and output lanes.
  const size_t row = blockIdx.y;
  digest_body<false, kShared>(lags + row * B, choice + row * B, counts + row * C,
                     row_tab != nullptr ? row_tab + row * C * static_cast<size_t>(M) : nullptr,
                     B, C, M, 0, B, true,
                     acc + row * (kAccWords + (static_cast<size_t>(C) + 1) / 2), out + row * 5,
                     nullptr);
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads) klba_state_digest_shard_kernel(
    const long long* __restrict__ lags, const int* __restrict__ choice,
    const int* __restrict__ counts, const int* __restrict__ row_tab, int Bs, int C, int M, int lo,
    int Bg, int lead, unsigned long long* __restrict__ acc, long long* __restrict__ part,
    int* __restrict__ hist) {
  digest_body<true, kShared>(lags, choice, counts, row_tab, Bs, C, M, lo, Bg, lead != 0, acc, part, hist);
}

// Clusters of `kernel` that fit on the current card at once with `smem`
// bytes of dynamic shared memory, found once a kernel, device and size (the
// first query for a kernel and device also lets the kernel take the
// largest shared histogram, kMaxSharedBins bins).
template <typename Kernel>
cudaError_t resident_clusters(Kernel kernel, size_t smem, int* clusters) {
  static std::mutex mu;
  static std::vector<std::tuple<const void*, int, size_t, int>> known;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  const void* fn = reinterpret_cast<const void*>(kernel);
  bool seen = false;
  for (const auto& [k, d, b, n] : known) {
    if (k != fn || d != device) continue;
    if (b == smem) return *clusters = n, cudaSuccess;
    seen = true;
  }
  if (!seen && (err = cudaFuncSetAttribute(kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kMaxSharedBins * static_cast<int>(sizeof(unsigned)))) !=
                   cudaSuccess)
    return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if ((err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg)) != cudaSuccess)
    return err;
  if (n < 1) return cudaErrorInvalidConfiguration;
  known.emplace_back(fn, device, smem, n);
  *clusters = n;
  return cudaSuccess;
}

// Launches the digest of N states on `stream` (see the header); returns the
// first CUDA error (0 = ok).  row_tab may be null with M = 0.  scratch: N
// rows of 8 * (8 + ceil(C / 2)) bytes, each the sums and the ticket, then
// the histogram (ops/state_digest_cuda.scratch_bytes), zero at the call and
// left zero.  out: int64[N, 5].  The grid: for each row a thread for four
// rows and a warp for a table row, in whole clusters, the rows together at
// most as many clusters as fit on the card at once (the grid-stride loops
// take the rest; a row gets at least one cluster).
int launch_rows(const void* lags, const void* choice, const void* counts, const void* row_tab,
                long long B, int C, int M, int N, void* scratch, void* out, void* stream) {
  if (B < 1 || B >= (1LL << 31) || C < 1 || M < 0 || N < 1 ||
      N > 65535 || (M > 0 && row_tab == nullptr) ||
      static_cast<long long>(C) * M >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool shared = C <= kMaxSharedBins;
  const auto kernel = shared ? klba_state_digest_kernel<true> : klba_state_digest_kernel<false>;
  const size_t smem = shared ? static_cast<size_t>(C) * sizeof(unsigned) : 0;
  int fit = 0;
  cudaError_t err = resident_clusters(kernel, smem, &fit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long work = (B + 3) / 4 > 32LL * C ? (B + 3) / 4 : 32LL * C;
  long long clusters = (work + kThreads * kCluster - 1) / (kThreads * kCluster);
  const long long share = fit / N > 1 ? fit / N : 1;
  if (clusters > share) clusters = share;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * kCluster), static_cast<unsigned>(N));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const long long*>(lags),
                           static_cast<const int*>(choice), static_cast<const int*>(counts),
                           static_cast<const int*>(row_tab), static_cast<int>(B), C, M,
                           static_cast<unsigned long long*>(scratch), static_cast<long long*>(out));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Launches the partial digest of one row shard on `stream`: the grid of a
// one-state launch of Bs rows (the whole table walked by every shard).
// scratch as launch_rows' one row; part int64[5], hist int32[C].
int launch_shard(const void* lags, const void* choice, const void* counts, const void* row_tab,
                 long long Bs, long long lo, long long Bg, int C, int M, int lead, void* scratch,
                 void* part, void* hist, void* stream) {
  if (Bs < 1 || lo < 0 || Bg >= (1LL << 31) || lo + Bs > Bg || C < 1 ||
      M < 1 || row_tab == nullptr || static_cast<long long>(C) * M >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool shared = C <= kMaxSharedBins;
  const auto kernel =
      shared ? klba_state_digest_shard_kernel<true> : klba_state_digest_shard_kernel<false>;
  const size_t smem = shared ? static_cast<size_t>(C) * sizeof(unsigned) : 0;
  int fit = 0;
  cudaError_t err = resident_clusters(kernel, smem, &fit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long work = (Bs + 3) / 4 > 32LL * C ? (Bs + 3) / 4 : 32LL * C;
  long long clusters = (work + kThreads * kCluster - 1) / (kThreads * kCluster);
  if (clusters > fit) clusters = fit;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * kCluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel,
                           static_cast<const long long*>(lags), static_cast<const int*>(choice),
                           static_cast<const int*>(counts), static_cast<const int*>(row_tab),
                           static_cast<int>(Bs), C, M, static_cast<int>(lo), static_cast<int>(Bg),
                           lead, static_cast<unsigned long long*>(scratch),
                           static_cast<long long*>(part), static_cast<int*>(hist));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One state: the digest into out int64[5].
extern "C" int klba_state_digest(const void* lags, const void* choice, const void* counts,
                                 const void* row_tab, long long B, int C, int M, void* scratch,
                                 void* out, void* stream) {
  return launch_rows(lags, choice, counts, row_tab, B, C, M, 1, scratch, out, stream);
}

// N states of one shape in one launch: out int64[N, 5].
extern "C" int klba_state_digest_rows(const void* lags, const void* choice, const void* counts,
                                      const void* row_tab, long long B, int C, int M, int N,
                                      void* scratch, void* out, void* stream) {
  return launch_rows(lags, choice, counts, row_tab, B, C, M, N, scratch, out, stream);
}

// One row shard [lo, lo + Bs) of a state of Bg rows: the partial lanes into
// part int64[5] and the shard's histogram into hist int32[C] (lead != 0
// adds the table's replicated terms; exactly one shard of a state is lead).
extern "C" int klba_state_digest_shard(const void* lags, const void* choice, const void* counts,
                                       const void* row_tab, long long Bs, long long lo,
                                       long long Bg, int C, int M, int lead, void* scratch,
                                       void* part, void* hist, void* stream) {
  return launch_shard(lags, choice, counts, row_tab, Bs, lo, Bg, C, M, lead, scratch, part, hist,
                      stream);
}

extern "C" const char* klba_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
