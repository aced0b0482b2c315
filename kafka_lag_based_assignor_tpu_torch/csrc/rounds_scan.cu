// Greedy round scan of the lag-based assignor, for Hopper (sm_90a).
//
// Replaces the TPU kernels kafka_lag_based_assignor_tpu/ops/rounds_pallas.py
// ::_rounds_kernel (int32 totals) and ::_rounds_kernel_wide (int64 totals as
// two int32 planes with a carry).  One int64 kernel covers both.
//
// What it computes: exactly ops/rounds_kernel.py::_rounds_body (the two-key
// form) or ::_rounds_body_packed (the packed form), round after round.  At
// the start of round r every consumer holds r partitions, so the j-th
// partition of the round (in processing order) goes to the consumer with the
// (j+1)-th smallest (total lag, consumer id).  A round is therefore: sort the
// C (total, id) slots ascending, seat the id at position j, add gain[j] to
// the slot at position j.
//
// Layout: gains int64[T, R, C] and valid uint8[T, R, C] (the sorted lags of
// each round's row and their validity), totals0 int64[C], choice
// int32[T, R, C], totals int64[T, C].  Grid = T: one block per topic, every
// topic starting from totals0.  The cross-topic "global" solve is the same
// kernel over [1, T*R, C] (the wrapper reshapes), so its totals carry across
// topics.
//
// What bounds it: its sequential depth, not bytes.  Each round is a full
// bitonic network over N = next_pow2(C) slots, log2(N) * (log2(N) + 1) / 2
// compare-exchange stages, each depending on the one before; at 100k
// partitions / 1k consumers that is 100 * 55 stages against 1.3 MB of
// device-memory traffic, in one block on one SM.  A round cannot be a merge
// of the seated slots into the rest: after round r slot j holds t_j + g_j
// with t ascending and g descending, which can be any order at all.  So the
// design shortens each stage instead:
//
// - The sort is slot_sort.cuh's network in one of its three forms (see its
//   header), by N: keys in registers, shuffles for the short strides,
//   shared memory (one barrier each) for the long ones.
//   * Registers, N <= 16,384 (rounds_scan_kernel, one instantiation a power
//     of two): one block, the whole round in its registers.
//   * Cluster, 16,384 < N <= 131,072 (rounds_scan_kernel_cluster, one
//     instantiation a power of two): one thread-block cluster of 16 blocks a
//     topic, block r holding positions r * N / 16 ... in registers; the
//     strides of N / 16 and more go through distributed shared memory, one
//     cluster barrier each (10 of a round's stages).  Each block loads its
//     own positions' gains and validity, seats them and writes its part of
//     the choice row, and scatters its own slots' totals at the end.
//   * Scratch, N > 131,072 (rounds_scan_kernel_wide, one instantiation a
//     key form for every N): the slots live in a per-block scratch of device
//     memory and each round is slot_sort.cuh's wide_sort; the round is
//     seated on the last level's chunks while their keys are still in
//     registers, and the totals are scattered back by id at the end.  The
//     wrapper allocates the scratch, T * N * 12 bytes.  It is bound by one
//     SM's throughput, not by the network's depth.
// - One key where it is admissible: the packed int64 (total << rank_bits) |
//   id, whose order is the (total, id) order, so a stage compares and moves
//   one 64-bit word instead of a word and an id; the gain is added as gain
//   << rank_bits.  The wrapper admits it (rank_bits > 0) when every valid
//   gain and every starting total is >= 0 and the largest reachable total is
//   below 2^(61 - rank_bits); otherwise the two-key (int64 total, int32 id)
//   network runs, the same template with the other key.
// - The next round's C gains and validity bytes are loaded into registers
//   (16-byte loads where the row allows) before this round's network starts
//   and read only after it, so no round waits on device memory; the choice
//   row is written K int32 at a time.  At 8,192 and 16,384 slots a block
//   (K 8 and 16 over 1,024 threads, 64 registers a thread) the round's gains
//   are read after its network instead, so that the keys stay in registers;
//   at 16,384 slots they spill all the same.
//
// Pad slots (positions >= C) hold a key above every real one (total
// INT64_MAX, or the packed ((INT64_MAX >> rank_bits) << rank_bits) | j) and
// id j >= C, so they sort after every real slot and never receive a gain.
// Validity is read from `valid`, never inferred from the gain, so a valid
// zero lag is never taken for padding.

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

// Most slots a call takes: the ids are int32 and the pad ids reach N - 1.
constexpr int kMaxLogWide = 30;

constexpr int kMaxDevices = 64;

template <int kLogN, bool kPacked>
struct Plan : klba::SlotPlan<kLogN, kPacked> {
  using Net = klba::SlotPlan<kLogN, kPacked>;
  static constexpr int kSmem = Net::kExchangeBytes;
  // Read the next round's gains during this round's network where the 64
  // registers a thread has at 1,024 threads hold them beside the keys.
  static constexpr bool kPrefetch = Net::kK <= 4;
};

// This thread's K gains and validity bytes of one round row, as loaded:
// fetch() issues the loads and decode() alone reads them, after the
// network, so that a warp does not wait for them where it issues them.
template <int K>
struct RowLoad {
  long long gain[K];
  unsigned valid[K];  // a byte each, or (vector loads) four to a word
};

// `vec`: C % K == 0 and the pointers aligned, so the K positions are all
// inside the row or all past it, and one 16-byte load takes two gains.
template <int K>
__device__ __forceinline__ void fetch(const long long* __restrict__ g,
                                      const unsigned char* __restrict__ v, int i0, int C,
                                      bool vec, RowLoad<K>& row) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    row.gain[k] = 0;
    row.valid[k] = 0;
  }
  if (vec && K > 1) {
    if (i0 >= C) return;
#pragma unroll
    for (int q = 0; q < K / 2; ++q) {
      const longlong2 w = __ldg(reinterpret_cast<const longlong2*>(g + i0) + q);
      row.gain[2 * q] = w.x;
      row.gain[2 * q + 1] = w.y;
    }
    if constexpr (K == 2) {
      row.valid[0] = __ldg(reinterpret_cast<const unsigned short*>(v + i0));
    } else if constexpr (K == 4) {
      row.valid[0] = __ldg(reinterpret_cast<const unsigned*>(v + i0));
    } else if constexpr (K == 8) {
      const uint2 w = __ldg(reinterpret_cast<const uint2*>(v + i0));
      row.valid[0] = w.x;
      row.valid[1] = w.y;
    } else {
#pragma unroll
      for (int q = 0; q < K / 16; ++q) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(v + i0) + q);
        row.valid[4 * q] = w.x;
        row.valid[4 * q + 1] = w.y;
        row.valid[4 * q + 2] = w.z;
        row.valid[4 * q + 3] = w.w;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (i0 + k < C) {
        row.gain[k] = __ldg(g + i0 + k);
        row.valid[k] = __ldg(v + i0 + k);
      }
    }
  }
}

// The gains, 0 where invalid; returns the validity as a bit mask.
template <int K>
__device__ __forceinline__ unsigned decode(const RowLoad<K>& row, bool vec,
                                           long long (&gain)[K]) {
  unsigned mask = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const unsigned ok =
        vec && K > 1 ? (row.valid[k / 4] >> (8 * (k % 4))) & 0xff : row.valid[k];
    gain[k] = ok ? row.gain[k] : 0;
    mask |= static_cast<unsigned>(ok != 0) << k;
  }
  return mask;
}

template <int K>
__device__ __forceinline__ void store_choice(int* __restrict__ c, int i0, int C, bool vec,
                                             const int (&cv)[K]) {
  if (vec && K > 1) {
    if (i0 < C) {
      if constexpr (K == 2) {
        *reinterpret_cast<int2*>(c + i0) = make_int2(cv[0], cv[1]);
      } else {
#pragma unroll
        for (int k = 0; k < K; k += 4)
          reinterpret_cast<int4*>(c + i0)[k >> 2] =
              make_int4(cv[k], cv[k + 1], cv[k + 2], cv[k + 3]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (i0 + k < C) c[i0 + k] = cv[k];
  }
}

template <int kLogN, bool kPacked>
__global__ void __launch_bounds__(Plan<kLogN, kPacked>::kThreads, 1)
    rounds_scan_kernel(const long long* __restrict__ gains,
                       const unsigned char* __restrict__ valid,
                       const long long* __restrict__ totals0, int* __restrict__ choice,
                       long long* __restrict__ totals_out, int R, int C, int rank_bits,
                       int vec) {
  using P = Plan<kLogN, kPacked>;
  constexpr int K = P::kK;
  extern __shared__ __align__(16) unsigned char smem[];
  const int buffers = P::kDouble ? 2 : 1;
  Exchange x{reinterpret_cast<long long*>(smem),
             reinterpret_cast<int*>(smem + static_cast<size_t>(buffers) * P::kSlots * 8), 0};

  const int i0 = threadIdx.x * K;
  const long long id_mask = (1LL << rank_bits) - 1;
  long long key[K];
  int id[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = i0 + k;
    id[k] = j;
    if constexpr (kPacked) {
      key[k] = j < C ? (totals0[j] << rank_bits) | j
                     : ((LLONG_MAX >> rank_bits) << rank_bits) | j;
    } else {
      key[k] = j < C ? totals0[j] : LLONG_MAX;
    }
  }

  const long long first = static_cast<long long>(blockIdx.x) * R;  // first row
  RowLoad<K> cur, next;
  if (P::kPrefetch && R > 0)
    fetch<K>(gains + first * C, valid + first * C, i0, C, vec != 0, cur);
  if constexpr (P::kPrefetch) next = cur;

  for (int r = 0; r < R; ++r) {
    const long long row = (first + r) * C;
    if constexpr (P::kPrefetch) {
      if (r + 1 < R) fetch<K>(gains + row + C, valid + row + C, i0, C, vec != 0, next);
    }
    klba::sort_slots<P>(key, id, x);
    if constexpr (!P::kPrefetch) fetch<K>(gains + row, valid + row, i0, C, vec != 0, cur);
    long long gain[K];
    const unsigned mask = decode<K>(cur, vec != 0, gain);
    int cv[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int who = kPacked ? static_cast<int>(key[k] & id_mask) : id[k];
      cv[k] = (mask >> k) & 1 ? who : -1;
      key[k] += kPacked ? gain[k] << rank_bits : gain[k];
    }
    store_choice<K>(choice + row, i0, C, vec != 0, cv);
    if constexpr (P::kPrefetch) cur = next;
  }

  // Positions < C hold the real slots, in the last round's order: scatter
  // the totals back to consumer order (this replaces the Pallas path's
  // final sort by id).
  long long* out = totals_out + static_cast<long long>(blockIdx.x) * C;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (i0 + k < C) {
      if constexpr (kPacked) {
        out[key[k] & id_mask] = key[k] >> rank_bits;
      } else {
        out[id[k]] = key[k];
      }
    }
  }
}

// The round scan over N = 2^kLogN slots, kMaxSlots < N <= kMaxClusterSlots,
// on one cluster of ClusterPlan::kBlocks blocks a topic (grid = T * blocks):
// the same rounds as rounds_scan_kernel, block r holding positions r * N /
// blocks ... of each, sorted by cluster_sort.
template <int kLogN, bool kPacked>
__global__ void __launch_bounds__(klba::ClusterPlan<kLogN, kPacked>::Block::kThreads, 1)
    rounds_scan_kernel_cluster(const long long* __restrict__ gains,
                               const unsigned char* __restrict__ valid,
                               const long long* __restrict__ totals0, int* __restrict__ choice,
                               long long* __restrict__ totals_out, int R, int C, int rank_bits,
                               int vec) {
  using CP = klba::ClusterPlan<kLogN, kPacked>;
  using P = typename CP::Block;
  constexpr int K = P::kK;
  constexpr bool kPrefetch = K <= 4;  // as Plan::kPrefetch
  extern __shared__ __align__(16) unsigned char smem[];
  Exchange x{reinterpret_cast<long long*>(smem),
             reinterpret_cast<int*>(smem + static_cast<size_t>(2) * P::kSlots * 8), 0};

  const unsigned rank = cooperative_groups::this_cluster().block_rank();
  const int topic = static_cast<int>(blockIdx.x) >> CP::kLogBlocks;
  const int i0 = static_cast<int>(rank) * P::kSlots + static_cast<int>(threadIdx.x) * K;
  const long long id_mask = (1LL << rank_bits) - 1;
  long long key[K];
  int id[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = i0 + k;
    id[k] = j;
    if constexpr (kPacked) {
      key[k] = j < C ? (totals0[j] << rank_bits) | j
                     : ((LLONG_MAX >> rank_bits) << rank_bits) | j;
    } else {
      key[k] = j < C ? totals0[j] : LLONG_MAX;
    }
  }

  const long long first = static_cast<long long>(topic) * R;  // first row
  RowLoad<K> cur, next;
  if (kPrefetch && R > 0)
    fetch<K>(gains + first * C, valid + first * C, i0, C, vec != 0, cur);
  if constexpr (kPrefetch) next = cur;

  for (int r = 0; r < R; ++r) {
    const long long row = (first + r) * C;
    if constexpr (kPrefetch) {
      if (r + 1 < R) fetch<K>(gains + row + C, valid + row + C, i0, C, vec != 0, next);
    }
    klba::cluster_sort<CP>(key, id, x, rank);
    if constexpr (!kPrefetch) fetch<K>(gains + row, valid + row, i0, C, vec != 0, cur);
    long long gain[K];
    const unsigned mask = decode<K>(cur, vec != 0, gain);
    int cv[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int who = kPacked ? static_cast<int>(key[k] & id_mask) : id[k];
      cv[k] = (mask >> k) & 1 ? who : -1;
      key[k] += kPacked ? gain[k] << rank_bits : gain[k];
    }
    store_choice<K>(choice + row, i0, C, vec != 0, cv);
    if constexpr (kPrefetch) cur = next;
  }

  // This block's positions < C, in the last round's order, to consumer
  // order.
  long long* out = totals_out + static_cast<long long>(topic) * C;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (i0 + k < C) {
      if constexpr (kPacked) {
        out[key[k] & id_mask] = key[k] >> rank_bits;
      } else {
        out[id[k]] = key[k];
      }
    }
  }
  // No block's shared memory goes while a partner may still read it.
  klba::cluster_arrive();
  klba::cluster_wait();
}

// The round scan over N = 2^log_n > kMaxClusterSlots slots, kept in the block's
// scratch (keys [T, N], ids [T, N]): the same rounds as
// rounds_scan_kernel, each sorted by wide_sort and seated on the chunks of
// its last level.
template <bool kPacked>
__global__ void __launch_bounds__(klba::ChunkPlan<kPacked>::kThreads, 1)
    rounds_scan_kernel_wide(const long long* __restrict__ gains,
                            const unsigned char* __restrict__ valid,
                            const long long* __restrict__ totals0, int* __restrict__ choice,
                            long long* __restrict__ totals_out, int R, int C, int rank_bits,
                            int vec, int log_n, long long* scratch_key, int* scratch_id) {
  using P = klba::ChunkPlan<kPacked>;
  constexpr int K = P::kK;
  extern __shared__ __align__(16) unsigned char smem[];
  const int buffers = P::kDouble ? 2 : 1;
  Exchange x{reinterpret_cast<long long*>(smem),
             reinterpret_cast<int*>(smem + static_cast<size_t>(buffers) * P::kSlots * 8), 0};
  const long long N = 1LL << log_n;
  const klba::WideSlots w{scratch_key + static_cast<long long>(blockIdx.x) * N,
                          scratch_id + static_cast<long long>(blockIdx.x) * N, log_n};
  const long long id_mask = (1LL << rank_bits) - 1;
  for (long long j = threadIdx.x; j < N; j += blockDim.x) {
    if constexpr (kPacked) {
      w.key[j] = j < C ? (totals0[j] << rank_bits) | j
                       : ((LLONG_MAX >> rank_bits) << rank_bits) | j;
    } else {
      w.key[j] = j < C ? totals0[j] : LLONG_MAX;
      w.id[j] = static_cast<int>(j);
    }
  }

  const long long first = static_cast<long long>(blockIdx.x) * R;  // first row
  for (int r = 0; r < R; ++r) {
    const long long row = (first + r) * C;
    klba::wide_sort<kPacked>(w, x, [&](long long chunk, long long (&key)[K], int (&id)[K]) {
      // Positions chunk * kMaxSlots + t * K + k, all below N <= 2^30.
      const int i0 = static_cast<int>(chunk * P::kSlots) + static_cast<int>(threadIdx.x) * K;
      RowLoad<K> cur;
      fetch<K>(gains + row, valid + row, i0, C, vec != 0, cur);
      long long gain[K];
      const unsigned mask = decode<K>(cur, vec != 0, gain);
      int cv[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int who = kPacked ? static_cast<int>(key[k] & id_mask) : id[k];
        cv[k] = (mask >> k) & 1 ? who : -1;
        key[k] += kPacked ? gain[k] << rank_bits : gain[k];
      }
      store_choice<K>(choice + row, i0, C, vec != 0, cv);
    });
  }

  // Positions < C hold the real slots, in the last round's order.
  __syncthreads();
  long long* out = totals_out + static_cast<long long>(blockIdx.x) * C;
  for (long long j = threadIdx.x; j < C; j += blockDim.x) {
    const long long k = w.key[j];
    if constexpr (kPacked) {
      out[k & id_mask] = k >> rank_bits;
    } else {
      out[w.id[j]] = k;
    }
  }
}

struct Instance {
  const void* fn;
  int threads;
  int k;
  int smem;
  int blocks;  // of a cluster; 1 for the register and scratch forms
};

template <int kLogN, bool kPacked>
Instance cluster_instance() {
  using P = typename klba::ClusterPlan<kLogN, kPacked>::Block;
  return {reinterpret_cast<const void*>(rounds_scan_kernel_cluster<kLogN, kPacked>),
          P::kThreads, P::kK, P::kExchangeBytes, klba::ClusterPlan<kLogN, kPacked>::kBlocks};
}

constexpr int kClusterForms = kMaxLogCluster - kMaxLogSlots;

// One instantiation a slot count 2^0 ... 2^14, one a slot count 2^15 ...
// 2^17 of the cluster form, then the scratch form's.
template <bool kPacked, int... Ls, int... Cs>
const Instance* instances(std::integer_sequence<int, Ls...>,
                          std::integer_sequence<int, Cs...>) {
  using W = Plan<kMaxLogSlots, kPacked>;  // the scratch form's chunk network
  static const Instance table[] = {
      {reinterpret_cast<const void*>(rounds_scan_kernel<Ls, kPacked>),
       Plan<Ls, kPacked>::kThreads, Plan<Ls, kPacked>::kK, Plan<Ls, kPacked>::kSmem, 1}...,
      cluster_instance<kMaxLogSlots + 1 + Cs, kPacked>()...,
      {reinterpret_cast<const void*>(rounds_scan_kernel_wide<kPacked>), W::kThreads, W::kK,
       W::kSmem, 1}};
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
// dynamic shared-memory limit could be raised to what it uses, whatever C
// the first call has, and, for each cluster form, whether it is launchable
// and the device holds one of its clusters.  A form that fails keeps its
// error; the other forms still launch.
struct Limits {
  cudaError_t form[2][kMaxLogCluster + 2];
};

void set_smem_limits(Limits& out) {
  for (int packed = 0; packed < 2; ++packed) {
    for (int log_n = 0; log_n <= kMaxLogCluster + 1; ++log_n) {
      const Instance& in = instance(log_n, packed != 0);
      cudaError_t err = cudaSuccess;
      if (in.blocks > 1) {
        err = klba::prepare_cluster(in.fn, in.blocks, in.threads, in.smem);
      } else if (in.smem > 48 * 1024) {
        err = cudaFuncSetAttribute(in.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, in.smem);
      }
      out.form[packed][log_n] = err;
    }
  }
}

int log2_of(int n) {
  int l = 0;
  while ((1 << l) < n) ++l;
  return l;
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

bool bad_slots(int C, int c_pad) {
  return C < 1 || c_pad < C || c_pad > (1 << kMaxLogWide) || (c_pad & (c_pad - 1));
}

// Whether a launch moves its rows with vector loads and stores: C a multiple
// of the slots a thread and every row aligned for them.
int vector_io(int k, const void* gains, const void* valid, const void* choice, int C) {
  return k > 1 && C % k == 0 && aligned(gains, 16) && aligned(valid, k < 16 ? k : 16) &&
         aligned(choice, 4 * k < 16 ? 4 * k : 16);
}

}  // namespace

// Launches the round scan on `stream`; returns the CUDA error (0 = ok).
// T topics, each over R rounds of C consumers; c_pad = next_pow2(C).
// rank_bits > 0 runs the packed key (the caller has checked that the
// shifted totals fit, and c_pad <= 2^rank_bits), 0 the two-key network.
// Up to 16,384 slots a topic is one block; up to 131,072 one cluster of
// blocks (a device that cannot hold one gives its error); above, one block
// whose slots are in `scratch`, T * c_pad * 12 bytes (the keys, then the
// ids), which the kernel overwrites.  Below 131,072 slots `scratch` is not
// read.
extern "C" int klba_rounds_scan(const void* gains, const void* valid,
                                const void* totals0, void* choice,
                                void* totals_out, int T, int R, int C,
                                int c_pad, int rank_bits, void* scratch, void* stream) {
  if (T < 1 || R < 0 || bad_slots(C, c_pad) || rank_bits < 0 || rank_bits > 61 ||
      (rank_bits > 0 && c_pad > (1LL << rank_bits)) ||
      (c_pad > kMaxClusterSlots && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  static std::once_flag once[kMaxDevices];
  static Limits limits[kMaxDevices];
  std::call_once(once[device], [device] { set_smem_limits(limits[device]); });

  int log_n = log2_of(c_pad);
  const Instance& in = instance(log_n, rank_bits > 0);
  err = limits[device].form[rank_bits > 0][form_of(log_n)];
  if (err != cudaSuccess) return static_cast<int>(err);
  int vec = vector_io(in.k, gains, valid, choice, C);
  const long long* g = static_cast<const long long*>(gains);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  const long long* t0 = static_cast<const long long*>(totals0);
  int* ch = static_cast<int*>(choice);
  long long* out = static_cast<long long*>(totals_out);
  long long* sk = static_cast<long long*>(scratch);
  int* si = log_n > kMaxLogCluster
                ? reinterpret_cast<int*>(sk + static_cast<long long>(T) * c_pad)
                : nullptr;
  void* args[] = {&g, &v, &t0, &ch, &out, &R, &C, &rank_bits, &vec, &log_n, &sk, &si};
  void* narrow[] = {&g, &v, &t0, &ch, &out, &R, &C, &rank_bits, &vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in.blocks > 1) {
    err = klba::launch_cluster(in.fn, T, in.blocks, in.threads, in.smem, narrow, s);
  } else {
    err = cudaLaunchKernel(in.fn, dim3(T), dim3(in.threads),
                           log_n > kMaxLogCluster ? args : narrow, in.smem, s);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// 1 where klba_rounds_scan on these pointers moves its rows with vector
// loads and stores, 0 where it moves one slot at a time, -1 for a bad c_pad.
extern "C" int klba_rounds_scan_vector_io(const void* gains, const void* valid,
                                          const void* choice, int C, int c_pad) {
  if (bad_slots(C, c_pad)) return -1;
  return vector_io(instance(log2_of(c_pad), false).k, gains, valid, choice, C);
}

extern "C" const char* klba_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
