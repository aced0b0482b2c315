// The ascending bitonic network over a block's slots, for Hopper (sm_90a).
// Shared by rounds_scan.cu (K1/K2: the round scan) and scan_greedy.cu (K7:
// the P-step greedy scan, computed as rounds).
//
// N = 2^kLogN slots, each an int64 key and an int32 id (the two-key form,
// compared as (key, id)) or one packed int64 key whose low bits hold the id
// (the packed form, compared as one word).  The keys live in registers in a
// blocked layout: thread t holds the K consecutive sorted positions t*K ..
// t*K+K-1 (slots_per_thread).  A stage of stride j < K runs inside the
// thread's registers; a stride from K to 16*K is one __shfl_xor_sync with
// lane ^ (j / K) at the same register index; only strides of 32*K and more
// go through shared memory, one block barrier each (the exchange buffer is
// double-buffered where it fits, so no second barrier guards its reuse).
// The network is the all-ascending form (each merge starts by pairing slot
// i with its mirror), so no stage computes a direction.  K is 2 up to
// 2,048 slots: a stage is a short dependent chain (shuffle, compare,
// select), and on one SM more warps hide it better than more slots a thread
// do (at 1,024 slots K 2 over 16 warps ran faster than K 4 over 8, K 8 over
// 4 and K 1 over 32 with its 15 barriers).  At 1,024 slots that is 10
// register, 35 shuffle and 10 barrier stages, against 55 barriers for a
// network through shared memory; at 64 slots (one warp) no barrier at all.
// Every register index is a constant after unrolling: the network is a
// template on log2(N).
//
// Three forms, by N = next_pow2(C):
//
// - Registers, N <= kMaxSlots (16,384): one block holds the slots
//   (sort_slots).  Bound by its depth: log2(N) * (log2(N) + 1) / 2
//   dependent stages, each a shuffle or one block barrier.
// - Cluster, kMaxSlots < N <= kMaxClusterSlots (131,072): a thread-block
//   cluster of S = 2^kClusterLogBlocks = 16 blocks holds them, block
//   r the N / S slots r * N / S ... in registers, in the same blocked layout
//   (cluster_sort).  A stage of a stride below N / S runs inside each block
//   as in the register form; a stage of a stride of N / S or more (log2 S
//   * (log2 S + 1) / 2 of them a sort: 10 at 16 blocks) goes through
//   distributed shared memory: each block writes its keys into its own
//   exchange buffer, one cluster barrier, and each reads its partner's.  Bound
//   by the same depth: a stage inside a block is a shuffle or a block
//   barrier, a cross-block stage a cluster barrier and a read of another
//   SM's shared memory.
// - Scratch, N > kMaxClusterSlots (up to 2^30): one block keeps its N slots
//   in a scratch of device memory (int64 keys, int32 ids: 12 B a slot, 3 MB
//   at 2^18, which stays in the 50 MB L2) and runs the same all-ascending
//   network in three kinds of step (wide_sort).  Each 16,384-slot chunk is
//   loaded into the registers of the 16,384-slot network and sorted there
//   (the levels of merge size up to 2^14 never leave a chunk); each stage of
//   stride 2^14 or more is a compare-exchange pass over the scratch, one
//   barrier after it; and each level ends with a merge-only entry into the
//   register network, its last 14 stages, one chunk at a time.  Every index
//   into the scratch is 64-bit.  Bound by one SM's throughput: each round
//   moves the scratch through L2 about five times.

#pragma once

#include <utility>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace klba {

constexpr int kMaxLogSlots = 14;
constexpr int kMaxSlots = 1 << kMaxLogSlots;
// Most slots of the cluster form; above them the scratch form.
constexpr int kMaxLogCluster = 17;
constexpr int kMaxClusterSlots = 1 << kMaxLogCluster;
// Dynamic shared memory a block may use on Hopper (227 KB).
constexpr int kSmemPerBlock = 232448;

// Slots a thread holds (K) for 2^log_n slots: 2, so that as many warps as
// possible hide each other's latency, until 1,024 threads hold them all.
__host__ __device__ constexpr int slots_per_thread(int log_n) {
  return log_n == 0 ? 1 : log_n <= 11 ? 2 : 1 << (log_n - 10);
}

// The network's geometry for 2^kLogN slots in one key form.
template <int kLogN, bool kPacked_>
struct SlotPlan {
  static constexpr int kLog = kLogN;
  static constexpr bool kPacked = kPacked_;
  static constexpr int kSlots = 1 << kLogN;
  static constexpr int kK = slots_per_thread(kLogN);
  static constexpr int kThreads = kSlots / kK;
  static constexpr int kSlotBytes = kPacked ? 8 : 12;
  // Two exchange buffers (one barrier a stage) where they fit, else one.
  static constexpr bool kDouble = 2 * kSlots * kSlotBytes <= kSmemPerBlock;
  static constexpr int kExchangeBytes =
      kThreads <= 32 ? 0 : (kDouble ? 2 : 1) * kSlots * kSlotBytes;
  static constexpr unsigned kLanes =
      kThreads >= 32 ? 0xffffffffu : (1u << kThreads) - 1u;
};

template <class F, int... Is>
__device__ __forceinline__ void static_for_impl(F&& f,
                                                std::integer_sequence<int, Is...>) {
  (f(std::integral_constant<int, Is>{}), ...);
}

// f(integral_constant<int, 0>) ... f(integral_constant<int, N - 1>).
template <int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_impl(f, std::make_integer_sequence<int, N>{});
}

// (key a, id a) < (key b, id b): the packed key alone, or key then id.
template <bool kPacked>
__device__ __forceinline__ bool less(long long ka, int ia, long long kb, int ib) {
  if constexpr (kPacked) {
    return ka < kb;
  } else {
    return ka < kb || (ka == kb && ia < ib);
  }
}

struct Exchange {
  long long* key;  // [buffers][N]
  int* id;         // [buffers][N], two-key form only
  int sel;         // the buffer the next barrier stage writes
};

template <int K>
__device__ __forceinline__ void put_keys(long long* dst, const long long (&v)[K]) {
  if constexpr (K == 1) {
    dst[0] = v[0];
  } else {
#pragma unroll
    for (int k = 0; k < K; k += 2)
      reinterpret_cast<longlong2*>(dst)[k >> 1] = make_longlong2(v[k], v[k + 1]);
  }
}

template <int K>
__device__ __forceinline__ void get_keys(const long long* src, long long (&v)[K]) {
  if constexpr (K == 1) {
    v[0] = src[0];
  } else {
#pragma unroll
    for (int k = 0; k < K; k += 2) {
      const longlong2 w = reinterpret_cast<const longlong2*>(src)[k >> 1];
      v[k] = w.x;
      v[k + 1] = w.y;
    }
  }
}

template <int K>
__device__ __forceinline__ void put_ids(int* dst, const int (&v)[K]) {
  if constexpr (K == 1) {
    dst[0] = v[0];
  } else if constexpr (K == 2) {
    *reinterpret_cast<int2*>(dst) = make_int2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < K; k += 4)
      reinterpret_cast<int4*>(dst)[k >> 2] = make_int4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  }
}

template <int K>
__device__ __forceinline__ void get_ids(const int* src, int (&v)[K]) {
  if constexpr (K == 1) {
    v[0] = src[0];
  } else if constexpr (K == 2) {
    const int2 w = *reinterpret_cast<const int2*>(src);
    v[0] = w.x;
    v[1] = w.y;
  } else {
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      const int4 w = reinterpret_cast<const int4*>(src)[k >> 2];
      v[k] = w.x;
      v[k + 1] = w.y;
      v[k + 2] = w.z;
      v[k + 3] = w.w;
    }
  }
}

// One stage of the bitonic network, in its all-ascending form: merge size
// 2^kLS, stride 2^kLJ.  The first stage of a merge pairs slot i with its
// mirror i ^ (size - 1), every later one with i ^ stride; in each pair the
// lower slot (i & stride == 0) keeps the smaller key.  So no slot needs a
// direction, and a thread's partner in another thread is always the same
// register index (reversed in a mirror stage).  Keys are distinct (ids
// differ), so "take the partner's" is exactly "partner < mine" == "I keep
// the smaller".
template <class P, int kLS, int kLJ>
__device__ __forceinline__ void stage(long long (&key)[P::kK], int (&id)[P::kK],
                                      Exchange& x) {
  constexpr bool kPacked = P::kPacked;
  constexpr int K = P::kK;
  constexpr int kStride = 1 << kLJ;
  constexpr bool kMirror = kLJ + 1 == kLS;
  constexpr int kFlip = kMirror ? (1 << kLS) - 1 : kStride;  // partner = i ^ kFlip
  const int t = threadIdx.x;

  if constexpr (kStride < K) {
    static_for<K>([&](auto kc) {
      constexpr int lo = decltype(kc)::value;
      if constexpr ((lo & kStride) == 0) {
        constexpr int hi = lo ^ kFlip;
        const bool swap = less<kPacked>(key[hi], id[hi], key[lo], id[lo]);
        const long long k0 = key[lo], k1 = key[hi];
        key[lo] = swap ? k1 : k0;
        key[hi] = swap ? k0 : k1;
        if constexpr (!kPacked) {
          const int i0 = id[lo], i1 = id[hi];
          id[lo] = swap ? i1 : i0;
          id[hi] = swap ? i0 : i1;
        }
      }
    });
    return;
  }
  // The partner's keys for each of this thread's K slots.
  long long yk[K];
  int yi[K];
  if constexpr (kStride < 32 * K) {
    constexpr int m = kFlip / K;  // partner lane = lane ^ m
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int src = kMirror ? K - 1 - k : k;
      yk[k] = __shfl_xor_sync(P::kLanes, key[src], m);
      if constexpr (!kPacked) yi[k] = __shfl_xor_sync(P::kLanes, id[src], m);
    }
  } else {
    if constexpr (!P::kDouble) __syncthreads();  // one buffer: readers done
    long long* kb = x.key + x.sel * P::kSlots;
    int* ib = x.id + x.sel * P::kSlots;
    put_keys<K>(kb + t * K, key);
    if constexpr (!kPacked) put_ids<K>(ib + t * K, id);
    __syncthreads();
    const int partner = (t ^ (kFlip / K)) * K;
    long long pk[K];
    int pi[K];
    get_keys<K>(kb + partner, pk);
    if constexpr (!kPacked) get_ids<K>(ib + partner, pi);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      yk[k] = pk[kMirror ? K - 1 - k : k];
      if constexpr (!kPacked) yi[k] = pi[kMirror ? K - 1 - k : k];
    }
    if constexpr (P::kDouble) x.sel ^= 1;
  }
  const bool keep_min = (t & (kStride / K)) == 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool take = less<kPacked>(yk[k], kPacked ? 0 : yi[k], key[k], id[k]) == keep_min;
    key[k] = take ? yk[k] : key[k];
    if constexpr (!kPacked) id[k] = take ? yi[k] : id[k];
  }
}

// The whole ascending bitonic network over P::kSlots slots, every stage
// unrolled, run by P::kThreads threads.  Above one warp they are the whole
// block (its barriers count every thread); below it, the warp's other
// lanes may sit it out (it has no barrier there).
template <class P>
__device__ __forceinline__ void sort_slots(long long (&key)[P::kK], int (&id)[P::kK],
                                           Exchange& x) {
  static_for<P::kLog>([&](auto a) {
    constexpr int ls = decltype(a)::value + 1;
    static_for<ls>([&](auto b) {
      stage<P, ls, ls - 1 - decltype(b)::value>(key, id, x);
    });
  });
}

// The last P::kLog stages of a merge larger than P::kSlots (strides
// P::kSlots / 2 down to 1, none a mirror): what is left of a level of the
// wide form once its long strides have run over the scratch.
template <class P>
__device__ __forceinline__ void merge_slots(long long (&key)[P::kK], int (&id)[P::kK],
                                            Exchange& x) {
  static_for<P::kLog>([&](auto b) {
    stage<P, P::kLog + 1, P::kLog - 1 - decltype(b)::value>(key, id, x);
  });
}

// The wide form's chunk network: the 16,384-slot plan, 16 slots a thread
// over 1,024 threads.
template <bool kPacked>
using ChunkPlan = SlotPlan<kMaxLogSlots, kPacked>;

// A block's slots in the wide form: key[N] and (two-key form) id[N] in
// device memory, N = 2^log_n > kMaxSlots.  In the packed form the id is
// the key's low bits and `id` is not read.
struct WideSlots {
  long long* key;
  int* id;
  int log_n;
};

template <class P>
__device__ __forceinline__ void load_chunk(const WideSlots& w, long long chunk,
                                           long long (&key)[P::kK], int (&id)[P::kK]) {
  const long long at = chunk * P::kSlots + static_cast<long long>(threadIdx.x) * P::kK;
  get_keys<P::kK>(w.key + at, key);
  if constexpr (!P::kPacked) get_ids<P::kK>(w.id + at, id);
}

template <class P>
__device__ __forceinline__ void store_chunk(const WideSlots& w, long long chunk,
                                            const long long (&key)[P::kK],
                                            const int (&id)[P::kK]) {
  const long long at = chunk * P::kSlots + static_cast<long long>(threadIdx.x) * P::kK;
  put_keys<P::kK>(w.key + at, key);
  if constexpr (!P::kPacked) put_ids<P::kK>(w.id + at, id);
}

// One stage of stride 2^lj >= kMaxSlots over the scratch, in the
// all-ascending form of `stage` (the first stage of merge size 2^ls pairs
// slot i with its mirror): the block's threads take the N / 2 pairs in
// turn, the lower slot keeping the smaller key.
template <bool kPacked>
__device__ __forceinline__ void wide_stage(const WideSlots& w, int ls, int lj) {
  const long long half = 1LL << (w.log_n - 1);
  const long long stride = 1LL << lj;
  const long long flip = lj + 1 == ls ? (1LL << ls) - 1 : stride;
  for (long long q = threadIdx.x; q < half; q += blockDim.x) {
    const long long lo = ((q >> lj) << (lj + 1)) | (q & (stride - 1));
    const long long hi = lo ^ flip;
    const long long kl = w.key[lo], kh = w.key[hi];
    const int il = kPacked ? 0 : w.id[lo], ih = kPacked ? 0 : w.id[hi];
    if (less<kPacked>(kh, ih, kl, il)) {
      w.key[lo] = kh;
      w.key[hi] = kl;
      if constexpr (!kPacked) {
        w.id[lo] = ih;
        w.id[hi] = il;
      }
    }
  }
}

// The ascending sort of a block's 2^log_n > kMaxSlots slots in the scratch
// (see the header), run by all 1,024 threads of the block.  The slots may
// have been written by any thread before the call; after it every thread
// sees the sorted scratch.  at_end(chunk, key, id) runs on each chunk of
// the last level with its keys at their final positions (thread t holds
// positions chunk * kMaxSlots + t * 16 + k) before they are stored back,
// so that the caller can seat a round there without another pass.
template <bool kPacked, class AtEnd>
__device__ __forceinline__ void wide_sort(const WideSlots& w, Exchange& x, AtEnd&& at_end) {
  using P = ChunkPlan<kPacked>;
  const long long chunks = 1LL << (w.log_n - P::kLog);
  long long key[P::kK];
  int id[P::kK];
#pragma unroll
  for (int k = 0; k < P::kK; ++k) id[k] = 0;
  __syncthreads();
  for (long long c = 0; c < chunks; ++c) {
    load_chunk<P>(w, c, key, id);
    sort_slots<P>(key, id, x);
    store_chunk<P>(w, c, key, id);
  }
  for (int ls = P::kLog + 1; ls <= w.log_n; ++ls) {
    for (int lj = ls - 1; lj >= P::kLog; --lj) {
      __syncthreads();
      wide_stage<kPacked>(w, ls, lj);
    }
    __syncthreads();
    for (long long c = 0; c < chunks; ++c) {
      load_chunk<P>(w, c, key, id);
      merge_slots<P>(key, id, x);
      if (ls == w.log_n) at_end(c, key, id);
      store_chunk<P>(w, c, key, id);
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The cluster form.

// log2 of the blocks of a cluster: 16 at every slot count.  8 blocks (2 or
// 4 times the slots a thread, 6 cluster stages a sort instead of 10) took
// 1.7x as long a round at 2^15 and 2.0x at 2^16 on the H100: the block-local
// stages, not the cluster barriers, hold most of a round.
constexpr int kClusterLogBlocks = 4;

// The cluster form's geometry for 2^kLogN slots: kBlocks blocks, each the
// register network's plan over its 2^kLogN / kBlocks slots.
template <int kLogN, bool kPacked>
struct ClusterPlan {
  static constexpr int kLogBlocks = kClusterLogBlocks;
  static constexpr int kBlocks = 1 << kLogBlocks;
  using Block = SlotPlan<kLogN - kLogBlocks, kPacked>;
  // One cluster barrier a cross-block stage needs two buffers; cluster_sort
  // takes the first local stage after the cross-block ones (stride half a
  // block's share) to go through shared memory: at least 64 threads.
  static_assert(Block::kDouble && Block::kThreads >= 64, "the cluster form's block");
};

// The two halves of a cluster barrier, every thread of every block of the
// cluster: what a thread wrote to shared memory before it arrives is seen by
// every thread that has waited.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// One stage of stride 2^lj >= P::kSlots across the blocks of a cluster, in
// the all-ascending form of `stage`: each block writes its slots to its own
// exchange buffer, one cluster barrier, and each thread reads its partner's
// K slots from the partner block's buffer (the same thread and register
// index, or in the mirror stage the reversed thread and register index) and
// keeps the smaller or the larger of each pair.
template <class P, bool kMirror>
__device__ __forceinline__ void cluster_stage(long long (&key)[P::kK], int (&id)[P::kK],
                                              Exchange& x, unsigned partner, bool keep_min) {
  constexpr bool kPacked = P::kPacked;
  constexpr int K = P::kK;
  const int t = threadIdx.x;
  long long* kb = x.key + x.sel * P::kSlots;
  int* ib = x.id + x.sel * P::kSlots;
  put_keys<K>(kb + t * K, key);
  if constexpr (!kPacked) put_ids<K>(ib + t * K, id);
  cluster_arrive();
  cluster_wait();
  const cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int at = (kMirror ? P::kThreads - 1 - t : t) * K;
  long long pk[K];
  int pi[K];
  get_keys<K>(cluster.map_shared_rank(kb, partner) + at, pk);
  if constexpr (!kPacked) get_ids<K>(cluster.map_shared_rank(ib, partner) + at, pi);
  x.sel ^= 1;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int src = kMirror ? K - 1 - k : k;
    const long long yk = pk[src];
    const int yi = kPacked ? 0 : pi[src];
    const bool take = less<kPacked>(yk, yi, key[k], id[k]) == keep_min;
    key[k] = take ? yk : key[k];
    if constexpr (!kPacked) id[k] = take ? yi : id[k];
  }
}

// The ascending sort of 2^kLogN slots over the blocks of a cluster (see the
// header), run by every thread of every block; `rank` is the block's rank
// in its cluster.  Each block first sorts its own slots (levels up to its
// share); each larger level runs its strides of a share or more across the
// blocks, then merge_slots' strides inside each block.  The last cross-block
// stage of a level leaves the partners reading this block's buffer, which
// the second local stage writes again: a split cluster barrier (arrive
// after the reads, wait after the first local stage) keeps them apart.
template <class CP>
__device__ __forceinline__ void cluster_sort(long long (&key)[CP::Block::kK],
                                             int (&id)[CP::Block::kK], Exchange& x,
                                             unsigned rank) {
  using P = typename CP::Block;
  sort_slots<P>(key, id, x);
  static_for<CP::kLogBlocks>([&](auto a) {
    constexpr int up = decltype(a)::value + 1;  // merge size 2^up shares
    cluster_stage<P, true>(key, id, x, rank ^ ((1u << up) - 1u), ((rank >> (up - 1)) & 1u) == 0);
#pragma unroll
    for (int b = up - 2; b >= 0; --b)
      cluster_stage<P, false>(key, id, x, rank ^ (1u << b), ((rank >> b) & 1u) == 0);
    cluster_arrive();
    stage<P, P::kLog + 1, P::kLog - 1>(key, id, x);
    cluster_wait();
    static_for<P::kLog - 1>([&](auto b) {
      stage<P, P::kLog + 1, P::kLog - 2 - decltype(b)::value>(key, id, x);
    });
  });
}

// Host side: the launch of `clusters` clusters of `blocks` blocks each
// (grid = clusters * blocks) on `stream`.
struct ClusterLaunch {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config;

  ClusterLaunch(int clusters, int blocks, int threads, int smem, cudaStream_t stream)
      : attr{}, config{} {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = static_cast<unsigned>(blocks);
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    config.gridDim = dim3(static_cast<unsigned>(clusters) * static_cast<unsigned>(blocks));
    config.blockDim = dim3(threads);
    config.dynamicSmemBytes = static_cast<size_t>(smem);
    config.stream = stream;
    config.attrs = &attr;
    config.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;  // config points at attr
};

// Make a cluster kernel launchable (its shared memory, a cluster of more
// than 8 blocks) and check that the device can hold one of its clusters;
// cudaErrorLaunchOutOfResources where it cannot.
inline cudaError_t prepare_cluster(const void* fn, int blocks, int threads, int smem) {
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (blocks > 8) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  const ClusterLaunch one(1, blocks, threads, smem, nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fn, &one.config);
  if (err != cudaSuccess) return err;
  return clusters >= 1 ? cudaSuccess : cudaErrorLaunchOutOfResources;
}

inline cudaError_t launch_cluster(const void* fn, int clusters, int blocks, int threads,
                                  int smem, void** args, cudaStream_t stream) {
  const ClusterLaunch launch(clusters, blocks, threads, smem, stream);
  return cudaLaunchKernelExC(&launch.config, fn, args);
}

}  // namespace klba
