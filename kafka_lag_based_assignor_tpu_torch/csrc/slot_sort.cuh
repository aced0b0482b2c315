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
// Above kMaxSlots (16,384) slots a block's registers cannot hold them: the
// wide form (wide_sort) keeps a block's N slots in a scratch of device
// memory (int64 keys, int32 ids: 12 B a slot, 1.5 MB at 2^17, which stays
// in the 50 MB L2) and runs the same all-ascending network in three kinds
// of step.  Each 16,384-slot chunk is loaded into the registers of the
// 16,384-slot network and sorted there (the levels of merge size up to
// 2^14 never leave a chunk); each stage of stride 2^14 or more is a
// compare-exchange pass over the scratch, one barrier after it; and each
// level ends with a merge-only entry into the register network, its last
// 14 stages, one chunk at a time.  Every index into the scratch is 64-bit.

#pragma once

#include <utility>

#include <cuda_runtime.h>

namespace klba {

constexpr int kMaxLogSlots = 14;
constexpr int kMaxSlots = 1 << kMaxLogSlots;
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

}  // namespace klba
