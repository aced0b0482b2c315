// P-step greedy scan of the lag-based assignor, for Hopper (sm_90a).
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
// What bounds it: its depth.  Step s needs the winner of step s - 1, so a
// topic is n dependent steps (n its rows up to the last valid one), each a
// block-wide lexicographic argmin; bytes (13 a row) and compares (C a step)
// are far below what one step's latency costs.  The design keeps each step
// short and simple:
//
// - Consumer j's slot (count, total, eligibility) lives in registers of
//   thread j / S, S = 1 up to 1,024 consumers and the next power of two of
//   C / 1,024 above (at most 16 at 16,384 consumers).  Each thread keeps the
//   minimum of its own slots and recomputes it only when it owned the last
//   winner.
// - A step is a 5-level __shfl_xor_sync butterfly over (count, total,
//   index), one write of each warp's minimum to shared memory, one
//   __syncthreads, and a second butterfly over the warp minima that every
//   warp runs, so that every thread knows the winner without a second
//   barrier.  The warp minima are double-buffered: a warp can be one step
//   ahead, never two.  With one warp (C <= 32) there is no barrier at all.
// - The owning thread adds 1 and the lag (int64, wrapping on overflow as
//   the JAX package's arithmetic does; compared as signed).  Thread 0
//   writes the winner to sorted_choice.
// - The rows are staged into shared memory 1,024 at a time, so a step
//   reads its lag and validity byte there, as a broadcast.
//
// The loop stops after the topic's last valid row; padding rows get -1, and
// with no eligible consumer every row does.  An invalid row before the last
// valid one also gets -1 and changes nothing, as in the JAX step.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSlots = 16384;
constexpr int kMaxThreads = 1024;
constexpr int kTile = 1024;  // rows staged in shared memory at a time
constexpr unsigned kFull = 0xffffffffu;

struct Key {
  int count;
  int idx;
  long long total;
};

__device__ __forceinline__ Key sentinel() { return Key{INT_MAX, INT_MAX, LLONG_MAX}; }

// (count, total, index) of a before b.
__device__ __forceinline__ bool less(const Key& a, const Key& b) {
  if (a.count != b.count) return a.count < b.count;
  if (a.total != b.total) return a.total < b.total;
  return a.idx < b.idx;
}

// The warp's least key, in every lane.
__device__ __forceinline__ Key warp_min(Key k) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) {
    Key o;
    o.count = __shfl_xor_sync(kFull, k.count, m);
    o.idx = __shfl_xor_sync(kFull, k.idx, m);
    o.total = __shfl_xor_sync(kFull, k.total, m);
    if (less(o, k)) k = o;
  }
  return k;
}

// The least of this thread's eligible slots (consumers base .. base+S-1).
template <int S>
__device__ __forceinline__ Key local_min(const int (&cnt)[S], const long long (&tot)[S],
                                         unsigned elig, int base) {
  Key best = sentinel();
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const Key c{cnt[k], base + k, tot[k]};
    if (((elig >> k) & 1u) && less(c, best)) best = c;
  }
  return best;
}

template <int S>
__global__ void __launch_bounds__(kMaxThreads)
    scan_greedy_kernel(const long long* __restrict__ lags,
                       const unsigned char* __restrict__ valid,
                       const unsigned char* __restrict__ eligible, int* __restrict__ choice,
                       int* __restrict__ counts_out, long long* __restrict__ totals_out, int P,
                       int C) {
  __shared__ long long tile_lag[kTile];
  __shared__ unsigned char tile_ok[kTile];
  __shared__ Key red[2][32];
  __shared__ int flags[2];  // last valid row + 1, any eligible consumer

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const int base = t * S;
  const long long row0 = static_cast<long long>(blockIdx.x) * P;
  const long long* g = lags + row0;
  const unsigned char* v = valid + row0;
  int* ch = choice + row0;

  int cnt[S];
  long long tot[S];
  unsigned elig = 0;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    cnt[k] = 0;
    tot[k] = 0;
    const int j = base + k;
    if (j < C && (eligible == nullptr || eligible[j])) elig |= 1u << k;
  }

  if (t == 0) {
    flags[0] = 0;
    flags[1] = 0;
  }
  __syncthreads();
  int last = 0;
  for (int i = t; i < P; i += blockDim.x)
    if (v[i]) last = i + 1;
  last = __reduce_max_sync(kFull, last);
  const bool any = __any_sync(kFull, elig != 0);
  if (lane == 0) {
    if (last) atomicMax(&flags[0], last);
    if (any) flags[1] = 1;
  }
  __syncthreads();
  const int n = flags[1] ? flags[0] : 0;
  for (int i = n + t; i < P; i += blockDim.x) ch[i] = -1;

  Key best = local_min<S>(cnt, tot, elig, base);
  int phase = 0;
  for (int s0 = 0; s0 < n; s0 += kTile) {
    const int len = min(kTile, n - s0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = t; i < len; i += blockDim.x) {
      tile_lag[i] = g[s0 + i];
      tile_ok[i] = v[s0 + i];
    }
    __syncthreads();
    for (int i = 0; i < len; ++i) {
      if (!tile_ok[i]) {  // the same for every thread of the block
        if (t == 0) ch[s0 + i] = -1;
        continue;
      }
      Key w = warp_min(best);
      if (nwarps > 1) {
        if (lane == 0) red[phase][warp] = w;
        __syncthreads();
        w = warp_min(lane < nwarps ? red[phase][lane] : sentinel());
        phase ^= 1;
      }
      if (w.idx / S == t) {
        const unsigned long long lag = static_cast<unsigned long long>(tile_lag[i]);
#pragma unroll
        for (int k = 0; k < S; ++k) {
          if (base + k == w.idx) {
            cnt[k] += 1;
            tot[k] = static_cast<long long>(static_cast<unsigned long long>(tot[k]) + lag);
          }
        }
        best = local_min<S>(cnt, tot, elig, base);
      }
      if (t == 0) ch[s0 + i] = w.idx;
    }
  }

  const long long out0 = static_cast<long long>(blockIdx.x) * C;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int j = base + k;
    if (j < C) {
      counts_out[out0 + j] = cnt[k];
      totals_out[out0 + j] = tot[k];
    }
  }
}

using KernelFn = void (*)(const long long*, const unsigned char*, const unsigned char*, int*,
                          int*, long long*, int, int);

// S, the slots a thread holds for C consumers: the least power of two that
// fits them into 1,024 threads.
int slots_per_thread(int C) {
  int s = 1;
  while ((C + s - 1) / s > kMaxThreads) s <<= 1;
  return s;
}

KernelFn kernel_for(int s) {
  switch (s) {
    case 1: return scan_greedy_kernel<1>;
    case 2: return scan_greedy_kernel<2>;
    case 4: return scan_greedy_kernel<4>;
    case 8: return scan_greedy_kernel<8>;
    case 16: return scan_greedy_kernel<16>;
    default: return nullptr;
  }
}

}  // namespace

// Launches the scan on `stream`; returns the CUDA error (0 = ok).  T blocks,
// each over P rows of C <= 16,384 consumers; `eligible` may be null.
extern "C" int klba_scan_greedy(const void* lags, const void* valid, const void* eligible,
                                void* choice, void* counts, void* totals, int T, int P, int C,
                                void* stream) {
  if (T < 0 || P < 0 || C < 1 || C > kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  const int s = slots_per_thread(C);
  KernelFn fn = kernel_for(s);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((C + s - 1) / s + 31) / 32 * 32;
  const long long* g = static_cast<const long long*>(lags);
  const unsigned char* v = static_cast<const unsigned char*>(valid);
  const unsigned char* e = static_cast<const unsigned char*>(eligible);
  int* ch = static_cast<int*>(choice);
  int* cn = static_cast<int*>(counts);
  long long* tt = static_cast<long long*>(totals);
  void* args[] = {&g, &v, &e, &ch, &cn, &tt, &P, &C};
  cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(fn), dim3(T), dim3(threads),
                                     args, 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" const char* klba_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
