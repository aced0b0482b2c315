// Greedy round scan of the lag-based assignor, for Hopper (sm_90a).
//
// Replaces the TPU kernels kafka_lag_based_assignor_tpu/ops/rounds_pallas.py
// ::_rounds_kernel (int32 totals) and ::_rounds_kernel_wide (int64 totals as
// two int32 planes with a carry).  One int64 kernel covers both.
//
// What it computes: exactly ops/rounds_kernel.py::_rounds_body, round after
// round.  At the start of round r every consumer holds r partitions, so the
// j-th partition of the round (in processing order) goes to the consumer with
// the (j+1)-th smallest (total lag, consumer id).  A round is therefore: sort
// the C (total, id) slots ascending, seat id[j] at position j, add gain[j] to
// slot j.
//
// Layout: gains int64[T, R, C] and valid uint8[T, R, C] (the sorted lags of
// each round's row and their validity), totals0 int64[C], choice
// int32[T, R, C], totals int64[T, C].  Grid = T: one block per topic, every
// topic starting from totals0.  The cross-topic "global" solve is the same
// kernel over [1, T*R, C] (the wrapper reshapes), so its totals carry across
// topics.
//
// What bounds it: its sequential depth, not bytes.  Each round is a full
// bitonic network over C_pad = next_pow2(C) slots, log2(C_pad) *
// (log2(C_pad) + 1) / 2 stages with a block barrier after each, so a topic
// costs R * stages barriers; at 100k partitions / 1k consumers that is
// 100 * 55 barriers against 1.3 MB of device-memory traffic.  The design keeps
// all (total, id) state in shared memory across the rounds (12 B a slot, up
// to C_pad = 16384 = 192 KiB), so a round touches device memory only for its
// C gains, C validity bytes and C choices; nothing else leaves the SM.
//
// Pad slots (j >= C) hold total INT64_MAX and id j >= C, so they sort after
// every real slot (ties on total break by id) and never receive a gain.
// Validity is read from `valid`, never inferred from the gain, so a valid
// zero lag is never taken for padding.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSlots = 16384;

__device__ __forceinline__ bool slot_greater(long long ta, int ia, long long tb,
                                             int ib) {
  return ta > tb || (ta == tb && ia > ib);
}

__global__ void rounds_scan_kernel(const long long* __restrict__ gains,
                                   const unsigned char* __restrict__ valid,
                                   const long long* __restrict__ totals0,
                                   int* __restrict__ choice,
                                   long long* __restrict__ totals_out, int R,
                                   int C, int c_pad) {
  extern __shared__ long long smem[];
  long long* tot = smem;
  int* ids = reinterpret_cast<int*>(smem + c_pad);

  const long long topic = blockIdx.x;
  for (int j = threadIdx.x; j < c_pad; j += blockDim.x) {
    tot[j] = j < C ? totals0[j] : LLONG_MAX;
    ids[j] = j;
  }
  __syncthreads();

  const int half = c_pad >> 1;
  for (int r = 0; r < R; ++r) {
    // Ascending bitonic sort of (total, id).  Ids are distinct, so the
    // order is total and the network exact.
    for (int k = 2; k <= c_pad; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int p = threadIdx.x; p < half; p += blockDim.x) {
          const int lo = ((p & ~(j - 1)) << 1) | (p & (j - 1));
          const int hi = lo | j;
          const long long tl = tot[lo];
          const long long th = tot[hi];
          const int il = ids[lo];
          const int ih = ids[hi];
          const bool ascending = (lo & k) == 0;
          if (slot_greater(tl, il, th, ih) == ascending) {
            tot[lo] = th;
            tot[hi] = tl;
            ids[lo] = ih;
            ids[hi] = il;
          }
        }
        __syncthreads();
      }
    }
    const long long row = (topic * R + r) * C;
    for (int j = threadIdx.x; j < C; j += blockDim.x) {
      const bool v = valid[row + j] != 0;
      choice[row + j] = v ? ids[j] : -1;
      if (v) tot[j] += gains[row + j];
    }
    __syncthreads();
  }

  // Slots are in the last round's order: scatter the totals back to
  // consumer order (this replaces the Pallas path's final sort by id).
  for (int j = threadIdx.x; j < c_pad; j += blockDim.x) {
    const int id = ids[j];
    if (id < C) totals_out[topic * C + id] = tot[j];
  }
}

}  // namespace

// Launches the round scan on `stream`; returns cudaGetLastError() (0 = ok).
// T blocks, each over R rounds of C consumers; c_pad = next_pow2(C) <= 16384.
extern "C" int klba_rounds_scan(const void* gains, const void* valid,
                                const void* totals0, void* choice,
                                void* totals_out, int T, int R, int C,
                                int c_pad, void* stream) {
  if (T < 1 || C < 1 || c_pad < C || c_pad > kMaxSlots || (c_pad & (c_pad - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(c_pad) * (sizeof(long long) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rounds_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = c_pad / 2;
  if (threads < 32) threads = 32;
  if (threads > 1024) threads = 1024;
  rounds_scan_kernel<<<T, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(gains),
      static_cast<const unsigned char*>(valid),
      static_cast<const long long*>(totals0), static_cast<int*>(choice),
      static_cast<long long*>(totals_out), R, C, c_pad);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* klba_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
