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
// Design.  Pass 1 is a grid-stride loop over the B rows and the C * M table
// slots: each block keeps an in-range histogram of `choice` in shared memory
// (int32[C], C <= 16384: 64 KiB) and five 64-bit sums in registers, reduces
// the sums over the block with warp shuffles, and adds them and its nonzero
// histogram bins into global accumulators with integer atomics.  Pass 2 is
// one block over the C consumers: sum(counts), the L1 distance of the
// histogram to `counts`, and the assembly of the five lanes.  Integer
// addition is exact in any order, so the atomics give the same bits on every
// run; every sum is taken as unsigned long long, which wraps exactly as the
// JAX package's and numpy's int64 sums do.
//
// What bounds it: bytes, and at the streaming engine's shapes the launch.
// At 100k partitions / 1k consumers (B = 131,072, M = 133) it reads 2.64 MB
// (lags 1 MB, choice 0.5 MB, the table 0.53 MB, at most 0.53 MB of gathered
// choices), 0.79 us at 3.35 TB/s: two launches and a memset cost more.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxConsumers = 16384;
constexpr int kThreads = 256;
constexpr int kFinishThreads = 1024;
constexpr int kRowsPerBlock = 2048;
constexpr int kMaxBlocks = 264;  // two blocks on each of 132 SMs

// Slots of the 64-bit accumulators in the scratch buffer.
enum { kLagSum = 0, kViol, kRowSum, kSlotSum, kBad, kNumAcc };
constexpr int kAccSlots = 8;  // kNumAcc rounded up; the histogram follows

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sums v[0..n) over the block; the result is valid in thread 0.
template <int N>
__device__ void block_sum(unsigned long long (&v)[N]) {
  __shared__ unsigned long long part[N][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    v[k] = warp_sum(v[k]);
    if (lane == 0) part[k][warp] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = warp_sum(lane < warps ? part[k][lane] : 0ULL);
  }
}

__global__ void digest_pass1(const long long* __restrict__ lags,
                             const int* __restrict__ choice,
                             const int* __restrict__ counts,
                             const int* __restrict__ row_tab, long long B,
                             int C, int M, unsigned long long* __restrict__ acc,
                             unsigned int* __restrict__ hist) {
  extern __shared__ unsigned int sh_hist[];
  for (int c = threadIdx.x; c < C; c += blockDim.x) sh_hist[c] = 0u;
  __syncthreads();

  unsigned long long v[kNumAcc] = {0ULL, 0ULL, 0ULL, 0ULL, 0ULL};
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long i = first; i < B; i += stride) {
    v[kLagSum] += static_cast<unsigned long long>(lags[i]);
    const int ch = choice[i];
    if (ch < -1 || ch >= C) {
      v[kViol] += 1ULL;
    } else if (ch >= 0) {
      atomicAdd(&sh_hist[ch], 1u);
      v[kRowSum] += static_cast<unsigned long long>(i);
    }
  }
  const long long slots = static_cast<long long>(C) * M;
  for (long long e = first; e < slots; e += stride) {
    const int c = static_cast<int>(e / M);
    const int j = static_cast<int>(e - static_cast<long long>(c) * M);
    const long long rt = row_tab[e];
    if (j < min(counts[c], M)) {
      const long long r = rt < 0 ? 0 : (rt >= B ? B - 1 : rt);
      v[kBad] += static_cast<unsigned long long>(choice[r] != c) +
                 static_cast<unsigned long long>(rt < 0 || rt >= B);
      v[kSlotSum] += static_cast<unsigned long long>(r);
    } else {
      v[kBad] += static_cast<unsigned long long>(rt != B);
    }
  }

  block_sum(v);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kNumAcc; ++k)
      if (v[k]) atomicAdd(&acc[k], v[k]);
  }
  __syncthreads();  // every shared-memory histogram add is done
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const unsigned int h = sh_hist[c];
    if (h) atomicAdd(&hist[c], h);
  }
}

__global__ void digest_finish(const int* __restrict__ counts,
                              const unsigned int* __restrict__ hist,
                              const unsigned long long* __restrict__ acc, int C,
                              long long* __restrict__ out) {
  unsigned long long v[2] = {0ULL, 0ULL};  // sum(counts), L1
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const long long k = counts[c];
    const long long d = static_cast<long long>(hist[c]) - k;
    v[0] += static_cast<unsigned long long>(k);
    v[1] += static_cast<unsigned long long>(d < 0 ? -d : d);
  }
  block_sum(v);
  if (threadIdx.x == 0) {
    // |slot_sum - row_sum| in wrapping int64, as jnp.abs gives it.
    const long long diff = static_cast<long long>(acc[kSlotSum] - acc[kRowSum]);
    const unsigned long long adiff =
        diff < 0 ? 0ULL - static_cast<unsigned long long>(diff)
                 : static_cast<unsigned long long>(diff);
    out[0] = static_cast<long long>(v[0]);
    out[1] = static_cast<long long>(acc[kViol]);
    out[2] = static_cast<long long>(acc[kLagSum]);
    out[3] = static_cast<long long>(v[1]);
    out[4] = static_cast<long long>(acc[kBad] + adiff);
  }
}

}  // namespace

// Bytes of scratch the wrapper allocates for C consumers (zeroed here).
extern "C" long long klba_state_digest_scratch_bytes(int C) {
  return static_cast<long long>(kAccSlots) * 8 + static_cast<long long>(C) * 4;
}

// Launches the digest on `stream`; returns the first CUDA error (0 = ok).
// row_tab may be null with M = 0.  out: int64[5].
extern "C" int klba_state_digest(const void* lags, const void* choice,
                                 const void* counts, const void* row_tab,
                                 long long B, int C, int M, void* scratch,
                                 void* out, void* stream) {
  if (B < 1 || C < 1 || C > kMaxConsumers || M < 0 || (M > 0 && row_tab == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(scratch, 0, klba_state_digest_scratch_bytes(C), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* acc = static_cast<unsigned long long*>(scratch);
  auto* hist = reinterpret_cast<unsigned int*>(acc + kAccSlots);

  const size_t smem = static_cast<size_t>(C) * sizeof(unsigned int);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(digest_pass1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long work = B > static_cast<long long>(C) * M ? B : static_cast<long long>(C) * M;
  long long blocks = (work + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  digest_pass1<<<static_cast<int>(blocks), kThreads, smem, s>>>(
      static_cast<const long long*>(lags), static_cast<const int*>(choice),
      static_cast<const int*>(counts), static_cast<const int*>(row_tab), B, C, M,
      acc, hist);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  digest_finish<<<1, kFinishThreads, 0, s>>>(static_cast<const int*>(counts), hist, acc,
                                            C, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* klba_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
