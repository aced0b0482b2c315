// Native host-side greedy LPT assignment core (the `native` solver).
//
// A copy of kafka_lag_based_assignor_tpu/native/greedy.cpp.  Exact reference
// semantics (LagBasedPartitionAssignor.java:204-308) as a heap-based
// O(P log P + P log C) C++ routine: the accelerator-independent solver, and
// a fair single-thread baseline for benchmarks.  The JVM original does an O(C) linear scan per partition
// (Collections.min, :240-263); a binary heap keyed on the same comparator
// (count, total lag, member rank) gives identical output in O(log C) per
// step because the selection key of every non-popped consumer is unchanged
// by an assignment (only the popped consumer's key changes).
//
// ABI: plain C, int64/int32 columns, caller-allocated output. Consumers are
// dense ranks 0..C-1 in lexicographic member-id order (the package-wide
// convention), so rank comparison == member-id comparison.

#include <algorithm>
#include <cstdint>
#include <queue>
#include <vector>

namespace {

struct ConsumerKey {
  int64_t count;
  int64_t total;
  int32_t rank;
};

struct KeyGreater {
  bool operator()(const ConsumerKey& a, const ConsumerKey& b) const {
    if (a.count != b.count) return a.count > b.count;
    if (a.total != b.total) return a.total > b.total;
    return a.rank > b.rank;
  }
};

}  // namespace

extern "C" {

// Assign P partitions to C consumers.  lags/partition_ids are parallel
// arrays of length P; out_choice receives the consumer rank per input row.
// Returns 0 on success, nonzero on invalid arguments.
int klba_assign_greedy(const int64_t* lags, const int32_t* partition_ids,
                       int64_t num_partitions, int32_t num_consumers,
                       int32_t* out_choice) {
  if (num_partitions < 0 || num_consumers <= 0 || (!lags && num_partitions) ||
      (!partition_ids && num_partitions) || (!out_choice && num_partitions)) {
    return 1;
  }

  // Processing order: lag descending, partition id ascending
  // (reference :228-235).
  std::vector<int64_t> order(static_cast<size_t>(num_partitions));
  for (int64_t i = 0; i < num_partitions; ++i) order[static_cast<size_t>(i)] = i;
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    if (lags[a] != lags[b]) return lags[a] > lags[b];
    return partition_ids[a] < partition_ids[b];
  });

  std::priority_queue<ConsumerKey, std::vector<ConsumerKey>, KeyGreater> heap;
  for (int32_t c = 0; c < num_consumers; ++c) heap.push({0, 0, c});

  for (int64_t i = 0; i < num_partitions; ++i) {
    const int64_t row = order[static_cast<size_t>(i)];
    ConsumerKey best = heap.top();
    heap.pop();
    out_choice[row] = best.rank;
    best.count += 1;
    best.total += lags[row];
    heap.push(best);
  }
  return 0;
}

}  // extern "C"
