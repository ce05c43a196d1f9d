// Work counters of the kernels' STATS (counting) instantiations, shared
// by the walk of packet_walk.cuh and its two layouts, packet_tracer.cu
// (K1/K2) and mt_tracer.cu (K3/K4).
//
// A STATS launch writes STATS_COLS unsigned 64-bit counters per ray
// block:
//   [0] visits walked (clusters staged for the block),
//   [1] (ray, triangle) pairs tested,
//   [2..5] pairs past stage 1, 2, 3, 4 of the pair test,
//   [6] clock64() cycles the block's work held a CTA: the sum over the
//       block's work items,
//   [7] the longest single work item of the block, in cycles.
// The stages are the early returns of the pair test, in order:
//   K1: keep (r_z), t in range, u >= 0, v and u + v (a hit);
//   K2: keep (r_z), t in range, u with v and u + v (a hit); stage 4
//       stays 0;
//   K3, K4: determinant, u >= 0, v and u + v, t in range (a hit).
// A thread counts its own pairs in a Work and the CTA sums them into the
// block's row. ops/tracer_cuda.py STATS_COLS mirrors the constant.
#pragma once

constexpr int STATS_COLS = 8;
constexpr int STAT_STAGES = 5;  // columns 1..5: tested, then past each stage
constexpr int STAT_CYCLES = 6;
constexpr int STAT_ITEM_CYCLES = 7;

struct Work {
  unsigned n[STAT_STAGES] = {};
};

// Add one CTA's counts to row `row` of the stats table.
__device__ __forceinline__ void add_stats(unsigned long long* stats, int row,
                                          int walked, const Work& w) {
  unsigned long long* out = stats + (size_t)row * STATS_COLS;
  if (threadIdx.x == 0) atomicAdd(out, (unsigned long long)walked);
  for (int k = 0; k < STAT_STAGES; ++k) {
    const unsigned sum = __reduce_add_sync(0xffffffffu, w.n[k]);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(out + 1 + k, (unsigned long long)sum);
    }
  }
}
