// The older launch layout of the neighborhood kernels, kept by K7's
// backward alone (mm_bwd_kernel in gather_reduce.cu): one block per kQPB
// consecutive queries of one cloud (grid.y = cloud), which stages its
// query's K <= kMaxK slots in shared memory with one thread per slot
// behind __syncthreads, then strides its threads over the C channels. The
// forwards K1f, K5f, K6f, K7f, K8f, K9f and K10f moved to
// query_groups.cuh, the backwards K1b, K5b, K8b and K9b to row_terms.cuh;
// kMaxK serves every kernel (row_gather.cuh includes this header).
#pragma once

#include "common.cuh"

namespace {

constexpr int kMaxK = 64;  // slots per query (ops/neighbors.py MAX_K)
constexpr int kQPB = 4;    // queries per block

dim3 grid_for(int b, int nq) { return dim3((nq + kQPB - 1) / kQPB, b); }

int threads_for(int c) {
  const int threads = ((c + 31) / 32) * 32;
  // at least kMaxK threads: one thread stages each neighbor slot
  return std::max(64, std::min(256, threads));
}

// Stage the K slots of query row `row` without positions: s_idx[t] =
// support row of slot t, or -1 when masked. Needs blockDim.x >= k.
__device__ __forceinline__ void stage_rows(const int32_t* __restrict__ idx,
                                           const bool* __restrict__ mask,
                                           size_t row, int k, int* s_idx) {
  if (threadIdx.x < k) {
    const int t = threadIdx.x;
    s_idx[t] = mask[row * k + t] ? idx[row * k + t] : -1;
  }
}

// Number of valid slots staged by stage_rows.
__device__ __forceinline__ int staged_count(const int* s_idx, int k) {
  int cnt = 0;
  for (int t = 0; t < k; ++t) cnt += s_idx[t] >= 0;
  return cnt;
}

}  // namespace
