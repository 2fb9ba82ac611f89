// Launch layout shared by the neighborhood kernels (pospool_xyz.cu,
// pospool_sincos.cu, moments.cu, neighborhood_max.cu): one block per kQPB
// consecutive queries of one cloud (grid.y = cloud), which stages its
// query's K <= kMaxK slots in shared memory with one thread per slot, then
// strides its threads over the C channels.
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

// Stage the K slots of query row `row` (q is [B*Nq, 3], sb the cloud's
// support points [Ns, 3]): s_idx[t] = support row or -1 (masked slot),
// s_d[t, d] = D[t, d] = (sb[idx[t], d] - q[row, d]) / r in f32, rounded to
// T (T = float keeps f32). Needs blockDim.x >= k.
template <typename T>
__device__ __forceinline__ void stage_slots(const float* __restrict__ q,
                                            const float* __restrict__ sb,
                                            const int32_t* __restrict__ idx,
                                            const bool* __restrict__ mask,
                                            size_t row, int k, float radius,
                                            int* s_idx, float* s_d) {
  if (threadIdx.x < k) {
    const int t = threadIdx.x;
    const bool v = mask[row * k + t];
    const int j = idx[row * k + t];
    s_idx[t] = v ? j : -1;
    if (v) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float delta =
            __fdiv_rn(__fsub_rn(sb[static_cast<size_t>(j) * 3 + d],
                                q[row * 3 + d]),
                      radius);
        s_d[t * 3 + d] = to_f32(from_f32<T>(delta));
      }
    }
  }
}

// Number of valid slots staged by stage_slots.
__device__ __forceinline__ int staged_count(const int* s_idx, int k) {
  int cnt = 0;
  for (int t = 0; t < k; ++t) cnt += s_idx[t] >= 0;
  return cnt;
}

}  // namespace
