// Launch layout shared by the neighborhood kernels (pospool_xyz.cu,
// neighborhood_max.cu): one block per kQPB consecutive queries of one
// cloud (grid.y = cloud), which stages its query's K <= kMaxK slots in
// shared memory with one thread per slot, then strides its threads over
// the C channels.
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

}  // namespace
