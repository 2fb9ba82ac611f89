// Reverse (CSR) neighbor index of one cloud, built by one block: for the
// slots of its queries (idx, mask [Nq, K]: slot t of query q names support
// row idx[q, t] where mask[q, t]), the slots that name each support row.
//   offsets[s] .. offsets[s + 1]  the entries of row s, s < Ns;
//   slots[e] = q * K + t          for e < offsets[Ns] (the valid slots; the
//                                 rest is not written),
// each row's slots in ascending order, i.e. in (q, t) order. Masked slots,
// and valid ones whose index lies outside [0, Ns), are left out.
//
// No TPU kernel corresponds to it: the Pallas backward kernels scatter by
// one-hot matmuls. The backward gathers of K6 (csrc/gather_reduce.cu) and
// K10 (csrc/pseudo_grid.cu) run it in the first of their two launches,
// blocks [0, B) beside the query-major blocks, so that a group of lanes
// owning a support row then reads that row's terms in (q, t) order and
// writes the row once, with no float atomics, no zeroed scratch and no
// cast; those of K5 and K9 (csrc/row_terms.cuh) run it once a tile of
// consecutive queries, each entry holding its query (kQueries).
// csrc/reverse_index.cu launches it alone; its plain version is
// ops/reverse_index.py::reverse_index_plain.
//
// The block:
//   1. count: n[s] = valid slots naming s, by integer atomics (exact in
//      any order), each thread's kIndexUnroll slot loads started at once;
//   2. scan: an exclusive block scan of n gives the offsets;
//   3. fill: each valid slot takes the next place of its row by an atomic
//      cursor, into a scratch copy (the order within a row varies run to
//      run);
//   4. sort: rows of up to 16 slots one a thread, by a sorting network in
//      registers; longer ones one a warp (ranks by warp shuffles, O(n^2 /
//      32) for a row of n). Each slot is written at its place.
// The counters (Ns + 1 ints) are in shared memory where the caller gives
// it (Ns 5000: 20 KB; S3DIS's 15000: 60 KB), else in a global scratch,
// zeroed by the block.
#pragma once

#include <climits>

#include "row_gather.cuh"

namespace {

// A counter in global memory is read past the L1, which may hold a line
// from before another thread's atomics.
template <bool kShared>
__device__ __forceinline__ int load_count(const int* p) {
  if constexpr (kShared)
    return *p;
  else
    return __ldcg(p);
}

// In place: cnt[i] <- cnt[0] + ... + cnt[i - 1] for i < m, also written to
// out[i]. Thread t takes the contiguous chunk [t * per, (t + 1) * per).
template <int kThreads, bool kShared>
__device__ void exclusive_scan(int* cnt, int m, int32_t* out) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (m + kThreads - 1) / kThreads;
  const int lo = min(m, static_cast<int>(threadIdx.x) * per);
  const int hi = min(m, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += load_count<kShared>(cnt + i);
  int incl = sum;  // inclusive scan over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += v;
    }
    if (lane < kWarps) s_warp[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  int run = incl - sum + (warp > 0 ? s_warp[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int v = load_count<kShared>(cnt + i);
    cnt[i] = run;
    out[i] = run;
    run += v;
  }
}

// Ascending sort of N ints in registers (a bitonic network; N a power of
// two, every index known at compile time).
template <int N>
__device__ __forceinline__ void sort_network(int (&v)[N]) {
#pragma unroll
  for (int size = 2; size <= N; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int j = i ^ stride;
        if (j > i) {
          const int lo = min(v[i], v[j]), hi = max(v[i], v[j]);
          const bool up = (i & size) == 0;
          v[i] = up ? lo : hi;
          v[j] = up ? hi : lo;
        }
      }
}

// What an index entry holds: its slot id q * K + t, or (kQueries) its
// query q.
template <bool kQueries>
__device__ __forceinline__ int32_t entry_of(int slot, int k) {
  if constexpr (kQueries)
    return slot / k;
  else
    return slot;
}

// One thread: the n <= N slot ids raw[0..n) to out[0..n) in order.
template <int N, bool kQueries>
__device__ __forceinline__ void sort_short_row(const int32_t* raw, int n,
                                               int k, int32_t* out) {
  int v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = i < n ? __ldcg(raw + i) : INT_MAX;
  sort_network<N>(v);
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) out[i] = entry_of<kQueries>(v[i], k);
}

// One warp: the n slot ids raw[0..n) (distinct) to out[0..n) in order,
// each written at its rank.
template <bool kQueries>
__device__ void sort_long_row(const int32_t* raw, int n, int k,
                              int32_t* out) {
  const int lane = threadIdx.x & 31;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const bool mine = i0 + lane < n;
    const int v = mine ? __ldcg(raw + i0 + lane) : INT_MAX;
    int rank = 0;
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int w = j0 + lane < n ? __ldcg(raw + j0 + lane) : INT_MAX;
#pragma unroll 8
      for (int j = 0; j < 32; ++j) rank += __shfl_sync(kFull, w, j) < v;
    }
    if (mine) out[rank] = entry_of<kQueries>(v, k);
  }
}

constexpr int kIndexUnroll = 8;  // slots a thread loads at once
constexpr int kShortRow = 16;    // rows sorted by one thread

// Cloud b's index (see the header), by the kThreads threads of one block.
// cnt: Ns + 1 ints of shared memory (kShared), else counters + b (Ns + 1)
// in global memory; raw: the cloud's Nq * K scratch ints. With kQueries
// each entry holds its query q in place of its slot id (the same order).
template <int kThreads, bool kShared, bool kQueries = false>
__device__ void build_reverse_index(const int32_t* __restrict__ idx,
                                    const bool* __restrict__ mask, int nq,
                                    int ns, int k, int b, int* s_cnt,
                                    int32_t* __restrict__ offsets,
                                    int32_t* __restrict__ slots,
                                    int32_t* __restrict__ raw,
                                    int* __restrict__ counters) {
  constexpr int kWarps = kThreads / 32;
  const int n = nq * k;
  int* cnt = kShared ? s_cnt : counters + static_cast<size_t>(b) * (ns + 1);
  const int32_t* ib = idx + static_cast<size_t>(b) * n;
  const bool* mb = mask + static_cast<size_t>(b) * n;
  int32_t* ob = offsets + static_cast<size_t>(b) * (ns + 1);
  int32_t* sb = slots + static_cast<size_t>(b) * n;
  int32_t* rb = raw + static_cast<size_t>(b) * n;

  for (int i = threadIdx.x; i <= ns; i += kThreads) cnt[i] = 0;
  __syncthreads();
  for (int e0 = threadIdx.x; e0 < n; e0 += kThreads * kIndexUnroll) {
    int row[kIndexUnroll];
#pragma unroll
    for (int u = 0; u < kIndexUnroll; ++u) {  // idx and mask at once
      const int e = e0 + u * kThreads;
      const int j = e < n ? ib[e] : -1;
      row[u] = e < n && mb[e] ? j : -1;
    }
#pragma unroll
    for (int u = 0; u < kIndexUnroll; ++u)
      if (static_cast<unsigned>(row[u]) < static_cast<unsigned>(ns))
        atomicAdd(cnt + row[u], 1);
  }
  __syncthreads();
  exclusive_scan<kThreads, kShared>(cnt, ns + 1, ob);
  __syncthreads();
  for (int e0 = threadIdx.x; e0 < n; e0 += kThreads * kIndexUnroll) {
    int row[kIndexUnroll];
#pragma unroll
    for (int u = 0; u < kIndexUnroll; ++u) {  // idx and mask at once
      const int e = e0 + u * kThreads;
      const int j = e < n ? ib[e] : -1;
      row[u] = e < n && mb[e] ? j : -1;
    }
#pragma unroll
    for (int u = 0; u < kIndexUnroll; ++u)
      if (static_cast<unsigned>(row[u]) < static_cast<unsigned>(ns))
        rb[atomicAdd(cnt + row[u], 1)] = e0 + u * kThreads;
  }
  __syncthreads();  // cnt[s] is now the end of row s, the start of s + 1
  for (int s = threadIdx.x; s < ns; s += kThreads) {
    const int start = s > 0 ? load_count<kShared>(cnt + s - 1) : 0;
    const int len = load_count<kShared>(cnt + s) - start;
    if (len == 1)
      sb[start] = entry_of<kQueries>(__ldcg(rb + start), k);
    else if (len > 1 && len <= kShortRow / 2)
      sort_short_row<kShortRow / 2, kQueries>(rb + start, len, k,
                                              sb + start);
    else if (len > kShortRow / 2 && len <= kShortRow)
      sort_short_row<kShortRow, kQueries>(rb + start, len, k, sb + start);
  }
  // rows longer than kShortRow: a warp each, found 32 rows at a time
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s0 = warp * 32; s0 < ns; s0 += kWarps * 32) {
    const int s = s0 + lane;
    int start = 0, len = 0;
    if (s < ns) {
      start = s > 0 ? load_count<kShared>(cnt + s - 1) : 0;
      len = load_count<kShared>(cnt + s) - start;
    }
    unsigned long_rows = __ballot_sync(kFull, len > kShortRow);
    while (long_rows) {
      const int l = __ffs(long_rows) - 1;
      long_rows &= long_rows - 1;
      sort_long_row<kQueries>(rb + __shfl_sync(kFull, start, l),
                              __shfl_sync(kFull, len, l), k,
                              sb + __shfl_sync(kFull, start, l));
    }
  }
}

}  // namespace
