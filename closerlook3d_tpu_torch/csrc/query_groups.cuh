// Query-group layout of the forward neighborhood kernels (K10f in
// pseudo_grid.cu, K5f in pospool_sincos.cu, K1f in pospool_xyz.cu, K9f in
// moments.cu, K6f, K7f and K7b's launch 1 in gather_reduce.cu, K8f and
// K8b's launch 1 in neighborhood_max.cu): a group of kG lanes of one warp
// (8, 16 or 32) owns one work item, a query and a slice of its output,
// and several groups share a block with no block-wide barrier:
// each group stages its query in its own slice of shared memory behind
// __syncwarp only, so one query's staging overlaps another's row traffic.
//
//   1. row load: the group reads the query's idx and mask rows at once,
//      coalesced (lane lg the slots lg, lg + kG, ...);
//   2. ballot compaction: the valid slots (mask set and idx >= 0) are
//      numbered in ascending slot order by __ballot_sync / __popc, so a
//      sum over them runs in the order of a loop over all K slots that
//      skips the masked ones;
//   3. position staging: for valid slots only, the support row and a
//      position term per coordinate, pos(s[idx, d], q[d]), are written to
//      the group's GroupSlots (K6f, K7f and K8f, which need no positions,
//      stage the rows alone in GroupRows: stage_valid_rows).
//
// A query's output is cut into `passes` of kG lanes' units (channel
// vectors, pairs, kernel-point chunks: the kernel's own); where queries are
// few (deep stages: 608 queries at C = 1152) the passes are split into
// slices, one item each, so that the launch still fills the card.
#pragma once

#include <climits>
#include <type_traits>

#include "row_gather.cuh"

namespace {

constexpr int kGroupThreads = 256;  // threads of a query-group block

// A query's valid slots, compacted: j[at] its support row and x[at][d]
// its position term, at < the count stage_valid_slots returns.
struct GroupSlots {
  int j[kMaxK];
  float x[kMaxK][3];
};

// The same without positions (stage_valid_rows).
struct GroupRows {
  int j[kMaxK];
};

// stage_valid_slots' pos where the kernel needs no positions: nothing but
// the rows is loaded or staged.
struct NoPositions {};

// Steps 1-3 above for the calling lane's group (live: the group has an
// item). Every lane of the warp takes part; the caller syncs the warp
// before reading `st`. Returns the number of valid slots, uniform across
// the group (0 where not live). Unlike row_gather.cuh's stage_group_slots
// (the backward gathers, which keep slot numbers), a slot naming a
// negative row is not valid, as the forward kernels' loops over K skipped
// it, and every round's positions are loaded before the first ballot.
// With pos NoPositions (and `st` a GroupRows) no position is loaded.
template <int kG, typename Pos, typename Slots>
__device__ __forceinline__ int stage_valid_slots(
    const int32_t* __restrict__ idx_row, const bool* __restrict__ mask_row,
    int k, bool live, const float* __restrict__ sb, const float (&qp)[3],
    Pos pos, Slots& st) {
  constexpr bool kPos = !std::is_same_v<Pos, NoPositions>;
  constexpr int kRounds = kMaxK / kG;
  const int lane = threadIdx.x & 31, lg = lane % kG;
  const unsigned group =
      kG == 32 ? kFull : ((1u << kG) - 1u) << (lane - lg);
  const unsigned below = (1u << lane) - 1u;
  int j[kRounds];
  bool v[kRounds];
#pragma unroll
  for (int h = 0; h < kRounds; ++h) {
    if (kG * h >= k) break;  // uniform: K is the launch's
    const int t = lg + kG * h;
    const bool in = live && t < k;
    j[h] = in ? idx_row[t] : 0;
    v[h] = in && mask_row[t] && j[h] >= 0;
  }
  float sp[kRounds][3];  // every round's positions in flight at once
#pragma unroll
  for (int h = 0; h < kRounds; ++h) {
    if (kG * h >= k) break;
    if (kPos && v[h]) {
#pragma unroll
      for (int d = 0; d < 3; ++d)
        sp[h][d] = sb[static_cast<size_t>(j[h]) * 3 + d];
    }
  }
  int n = 0;
#pragma unroll
  for (int h = 0; h < kRounds; ++h) {
    if (kG * h >= k) break;
    const unsigned m = __ballot_sync(kFull, v[h]) & group;
    if (v[h]) {
      const int at = n + __popc(m & below);
      st.j[at] = j[h];
      if constexpr (kPos) {
#pragma unroll
        for (int d = 0; d < 3; ++d) st.x[at][d] = pos(sp[h][d], qp[d]);
      }
    }
    n += __popc(m);
  }
  return n;
}

// Steps 1 and 2 alone: the query's valid slots' support rows, compacted
// in slot order into `st` (stage_valid_slots without positions).
template <int kG>
__device__ __forceinline__ int stage_valid_rows(
    const int32_t* __restrict__ idx_row, const bool* __restrict__ mask_row,
    int k, bool live, GroupRows& st) {
  const float none[3] = {};
  return stage_valid_slots<kG>(idx_row, mask_row, k, live, nullptr, none,
                               NoPositions{}, st);
}

// Row j of a [Ns, C] matrix, from a pointer into its row 0: one 32 x 32 ->
// 64-bit multiply-add (row_bytes = C * sizeof(T), below kMaxRowBytes).
constexpr long long kMaxRowBytes = 1LL << 31;
template <typename T>
__device__ __forceinline__ const T* row_at(const T* row0, int j,
                                           unsigned row_bytes) {
  return reinterpret_cast<const T*>(
      reinterpret_cast<const char*>(row0) +
      static_cast<size_t>(static_cast<unsigned>(j)) * row_bytes);
}

// Lanes a query group takes for `units` units a query: the largest of 32,
// 16 and 8 (down to `narrowest`) whose passes (ceil(units / lanes)) keep
// at least 85% of its lanes busy, else the one that keeps the most busy.
inline int group_lanes_for(int units, int narrowest = 8) {
  int best = 32;
  double best_busy = 0.0;
  for (int g : {32, 16, 8}) {
    if (g < narrowest) break;
    const int passes = (units + g - 1) / g;
    const double busy = static_cast<double>(units) / (passes * g);
    if (busy >= 0.85) return g;
    if (busy > best_busy) {
      best = g;
      best_busy = busy;
    }
  }
  return best;
}

// How a launch cuts each query's `passes`: `slices` items a query of `per`
// passes each (the last may hold fewer). One slice where the queries alone
// give every SM kFillThreads lanes of groups, else as many as that needs.
constexpr int kFillThreads = 4096;
struct PassSplit {
  int slices, per;
};
inline PassSplit split_passes(long long queries, int passes, int lanes) {
  const long long want =
      static_cast<long long>(sm_count()) * kFillThreads / lanes;
  const long long slices = std::min<long long>(
      passes, std::max(1LL, (want + queries - 1) / queries));
  const int per = static_cast<int>((passes + slices - 1) / slices);
  return {(passes + per - 1) / per, per};
}

// The item of the calling lane's group: query row (b * Nq + q) and slice;
// items are query-major, so a block's groups take consecutive queries and
// write one contiguous span of the output.
struct GroupItem {
  bool live;
  size_t row;
  int slice;
};
template <int kG>
__device__ __forceinline__ GroupItem group_item(long long items,
                                                int slices) {
  const long long item =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kG) +
      threadIdx.x / kG;
  const bool live = item < items;
  return {live, live ? static_cast<size_t>(item / slices) : 0,
          live ? static_cast<int>(item % slices) : 0};
}

// A unit of kW = kBytes / sizeof(T) consecutive channels of a row (the
// forwards' lanes and K8b's launch 1; kBytes 8 or 16). Vectorized (kVec): one load of
// kBytes through the read-only path and one store; needs rows of a
// multiple of kW channels aligned to kBytes (runs_ok<T, kW>). Scalar:
// element by element, any C and any alignment, `left` channels of the row
// from p.
template <typename T, bool kVec, int kBytes>
struct ChannelUnit {
  static constexpr int kW = kBytes / static_cast<int>(sizeof(T));
  using Vec = std::conditional_t<kBytes == 16, uint4, uint2>;
  struct alignas(kBytes) Raw {
    T v[kW];
  };
  __device__ __forceinline__ static Raw load(const T* __restrict__ p,
                                             int left) {
    Raw r;
    if (kVec) {
      *reinterpret_cast<Vec*>(&r) = __ldg(reinterpret_cast<const Vec*>(p));
    } else {
#pragma unroll
      for (int i = 0; i < kW; ++i)
        r.v[i] = i < left ? p[i] : from_f32<T>(0.f);
    }
    return r;
  }
  __device__ __forceinline__ static void store(T* __restrict__ p, int left,
                                               const float (&x)[kW]) {
    Raw r;
#pragma unroll
    for (int i = 0; i < kW; ++i) r.v[i] = from_f32<T>(x[i]);
    if (kVec) {
      *reinterpret_cast<Vec*>(p) = *reinterpret_cast<const Vec*>(&r);
    } else {
#pragma unroll
      for (int i = 0; i < kW; ++i)
        if (i < left) p[i] = r.v[i];
    }
  }
  __host__ __device__ static int units(int c) { return (c + kW - 1) / kW; }
};

// Launch a query-group kernel over `queries` queries of `units` units
// each, at the group width group_lanes_for picks (`narrowest` lanes at
// least) and the slices split_passes gives: launch(lanes, blocks, items,
// split) launches it in `blocks` blocks of kGroupThreads, lanes a
// std::integral_constant of kG. Returns the launch's error code.
template <typename Launch>
int launch_query_groups(long long queries, int units, int narrowest,
                        Launch launch) {
  const auto at = [&](auto lanes) {
    constexpr int kG = decltype(lanes)::value;
    constexpr int kGroups = kGroupThreads / kG;
    const PassSplit sp = split_passes(queries, (units + kG - 1) / kG, kG);
    const long long items = queries * sp.slices;
    const long long blocks = (items + kGroups - 1) / kGroups;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    launch(lanes, static_cast<unsigned>(blocks), items, sp);
    return static_cast<int>(cudaGetLastError());
  };
  switch (group_lanes_for(units, narrowest)) {
    case 8:
      return at(std::integral_constant<int, 8>{});
    case 16:
      return at(std::integral_constant<int, 16>{});
    default:
      return at(std::integral_constant<int, 32>{});
  }
}

}  // namespace
