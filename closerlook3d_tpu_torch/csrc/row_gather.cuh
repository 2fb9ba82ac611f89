// Lane layout of the row kernels (K13 in gather_reduce.cu, and the
// backward gathers of K6 and K10 over a reverse neighbor index): a group of
// kG lanes of one warp owns one row and a slice of its channels, so a warp
// holds 32 / kG rows. Narrow rows take small groups (C = 72 bf16 needs 9
// lanes of 8 channels: two rows a warp in groups of 16), wide ones whole
// warps and several slices. Also the gather itself (csr_gather_kernel),
// which both backward gathers end with.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxK = 64;  // slots per query (ops/neighbors.py MAX_K)
constexpr unsigned kFull = 0xffffffffu;

// The channels one lane of a group of kG covers in a slice of kG x kW
// channels, kW = kBytes of T (16 or 8 bytes), as one Raw. Vectorized
// (kVec): kW consecutive channels, one load and store of kBytes; needs
// C % kW == 0 and 16-byte aligned rows. Scalar: channels lane, lane + kG,
// ..., coalesced across the group, any C and any alignment. f32 rows of
// the same channels (per-query statistics, cotangents, per-slot terms)
// load as kW floats.
template <typename T, bool kVec, int kG = 32, int kBytes = 16>
struct GroupChannels {
  static constexpr int kW = kBytes / sizeof(T);
  static constexpr int kSlice = kG * kW;
  using Vec = std::conditional_t<kBytes == 16, uint4, uint2>;
  struct alignas(kBytes) Raw {
    T v[kW];
  };
  __device__ __forceinline__ static Vec bits(const Raw& r) {
    return *reinterpret_cast<const Vec*>(&r);
  }
  __device__ __forceinline__ static Raw raw(const Vec& u) {
    Raw r;
    *reinterpret_cast<Vec*>(&r) = u;
    return r;
  }
  int first, c;

  // The lanes of the calling lane's group, for __syncwarp.
  __device__ __forceinline__ static unsigned group_mask() {
    const int lane = threadIdx.x & 31;
    return kG == 32 ? kFull : ((1u << kG) - 1u) << (lane - lane % kG);
  }

  // lane: the lane's index within its group, 0..kG-1
  __device__ GroupChannels(int slice, int lane, int c_)
      : first(slice * kSlice + (kVec ? lane * kW : lane)), c(c_) {}
  __device__ __forceinline__ int ch(int i) const {
    return first + (kVec ? i : kG * i);
  }
  __device__ __forceinline__ Raw load(const T* __restrict__ row) const {
    Raw r;
    if (kVec) {
      r = raw(first < c ? *reinterpret_cast<const Vec*>(row + first)
                        : Vec{});
    } else {
#pragma unroll
      for (int i = 0; i < kW; ++i)
        r.v[i] = ch(i) < c ? row[ch(i)] : from_f32<T>(0.f);
    }
    return r;
  }
  __device__ __forceinline__ static void to_floats(const Raw& r,
                                                   float (&x)[kW]) {
#pragma unroll
    for (int i = 0; i < kW; ++i) x[i] = to_f32(r.v[i]);
  }
  __device__ __forceinline__ static void add(float (&acc)[kW],
                                             const Raw& r) {
#pragma unroll
    for (int i = 0; i < kW; ++i) acc[i] += to_f32(r.v[i]);
  }
  __device__ __forceinline__ void store(T* __restrict__ row,
                                        const float (&acc)[kW]) const {
    Raw r;
#pragma unroll
    for (int i = 0; i < kW; ++i) r.v[i] = from_f32<T>(acc[i]);
    if (kVec) {
      if (first < c) *reinterpret_cast<Vec*>(row + first) = bits(r);
    } else {
#pragma unroll
      for (int i = 0; i < kW; ++i)
        if (ch(i) < c) row[ch(i)] = r.v[i];
    }
  }
  // f32 values of the lane's channels (0 past C)
  __device__ __forceinline__ void load_f32(const float* __restrict__ row,
                                           float (&x)[kW]) const {
    if (kVec) {
      if constexpr (kW % 4 == 0) {
#pragma unroll
        for (int i = 0; i < kW; i += 4) {
          const float4 v = first < c ? *reinterpret_cast<const float4*>(
                                           row + first + i)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
          x[i] = v.x;
          x[i + 1] = v.y;
          x[i + 2] = v.z;
          x[i + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < kW; i += 2) {
          const float2 v = first < c ? *reinterpret_cast<const float2*>(
                                           row + first + i)
                                     : make_float2(0.f, 0.f);
          x[i] = v.x;
          x[i + 1] = v.y;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kW; ++i) x[i] = ch(i) < c ? row[ch(i)] : 0.f;
    }
  }
  __device__ __forceinline__ void store_f32(float* __restrict__ row,
                                            const float (&x)[kW]) const {
    if (kVec) {
      if (first < c) {
        if constexpr (kW % 4 == 0) {
#pragma unroll
          for (int i = 0; i < kW; i += 4)
            *reinterpret_cast<float4*>(row + first + i) =
                make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
        } else {
#pragma unroll
          for (int i = 0; i < kW; i += 2)
            *reinterpret_cast<float2*>(row + first + i) =
                make_float2(x[i], x[i + 1]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kW; ++i)
        if (ch(i) < c) row[ch(i)] = x[i];
    }
  }
};

// The valid slots of one query for a group of kG lanes (each group of the
// warp its own query; live: the group has one): every slot's idx and mask
// read at once (lane lg the slots lg, lg + kG, ...), then
// visit(at, t, j) for the at-th valid slot in slot order, slot t naming
// support row j, by the lane that read it. Returns their number. Every
// lane of the warp takes part.
template <int kG, typename Visit>
__device__ __forceinline__ int stage_group_slots(
    const int32_t* __restrict__ idx_row, const bool* __restrict__ mask_row,
    int k, bool live, Visit visit) {
  constexpr int kRounds = kMaxK / kG;
  const int lane = threadIdx.x & 31, lg = lane % kG;
  const unsigned group =
      kG == 32 ? kFull : ((1u << kG) - 1u) << (lane - lg);
  const unsigned below = (1u << lane) - 1u;
  int j[kRounds];
  bool v[kRounds];
#pragma unroll
  for (int h = 0; h < kRounds; ++h) {
    const int t = lg + kG * h;
    const bool in = live && t < k;
    j[h] = in ? idx_row[t] : 0;
    v[h] = in && mask_row[t];
  }
  int n = 0;
#pragma unroll
  for (int h = 0; h < kRounds; ++h) {
    const unsigned m = __ballot_sync(kFull, v[h]) & group;
    if (v[h]) visit(n + __popc(m & below), lg + kG * h, j[h]);
    n += __popc(m);
  }
  return n;
}

// Whether the row kernels may take 16-byte vectors: C a multiple of the
// vector width of T and every row pointer 16-byte aligned.
template <typename T, typename... Ptr>
bool vec_ok(int c, const Ptr*... ptrs) {
  return c % (16 / sizeof(T)) == 0 &&
         ((reinterpret_cast<uintptr_t>(ptrs) % 16 == 0) && ...);
}

// Whether runs of kN values of T may be loaded as row_terms.cuh's load_run
// and query_groups.cuh's vector ChannelUnit load them at every multiple of
// kN of these rows.
template <typename T, int kN, typename... Ptr>
bool runs_ok(int c, const Ptr*... ptrs) {
  constexpr int kBytes = kN * sizeof(T) < 16 ? kN * sizeof(T) : 16;
  return c % kN == 0 &&
         ((reinterpret_cast<uintptr_t>(ptrs) % kBytes == 0) && ...);
}

// Lanes a row takes: the fewest of 8, 16 or 32 that cover its channels at
// kW = kBytes of T a lane; rows wider than 32 lanes take whole warps, slice
// by slice.
template <typename T, int kBytes = 16>
int group_lanes(int c) {
  constexpr int kW = kBytes / static_cast<int>(sizeof(T));
  const int lanes = (c + kW - 1) / kW;
  return lanes <= 8 ? 8 : lanes <= 16 ? 16 : 32;
}

// Lanes a query takes in the query-major first launches of the backward
// gathers: as group_lanes, but at least 16 (their staging in shared memory
// is per group). K6's take 8 bytes a lane (kPrepBytes): half the registers
// of a query's five f32 rows, so twice the queries in flight.
constexpr int kPrepBytes = 8;
template <typename T, int kBytes = 16>
int prep_lanes(int c) {
  return std::max(16, group_lanes<T, kBytes>(c));
}

// The device's SMs, read once.
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Blocks of the query-major part of those launches, whose `groups` query
// groups take the `items` (query, slice) pairs in turn: about kPrepItems
// each where there are many, one each where that leaves the SMs short of
// blocks.
constexpr int kPrepItems = 8;
inline int prep_blocks(int groups, long long items) {
  const long long one_each = (items + groups - 1) / groups;
  const long long looped = (one_each + kPrepItems - 1) / kPrepItems;
  return static_cast<int>(
      std::max(looped, std::min(one_each, 4LL * sm_count())));
}

template <typename T, int kG = 32, int kBytes = 16>
int slices_of(int c) {
  constexpr int width = GroupChannels<T, true, kG, kBytes>::kSlice;
  return (c + width - 1) / width;
}

// The second launch of the backward gathers of K6 and K10: for support row
// s of cloud b, over the slots (q, t) that name it in the reverse index's
// (q, t) order (reverse_index.cuh),
//   out1[s, c] = sum of terms[slot, c],    terms [B, Nq * K, C] f32, the
//                                          per-slot terms of launch 1;
//   out2[s, c] = sum of per_query[q, c]    (kSecond), [B, Nq, C] f32,
// each an f32 sum from +0 in that order, written once in T; zeros where no
// slot names s. A group of kG lanes owns a row and a channel slice and
// loads the rows of kBatch slots at once (2 with kSecond, else 4).
constexpr int kGatherThreads = 256;

template <typename T, bool kVec, int kG, bool kSecond>
__global__ void __launch_bounds__(kGatherThreads)
    csr_gather_kernel(const int32_t* __restrict__ offsets,
                      const int32_t* __restrict__ slots,
                      const float* __restrict__ terms,
                      const float* __restrict__ per_query, int nq, int ns,
                      int c, int k, int slices, T* __restrict__ out1,
                      T* __restrict__ out2) {
  using Lanes = GroupChannels<T, kVec, kG>;
  constexpr int kW = Lanes::kW;
  constexpr int kRows = kGatherThreads / kG;  // rows a block
  constexpr int kGatherBatch = kSecond ? 2 : 4;
  const int b = blockIdx.y, slice = blockIdx.x % slices;
  const int s = (blockIdx.x / slices) * kRows + threadIdx.x / kG;
  if (s >= ns) return;  // no warp-wide step below: a group may leave
  const Lanes lc(slice, threadIdx.x % kG, c);
  const int32_t* ob = offsets + static_cast<size_t>(b) * (ns + 1);
  const int32_t* sb = slots + static_cast<size_t>(b) * nq * k;
  const float* tb = terms + static_cast<size_t>(b) * nq * k * c;
  const float* pb = kSecond ? per_query + static_cast<size_t>(b) * nq * c
                            : nullptr;
  const int start = ob[s], end = ob[s + 1];
  float a1[kW] = {}, a2[kW] = {};
  for (int e0 = start; e0 < end; e0 += kGatherBatch) {
    int slot[kGatherBatch];
#pragma unroll
    for (int u = 0; u < kGatherBatch; ++u) slot[u] = sb[min(e0 + u, end - 1)];
    float x[kGatherBatch][kW], y[kGatherBatch][kW];
#pragma unroll
    for (int u = 0; u < kGatherBatch; ++u) {
      lc.load_f32(tb + static_cast<size_t>(slot[u]) * c, x[u]);
      if constexpr (kSecond)
        lc.load_f32(pb + static_cast<size_t>(slot[u] / k) * c, y[u]);
    }
#pragma unroll
    for (int u = 0; u < kGatherBatch; ++u) {
      if (e0 + u < end) {
#pragma unroll
        for (int i = 0; i < kW; ++i) {
          a1[i] = __fadd_rn(a1[i], x[u][i]);
          if constexpr (kSecond) a2[i] = __fadd_rn(a2[i], y[u][i]);
        }
      }
    }
  }
  const size_t row = (static_cast<size_t>(b) * ns + s) * c;
  lc.store(out1 + row, a1);
  if constexpr (kSecond) lc.store(out2 + row, a2);
}

template <typename T, bool kVec, int kG, bool kSecond>
void launch_csr_gather_lanes(const int32_t* offsets, const int32_t* slots,
                             const float* terms, const float* per_query,
                             int b, int nq, int ns, int c, int k, T* out1,
                             T* out2, cudaStream_t stream) {
  const int slices = slices_of<T, kG>(c);
  constexpr int kRows = kGatherThreads / kG;
  const dim3 grid((ns + kRows - 1) / kRows * slices, b);
  csr_gather_kernel<T, kVec, kG, kSecond><<<grid, kGatherThreads, 0, stream>>>(
      offsets, slots, terms, per_query, nq, ns, c, k, slices, out1, out2);
}

// csr_gather_kernel at the fewest lanes a row that cover C.
template <typename T, bool kVec, bool kSecond>
void launch_csr_gather(const int32_t* offsets, const int32_t* slots,
                       const float* terms, const float* per_query, int b,
                       int nq, int ns, int c, int k, T* out1, T* out2,
                       cudaStream_t stream) {
  const int lanes = group_lanes<T>(c);
  if (lanes == 8)
    launch_csr_gather_lanes<T, kVec, 8, kSecond>(
        offsets, slots, terms, per_query, b, nq, ns, c, k, out1, out2, stream);
  else if (lanes == 16)
    launch_csr_gather_lanes<T, kVec, 16, kSecond>(
        offsets, slots, terms, per_query, b, nq, ns, c, k, out1, out2, stream);
  else
    launch_csr_gather_lanes<T, kVec, 32, kSecond>(
        offsets, slots, terms, per_query, b, nq, ns, c, k, out1, out2, stream);
}

// Bytes of dynamic shared memory `kernel` may take on this device beside
// its static shared memory; raises the kernel's limit to that. Call once
// per kernel (a function-local static).
template <typename Kernel>
int dynamic_smem_room(Kernel* kernel) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, kernel);
  const int room = optin - static_cast<int>(attr.sharedSizeBytes);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       room);
  return room;
}

}  // namespace
