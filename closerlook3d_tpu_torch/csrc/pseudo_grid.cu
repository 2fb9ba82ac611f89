// Pseudo-grid (KPConv-style) kernel-point correlation, forward and
// backward in features. For query q with neighbor slots k (index idx[k],
// validity mask[k]) over support features f [Ns, C] and kernel points
// kp [Kp, 3]:
//   u_k     = (s[idx[k]] - q) * inv_r                        (f32)
//   d2[k,p] = ((u0 - kp0)^2 + (u1 - kp1)^2) + (u2 - kp2)^2   (f32)
//   w[k,p]  = mask[k] * infl(d2[k,p]),
//     linear:   max(1 - sqrt(d2) * coef, 0),   coef = 1 / extent
//     constant: d2 <= coef,                    coef = extent^2
//     gaussian: exp(-d2 * coef),               coef = 1 / (2 (0.3 extent)^2)
//   out[q, p*C + c] = sum_k w[k,p] * f[idx[k], c]   (p-major, f32, rounded
//                                                    once to f's dtype)
// and the backward scatters onto the support rows:
//   df[s, c] = sum over (q, k) with idx[q,k] = s of
//              sum_p w[k,p] * dy[q, p*C + c].
// Positions and kernel points get no gradient, as in the JAX package.
// Duplicated valid indices count once per slot.
//
// Replaces: closerlook3d_tpu/ops/pallas/pseudo_grid.py:_fwd_kernel (entry
// pseudo_grid_fused -> _call) and _bwd_kernel (the custom VJP's _bwd).
// The TPU kernels gather slot positions and features with one-hot MXU
// matmuls over Morton support chunks and evaluate the influences on a
// slot grid; here each block reads its neighbor rows by index.
//
// Numerics follow the TPU kernel (its _influence_rows): u multiplies by
// 1/r in f32 (the jnp gather path divides and rounds dp and the
// influences to the features' dtype first), every product and sum of u
// and d2 is rounded to f32 in that order (the intrinsics keep nvcc from
// contracting them into FMAs, so the influences equal the plain PyTorch
// version's bit for bit, up to exp's last ulp), and the sums over slots
// are f32, rounded once to the features' dtype.
//
// Forward layout (query_groups.cuh): a group of 8-32 lanes per query (and
// slice of its output where queries are few), several groups a block and
// no block-wide barrier. The group compacts its query's valid slots in
// slot order, stages their u and Kp influences in its own shared memory,
// then its lanes take units of 16 bytes of channels (kW) by kSums / kW
// kernel points, whose kSums (16, or 32 where C is wide) sums stay in
// registers; a row's 16-byte vectors are read and the output's 16-byte
// vectors written by neighbouring lanes. The backward takes two launches
// over a reverse neighbor index (reverse_index.cuh, row_gather.cuh): each
// valid slot's f32 sum over the
// kernel points by query (pseudo_grid_sums_kernel), then a gather per
// support row that adds its slots' sums in (q, t) order and writes the row
// once in the features' dtype: no float atomics, no zeroed scratch, no
// cast, and the same bits on every run.
//
// Bound on the H100: bytes. The output is Kp = 15 times as wide as the
// features, so writing it dominates (B*Nq*Kp*C values, ~90% of the bytes);
// the gathered feature rows are L2-resident, as for the PosPool kernels.
// Yet the forward's pace is set by chains of dependent loads a query (idx
// and mask, positions, rows) and by instructions, not bytes: hence no
// block barrier, valid slots only, 16 bytes a lane. It runs at 2-5x the
// bound: per (unit, slot) ~45 instructions, a third of them converting
// bf16 to f32 and forming addresses, at 30-40% of the issue rate, so
// wider units (fewer conversions an FMA) pay where the rows are wide and
// fewer registers pay nowhere (the sums spill). The backward reads dy
// once and writes df once, but also writes and reads back an f32
// sum per valid slot and channel: at the strided calls (9.5 valid slots a
// query on ModelNet40's synthetic clouds) that is more than dy itself.
// Its launches are latency-bound (two to three dependent round trips to
// memory a query or row).

#include "query_groups.cuh"
#include "reverse_index.cuh"

namespace {

constexpr int kMaxKp = 64;  // kernel points

enum Influence { kLinear = 0, kConstant = 1, kGaussian = 2 };

__device__ __forceinline__ float influence(float d2, int mode, float coef) {
  if (mode == kLinear) {
    return fmaxf(__fsub_rn(1.f, __fmul_rn(__fsqrt_rn(d2), coef)), 0.f);
  }
  if (mode == kConstant) return d2 <= coef ? 1.f : 0.f;
  return expf(-__fmul_rn(d2, coef));
}

// The influence of kernel point p (kp [Kp, 3]) on a slot at u.
__device__ __forceinline__ float slot_influence(const float* u,
                                                const float* __restrict__ kp,
                                                int p, int mode, float coef) {
  const float d0 = __fsub_rn(u[0], __ldg(kp + p * 3 + 0));
  const float d1 = __fsub_rn(u[1], __ldg(kp + p * 3 + 1));
  const float d2 = __fsub_rn(u[2], __ldg(kp + p * 3 + 2));
  float dd = __fmul_rn(d0, d0);
  dd = __fadd_rn(dd, __fmul_rn(d1, d1));
  dd = __fadd_rn(dd, __fmul_rn(d2, d2));
  return influence(dd, mode, coef);
}

// A forward unit: kW consecutive channels (16 bytes of T) of kPC kernel
// points, kSums = kPC * kW f32 sums in registers. Vectorized (kVec): one
// 16-byte load of a row and one 16-byte store per kernel point; needs
// C % kW == 0 and 16-byte aligned features. Scalar: element by element,
// any C and any alignment.
template <typename T, bool kVec, int kSums>
struct FwdUnit {
  static constexpr int kW = 16 / sizeof(T);
  static constexpr int kPC = kSums / kW;
  struct alignas(16) Raw {
    T v[kW];
  };
  // the unit's channels at p, `left` of them in the row
  __device__ __forceinline__ static Raw load(const T* __restrict__ p,
                                             int left) {
    Raw r;
    if (kVec) {
      *reinterpret_cast<uint4*>(&r) =
          __ldg(reinterpret_cast<const uint4*>(p));
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
      __stcs(reinterpret_cast<uint4*>(p), *reinterpret_cast<const uint4*>(&r));
    } else {
#pragma unroll
      for (int i = 0; i < kW; ++i)
        if (i < left) p[i] = r.v[i];
    }
  }
  // the units of a query: channel vectors x kernel-point chunks
  static int units(int c, int kpn) {
    return (c + kW - 1) / kW * ((kpn + kPC - 1) / kPC);
  }
};

// Floats of a forward group's shared memory: its GroupSlots, then the
// influences w[at * kpw + p] of its valid slots (kpw: Kp rounded up to the
// unit's kPC), a multiple of 4 so that every group's slice is 16-byte
// aligned.
__host__ __device__ inline int fwd_group_floats(int k, int kpw) {
  const int n = static_cast<int>(sizeof(GroupSlots) / sizeof(float)) +
                k * kpw;
  return (n + 3) / 4 * 4;
}

// K10 forward in query groups (query_groups.cuh): a group of kG lanes per
// item, a query and a slice of its passes. The group stages its valid
// slots and u, then their influences (a lane per (valid slot, kernel
// point)), in its slice of dynamic shared memory behind __syncwarp only.
// Unit e * kG + lg of pass e belongs to lane lg: kernel-point chunk
// pc = unit / CV and channel vector unit % CV (CV = C / kW), so a pass's
// lanes read neighbouring vectors of a row and write neighbouring vectors
// of one output row per kernel point (16-byte stores with the streaming
// hint: the output is written once). Each sum runs over the valid slots
// in slot order, fma(w, f, acc) from +0, rounded once; a lane starts the
// row loads of kSlotBatch slots at once.

template <typename T, bool kVec, int kSums, int kG>
__global__ void __launch_bounds__(kGroupThreads)
    pseudo_grid_kernel(const float* __restrict__ q,
                       const float* __restrict__ s,
                       const T* __restrict__ f,
                       const int32_t* __restrict__ idx,
                       const bool* __restrict__ mask,
                       const float* __restrict__ kp, int nq, int ns, int c,
                       int k, int kpn, float inv_r, float coef, int mode,
                       long long items, int slices, int per,
                       T* __restrict__ out) {
  using U = FwdUnit<T, kVec, kSums>;
  constexpr int kW = U::kW, kPC = U::kPC;
  // slots whose rows a lane loads at once: more where the units are wide
  constexpr int kSlotBatch = kSums == 32 ? 4 : 2;
  extern __shared__ float4 s_fwd[];
  const int kpw = (kpn + kPC - 1) / kPC * kPC;
  float* mine = reinterpret_cast<float*>(s_fwd) +
                static_cast<size_t>(threadIdx.x / kG) *
                    fwd_group_floats(k, kpw);
  GroupSlots& st = *reinterpret_cast<GroupSlots*>(mine);
  float* sw = mine + sizeof(GroupSlots) / sizeof(float);
  const int lg = threadIdx.x % kG;
  const GroupItem it = group_item<kG>(items, slices);
  const size_t b = it.row / nq;
  float qp[3] = {};
  if (it.live) {
#pragma unroll
    for (int d = 0; d < 3; ++d) qp[d] = q[it.row * 3 + d];
  }
  const int n = stage_valid_slots<kG>(
      idx + it.row * k, mask + it.row * k, k, it.live, s + b * ns * 3, qp,
      [inv_r](float sv, float qv) {
        return __fmul_rn(__fsub_rn(sv, qv), inv_r);
      },
      st);
  __syncwarp();
  for (int e = lg; e < n * kpw; e += kG) {
    const int i = e / kpw, p = e - i * kpw;
    sw[e] = p < kpn ? slot_influence(st.x[i], kp, p, mode, coef) : 0.f;
  }
  __syncwarp();
  if (!it.live) return;
  const int cvs = (c + kW - 1) / kW;
  const int u_end = min(cvs * (kpw / kPC), (it.slice + 1) * per * kG);
  const unsigned row_bytes = static_cast<unsigned>(c) * sizeof(T);
  for (int unit = it.slice * per * kG + lg; unit < u_end; unit += kG) {
    const int pc = unit / cvs;
    const int ch0 = (unit - pc * cvs) * kW;
    const T* f0 = f + b * ns * c + ch0;  // the unit's channels of row 0
    float acc[kPC][kW] = {};
    for (int i0 = 0; i0 < n; i0 += kSlotBatch) {
      typename U::Raw r[kSlotBatch];
#pragma unroll
      for (int v = 0; v < kSlotBatch; ++v)
        r[v] = U::load(row_at(f0, st.j[min(i0 + v, n - 1)], row_bytes),
                       c - ch0);
#pragma unroll
      for (int v = 0; v < kSlotBatch; ++v) {
        if (i0 + v < n) {
          const float* w = sw + (i0 + v) * kpw + pc * kPC;
#pragma unroll
          for (int pp = 0; pp < kPC; ++pp) {
            const float wv = w[pp];
#pragma unroll
            for (int ii = 0; ii < kW; ++ii)
              acc[pp][ii] = __fmaf_rn(wv, to_f32(r[v].v[ii]), acc[pp][ii]);
          }
        }
      }
    }
    T* o = out + (it.row * kpn + pc * kPC) * c + ch0;
#pragma unroll
    for (int pp = 0; pp < kPC; ++pp)
      if (pc * kPC + pp < kpn) U::store(o + pp * c, c - ch0, acc[pp]);
  }
}

template <typename T, bool kVec, int kSums, int kG>
int launch_fwd_lanes(const float* q, const float* s, const T* f,
                     const int32_t* idx, const bool* mask, const float* kp,
                     int b, int nq, int ns, int c, int k, int kpn,
                     float inv_r, float coef, int mode, T* out,
                     cudaStream_t stream) {
  using U = FwdUnit<T, kVec, kSums>;
  // the influences of 64 slots x 64 kernel points outgrow 48 KB a block
  static const int room =
      dynamic_smem_room(pseudo_grid_kernel<T, kVec, kSums, kG>);
  const int kpw = (kpn + U::kPC - 1) / U::kPC * U::kPC;
  const long long queries = static_cast<long long>(b) * nq;
  const PassSplit sp =
      split_passes(queries, (U::units(c, kpn) + kG - 1) / kG, kG);
  const int group_bytes =
      fwd_group_floats(k, kpw) * static_cast<int>(sizeof(float));
  // whole warps of groups, as many as fit
  constexpr int kWarpGroups = 32 / kG;
  const int groups = std::min(kGroupThreads / kG,
                              room / group_bytes / kWarpGroups * kWarpGroups);
  const long long items = queries * sp.slices;
  const long long blocks = (items + groups - 1) / groups;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  pseudo_grid_kernel<T, kVec, kSums, kG>
      <<<static_cast<unsigned>(blocks), groups * kG, groups * group_bytes,
         stream>>>(q, s, f, idx, mask, kp, nq, ns, c, k, kpn, inv_r, coef,
                   mode, items, sp.slices, sp.per, out);
  return static_cast<int>(cudaGetLastError());
}

// The forward at the group width that keeps most lanes busy over its units
// (group_lanes_for).
template <typename T, bool kVec, int kSums>
int launch_fwd_sums(const float* q, const float* s, const T* f,
                    const int32_t* idx, const bool* mask, const float* kp,
                    int b, int nq, int ns, int c, int k, int kpn, float inv_r,
                    float coef, int mode, T* out, cudaStream_t stream) {
  switch (group_lanes_for(FwdUnit<T, kVec, kSums>::units(c, kpn))) {
    case 8:
      return launch_fwd_lanes<T, kVec, kSums, 8>(
          q, s, f, idx, mask, kp, b, nq, ns, c, k, kpn, inv_r, coef, mode,
          out, stream);
    case 16:
      return launch_fwd_lanes<T, kVec, kSums, 16>(
          q, s, f, idx, mask, kp, b, nq, ns, c, k, kpn, inv_r, coef, mode,
          out, stream);
    default:
      return launch_fwd_lanes<T, kVec, kSums, 32>(
          q, s, f, idx, mask, kp, b, nq, ns, c, k, kpn, inv_r, coef, mode,
          out, stream);
  }
}

// 32 sums a lane (16 bytes of channels x 4 kernel points in bf16) where
// Kp fills a chunk and the units still make two passes of 32 lanes (bf16:
// C >= 144 at Kp = 15); else 16, so that narrow rows keep groups busy.
template <typename T, bool kVec>
int launch_fwd_as(const float* q, const float* s, const T* f,
                  const int32_t* idx, const bool* mask, const float* kp,
                  int b, int nq, int ns, int c, int k, int kpn, float inv_r,
                  float coef, int mode, T* out, cudaStream_t stream) {
  using Wide = FwdUnit<T, kVec, 32>;
  if (kpn >= Wide::kPC && Wide::units(c, kpn) >= 64)
    return launch_fwd_sums<T, kVec, 32>(q, s, f, idx, mask, kp, b, nq, ns, c,
                                        k, kpn, inv_r, coef, mode, out,
                                        stream);
  return launch_fwd_sums<T, kVec, 16>(q, s, f, idx, mask, kp, b, nq, ns, c,
                                      k, kpn, inv_r, coef, mode, out,
                                      stream);
}

template <typename T>
int launch_fwd(const float* q, const float* s, const void* f,
               const int32_t* idx, const bool* mask, const float* kp, int b,
               int nq, int ns, int c, int k, int kpn, float inv_r,
               float coef, int mode, void* out, cudaStream_t stream) {
  const T* fp = static_cast<const T*>(f);
  T* op = static_cast<T*>(out);
  if (vec_ok<T>(c, f, out))
    return launch_fwd_as<T, true>(q, s, fp, idx, mask, kp, b, nq, ns, c, k,
                                  kpn, inv_r, coef, mode, op, stream);
  return launch_fwd_as<T, false>(q, s, fp, idx, mask, kp, b, nq, ns, c, k,
                                 kpn, inv_r, coef, mode, op, stream);
}

constexpr int kPrepThreads = 512;
constexpr int kSlotChunk = 4;  // valid slots whose sums a lane keeps
constexpr int kDyRows = 4;     // dy rows (kernel points) loaded at once

// Shared memory of a query group in the first launch of K10's backward:
// its valid slots' numbers and u, and one chunk's influences.
struct SlotStage {
  int t[kMaxK];
  float u[kMaxK][3];
  float w[kSlotChunk][kMaxKp];
};

// K10 backward, launch 1. Blocks [0, B) build cloud b's reverse index
// (reverse_index.cuh). The others, query-major, a group of kG lanes per
// query and channel slice, write each valid slot's f32 sum over the
// kernel points,
//   sums[q, t, c] = fma(w[t, Kp-1], dy[q, (Kp-1)*C + c], ...
//                       fma(w[t, 0], dy[q, c], 0)),
// with u and the influences w recomputed by the staging code's rounded
// intrinsics (bit-equal to the forward's). The group stages its valid
// slots' numbers and u in shared memory (dynamic, beside the index
// blocks' counters), then, kSlotChunk slots at a time, their influences (a
// lane per (slot, kernel point)) and their sums in registers, reading the
// query's dy row kDyRows kernel points at a time (the first with the
// slots) once a chunk. Masked slots are not written. A group takes about
// kPrepItems queries in turn where there are many (prep_blocks).
template <typename T, bool kVec, int kG, bool kSharedIndex>
__global__ void __launch_bounds__(kPrepThreads)
    pseudo_grid_sums_kernel(const float* __restrict__ q,
                            const float* __restrict__ s,
                            const float* __restrict__ kp,
                            const T* __restrict__ dy,
                            const int32_t* __restrict__ idx,
                            const bool* __restrict__ mask, int clouds,
                            int nq, int ns, int c, int k, int kpn,
                            float inv_r, float coef, int mode, int slices,
                            int32_t* __restrict__ offsets,
                            int32_t* __restrict__ slots,
                            int32_t* __restrict__ raw,
                            int* __restrict__ counters,
                            float* __restrict__ sums) {
  extern __shared__ int s_dyn[];
  if (blockIdx.x < clouds) {
    build_reverse_index<kPrepThreads, kSharedIndex>(
        idx, mask, nq, ns, k, blockIdx.x, s_dyn, offsets, slots, raw,
        counters);
    return;
  }
  using Lanes = GroupChannels<T, kVec, kG>;
  using Raw = typename Lanes::Raw;
  constexpr int kW = Lanes::kW;
  constexpr int kGroups = kPrepThreads / kG;  // queries a block
  const int grp = threadIdx.x / kG, lg = threadIdx.x % kG;
  SlotStage& st = reinterpret_cast<SlotStage*>(s_dyn)[grp];
  const long long queries = static_cast<long long>(clouds) * nq;
  const long long total = queries * slices;  // (slice, cloud, query) items
  const long long stride = static_cast<long long>(gridDim.x - clouds) * kGroups;
  // block-uniform trip count: every warp takes part in each round's staging
  for (long long item0 = static_cast<long long>(blockIdx.x - clouds) * kGroups;
       item0 < total; item0 += stride) {
    const long long item = item0 + grp;
    const bool live = item < total;  // group-uniform
    const int slice = static_cast<int>(item / queries);
    const size_t row = static_cast<size_t>(item % queries);  // b * nq + q
    const Lanes lc(slice, lg, c);
    const float* sb = s + row / nq * ns * 3;
    const T* dq = dy + row * kpn * c;
    Raw r[kDyRows];
    float qp[3] = {};
    if (live) {
#pragma unroll
      for (int v = 0; v < kDyRows; ++v)
        r[v] = lc.load(dq + static_cast<size_t>(min(v, kpn - 1)) * c);
#pragma unroll
      for (int d = 0; d < 3; ++d) qp[d] = q[row * 3 + d];
    }
    __syncwarp();  // the last round's staging is read
    const int n = stage_group_slots<kG>(
        idx + row * k, mask + row * k, k, live, [&](int at, int t, int j) {
          st.t[at] = t;
#pragma unroll
          for (int d = 0; d < 3; ++d)
            st.u[at][d] = __fmul_rn(
                __fsub_rn(sb[static_cast<size_t>(j) * 3 + d], qp[d]), inv_r);
        });
    __syncwarp();
    if (!live) continue;
    for (int i0 = 0; i0 < n; i0 += kSlotChunk) {
      for (int e = lg; e < kSlotChunk * kpn; e += kG) {
        const int i = e / kpn, p = e - i * kpn;
        float w = 0.f;
        if (i0 + i < n) w = slot_influence(st.u[i0 + i], kp, p, mode, coef);
        st.w[i][p] = w;
      }
      __syncwarp(Lanes::group_mask());
      float sum[kSlotChunk][kW] = {};
      for (int p0 = 0; p0 < kpn; p0 += kDyRows) {
        if (p0 > 0 || (i0 > 0 && kpn > kDyRows)) {  // past the held rows
#pragma unroll
          for (int v = 0; v < kDyRows; ++v)
            r[v] = lc.load(dq + static_cast<size_t>(min(p0 + v, kpn - 1)) *
                                    c);
        }
#pragma unroll
        for (int v = 0; v < kDyRows; ++v) {
          if (p0 + v < kpn) {
            float x[kW];
            Lanes::to_floats(r[v], x);
#pragma unroll
            for (int i = 0; i < kSlotChunk; ++i) {
              const float w = st.w[i][p0 + v];
#pragma unroll
              for (int ii = 0; ii < kW; ++ii)
                sum[i][ii] = __fmaf_rn(w, x[ii], sum[i][ii]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kSlotChunk; ++i)
        if (i0 + i < n)
          lc.store_f32(sums + (row * k + st.t[i0 + i]) * c, sum[i]);
      __syncwarp(Lanes::group_mask());  // influences read before the next
    }
  }
}

// K10's backward in two launches: the index and the per-slot sums, then
// the gather.
template <typename T, bool kVec, int kG>
void launch_bwd_lanes(const float* q, const float* s, const float* kp,
                      const T* dy, const int32_t* idx, const bool* mask,
                      int b, int nq, int ns, int c, int k, int kpn,
                      float inv_r, float coef, int mode, int32_t* offsets,
                      int32_t* slots, int32_t* raw, int* counters,
                      float* sums, T* df, cudaStream_t stream) {
  // both take dynamic shared memory: the staging, and the counters too
  static const int room =
      (dynamic_smem_room(pseudo_grid_sums_kernel<T, kVec, kG, false>),
       dynamic_smem_room(pseudo_grid_sums_kernel<T, kVec, kG, true>));
  constexpr int kGroups = kPrepThreads / kG;
  constexpr int kStage = kGroups * static_cast<int>(sizeof(SlotStage));
  const int slices = slices_of<T, kG>(c);
  const int blocks =
      b + prep_blocks(kGroups, static_cast<long long>(b) * nq * slices);
  const int counts = (ns + 1) * static_cast<int>(sizeof(int));
  if (std::max(counts, kStage) <= room)
    pseudo_grid_sums_kernel<T, kVec, kG, true>
        <<<blocks, kPrepThreads, std::max(counts, kStage), stream>>>(
            q, s, kp, dy, idx, mask, b, nq, ns, c, k, kpn, inv_r, coef, mode,
            slices, offsets, slots, raw, counters, sums);
  else
    pseudo_grid_sums_kernel<T, kVec, kG, false>
        <<<blocks, kPrepThreads, kStage, stream>>>(
            q, s, kp, dy, idx, mask, b, nq, ns, c, k, kpn, inv_r, coef, mode,
            slices, offsets, slots, raw, counters, sums);
  launch_csr_gather<T, kVec, false>(offsets, slots, sums, nullptr, b, nq, ns,
                                    c, k, df, nullptr, stream);
}

template <typename T, bool kVec>
void launch_bwd_as(const float* q, const float* s, const float* kp,
                   const T* dy, const int32_t* idx, const bool* mask, int b,
                   int nq, int ns, int c, int k, int kpn, float inv_r,
                   float coef, int mode, int32_t* offsets, int32_t* slots,
                   int32_t* raw, int* counters, float* sums, T* df,
                   cudaStream_t stream) {
  if (prep_lanes<T>(c) == 16)
    launch_bwd_lanes<T, kVec, 16>(q, s, kp, dy, idx, mask, b, nq, ns, c, k,
                                  kpn, inv_r, coef, mode, offsets, slots, raw,
                                  counters, sums, df, stream);
  else
    launch_bwd_lanes<T, kVec, 32>(q, s, kp, dy, idx, mask, b, nq, ns, c, k,
                                  kpn, inv_r, coef, mode, offsets, slots, raw,
                                  counters, sums, df, stream);
}

template <typename T>
void launch_bwd(const float* q, const float* s, const float* kp,
                const void* dy, const int32_t* idx, const bool* mask, int b,
                int nq, int ns, int c, int k, int kpn, float inv_r,
                float coef, int mode, int32_t* offsets, int32_t* slots,
                int32_t* raw, int* counters, float* sums, void* df,
                cudaStream_t stream) {
  const T* dp = static_cast<const T*>(dy);
  T* fp = static_cast<T*>(df);
  if (vec_ok<T>(c, dy, sums, df))
    launch_bwd_as<T, true>(q, s, kp, dp, idx, mask, b, nq, ns, c, k, kpn,
                           inv_r, coef, mode, offsets, slots, raw, counters,
                           sums, fp, stream);
  else
    launch_bwd_as<T, false>(q, s, kp, dp, idx, mask, b, nq, ns, c, k, kpn,
                            inv_r, coef, mode, offsets, slots, raw, counters,
                            sums, fp, stream);
}

bool bad_args(int b, int ns, int c, int k, int kpn, int mode) {
  return b < 1 || b > 65535 || ns < 1 || c < 1 || k < 1 || k > kMaxK ||
         kpn < 1 || kpn > kMaxKp || mode < kLinear || mode > kGaussian;
}

}  // namespace

extern "C" int cl3d_pseudo_grid_max_kernel_points() { return kMaxKp; }

// out is [B, Nq, Kp * C] in the features' dtype.
extern "C" int cl3d_pseudo_grid(const float* q, const float* s, const void* f,
                                const int32_t* idx, const bool* mask,
                                const float* kp, int b, int nq, int ns, int c,
                                int k, int kpn, float inv_r, float coef,
                                int mode, int is_bf16, void* out,
                                cudaStream_t stream) {
  if (bad_args(b, ns, c, k, kpn, mode) ||
      static_cast<long long>(c) * (is_bf16 ? 2 : 4) >= kMaxRowBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nq == 0) return static_cast<int>(cudaSuccess);
  return is_bf16 ? launch_fwd<__nv_bfloat16>(q, s, f, idx, mask, kp, b, nq,
                                             ns, c, k, kpn, inv_r, coef,
                                             mode, out, stream)
                 : launch_fwd<float>(q, s, f, idx, mask, kp, b, nq, ns, c, k,
                                     kpn, inv_r, coef, mode, out, stream);
}

// df [B, Ns, C] in the features' dtype, written in full (no zeroing
// needed); dy is [B, Nq, Kp * C] in that dtype. Scratch, none zeroed:
// offsets [B, Ns + 1], slots and raw [B, Nq * K] (the reverse index;
// offsets/slots hold it afterwards), counters [B, Ns + 1] (used where Ns
// outgrows shared memory), sums [B, Nq * K, C] float32. Two launches.
extern "C" int cl3d_pseudo_grid_bwd(
    const float* q, const float* s, const int32_t* idx, const bool* mask,
    const float* kp, const void* dy, int b, int nq, int ns, int c, int k,
    int kpn, float inv_r, float coef, int mode, int is_bf16, int32_t* offsets,
    int32_t* slots, int32_t* raw, int* counters, float* sums, void* df,
    cudaStream_t stream) {
  if (bad_args(b, ns, c, k, kpn, mode) ||
      static_cast<long long>(nq) * k > INT_MAX - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nq == 0) return static_cast<int>(cudaSuccess);
  if (is_bf16)
    launch_bwd<__nv_bfloat16>(q, s, kp, dy, idx, mask, b, nq, ns, c, k, kpn,
                              inv_r, coef, mode, offsets, slots, raw,
                              counters, sums, df, stream);
  else
    launch_bwd<float>(q, s, kp, dy, idx, mask, b, nq, ns, c, k, kpn, inv_r,
                      coef, mode, offsets, slots, raw, counters, sums, df,
                      stream);
  return static_cast<int>(cudaGetLastError());
}
