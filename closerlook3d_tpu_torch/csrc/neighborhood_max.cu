// Masked neighborhood max (the strided blocks' shortcut pooling) and its
// backward. For query q with neighbor slots k (index idx[k], validity
// mask[k]) over support features f [Ns, C]:
//   out[q, c] = max over valid k of f[idx[k], c], or 0 when no slot is
//               valid;
//   df[s, c] += dy[q, c] / n[q, c] for every valid slot k with
//               idx[k] = s and f[s, c] == out[q, c],
// where n[q, c] counts those tying slots. The backward thus splits dy
// evenly over ties, as the plain version (autograd of amax) and the JAX
// jnp path (the VJP of reduce_max) do. Ties are common on this path
// (post-ReLU zeros, duplicated points), so the rule matters.
//
// Replaces: closerlook3d_tpu/ops/pallas/gather_reduce.py:_max_fwd_kernel
// (forward), and the pair _max_fwd_arg_kernel + _max_bwd_kernel (the
// custom VJP). The Pallas pair gives all of dy to the FIRST winning slot
// in (chunk, slot) order and emits an argmax only for that; this kernel
// follows the plain version's even split instead, and finds the ties by
// reading the features and the saved output again, so it needs no argmax.
// The TPU kernels gather with one-hot MXU matmuls over Morton support
// chunks; here the forward reads each query's neighbor rows directly and
// the backward gathers per support row over a reverse neighbor index.
//
// Numerics: the max is exact in the features' dtype. The backward rounds
// g[q, c] = dy[q, c] / n[q, c] (f32 quotient) to the features' dtype, as
// PyTorch's amax backward rounds it, and adds a support row's g of its
// tying entries in f32 from +0 in (q, t) order, rounded once: the order
// of its plain twin's index_add_ on CPU tensors (neighborhood_max_bwd_plain),
// which it equals to the bit, with the same bits on every run. A slot
// that does not tie adds nothing: the twin adds g * 0, which is the same
// for finite g, but where dy holds an inf or a NaN the twin spreads NaN to
// every row its query's slots name (masked ones too) and the kernel only
// to the tying rows, as the atomic scatter before this design did.
//
// Layout. Forward: query groups (query_groups.cuh, stage_valid_rows: a
// group of 8-32 lanes a query and slice of its channels, several groups a
// block, no block barrier, the valid slots' rows compacted in slot order
// in the group's own shared memory); each lane takes units of 16 bytes of
// channels, loads kMaxBatch valid slots' rows at once and writes its unit
// of out once. Backward: two launches (row_terms.cuh), as K1b's: launch 1
// builds the reverse index in query tiles, and beside it query groups (as
// the forward's) count each channel's ties over the valid
// slots' rows of f, 8 bytes of channels a lane (kTieBytes: 16 spilled at
// the 64 registers of the index's launch bounds, and ran 5% slower) and
// kTieBatch rows at once, and write g (0 where n = 0; a query with no
// valid slot writes nothing, as no entry reads it); launch 2, a gather per
// support row: a
// lane holds 16 bytes of the row's channels of f and, entry by entry in
// (q, t) order, two at once, loads those of out[q] and g[q], and adds g
// where f ties out. No float atomics, no zeroed scratch, no cast. Rows
// off the 16-byte vector (C % 8 for bf16, C % 4 for f32) or views off 16
// bytes take scalar units of the same channels.
//
// Bound on the H100: bytes (one compare per gathered value). Device
// memory sees the features, indices, mask and output (and, backward, dy,
// the saved output and df); the K-fold re-reads of feature rows hit L2.

#include "query_groups.cuh"
#include "row_terms.cuh"

namespace {

constexpr int kMaxBytes = 16;  // bytes of channels a forward lane's unit
constexpr int kMaxBatch = 4;   // valid slots' rows a forward lane loads at once
constexpr int kMaxLanes = 8;   // the forward's narrowest group

// K8 forward in query groups (query_groups.cuh): a group of kG lanes per
// item, a query and a slice of its passes; the group stages its query's
// valid slots' rows in slot order (stage_valid_rows). Unit e * kG + lg of
// pass e belongs to lane lg: channels [unit * kW, unit * kW + kW) (16
// bytes: 8 bf16 or 4 f32), whose rows it loads kMaxBatch valid slots at
// once. Per channel, over the valid slots in slot order: the first sets
// acc, each later one sets it to v where acc == acc && (v != v || v >
// acc), so a NaN wins and stays, as amax propagates it (x != x is the NaN
// test; nvcc does not assume finite math by default), and of -0 and +0
// the first slot's stays: the bits of a loop over all K slots that skips
// the invalid ones. Each unit of out is written once (one 16-byte store
// where the rows allow vectors), 0 where no slot is valid.
template <typename T, bool kVec, int kG>
__global__ void __launch_bounds__(kGroupThreads)
    nmax_fwd_kernel(const T* __restrict__ f, const int32_t* __restrict__ idx,
                    const bool* __restrict__ mask, int nq, int ns, int c,
                    int k, long long items, int slices, int per,
                    T* __restrict__ out) {
  using U = ChannelUnit<T, kVec, kMaxBytes>;
  constexpr int kW = U::kW;
  __shared__ GroupRows s_rows[kGroupThreads / kG];
  GroupRows& st = s_rows[threadIdx.x / kG];
  const int lg = threadIdx.x % kG;
  const GroupItem it = group_item<kG>(items, slices);
  const int n = stage_valid_rows<kG>(idx + it.row * k, mask + it.row * k,
                                     k, it.live, st);
  __syncwarp();
  if (!it.live) return;
  const size_t b = it.row / nq;
  const unsigned row_bytes = static_cast<unsigned>(c) * sizeof(T);
  const int u_end = min(U::units(c), (it.slice + 1) * per * kG);
  for (int unit = it.slice * per * kG + lg; unit < u_end; unit += kG) {
    const int ch0 = unit * kW;
    const T* f0 = f + b * ns * c + ch0;  // the unit's channels of row 0
    float acc[kW] = {};
    for (int i0 = 0; i0 < n; i0 += kMaxBatch) {
      typename U::Raw r[kMaxBatch];
#pragma unroll
      for (int v = 0; v < kMaxBatch; ++v)
        r[v] = U::load(row_at(f0, st.j[min(i0 + v, n - 1)], row_bytes),
                       c - ch0);
#pragma unroll
      for (int v = 0; v < kMaxBatch; ++v) {
        if (i0 + v < n) {
#pragma unroll
          for (int i = 0; i < kW; ++i) {
            const float x = to_f32(r[v].v[i]);
            if (i0 + v == 0 || (acc[i] == acc[i] && (x != x || x > acc[i])))
              acc[i] = x;
          }
        }
      }
    }
    U::store(out + it.row * c + ch0, c - ch0, acc);
  }
}

template <typename T, bool kVec>
int launch_fwd_as(const T* f, const int32_t* idx, const bool* mask, int b,
                  int nq, int ns, int c, int k, T* out,
                  cudaStream_t stream) {
  return launch_query_groups(
      static_cast<long long>(b) * nq, ChannelUnit<T, kVec, kMaxBytes>::units(c),
      kMaxLanes,
      [&](auto lanes, unsigned blocks, long long items, PassSplit sp) {
        nmax_fwd_kernel<T, kVec, decltype(lanes)::value>
            <<<blocks, kGroupThreads, 0, stream>>>(
                f, idx, mask, nq, ns, c, k, items, sp.slices, sp.per, out);
      });
}

// The forward in 16-byte units where C and the pointers allow them.
template <typename T>
int launch_fwd(const void* f, const int32_t* idx, const bool* mask, int b,
               int nq, int ns, int c, int k, void* out, cudaStream_t stream) {
  const T* fp = static_cast<const T*>(f);
  T* op = static_cast<T*>(out);
  if (runs_ok<T, ChannelUnit<T, true, kMaxBytes>::kW>(c, f, out))
    return launch_fwd_as<T, true>(fp, idx, mask, b, nq, ns, c, k, op, stream);
  return launch_fwd_as<T, false>(fp, idx, mask, b, nq, ns, c, k, op, stream);
}

constexpr int kTieBatch = 4;   // valid slots' rows a lane loads at once
constexpr int kTieBytes = 8;   // bytes of channels a launch-1 lane's unit

// Launch 1's query-group part, for the item (query row = b * Nq + q,
// slice) of the calling lane's group: the query's valid slots' rows staged
// in `st`, then for each unit of kW channels of the slice
//   n[c] = #{valid t : f[idx[t], c] == out[q, c]},
//   g[q, c] = n > 0 ? round_T(dy[q, c] / n[c]) : 0.
template <typename T, bool kVec, int kG>
__device__ __forceinline__ void tie_quotients(
    const T* __restrict__ f, const int32_t* __restrict__ idx,
    const bool* __restrict__ mask, const T* __restrict__ out,
    const T* __restrict__ dy, int nq, int ns, int c, int k, bool live,
    size_t row, int slice, int per, GroupRows& st, T* __restrict__ g) {
  using U = ChannelUnit<T, kVec, kTieBytes>;
  constexpr int kW = U::kW;
  const int nv = stage_valid_rows<kG>(idx + row * k, mask + row * k, k, live,
                                      st);
  __syncwarp();
  if (nv == 0) return;  // not live, or no valid slot: nothing reads g[q]
  const int lg = (threadIdx.x & 31) % kG;
  const T* fb = f + row / nq * ns * c;
  const unsigned row_bytes = static_cast<unsigned>(c) * sizeof(T);
  const int end = min(U::units(c), (slice + 1) * per * kG);
  for (int u = slice * per * kG + lg; u < end; u += kG) {
    const int ch = u * kW;
    const int left = c - ch;
    const typename U::Raw o = U::load(out + row * c + ch, left);
    const typename U::Raw d = U::load(dy + row * c + ch, left);
    int n[kW] = {};
    for (int a = 0; a < nv; a += kTieBatch) {
      typename U::Raw v[kTieBatch];
#pragma unroll
      for (int h = 0; h < kTieBatch; ++h)
        if (a + h < nv)
          v[h] = U::load(row_at(fb, st.j[a + h], row_bytes) + ch, left);
#pragma unroll
      for (int h = 0; h < kTieBatch; ++h)
        if (a + h < nv)
#pragma unroll
          for (int i = 0; i < kW; ++i)
            n[i] += to_f32(v[h].v[i]) == to_f32(o.v[i]);
    }
    float q[kW];
#pragma unroll
    for (int i = 0; i < kW; ++i)
      q[i] = n[i] > 0 ? to_f32(from_f32<T>(__fdiv_rn(
                            to_f32(d.v[i]), static_cast<float>(n[i]))))
                      : 0.f;
    U::store(g + row * c + ch, left, q);
  }
}

// K8 backward, launch 1: blocks [0, B * tiles) build the tiles' reverse
// indexes (row_terms.cuh), the rest hold kIndexThreads / kG query groups
// that write g (tie_quotients) for `items` items of `slices` slices a
// query, `per` passes of kG units a slice.
template <typename T, bool kShared, bool kVec, int kG>
__global__ void __launch_bounds__(kIndexThreads, 2)
    nmax_index_ties_kernel(const T* __restrict__ f,
                           const int32_t* __restrict__ idx,
                           const bool* __restrict__ mask,
                           const T* __restrict__ out,
                           const T* __restrict__ dy, int clouds, int nq,
                           int ns, int c, int k, int tiles, int tile_queries,
                           long long items, int slices, int per,
                           int32_t* __restrict__ offsets,
                           int32_t* __restrict__ entries,
                           int32_t* __restrict__ raw,
                           int* __restrict__ counters, T* __restrict__ g) {
  extern __shared__ int s_cnt[];
  __shared__ GroupRows s_rows[kIndexThreads / kG];
  const int index_blocks = clouds * tiles;
  if (blockIdx.x < index_blocks) {
    index_tile<kShared>(idx, mask, nq, ns, k, tiles, tile_queries, s_cnt,
                        offsets, entries, raw, counters);
    return;
  }
  const long long item =
      static_cast<long long>(blockIdx.x - index_blocks) * (kIndexThreads / kG)
      + threadIdx.x / kG;
  const bool live = item < items;
  tie_quotients<T, kVec, kG>(
      f, idx, mask, out, dy, nq, ns, c, k, live,
      live ? static_cast<size_t>(item / slices) : 0,
      live ? static_cast<int>(item % slices) : 0, per,
      s_rows[threadIdx.x / kG], g);
}

// K8 backward, launch 2: the lane of unit `unit` of support row s holds
// channels [unit * kW, unit * kW + kW) of f[s]; for each entry (q, t) of
// the row, in (q, t) order, two at once,
//   df[s, c] += g[q, c]   where f[s, c] == out[q, c],
// in f32 from +0, written once in T. An entry holds its query
// (row_terms.cuh).
template <typename T, int kW>
__global__ void __launch_bounds__(kRowThreads)
    nmax_gather_kernel(const T* __restrict__ f, const T* __restrict__ out,
                       const T* __restrict__ g,
                       const int32_t* __restrict__ offsets,
                       const int32_t* __restrict__ entries, int nq, int ns,
                       int c, int k, int tiles, int per, int lanes,
                       int slices, T* __restrict__ df) {
  const RowItem it = row_item(ns, c / kW, lanes, slices);
  if (!it.live) return;
  const size_t b = blockIdx.y;
  const int ch = it.unit * kW;
  T fv[kW];
  load_run<T, kW>(f + (b * ns + it.row) * c + ch, fv);
  const T* ob = out + b * nq * c + ch;
  const T* gb = g + b * nq * c + ch;
  float acc[kW] = {};
  for_each_entry_tile(
      offsets, entries, b, nq, ns, k, tiles, per, it.row,
      [&](const int32_t* eb, int start, int end, int q0) {
        int e = start;
        for (; e + 1 < end; e += 2) {
          const size_t qa = q0 + eb[e], qz = q0 + eb[e + 1];
          T oa[kW], ga[kW], oz[kW], gz[kW];
          load_run<T, kW>(ob + qa * c, oa);
          load_run<T, kW>(gb + qa * c, ga);
          load_run<T, kW>(ob + qz * c, oz);
          load_run<T, kW>(gb + qz * c, gz);
#pragma unroll
          for (int i = 0; i < kW; ++i)
            if (to_f32(fv[i]) == to_f32(oa[i]))
              acc[i] = __fadd_rn(acc[i], to_f32(ga[i]));
#pragma unroll
          for (int i = 0; i < kW; ++i)
            if (to_f32(fv[i]) == to_f32(oz[i]))
              acc[i] = __fadd_rn(acc[i], to_f32(gz[i]));
        }
        if (e < end) {
          const size_t qi = q0 + eb[e];
          T ov[kW], gv[kW];
          load_run<T, kW>(ob + qi * c, ov);
          load_run<T, kW>(gb + qi * c, gv);
#pragma unroll
          for (int i = 0; i < kW; ++i)
            if (to_f32(fv[i]) == to_f32(ov[i]))
              acc[i] = __fadd_rn(acc[i], to_f32(gv[i]));
        }
      });
  store_run<T, kW>(df + (b * ns + it.row) * c + ch, acc);
}

// Launch 1 at the group width group_lanes_for picks for C / kW units a
// query, with the counters of the index in shared memory where Ns allows.
template <typename T, bool kVec>
void launch_index_ties(const T* f, const int32_t* idx, const bool* mask,
                       const T* out, const T* dy, int b, int nq, int ns,
                       int c, int k, int tiles, int32_t* offsets,
                       int32_t* entries, int32_t* raw, int* counters, T* g,
                       cudaStream_t stream) {
  const int units = ChannelUnit<T, kVec, kTieBytes>::units(c);
  const long long queries = static_cast<long long>(b) * nq;
  const int tile_queries = (nq + tiles - 1) / tiles;
  const int smem = (ns + 1) * static_cast<int>(sizeof(int));
  const auto at = [&](auto lanes) {
    constexpr int kG = decltype(lanes)::value;
    constexpr int kGroups = kIndexThreads / kG;
    static const int room =
        dynamic_smem_room(nmax_index_ties_kernel<T, true, kVec, kG>);
    const PassSplit sp = split_passes(queries, (units + kG - 1) / kG, kG);
    const long long items = queries * sp.slices;
    const int blocks =
        b * tiles + static_cast<int>((items + kGroups - 1) / kGroups);
    if (smem <= room)
      nmax_index_ties_kernel<T, true, kVec, kG>
          <<<blocks, kIndexThreads, smem, stream>>>(
              f, idx, mask, out, dy, b, nq, ns, c, k, tiles, tile_queries,
              items, sp.slices, sp.per, offsets, entries, raw, counters, g);
    else
      nmax_index_ties_kernel<T, false, kVec, kG>
          <<<blocks, kIndexThreads, 0, stream>>>(
              f, idx, mask, out, dy, b, nq, ns, c, k, tiles, tile_queries,
              items, sp.slices, sp.per, offsets, entries, raw, counters, g);
  };
  switch (group_lanes_for(units)) {
    case 8:
      return at(std::integral_constant<int, 8>{});
    case 16:
      return at(std::integral_constant<int, 16>{});
    default:
      return at(std::integral_constant<int, 32>{});
  }
}

template <typename T, int kW>
void launch_gather_as(const T* f, const T* out, const T* g,
                      const int32_t* offsets, const int32_t* entries, int b,
                      int nq, int ns, int c, int k, int tiles, T* df,
                      cudaStream_t stream) {
  const RowSplit sp = row_split(c / kW);
  nmax_gather_kernel<T, kW><<<row_grid(b, ns, sp), kRowThreads, 0, stream>>>(
      f, out, g, offsets, entries, nq, ns, c, k, tiles,
      (nq + tiles - 1) / tiles, sp.lanes, sp.slices, df);
}

// The backward's two launches, in 16-byte units where C and the pointers
// allow them.
template <typename T>
void launch_bwd(const void* f, const int32_t* idx, const bool* mask,
                const void* out, const void* dy, int b, int nq, int ns, int c,
                int k, int tiles, int32_t* offsets, int32_t* entries,
                int32_t* raw, int* counters, void* g, void* df,
                cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const T* fp = static_cast<const T*>(f);
  const T* op = static_cast<const T*>(out);
  const T* dp = static_cast<const T*>(dy);
  T* gp = static_cast<T*>(g);
  T* dfp = static_cast<T*>(df);
  constexpr int kTieW = kTieBytes / static_cast<int>(sizeof(T));
  if (runs_ok<T, kTieW>(c, fp, op, dp, gp))
    launch_index_ties<T, true>(fp, idx, mask, op, dp, b, nq, ns, c, k, tiles,
                               offsets, entries, raw, counters, gp, stream);
  else
    launch_index_ties<T, false>(fp, idx, mask, op, dp, b, nq, ns, c, k,
                                tiles, offsets, entries, raw, counters, gp,
                                stream);
  if (runs_ok<T, kV>(c, fp, op, gp, dfp))
    launch_gather_as<T, kV>(fp, op, gp, offsets, entries, b, nq, ns, c, k,
                            tiles, dfp, stream);
  else
    launch_gather_as<T, 1>(fp, op, gp, offsets, entries, b, nq, ns, c, k,
                           tiles, dfp, stream);
}

bool bad_args(int b, int ns, int c, int k) {
  return b < 1 || b > 65535 || ns < 1 || c < 1 || k < 1 || k > kMaxK;
}

}  // namespace

extern "C" int cl3d_neighborhood_max(const void* f, const int32_t* idx,
                                     const bool* mask, int b, int nq, int ns,
                                     int c, int k, int is_bf16, void* out,
                                     cudaStream_t stream) {
  if (bad_args(b, ns, c, k) ||
      static_cast<long long>(c) * (is_bf16 ? 2 : 4) >= kMaxRowBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaSuccess);
  return is_bf16 ? launch_fwd<__nv_bfloat16>(f, idx, mask, b, nq, ns, c, k,
                                             out, stream)
                 : launch_fwd<float>(f, idx, mask, b, nq, ns, c, k, out,
                                     stream);
}

// df [B, Ns, C] in the features' dtype, written in full (no zeroing
// needed); f, out and dy are in that dtype, out being this op's forward
// output for f. g: a [B, Nq, C] scratch buffer in that dtype (launch 1's
// quotients). The index in `tiles` query tiles a cloud (1 .. kMaxTiles, at
// most Nq); scratch, none zeroed: offsets and counters [B * tiles, Ns + 1]
// (counters used where Ns outgrows shared memory), entries and raw [B, Nq
// * K]. Two launches. The argument list is that of the other backwards on
// row_terms.cuh (cl3d_pospool_xyz_bwd), so that one host launcher serves
// them all: radius is unused and avg must be 1 (g is always a buffer).
extern "C" int cl3d_neighborhood_max_bwd(
    const void* f, const void* out, const int32_t* idx, const bool* mask,
    const void* dy, int b, int nq, int ns, int c, int k, int tiles,
    float radius, int avg, int is_bf16, int32_t* offsets, int32_t* entries,
    int32_t* raw, int* counters, void* g, void* df, cudaStream_t stream) {
  (void)radius;
  if (bad_args(b, ns, c, k) || static_cast<long long>(nq) * k > INT_MAX - 1 ||
      static_cast<long long>(c) * (is_bf16 ? 2 : 4) >= kMaxRowBytes ||
      tiles < 1 || tiles > kMaxTiles || (nq > 0 && tiles > nq) || avg != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaSuccess);
  if (is_bf16)
    launch_bwd<__nv_bfloat16>(f, idx, mask, out, dy, b, nq, ns, c, k, tiles,
                              offsets, entries, raw, counters, g, df, stream);
  else
    launch_bwd<float>(f, idx, mask, out, dy, b, nq, ns, c, k, tiles, offsets,
                      entries, raw, counters, g, df, stream);
  return static_cast<int>(cudaGetLastError());
}
