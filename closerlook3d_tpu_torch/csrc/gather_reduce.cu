// The factorized point-wise MLP's neighborhood reductions (K6, K7, K13),
// forward and backward. For query q with neighbor slots k (support row idx[k],
// validity mask[k]), over per-point projections g [Ns, C] and, for K7,
// d [Nq, C], all in f32:
//   K6  gmax[q, c] = max_k g[idx[k], c]    gmin = min_k, the same
//       s1[q, c]   = sum_k g[idx[k], c]    s2   = sum_k gsq[idx[k], c]
//   K7  hmax[q, c] = max_k (g[idx[k], c] - d[q, c])    hmin = min_k
//   K13 out[q, c]  = sum_k f[idx[k], c]   (in f's dtype)
// over the valid slots; every output is 0 where no slot is valid (never a
// sentinel). Backward:
//   K6  dg[s, c]   += ds1 + dmax / n (if g == gmax) + dmin / m (if g == gmin)
//       dgsq[s, c] += ds2                          for each valid slot at s;
//   K7  dg[s, c]   += dmax / n (if h == hmax) + dmin / m (if h == hmin);
//       dd[q, c]    = -(dmax + dmin), 0 for an empty neighborhood;
//   K13 df[s, c]   += dy[q, c]                      for each valid slot at s,
// where n (m) counts the valid slots that reach the max (min). The
// cotangent of an extremum is thus split evenly over ties, as autograd of
// amax/amin (the plain versions) and JAX's jnp path split it. Ties are real
// on this path: duplicated points carry equal features, hence equal g.
//
// Replaces: closerlook3d_tpu/ops/pallas/gather_reduce.py
//   _pwstats_fwd_kernel, _pwstats_bwd_kernel (K6, pwmlp_minmax_stats),
//   _mm_fwd_kernel, _mm_bwd_kernel            (K7, gather_sub_minmax),
//   _sum_fwd_kernel, _sum_bwd_kernel          (K13, neighborhood_sum).
// The Pallas kernels gather with one-hot MXU matmuls over Morton support
// chunks into transposed [C, T] query tiles, and disagree on ties: K6 sends
// a cotangent to the FIRST extremal slot (through an argmax it saves), K7
// to EVERY tying slot. Here each block reads its neighbor rows directly,
// and both backward kernels find the ties again by re-reading g (and d)
// beside the saved extrema, so no argmax is stored.
//
// Numerics: g, gsq and d are bf16 or f32; the kernels compute in f32 and
// the forward outputs are f32. s1 and s2 accumulate in f64 and round once,
// as the plain version does, so the two agree whatever their summation
// order: the masked BN variance formed from them, E[h^2] - mean^2,
// cancels, and f32 summation noise would move a train step's gradients
// by percents. dmax / n is an f32 division. K6's backward forms each valid
// slot's term ds1 + (dmax / n [g == gmax] + dmin / m [g == gmin]) in f32,
// as its twin groups it, and adds the terms of a support row in (q, t)
// order from +0, rounding once to g's dtype: the twin's index_add_ order
// on CPU tensors, so the two are equal to the bit (the twin's masked
// slots add +-0, which never changes a sum started at +0 under
// round-to-nearest), and every run gives the same bits. K7's backward
// forms each tying slot's term sh_hi * [h == hmax] + sh_lo * [h == hmin]
// (h = g - d in f32, sh_hi = dmax / n_hi, sh_lo = dmin / n_lo) in that
// grouping and adds a support row's terms in (q, t) order from +0,
// rounding once to g's dtype: equal to its twin on CPU copies to the bit,
// the same bits on every run. A slot that ties neither adds nothing,
// where the twin adds sh_hi * 0 + sh_lo * 0: the same for finite shares,
// but a non-finite dmax or dmin puts NaN at every valid slot of its query
// in the twin and only at the tying ones here.
// K13 sums in f32 and rounds once to f's dtype: forward slot by slot in
// slot order, as the TPU kernel writes it (its caller, the
// pwmlp_minmax_stats route for at most 64 folded queries, takes the
// reference's rounding of s1 and s2 to g's dtype with it); backward, per
// support row, over the slots that hold it in (q, t) order, with no
// atomics. The plain version and, on CPU tensors, the twin's index_add_
// add in the same orders, so each equals its kernel to the bit, and the
// backward gives the same bits on every run. The Pallas backward rounds
// each query tile's partial to the output dtype; at the caller's shapes
// there is one tile, so it too rounds once.
//
// Layout. K6's and K7's forwards (query_groups.cuh, one body:
// group_extrema): a group of 8-32 lanes a query (and slice of its
// channels where queries are few), several groups a block and no
// block-wide barrier; the group compacts the query's valid slots in slot
// order and stages their support rows in its own shared memory, then each
// lane takes units of 4 channels of g (and gsq; 8 bytes of bf16), loads 4
// valid slots' rows at once and writes its unit of each f32 output once
// (one 16-byte store each; K7 loads its unit of d once). C off 4, or views
// off the vector, take scalar units. K7's backward: row_terms.cuh's two
// launches, as K8b's (neighborhood_max.cu): launch 1 builds the reverse
// index in query tiles beside query groups that count each channel's max
// and min ties over the valid slots' rows (4 channels a lane, 4 rows at
// once), and write the two shares as f32 rows and dd; launch 2, a gather
// per support row: a lane holds 4 channels of g[s] and, entry by entry in
// (q, t) order, two at once, loads those of d[q], hmax[q], hmin[q] and the
// shares, and adds the tying terms. No float atomics, no zeroed scratch,
// no cast: 2 device ops a call. K6's backward:
// two launches over a reverse neighbor index (reverse_index.cuh,
// row_gather.cuh); see pwstats_terms_kernel. K13 has its own, below:
// forward a warp per (query, 256-channel bf16 slice; 128 in f32), a block
// per 8 queries of one cloud; backward a warp per 1-4 support rows and
// slice.
//
// Bound on the H100: bytes. The forward does a few f32 (and two f64)
// operations per gathered value and writes f32 outputs (K6 four, K7 two),
// which dominate the bytes; the K-fold re-reads of support rows hit L2.
// K6's forward takes 0.80 ms a ModelNet40 bf16 step (NVIDIA H100 80GB
// HBM3, 700 W), twice its byte bound, against 2.24 for a block per 4
// queries behind block barriers, its parent:
// each valid slot costs a lane two dependent row loads (g and gsq) from
// L2. Hence groups as narrow as 8 lanes at C = 72 (at least 16 ran 1.08x
// slower), 4 slots' rows in flight (2: 1.02x, 8: 1.13x), and 92
// registers for the f64 sums (a cap at 85, 3 blocks an SM, gained
// nothing).
// K6's backward reads its six f32 [B, Nq, C] inputs once and writes dg and
// dgsq once, but also writes and reads back an f32 term per valid slot and
// channel (on ModelNet40's synthetic clouds 3-10 valid slots of 26-41 a
// query) and re-reads ds2 once a slot; its launches are latency-bound (a
// query or row costs two to three dependent round trips to memory).
// K7's backward writes only two f32 shares a (query, channel) and dd, and
// its gather reads, per entry, d[q], hmax[q], hmin[q] and the shares (18
// bytes a channel in bf16, K8b's 4): a chain of dependent loads a row.
// K13 does one f32 add per gathered value and writes one row in f's dtype
// per query (per support row backward). At its one caller's shapes (8
// clouds of 8 queries, f = [g, g^2] of 2304 bf16 channels, Ns 32 or 8,
// K 41 or 39) its bytes (at most 1.5 MB) take 0.4 us, below the 0.9 us
// of device time that one launch of an empty kernel takes: launch and
// memory latency bound it, not bytes. A block per 4 queries gave it 16 blocks
// on 132 SMs, each thread walking 39-41 dependent 2-byte loads, and a
// backward of three launches (zeroed scratch, atomics, a cast). Here:
// 72 blocks at each call, every lane moving 16 bytes a row; one round
// trip to device memory for the slots and the rows (the forward stages
// its cloud's support rows' slice in shared memory, so each is read once
// a block, not once a slot; the backward stages its queries' dy slice);
// walks without branches, 8-16 rows in flight; one launch each way.
// The backward needs no float atomics: in (q, t) order a row's terms are
// dy[q] repeated n[q, s] times, so integer counts, exact in any order,
// fix the sum.

#include "query_groups.cuh"
#include "row_terms.cuh"

namespace {

// ---- K6 and K7 forwards: query groups (query_groups.cuh) ------------------

constexpr int kStatsChannels = 4;  // channels of a lane's unit
constexpr int kStatsBatch = 4;     // valid slots' rows a lane loads at once
constexpr int kStatsLanes = 8;     // the narrowest group

// The body of K6's and K7's forwards in query groups: a group of kG lanes
// per item, a query and a slice of its passes; the group stages its
// query's valid slots' rows in slot order (stage_valid_rows). Unit e * kG
// + lg of pass e belongs to lane lg: channels [unit * 4, unit * 4 + 4) of
// g (8 bytes of bf16, 16 of f32), whose rows it loads kStatsBatch valid
// slots at once. Per channel, over the valid slots in slot order, of x =
// g (K6) or x = g - d[q] in f32 (kSub, K7: `other` is d, its unit loaded
// once): the first sets hi and lo, each later x sets hi where hi == hi &&
// (x != x || x > hi) and lo alike, so a NaN wins and stays, as amax and
// amin propagate it (x != x is the NaN test; nvcc does not assume finite
// math by default). K6 also adds g and `other` (gsq) in f64 from +0
// into a1 and a2 and rounds them once to f32. So each output has the bits
// of a loop over all K slots that skips the invalid ones; each is written
// once, a 16-byte f32 store a unit where the rows allow vectors. 0 where
// no slot is valid.
template <typename T, bool kVec, int kG, bool kSub>
__device__ __forceinline__ void group_extrema(
    const T* __restrict__ g, const T* __restrict__ other,
    const int32_t* __restrict__ idx, const bool* __restrict__ mask, int nq,
    int ns, int c, int k, long long items, int slices, int per,
    float* __restrict__ hi_out, float* __restrict__ lo_out,
    float* __restrict__ s1, float* __restrict__ s2) {
  using U = ChannelUnit<T, kVec, kStatsChannels * sizeof(T)>;
  using Out = ChannelUnit<float, kVec, kStatsChannels * sizeof(float)>;
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
  const size_t o = it.row * c;
  const int u_end = min(U::units(c), (it.slice + 1) * per * kG);
  for (int unit = it.slice * per * kG + lg; unit < u_end; unit += kG) {
    const int ch0 = unit * kW;
    const T* g0 = g + b * ns * c + ch0;  // the unit's channels of row 0
    const T* q0 = kSub ? nullptr : other + b * ns * c + ch0;  // gsq's
    float dv[kW];  // K7: the unit of d[q]
    if constexpr (kSub) {
      const typename U::Raw dr = U::load(other + o + ch0, c - ch0);
#pragma unroll
      for (int i = 0; i < kW; ++i) dv[i] = to_f32(dr.v[i]);
    }
    float hi[kW] = {}, lo[kW] = {};
    double a1[kW] = {}, a2[kW] = {};
    for (int i0 = 0; i0 < n; i0 += kStatsBatch) {
      typename U::Raw r[kStatsBatch], rq[kStatsBatch];
#pragma unroll
      for (int v = 0; v < kStatsBatch; ++v) {
        const int j = st.j[min(i0 + v, n - 1)];
        r[v] = U::load(row_at(g0, j, row_bytes), c - ch0);
        if constexpr (!kSub)
          rq[v] = U::load(row_at(q0, j, row_bytes), c - ch0);
      }
#pragma unroll
      for (int v = 0; v < kStatsBatch; ++v) {
        if (i0 + v < n) {
#pragma unroll
          for (int i = 0; i < kW; ++i) {
            float x = to_f32(r[v].v[i]);
            if constexpr (kSub) x = __fsub_rn(x, dv[i]);
            if (i0 + v == 0) {
              hi[i] = x;
              lo[i] = x;
            } else {
              if (hi[i] == hi[i] && (x != x || x > hi[i])) hi[i] = x;
              if (lo[i] == lo[i] && (x != x || x < lo[i])) lo[i] = x;
            }
            if constexpr (!kSub) {
              a1[i] += x;
              a2[i] += to_f32(rq[v].v[i]);
            }
          }
        }
      }
    }
    Out::store(hi_out + o + ch0, c - ch0, hi);
    Out::store(lo_out + o + ch0, c - ch0, lo);
    if constexpr (!kSub) {
      float x1[kW], x2[kW];
#pragma unroll
      for (int i = 0; i < kW; ++i) {
        x1[i] = __double2float_rn(a1[i]);
        x2[i] = __double2float_rn(a2[i]);
      }
      Out::store(s1 + o + ch0, c - ch0, x1);
      Out::store(s2 + o + ch0, c - ch0, x2);
    }
  }
}

// K6 forward: (gmax, gmin, s1, s2) of g and gsq (group_extrema).
template <typename T, bool kVec, int kG>
__global__ void __launch_bounds__(kGroupThreads)
    pwstats_fwd_kernel(const T* __restrict__ g, const T* __restrict__ gsq,
                       const int32_t* __restrict__ idx,
                       const bool* __restrict__ mask, int nq, int ns, int c,
                       int k, long long items, int slices, int per,
                       float* __restrict__ gmax, float* __restrict__ gmin,
                       float* __restrict__ s1, float* __restrict__ s2) {
  group_extrema<T, kVec, kG, false>(g, gsq, idx, mask, nq, ns, c, k, items,
                                    slices, per, gmax, gmin, s1, s2);
}

// K7 forward: (hmax, hmin) of g - d (group_extrema).
template <typename T, bool kVec, int kG>
__global__ void __launch_bounds__(kGroupThreads)
    mm_fwd_kernel(const T* __restrict__ g, const T* __restrict__ d,
                  const int32_t* __restrict__ idx,
                  const bool* __restrict__ mask, int nq, int ns, int c,
                  int k, long long items, int slices, int per,
                  float* __restrict__ hmax, float* __restrict__ hmin) {
  group_extrema<T, kVec, kG, true>(g, d, idx, mask, nq, ns, c, k, items,
                                   slices, per, hmax, hmin, nullptr, nullptr);
}

// K6's forward (gsq and the sums given) or K7's (d given, sums null) at
// the group width group_lanes_for picks for 4-channel units.
template <typename T, bool kVec>
int launch_extrema_as(const T* g, const T* other, const int32_t* idx,
                      const bool* mask, int b, int nq, int ns, int c, int k,
                      float* hi, float* lo, float* s1, float* s2,
                      cudaStream_t stream) {
  return launch_query_groups(
      static_cast<long long>(b) * nq,
      ChannelUnit<T, kVec, kStatsChannels * sizeof(T)>::units(c),
      kStatsLanes,
      [&](auto lanes, unsigned blocks, long long items, PassSplit sp) {
        constexpr int kG = decltype(lanes)::value;
        if (s1)
          pwstats_fwd_kernel<T, kVec, kG>
              <<<blocks, kGroupThreads, 0, stream>>>(
                  g, other, idx, mask, nq, ns, c, k, items, sp.slices,
                  sp.per, hi, lo, s1, s2);
        else
          mm_fwd_kernel<T, kVec, kG><<<blocks, kGroupThreads, 0, stream>>>(
              g, other, idx, mask, nq, ns, c, k, items, sp.slices, sp.per,
              hi, lo);
      });
}

// K6's or K7's forward in vector units where C and the pointers allow
// them (`other`: gsq [B, Ns, C] for K6, d [B, Nq, C] for K7).
template <typename T>
int launch_extrema(const void* g, const void* other, const int32_t* idx,
                   const bool* mask, int b, int nq, int ns, int c, int k,
                   float* hi, float* lo, float* s1, float* s2,
                   cudaStream_t stream) {
  const T* gp = static_cast<const T*>(g);
  const T* op = static_cast<const T*>(other);
  if (runs_ok<T, kStatsChannels>(c, g, other) &&
      runs_ok<float, kStatsChannels>(c, hi, lo) &&
      (!s1 || runs_ok<float, kStatsChannels>(c, s1, s2)))
    return launch_extrema_as<T, true>(gp, op, idx, mask, b, nq, ns, c, k, hi,
                                      lo, s1, s2, stream);
  return launch_extrema_as<T, false>(gp, op, idx, mask, b, nq, ns, c, k, hi,
                                     lo, s1, s2, stream);
}

// (dmax / n, dmin / m) for one (query, channel): n (m) = valid slots whose
// value equals hi (lo), counted by the caller; clamped at 1 as the plain
// twins clamp.
__device__ __forceinline__ float share(float dy, int n) {
  return __fdiv_rn(dy, static_cast<float>(max(n, 1)));
}

// ---- K7's backward: row_terms.cuh's two launches ---------------------------

// f32 values a (query, channel) of launch 1's scratch (ops/gather_reduce.py
// allocates it): the two shares, sh_hi in the first C values of a query's
// scratch row and sh_lo in the next C.
constexpr int kShareFloats = 2;

// Launch 1's query-group part, for the item (query row = b * Nq + q,
// slice) of the calling lane's group: the query's valid slots' rows staged
// in `st`, then for each unit of 4 channels of the slice, with h = g[j] -
// d[q] in f32 over the valid slots j,
//   n_hi = #{h == hmax[q]},  n_lo = #{h == hmin[q]},
//   shares[q] = (share(dmax, n_hi), share(dmin, n_lo)) in f32,
//   dd[q] = -(dmax + dmin) in T,
// and dd[q] = 0 where the query has no valid slot (its shares are not
// written: no entry of the index reads them). Rows are loaded kStatsBatch
// valid slots at once.
template <typename T, bool kVec, int kG>
__device__ __forceinline__ void minmax_shares(
    const T* __restrict__ g, const T* __restrict__ d,
    const int32_t* __restrict__ idx, const bool* __restrict__ mask,
    const float* __restrict__ hmax, const float* __restrict__ hmin,
    const float* __restrict__ dmax, const float* __restrict__ dmin, int nq,
    int ns, int c, int k, bool live, size_t row, int slice, int per,
    GroupRows& st, float* __restrict__ shares, T* __restrict__ dd) {
  using U = ChannelUnit<T, kVec, kStatsChannels * sizeof(T)>;
  using F = ChannelUnit<float, kVec, kStatsChannels * sizeof(float)>;
  constexpr int kW = U::kW;
  const int nv = stage_valid_rows<kG>(idx + row * k, mask + row * k, k, live,
                                      st);
  __syncwarp();
  if (!live) return;
  const int lg = (threadIdx.x & 31) % kG;
  const T* gb = g + row / nq * ns * c;
  const unsigned row_bytes = static_cast<unsigned>(c) * sizeof(T);
  const size_t o = row * c;
  float* sh_row = shares + row * kShareFloats * c;
  const int end = min(U::units(c), (slice + 1) * per * kG);
  for (int u = slice * per * kG + lg; u < end; u += kG) {
    const int ch = u * kW;
    const int left = c - ch;
    float out[kW] = {};
    if (nv > 0) {
      const typename U::Raw dv = U::load(d + o + ch, left);
      const typename F::Raw hi = F::load(hmax + o + ch, left);
      const typename F::Raw lo = F::load(hmin + o + ch, left);
      const typename F::Raw dx = F::load(dmax + o + ch, left);
      const typename F::Raw dn = F::load(dmin + o + ch, left);
      int n[kW] = {};  // ties of the max, plus 256 x those of the min
      for (int a = 0; a < nv; a += kStatsBatch) {
        typename U::Raw v[kStatsBatch];
#pragma unroll
        for (int h = 0; h < kStatsBatch; ++h)
          if (a + h < nv)
            v[h] = U::load(row_at(gb, st.j[a + h], row_bytes) + ch, left);
#pragma unroll
        for (int h = 0; h < kStatsBatch; ++h)
          if (a + h < nv)
#pragma unroll
            for (int i = 0; i < kW; ++i) {
              const float x = __fsub_rn(to_f32(v[h].v[i]), to_f32(dv.v[i]));
              n[i] += (x == hi.v[i]) + ((x == lo.v[i]) << 8);
            }
      }
      float sh[kW], sl[kW];
#pragma unroll
      for (int i = 0; i < kW; ++i) {
        sh[i] = share(dx.v[i], n[i] & 255);
        sl[i] = share(dn.v[i], n[i] >> 8);
        out[i] = -__fadd_rn(dx.v[i], dn.v[i]);
      }
      F::store(sh_row + ch, left, sh);
      F::store(sh_row + c + ch, left, sl);
    }
    U::store(dd + o + ch, left, out);
  }
}

// K7 backward, launch 1: blocks [0, B * tiles) build the tiles' reverse
// indexes (row_terms.cuh), the rest hold kIndexThreads / kG query groups
// that write the shares and dd (minmax_shares) for `items` items of
// `slices` slices a query, `per` passes of kG units a slice.
template <typename T, bool kShared, bool kVec, int kG>
__global__ void __launch_bounds__(kIndexThreads, 2)
    mm_index_shares_kernel(
        const T* __restrict__ g, const T* __restrict__ d,
        const int32_t* __restrict__ idx, const bool* __restrict__ mask,
        const float* __restrict__ hmax, const float* __restrict__ hmin,
        const float* __restrict__ dmax, const float* __restrict__ dmin,
        int clouds, int nq, int ns, int c, int k, int tiles,
        int tile_queries, long long items, int slices, int per,
        int32_t* __restrict__ offsets, int32_t* __restrict__ entries,
        int32_t* __restrict__ raw, int* __restrict__ counters,
        float* __restrict__ shares, T* __restrict__ dd) {
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
  minmax_shares<T, kVec, kG>(
      g, d, idx, mask, hmax, hmin, dmax, dmin, nq, ns, c, k, live,
      live ? static_cast<size_t>(item / slices) : 0,
      live ? static_cast<int>(item % slices) : 0, per,
      s_rows[threadIdx.x / kG], shares, dd);
}

constexpr int kGatherBlocks = 4;  // launch 2's blocks an SM, at least

// One entry's loads in K7's gather: its query's units of d, hmax, hmin
// and the two shares.
template <typename T, int kW>
struct MinmaxEntry {
  T d[kW];
  float hi[kW], lo[kW], sh[kW], sl[kW];
  __device__ __forceinline__ void load(const T* __restrict__ db,
                                       const float* __restrict__ hb,
                                       const float* __restrict__ lb,
                                       const float* __restrict__ sb,
                                       size_t q, int c) {
    load_run<T, kW>(db + q * c, d);
    load_run<float, kW>(hb + q * c, hi);
    load_run<float, kW>(lb + q * c, lo);
    load_run<float, kW>(sb + q * kShareFloats * c, sh);
    load_run<float, kW>(sb + q * kShareFloats * c + c, sl);
  }
  // acc += sh * [h == hi] + sl * [h == lo] where h ties either, h = g -
  // d[q], grouped as the twin groups it (_extremal_shares)
  __device__ __forceinline__ void add(const float (&gv)[kW],
                                      float (&acc)[kW]) const {
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      const float h = __fsub_rn(gv[i], to_f32(d[i]));
      const bool th = h == hi[i], tl = h == lo[i];
      if (th || tl)
        acc[i] = __fadd_rn(acc[i],
                           __fadd_rn(__fmul_rn(sh[i], th ? 1.f : 0.f),
                                     __fmul_rn(sl[i], tl ? 1.f : 0.f)));
    }
  }
};

// K7 backward, launch 2: the lane of unit `unit` of support row s holds
// channels [unit * kW, unit * kW + kW) of g[s]; for each entry (q, t) of
// the row, in (q, t) order, two at once, it adds the entry's term
// (MinmaxEntry::add) in f32 from +0 and writes dg once in T. An entry
// holds its query (row_terms.cuh). Capped at 64 registers, 4 blocks an
// SM: uncapped (78 registers in f32), it ran 1.06x slower a bf16 pwmlp
// eval backward on the H100 (a few spilled bytes cost less than the lost
// warps).
template <typename T, int kW>
__global__ void __launch_bounds__(kRowThreads, kGatherBlocks)
    mm_gather_kernel(const T* __restrict__ g, const T* __restrict__ d,
                     const float* __restrict__ hmax,
                     const float* __restrict__ hmin,
                     const float* __restrict__ shares,
                     const int32_t* __restrict__ offsets,
                     const int32_t* __restrict__ entries, int nq, int ns,
                     int c, int k, int tiles, int per, int lanes, int slices,
                     T* __restrict__ dg) {
  const RowItem it = row_item(ns, c / kW, lanes, slices);
  if (!it.live) return;
  const size_t b = blockIdx.y;
  const int ch = it.unit * kW;
  float gv[kW];
  {
    T raw[kW];
    load_run<T, kW>(g + (b * ns + it.row) * c + ch, raw);
#pragma unroll
    for (int i = 0; i < kW; ++i) gv[i] = to_f32(raw[i]);
  }
  const size_t o = b * nq * c + ch;
  const T* db = d + o;
  const float* hb = hmax + o;
  const float* lb = hmin + o;
  const float* sb = shares + b * nq * kShareFloats * c + ch;
  float acc[kW] = {};
  for_each_entry_tile(
      offsets, entries, b, nq, ns, k, tiles, per, it.row,
      [&](const int32_t* eb, int start, int end, int q0) {
        int e = start;
        for (; e + 1 < end; e += 2) {
          MinmaxEntry<T, kW> a, z;
          a.load(db, hb, lb, sb, q0 + eb[e], c);
          z.load(db, hb, lb, sb, q0 + eb[e + 1], c);
          a.add(gv, acc);
          z.add(gv, acc);
        }
        if (e < end) {
          MinmaxEntry<T, kW> a;
          a.load(db, hb, lb, sb, q0 + eb[e], c);
          a.add(gv, acc);
        }
      });
  store_run<T, kW>(dg + (b * ns + it.row) * c + ch, acc);
}

// Launch 1 at the group width group_lanes_for picks for 4-channel units,
// with the counters of the index in shared memory where Ns allows.
template <typename T, bool kVec>
void launch_index_shares(const T* g, const T* d, const int32_t* idx,
                         const bool* mask, const float* hmax,
                         const float* hmin, const float* dmax,
                         const float* dmin, int b, int nq, int ns, int c,
                         int k, int tiles, int32_t* offsets,
                         int32_t* entries, int32_t* raw, int* counters,
                         float* shares, T* dd, cudaStream_t stream) {
  const int units =
      ChannelUnit<T, kVec, kStatsChannels * sizeof(T)>::units(c);
  const long long queries = static_cast<long long>(b) * nq;
  const int tile_queries = (nq + tiles - 1) / tiles;
  const int smem = (ns + 1) * static_cast<int>(sizeof(int));
  const auto at = [&](auto lanes) {
    constexpr int kG = decltype(lanes)::value;
    constexpr int kGroups = kIndexThreads / kG;
    static const int room =
        dynamic_smem_room(mm_index_shares_kernel<T, true, kVec, kG>);
    const PassSplit sp = split_passes(queries, (units + kG - 1) / kG, kG);
    const long long items = queries * sp.slices;
    const int blocks =
        b * tiles + static_cast<int>((items + kGroups - 1) / kGroups);
    if (smem <= room)
      mm_index_shares_kernel<T, true, kVec, kG>
          <<<blocks, kIndexThreads, smem, stream>>>(
              g, d, idx, mask, hmax, hmin, dmax, dmin, b, nq, ns, c, k,
              tiles, tile_queries, items, sp.slices, sp.per, offsets,
              entries, raw, counters, shares, dd);
    else
      mm_index_shares_kernel<T, false, kVec, kG>
          <<<blocks, kIndexThreads, 0, stream>>>(
              g, d, idx, mask, hmax, hmin, dmax, dmin, b, nq, ns, c, k,
              tiles, tile_queries, items, sp.slices, sp.per, offsets,
              entries, raw, counters, shares, dd);
  };
  switch (group_lanes_for(units, kStatsLanes)) {
    case 8:
      return at(std::integral_constant<int, 8>{});
    case 16:
      return at(std::integral_constant<int, 16>{});
    default:
      return at(std::integral_constant<int, 32>{});
  }
}

template <typename T, int kW>
void launch_mm_gather_as(const T* g, const T* d, const float* hmax,
                         const float* hmin, const float* shares,
                         const int32_t* offsets, const int32_t* entries,
                         int b, int nq, int ns, int c, int k, int tiles,
                         T* dg, cudaStream_t stream) {
  const RowSplit sp = row_split(c / kW);
  mm_gather_kernel<T, kW><<<row_grid(b, ns, sp), kRowThreads, 0, stream>>>(
      g, d, hmax, hmin, shares, offsets, entries, nq, ns, c, k, tiles,
      (nq + tiles - 1) / tiles, sp.lanes, sp.slices, dg);
}

// K7's backward: its two launches, in 4-channel units where C and the
// pointers allow them, else channel by channel.
template <typename T>
void launch_mm_bwd(const void* g, const void* d, const int32_t* idx,
                   const bool* mask, const float* hmax, const float* hmin,
                   const float* dmax, const float* dmin, int b, int nq,
                   int ns, int c, int k, int tiles, int32_t* offsets,
                   int32_t* entries, int32_t* raw, int* counters,
                   float* shares, void* dg, void* dd, cudaStream_t stream) {
  const T* gp = static_cast<const T*>(g);
  const T* dp = static_cast<const T*>(d);
  T* dgp = static_cast<T*>(dg);
  T* ddp = static_cast<T*>(dd);
  const bool vec = runs_ok<T, kStatsChannels>(c, gp, dp, dgp, ddp) &&
                   runs_ok<float, kStatsChannels>(c, hmax, hmin, dmax, dmin,
                                                  shares);
  if (vec) {
    launch_index_shares<T, true>(gp, dp, idx, mask, hmax, hmin, dmax, dmin,
                                 b, nq, ns, c, k, tiles, offsets, entries,
                                 raw, counters, shares, ddp, stream);
    launch_mm_gather_as<T, kStatsChannels>(gp, dp, hmax, hmin, shares,
                                           offsets, entries, b, nq, ns, c, k,
                                           tiles, dgp, stream);
  } else {
    launch_index_shares<T, false>(gp, dp, idx, mask, hmax, hmin, dmax, dmin,
                                  b, nq, ns, c, k, tiles, offsets, entries,
                                  raw, counters, shares, ddp, stream);
    launch_mm_gather_as<T, 1>(gp, dp, hmax, hmin, shares, offsets, entries,
                              b, nq, ns, c, k, tiles, dgp, stream);
  }
}

// ---- K13: own launch geometry ----------------------------------------------

// forward: queries (one a warp) a block; support rows staged in shared
// memory (up to kStageRows; more are read from global memory); rows a
// lane loads at once in full batches
constexpr int kSumWarps = 8;
constexpr int kSumThreads = kSumWarps * 32;
constexpr int kStageRows = 64;
constexpr int kSumUnroll = 16;
// backward: warps a block; a round reads up to kChunkSlots slot entries
// and stages up to kChunkQueries dy rows, which a walk loads kWalkUnroll
// at a time
constexpr int kRowWarps = 8;
static_assert(kRowThreads == kRowWarps * 32, "row_terms.cuh's blocks");
constexpr int kChunkSlots = 512;
constexpr int kChunkQueries = 16;
constexpr int kWalkUnroll = 8;
// a walk's last, partial batch loads this many rows at once
constexpr int kTailUnroll = 8;

// Adds the rows of list[t0], ..., list[min(t0 + U, n) - 1] to acc in that
// order, their U loads (row(list entry) -> Raw) all started first. Past n it
// loads list[n - 1] again and does not add it: no branches.
template <int U, typename Lanes, typename Entry, typename RowLoad>
__device__ __forceinline__ void add_batch(float (&acc)[Lanes::kW],
                                          const Entry* list, int t0, int n,
                                          RowLoad row) {
  typename Lanes::Raw r[U];
#pragma unroll
  for (int u = 0; u < U; ++u) r[u] = row(list[min(t0 + u, n - 1)]);
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (t0 + u < n) Lanes::add(acc, r[u]);
}

// Adds the rows of list[0..n) to acc in list order: full batches of
// kSumUnroll, then batches of kTailUnroll.
template <typename Lanes, typename Entry, typename RowLoad>
__device__ __forceinline__ void add_list(float (&acc)[Lanes::kW],
                                         const Entry* list, int n,
                                         RowLoad row) {
  int t0 = 0;
  for (; t0 + kSumUnroll <= n; t0 += kSumUnroll)
    add_batch<kSumUnroll, Lanes>(acc, list, t0, n, row);
  for (; t0 < n; t0 += kTailUnroll)
    add_batch<kTailUnroll, Lanes>(acc, list, t0, n, row);
}

// K13 forward: out[q, c] = the f32 sum of f[idx[t], c] over the valid slots
// t = 0, 1, ..., K-1 in that order, rounded once to T. One warp per query
// and channel slice; a block holds kSumWarps queries of one cloud. With
// kStaged (Ns <= kStageRows) the block first copies its cloud's support
// rows' slice into shared memory, so each row is read from device memory
// once a block, not once a slot. The warp reads its K <= 64 slots itself
// (lane t holds slots t and t + 32), lists its valid slots' support rows
// in slot order (ballot, prefix counts) and adds them (add_list).
template <typename T, bool kVec, bool kStaged>
__global__ void __launch_bounds__(kSumThreads)
    nsum_fwd_kernel(const T* __restrict__ f, const int32_t* __restrict__ idx,
                    const bool* __restrict__ mask, int nq, int ns, int c,
                    int k, int slices, T* __restrict__ out) {
  using Lanes = GroupChannels<T, kVec>;  // a whole warp a row slice
  using Raw = typename Lanes::Raw;
  __shared__ uint4 s_rows[kStaged ? kStageRows : 1][32];
  __shared__ int s_j[kSumWarps][kMaxK];  // each warp's valid slots' rows
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y, slice = blockIdx.x % slices;
  const int q = (blockIdx.x / slices) * kSumWarps + warp;
  const bool live = q < nq;  // warp-uniform
  const Lanes lc(slice, lane, c);
  const T* fb = f + static_cast<size_t>(b) * ns * c;
  const size_t slot0 = (static_cast<size_t>(b) * nq + q) * k;
  // the slot loads and the staging loads are independent: one round trip
  const int j_lo = live && lane < k ? idx[slot0 + lane] : 0;
  const int j_hi = live && lane + 32 < k ? idx[slot0 + lane + 32] : 0;
  const bool v_lo = live && lane < k && mask[slot0 + lane];
  const bool v_hi = live && lane + 32 < k && mask[slot0 + lane + 32];
  if constexpr (kStaged) {
    constexpr int kPer = kStageRows * 32 / kSumThreads;
    Raw r[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int v = i * kSumThreads + threadIdx.x;  // row v / 32, lane v % 32
      if (v < ns * 32)
        r[i] = Lanes(slice, v & 31, c).load(fb + static_cast<size_t>(v >> 5) *
                                                     c);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int v = i * kSumThreads + threadIdx.x;
      if (v < ns * 32) s_rows[v >> 5][v & 31] = Lanes::bits(r[i]);
    }
  }
  const unsigned below = (1u << lane) - 1;
  const unsigned m_lo = __ballot_sync(kFull, v_lo);
  const unsigned m_hi = __ballot_sync(kFull, v_hi);
  const int n_lo = __popc(m_lo), n = n_lo + __popc(m_hi);
  if (v_lo) s_j[warp][__popc(m_lo & below)] = j_lo;
  if (v_hi) s_j[warp][n_lo + __popc(m_hi & below)] = j_hi;
  if constexpr (kStaged)
    __syncthreads();
  else
    __syncwarp();
  if (!live) return;
  float acc[Lanes::kW] = {};
  if constexpr (kStaged) {
    add_list<Lanes>(acc, s_j[warp], n,
                    [&](int j) { return Lanes::raw(s_rows[j][lane]); });
  } else {
    add_list<Lanes>(acc, s_j[warp], n, [&](int j) {
      return lc.load(fb + static_cast<size_t>(j) * c);
    });
  }
  lc.store(out + (static_cast<size_t>(b) * nq + q) * c, acc);
}

// K13 backward: df[s, c] = the f32 sum of dy[q, c] over the valid slots
// (q, t) with idx[q, t] == s, in (q, t) order, rounded once to T; 0 where
// no slot reaches s. In that order a query's slots that hold s follow one
// another, so df[s] adds dy[q] n[q, s] times for q = 0, 1, ..., where
// n[q, s] counts q's valid slots at s: integer counts, which shared-memory
// atomics build exactly, in any order. A gather by support row, not a
// scatter: a block owns kRowWarps * kRows support rows of one cloud (warp
// w the rows w * kRows + m) and a channel slice. In rounds of up to
// kChunkQueries queries (at most kChunkSlots slot entries) the block
// stages the round's dy rows' slice and counts n[q, s] for its rows in
// shared memory; then each warp walks the round's queries in order, dy
// rows kWalkUnroll at a time, converts each once and adds it to each of
// its rows as many times as counted. No float atomics, no scratch: each
// df row is written once, in dy's dtype.
template <typename T, bool kVec, int kRows>
__global__ void __launch_bounds__(kRowThreads)
    nsum_bwd_kernel(const int32_t* __restrict__ idx,
                    const bool* __restrict__ mask, const T* __restrict__ dy,
                    int nq, int ns, int c, int k, int slices, int qchunk,
                    T* __restrict__ df) {
  using Lanes = GroupChannels<T, kVec>;  // a whole warp a row slice
  using Raw = typename Lanes::Raw;
  constexpr int kW = Lanes::kW;
  constexpr int kTile = kRowWarps * kRows;
  constexpr int kDyPer = kChunkQueries * 32 / kRowThreads;
  constexpr int kPer = kChunkSlots / kRowThreads;  // entries a thread reads
  __shared__ uint4 s_dy[kChunkQueries][32];
  // [round parity][query in the round][tile row]: n[q, s]
  __shared__ int s_cnt[2][kChunkQueries][kTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y, slice = blockIdx.x % slices;
  const int r0 = (blockIdx.x / slices) * kTile;
  const Lanes lc(slice, lane, c);
  const int32_t* ib = idx + static_cast<size_t>(b) * nq * k;
  const bool* mb = mask + static_cast<size_t>(b) * nq * k;
  const T* dyb = dy + static_cast<size_t>(b) * nq * c;
  for (int v = threadIdx.x; v < kChunkQueries * kTile; v += kRowThreads)
    s_cnt[0][v / kTile][v % kTile] = 0;
  float acc[kRows][kW] = {};
  int parity = 0;
  for (int q0 = 0; q0 < nq; q0 += qchunk, parity ^= 1) {
    const int qn = min(qchunk, nq - q0), entries = qn * k;
    const size_t e0 = static_cast<size_t>(q0) * k;
    // the round's loads at once: the dy slice, Raw v = i * kRowThreads +
    // thread (query v / 32, lane v % 32), and the slot entries
    Raw d[kDyPer];
#pragma unroll
    for (int i = 0; i < kDyPer; ++i) {
      const int v = i * kRowThreads + threadIdx.x;
      if (v < qn * 32)
        d[i] = Lanes(slice, v & 31, c).load(
            dyb + static_cast<size_t>(q0 + (v >> 5)) * c);
    }
    int row[kPer];  // the tile row an entry counts at, or -1
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = i * kRowThreads + threadIdx.x;
      int j = -1;
      bool valid = false;
      if (e < entries) {  // two independent loads
        j = ib[e0 + e] - r0;
        valid = mb[e0 + e];
      }
      row[i] = valid && j >= 0 && j < kTile ? j : -1;
    }
    __syncthreads();  // the previous round's walks are done
#pragma unroll
    for (int i = 0; i < kDyPer; ++i) {
      const int v = i * kRowThreads + threadIdx.x;
      if (v < qn * 32) s_dy[v >> 5][v & 31] = Lanes::bits(d[i]);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (row[i] >= 0)
        atomicAdd(&s_cnt[parity][(i * kRowThreads + threadIdx.x) / k][row[i]],
                  1);
    // the next round counts from zero (last read last round)
    for (int v = threadIdx.x; v < kChunkQueries * kTile; v += kRowThreads)
      s_cnt[parity ^ 1][v / kTile][v % kTile] = 0;
    __syncthreads();  // the dy slice and the counts complete
    for (int t0 = 0; t0 < qn; t0 += kWalkUnroll) {
      Raw r[kWalkUnroll];
      int n[kWalkUnroll][kRows];
#pragma unroll
      for (int u = 0; u < kWalkUnroll; ++u) {
        const int q = min(t0 + u, qn - 1);  // past qn: counted as 0
        r[u] = Lanes::raw(s_dy[q][lane]);
#pragma unroll
        for (int m = 0; m < kRows; ++m)
          n[u][m] = t0 + u < qn ? s_cnt[parity][q][warp * kRows + m] : 0;
      }
      int most = 0;  // warp-uniform, like every count
#pragma unroll
      for (int u = 0; u < kWalkUnroll; ++u)
#pragma unroll
        for (int m = 0; m < kRows; ++m) most = max(most, n[u][m]);
      // each dy row converted once, then added to each row as counted
      if (most <= 1) {  // no row listed twice by one query: no loops
#pragma unroll
        for (int u = 0; u < kWalkUnroll; ++u) {
          float x[kW];
          Lanes::to_floats(r[u], x);
#pragma unroll
          for (int m = 0; m < kRows; ++m)
            if (n[u][m] > 0)
#pragma unroll
              for (int i = 0; i < kW; ++i) acc[m][i] += x[i];
        }
      } else {
#pragma unroll
        for (int u = 0; u < kWalkUnroll; ++u) {
          float x[kW];
          Lanes::to_floats(r[u], x);
#pragma unroll
          for (int m = 0; m < kRows; ++m)
            for (int rep = 0; rep < n[u][m]; ++rep)
#pragma unroll
              for (int i = 0; i < kW; ++i) acc[m][i] += x[i];
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int rr = r0 + warp * kRows + m;
    if (rr < ns)
      lc.store(df + (static_cast<size_t>(b) * ns + rr) * c, acc[m]);
  }
}

// ---- K6 backward: per-slot terms by query, then a gather per support row ---

constexpr int kPrepThreads = 1024;
constexpr int kTermUnroll = 8;  // slot rows a lane loads at once

// K6 backward, launch 1. Blocks [0, B) build cloud b's reverse index
// (reverse_index.cuh). The others, query-major, a group of kG lanes per
// query and channel slice, write the f32 term that the twin adds at each
// valid slot's support row:
//   terms[q, t, c] = ds1[q, c] + (sh_hi[q, c] * [g == gmax[q, c]]
//                                 + sh_lo[q, c] * [g == gmin[q, c]]),
// g = g[idx[q, t], c], sh_hi = dmax / n_hi and sh_lo = dmin / n_lo
// (share()), n_hi (n_lo) the valid slots whose g equals gmax (gmin); each
// product and sum rounded to f32 in that grouping (the intrinsics keep nvcc
// from contracting them). Masked slots are not written. Lanes take 8 bytes
// of channels (kPrepBytes), so a query's five f32 rows load with its slots
// and its first 8 slot rows right after: two round trips to memory; the
// slot rows are read again from L1 for the terms. A group takes about
// kPrepItems queries in turn (prep_blocks), so a block lives long enough
// that its last queries' latency does not idle the SM for long.
template <typename T, bool kVec, int kG, bool kSharedIndex>
__global__ void __launch_bounds__(kPrepThreads, 1)
    pwstats_terms_kernel(const T* __restrict__ g,
                         const int32_t* __restrict__ idx,
                         const bool* __restrict__ mask,
                         const float* __restrict__ gmax,
                         const float* __restrict__ gmin,
                         const float* __restrict__ dmax,
                         const float* __restrict__ dmin,
                         const float* __restrict__ ds1, int clouds, int nq,
                         int ns, int c, int k, int slices,
                         int32_t* __restrict__ offsets,
                         int32_t* __restrict__ slots,
                         int32_t* __restrict__ raw, int* __restrict__ counters,
                         float* __restrict__ terms) {
  extern __shared__ int s_cnt[];
  if (blockIdx.x < clouds) {
    build_reverse_index<kPrepThreads, kSharedIndex>(
        idx, mask, nq, ns, k, blockIdx.x, s_cnt, offsets, slots, raw,
        counters);
    return;
  }
  using Lanes = GroupChannels<T, kVec, kG, kPrepBytes>;
  using Raw = typename Lanes::Raw;
  constexpr int kW = Lanes::kW;
  constexpr int kGroups = kPrepThreads / kG;  // queries a block at once
  __shared__ int s_j[kGroups][kMaxK];  // valid slots' support rows
  __shared__ int s_t[kGroups][kMaxK];  // and their slot numbers
  const int grp = threadIdx.x / kG;
  const long long queries = static_cast<long long>(clouds) * nq;
  const long long total = queries * slices;  // (slice, cloud, query) items
  const long long stride = static_cast<long long>(gridDim.x - clouds) * kGroups;
  // block-uniform trip count: every warp takes part in each round's staging
  for (long long item0 = static_cast<long long>(blockIdx.x - clouds) * kGroups;
       item0 < total; item0 += stride) {
    const long long item = item0 + grp;
    const bool live = item < total;  // group-uniform
    const int slice = static_cast<int>(item / queries);
    const long long bq = item % queries;  // b * nq + q
    const Lanes lc(slice, threadIdx.x % kG, c);
    const T* gb = g + bq / nq * ns * c;
    const size_t slot0 = static_cast<size_t>(bq) * k;
    const size_t o = static_cast<size_t>(bq) * c;
    float hi[kW], lo[kW], sh_hi[kW], sh_lo[kW], d1[kW];
    if (live) {
      lc.load_f32(gmax + o, hi);
      lc.load_f32(gmin + o, lo);
      lc.load_f32(dmax + o, sh_hi);
      lc.load_f32(dmin + o, sh_lo);
      lc.load_f32(ds1 + o, d1);
    }
    __syncwarp();  // the last round's staging is read
    const int n = stage_group_slots<kG>(
        idx + slot0, mask + slot0, k, live, [&](int at, int t, int j) {
          s_j[grp][at] = j;
          s_t[grp][at] = t;
        });
    __syncwarp();
    if (!live || n == 0) continue;
    int cnt[kW] = {};  // valid slots at the max, plus 256 x those at the min
    for (int t0 = 0; t0 < n; t0 += kTermUnroll) {
      Raw r[kTermUnroll];
#pragma unroll
      for (int u = 0; u < kTermUnroll; ++u)
        r[u] = lc.load(gb + static_cast<size_t>(s_j[grp][min(t0 + u, n - 1)]) *
                                c);
#pragma unroll
      for (int u = 0; u < kTermUnroll; ++u) {
        if (t0 + u < n) {
          float x[kW];
          Lanes::to_floats(r[u], x);
#pragma unroll
          for (int i = 0; i < kW; ++i)
            cnt[i] += (x[i] == hi[i]) + ((x[i] == lo[i]) << 8);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      sh_hi[i] = share(sh_hi[i], cnt[i] & 255);
      sh_lo[i] = share(sh_lo[i], cnt[i] >> 8);
    }
    for (int t0 = 0; t0 < n; t0 += kTermUnroll) {
      Raw r[kTermUnroll];
#pragma unroll
      for (int u = 0; u < kTermUnroll; ++u)
        r[u] = lc.load(gb + static_cast<size_t>(s_j[grp][min(t0 + u, n - 1)]) *
                                c);
#pragma unroll
      for (int u = 0; u < kTermUnroll; ++u) {
        if (t0 + u < n) {
          float x[kW];
          Lanes::to_floats(r[u], x);
#pragma unroll
          for (int i = 0; i < kW; ++i) {
            const float th = __fmul_rn(sh_hi[i], x[i] == hi[i] ? 1.f : 0.f);
            const float tl = __fmul_rn(sh_lo[i], x[i] == lo[i] ? 1.f : 0.f);
            x[i] = __fadd_rn(d1[i], __fadd_rn(th, tl));
          }
          lc.store_f32(terms + (slot0 + s_t[grp][t0 + u]) * c, x);
        }
      }
    }
  }
}

template <typename T, bool kVec>
void launch_nsum_fwd_as(const T* f, const int32_t* idx, const bool* mask,
                        int b, int nq, int ns, int c, int k, T* out,
                        cudaStream_t stream) {
  const int slices = slices_of<T>(c);
  const dim3 grid((nq + kSumWarps - 1) / kSumWarps * slices, b);
  if (ns <= kStageRows)
    nsum_fwd_kernel<T, kVec, true><<<grid, kSumThreads, 0, stream>>>(
        f, idx, mask, nq, ns, c, k, slices, out);
  else
    nsum_fwd_kernel<T, kVec, false><<<grid, kSumThreads, 0, stream>>>(
        f, idx, mask, nq, ns, c, k, slices, out);
}

template <typename T>
void launch_nsum_fwd(const void* f, const int32_t* idx, const bool* mask,
                     int b, int nq, int ns, int c, int k, void* out,
                     cudaStream_t stream) {
  const T* fp = static_cast<const T*>(f);
  T* op = static_cast<T*>(out);
  if (vec_ok<T>(c, f, out))
    launch_nsum_fwd_as<T, true>(fp, idx, mask, b, nq, ns, c, k, op,
                                stream);
  else
    launch_nsum_fwd_as<T, false>(fp, idx, mask, b, nq, ns, c, k, op,
                                 stream);
}

template <typename T, bool kVec, int kRows>
void launch_nsum_bwd_rows(const int32_t* idx, const bool* mask,
                          const T* dy, int b, int nq, int ns, int c, int k,
                          T* df, cudaStream_t stream) {
  const int slices = slices_of<T>(c);
  const int qchunk = std::min(kChunkQueries, kChunkSlots / k);
  constexpr int kTile = kRowWarps * kRows;
  const dim3 grid((ns + kTile - 1) / kTile * slices, b);
  nsum_bwd_kernel<T, kVec, kRows><<<grid, kRowThreads, 0, stream>>>(
      idx, mask, dy, nq, ns, c, k, slices, qchunk, df);
}

// Rows a backward warp owns: one where the cloud has few support rows
// (more warps, less idle work), up to four where it has many (each dy row
// loaded once for four rows).
template <typename T, bool kVec>
void launch_nsum_bwd_as(const int32_t* idx, const bool* mask, const T* dy,
                        int b, int nq, int ns, int c, int k, T* df,
                        cudaStream_t stream) {
  if (ns <= kRowWarps)
    launch_nsum_bwd_rows<T, kVec, 1>(idx, mask, dy, b, nq, ns, c, k, df,
                                     stream);
  else if (ns <= 2 * kRowWarps)
    launch_nsum_bwd_rows<T, kVec, 2>(idx, mask, dy, b, nq, ns, c, k, df,
                                     stream);
  else
    launch_nsum_bwd_rows<T, kVec, 4>(idx, mask, dy, b, nq, ns, c, k, df,
                                     stream);
}

template <typename T>
void launch_nsum_bwd(const int32_t* idx, const bool* mask, const void* dy,
                     int b, int nq, int ns, int c, int k, void* df,
                     cudaStream_t stream) {
  const T* dp = static_cast<const T*>(dy);
  T* op = static_cast<T*>(df);
  if (vec_ok<T>(c, dy, df))
    launch_nsum_bwd_as<T, true>(idx, mask, dp, b, nq, ns, c, k, op, stream);
  else
    launch_nsum_bwd_as<T, false>(idx, mask, dp, b, nq, ns, c, k, op, stream);
}

// K6's backward in two launches: the index and the per-slot terms, then
// the gather (dg from the terms, dgsq from ds2).
template <typename T, bool kVec, int kG>
void launch_pwstats_bwd_lanes(const T* g, const int32_t* idx,
                              const bool* mask, const float* gmax,
                              const float* gmin, const float* dmax,
                              const float* dmin, const float* ds1,
                              const float* ds2, int b, int nq, int ns, int c,
                              int k, int32_t* offsets, int32_t* slots,
                              int32_t* raw, int* counters, float* terms,
                              T* dg, T* dgsq, cudaStream_t stream) {
  static const int room =
      dynamic_smem_room(pwstats_terms_kernel<T, kVec, kG, true>);
  const int slices = slices_of<T, kG, kPrepBytes>(c);
  const int blocks = b + prep_blocks(kPrepThreads / kG,
                                      static_cast<long long>(b) * nq * slices);
  const int smem = (ns + 1) * static_cast<int>(sizeof(int));
  if (smem <= room)
    pwstats_terms_kernel<T, kVec, kG, true>
        <<<blocks, kPrepThreads, smem, stream>>>(
            g, idx, mask, gmax, gmin, dmax, dmin, ds1, b, nq, ns, c, k,
            slices, offsets, slots, raw, counters, terms);
  else
    pwstats_terms_kernel<T, kVec, kG, false>
        <<<blocks, kPrepThreads, 0, stream>>>(
            g, idx, mask, gmax, gmin, dmax, dmin, ds1, b, nq, ns, c, k,
            slices, offsets, slots, raw, counters, terms);
  launch_csr_gather<T, kVec, true>(offsets, slots, terms, ds2, b, nq, ns, c,
                                   k, dg, dgsq, stream);
}

template <typename T, bool kVec>
void launch_pwstats_bwd_as(const T* g, const int32_t* idx, const bool* mask,
                           const float* gmax, const float* gmin,
                           const float* dmax, const float* dmin,
                           const float* ds1, const float* ds2, int b, int nq,
                           int ns, int c, int k, int32_t* offsets,
                           int32_t* slots, int32_t* raw, int* counters,
                           float* terms, T* dg, T* dgsq,
                           cudaStream_t stream) {
  if (prep_lanes<T, kPrepBytes>(c) == 16)
    launch_pwstats_bwd_lanes<T, kVec, 16>(
        g, idx, mask, gmax, gmin, dmax, dmin, ds1, ds2, b, nq, ns, c, k,
        offsets, slots, raw, counters, terms, dg, dgsq, stream);
  else
    launch_pwstats_bwd_lanes<T, kVec, 32>(
        g, idx, mask, gmax, gmin, dmax, dmin, ds1, ds2, b, nq, ns, c, k,
        offsets, slots, raw, counters, terms, dg, dgsq, stream);
}

template <typename T>
void launch_pwstats_bwd(const void* g, const int32_t* idx, const bool* mask,
                        const float* gmax, const float* gmin,
                        const float* dmax, const float* dmin,
                        const float* ds1, const float* ds2, int b, int nq,
                        int ns, int c, int k, int32_t* offsets,
                        int32_t* slots, int32_t* raw, int* counters,
                        float* terms, void* dg, void* dgsq,
                        cudaStream_t stream) {
  const T* gp = static_cast<const T*>(g);
  T* dgp = static_cast<T*>(dg);
  T* dqp = static_cast<T*>(dgsq);
  if (vec_ok<T>(c, g, gmax, gmin, dmax, dmin, ds1, ds2, terms, dg, dgsq))
    launch_pwstats_bwd_as<T, true>(gp, idx, mask, gmax, gmin, dmax, dmin,
                                   ds1, ds2, b, nq, ns, c, k, offsets, slots,
                                   raw, counters, terms, dgp, dqp, stream);
  else
    launch_pwstats_bwd_as<T, false>(gp, idx, mask, gmax, gmin, dmax, dmin,
                                    ds1, ds2, b, nq, ns, c, k, offsets, slots,
                                    raw, counters, terms, dgp, dqp, stream);
}

bool bad_args(int b, int ns, int c, int k) {
  return b < 1 || b > 65535 || ns < 1 || c < 1 || k < 1 || k > kMaxK;
}

}  // namespace

// Outputs: gmax, gmin, s1, s2, each [B, Nq, C] float32. g and gsq are in
// one dtype (bf16 when is_bf16, else f32).
extern "C" int cl3d_pwmlp_stats(const void* g, const void* gsq,
                                const int32_t* idx, const bool* mask, int b,
                                int nq, int ns, int c, int k, int is_bf16,
                                float* gmax, float* gmin, float* s1, float* s2,
                                cudaStream_t stream) {
  if (bad_args(b, ns, c, k) ||
      static_cast<long long>(c) * (is_bf16 ? 2 : 4) >= kMaxRowBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaSuccess);
  return is_bf16 ? launch_extrema<__nv_bfloat16>(g, gsq, idx, mask, b, nq,
                                                 ns, c, k, gmax, gmin, s1, s2,
                                                 stream)
                 : launch_extrema<float>(g, gsq, idx, mask, b, nq, ns, c, k,
                                         gmax, gmin, s1, s2, stream);
}

// Outputs: dg, dgsq [B, Ns, C] in g's dtype, written in full (no zeroing
// needed). gmax/gmin are this op's forward outputs for g, the cotangents
// f32 [B, Nq, C]. Scratch, none zeroed: offsets [B, Ns + 1], slots and raw
// [B, Nq * K] (the reverse index; offsets/slots hold it afterwards),
// counters [B, Ns + 1] (used where Ns outgrows shared memory), terms
// [B, Nq * K, C] float32. Two launches.
extern "C" int cl3d_pwmlp_stats_bwd(
    const void* g, const int32_t* idx, const bool* mask, const float* gmax,
    const float* gmin, const float* dmax, const float* dmin, const float* ds1,
    const float* ds2, int b, int nq, int ns, int c, int k, int is_bf16,
    int32_t* offsets, int32_t* slots, int32_t* raw, int* counters,
    float* terms, void* dg, void* dgsq, cudaStream_t stream) {
  if (bad_args(b, ns, c, k) || static_cast<long long>(nq) * k > INT_MAX - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaSuccess);
  if (is_bf16)
    launch_pwstats_bwd<__nv_bfloat16>(g, idx, mask, gmax, gmin, dmax, dmin,
                                      ds1, ds2, b, nq, ns, c, k, offsets,
                                      slots, raw, counters, terms, dg, dgsq,
                                      stream);
  else
    launch_pwstats_bwd<float>(g, idx, mask, gmax, gmin, dmax, dmin, ds1, ds2,
                              b, nq, ns, c, k, offsets, slots, raw, counters,
                              terms, dg, dgsq, stream);
  return static_cast<int>(cudaGetLastError());
}

// Outputs: hmax, hmin, each [B, Nq, C] float32. g [B, Ns, C] and d
// [B, Nq, C] are in one dtype.
extern "C" int cl3d_gather_sub_minmax(const void* g, const void* d,
                                      const int32_t* idx, const bool* mask,
                                      int b, int nq, int ns, int c, int k,
                                      int is_bf16, float* hmax, float* hmin,
                                      cudaStream_t stream) {
  if (bad_args(b, ns, c, k) ||
      static_cast<long long>(c) * (is_bf16 ? 2 : 4) >= kMaxRowBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaSuccess);
  return is_bf16 ? launch_extrema<__nv_bfloat16>(g, d, idx, mask, b, nq, ns,
                                                 c, k, hmax, hmin, nullptr,
                                                 nullptr, stream)
                 : launch_extrema<float>(g, d, idx, mask, b, nq, ns, c, k,
                                         hmax, hmin, nullptr, nullptr,
                                         stream);
}

// Outputs: dg [B, Ns, C] in g's dtype and dd [B, Nq, C] in d's (the
// same), both written in full (no zeroing needed). hmax/hmin are this op's
// forward outputs for (g, d), dmax/dmin the f32 cotangents. The index in
// `tiles` query tiles a cloud (1 .. kMaxTiles, at most Nq); scratch, none
// zeroed: offsets and counters [B * tiles, Ns + 1] (counters used where Ns
// outgrows shared memory), entries and raw [B, Nq * K], shares [B, Nq,
// 2 * C] f32. Two launches. The argument list is that of the
// backwards on row_terms.cuh (cl3d_pospool_xyz_bwd) with dd after dg, so
// that one host launcher serves them all: radius is unused and avg must
// be 1 (the shares are always a buffer).
extern "C" int cl3d_gather_sub_minmax_bwd(
    const void* g, const void* d, const int32_t* idx, const bool* mask,
    const float* hmax, const float* hmin, const float* dmax,
    const float* dmin, int b, int nq, int ns, int c, int k, int tiles,
    float radius, int avg, int is_bf16, int32_t* offsets, int32_t* entries,
    int32_t* raw, int* counters, float* shares, void* dg, void* dd,
    cudaStream_t stream) {
  (void)radius;
  if (bad_args(b, ns, c, k) || static_cast<long long>(nq) * k > INT_MAX - 1 ||
      static_cast<long long>(c) * kShareFloats * 4 >= kMaxRowBytes ||
      tiles < 1 || tiles > kMaxTiles || (nq > 0 && tiles > nq) || avg != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaSuccess);
  if (is_bf16)
    launch_mm_bwd<__nv_bfloat16>(g, d, idx, mask, hmax, hmin, dmax, dmin, b,
                                 nq, ns, c, k, tiles, offsets, entries, raw,
                                 counters, shares, dg, dd, stream);
  else
    launch_mm_bwd<float>(g, d, idx, mask, hmax, hmin, dmax, dmin, b, nq, ns,
                         c, k, tiles, offsets, entries, raw, counters, shares,
                         dg, dd, stream);
  return static_cast<int>(cudaGetLastError());
}

namespace {
__global__ void empty_kernel() {}
}  // namespace

// One launch of an empty kernel: chip_smoke.py times it beside K13, whose
// work at its caller's shapes is below any launch's own device time.
extern "C" int cl3d_empty(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}

// Output: out [B, Nq, C] in f's dtype (bf16 when is_bf16, else f32).
extern "C" int cl3d_neighborhood_sum(const void* f, const int32_t* idx,
                                     const bool* mask, int b, int nq, int ns,
                                     int c, int k, int is_bf16, void* out,
                                     cudaStream_t stream) {
  if (bad_args(b, ns, c, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaSuccess);
  if (is_bf16)
    launch_nsum_fwd<__nv_bfloat16>(f, idx, mask, b, nq, ns, c, k, out,
                                   stream);
  else
    launch_nsum_fwd<float>(f, idx, mask, b, nq, ns, c, k, out, stream);
  return static_cast<int>(cudaGetLastError());
}

// Output: df [B, Ns, C] in dy's dtype, written in full (no zeroing
// needed); dy [B, Nq, C] is in f's dtype.
extern "C" int cl3d_neighborhood_sum_bwd(const int32_t* idx, const bool* mask,
                                         const void* dy, int b, int nq, int ns,
                                         int c, int k, int is_bf16, void* df,
                                         cudaStream_t stream) {
  if (bad_args(b, ns, c, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    launch_nsum_bwd<__nv_bfloat16>(idx, mask, dy, b, nq, ns, c, k, df,
                                   stream);
  else
    launch_nsum_bwd<float>(idx, mask, dy, b, nq, ns, c, k, df, stream);
  return static_cast<int>(cudaGetLastError());
}
