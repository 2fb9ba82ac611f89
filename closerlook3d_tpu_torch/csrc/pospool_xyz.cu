// PosPool, xyz position embedding, forward and backward in features.
// For query q with neighbor slots k (index idx[k], validity mask[k]) over
// support features f [Ns, C]:
//   out[q, c] = R_k  mask[k] * D[k, c / (C/3)] * f[idx[k], c],
//   D[k, d] = (s[idx[k], d] - q[d]) / r,
// with R = sum, or avg = sum / max(count of valid slots, 1). The backward
// gathers onto the support rows:
//   df[s, c] = sum over (q, k) with idx[q, k] = s and mask[q, k] of
//              g[q, c] * D[k, c / (C/3)],
//   g = dy (sum), or dy / max(count_q, 1) rounded to the features' dtype
//   (avg; the gather path's autograd rounds it there too).
// Positions get no gradient, as in the JAX package.
//
// Replaces: closerlook3d_tpu/ops/pallas/aggregation.py:_xyz_fwd_kernel
// (entry pospool_fused -> _pospool_call) and _xyz_bwd_kernel (the custom
// VJP's _pospool_bwd). The TPU kernels build multi-hot matrices and
// gather / scatter with MXU matmuls over Morton support chunks; here the
// forward reads each query's neighbor rows directly, and the backward
// gathers per support row over a reverse neighbor index (row_terms.cuh).
//
// Numerics: D is computed as (s - q) / r in f32 (the jnp gather path's
// form; the Pallas kernel multiplies by 1/r instead) and rounded to the
// features' dtype, as the gather path casts dp to f.dtype. Products and
// sums are f32; forward sums run over k in slot order, and the backward
// adds a support row's terms from +0 in (q, t) order. Each result is
// rounded once to the features' dtype. Against the plain PyTorch forward:
// f32 agrees to the rounding of the sum order; bf16 differs by the plain
// path's bf16 rounding of each product and of the sum. The plain backward
// twin, pospool_xyz_bwd_plain, forms the same f32 terms and, on CPU
// tensors, adds them with index_add_ in the same order: the two are equal
// to the bit, and every run gives the same bits.
//
// Forward layout (query_groups.cuh): a group of 16 or 32 lanes a query
// (and slice of its channels where queries are few), several groups a
// block and no block-wide barrier. The group compacts the query's valid
// slots in slot order and stages their support rows and D in its own
// shared memory; then each lane takes units of 16 bytes of channels (8
// bf16, 4 f32) of one coordinate d = c / (C/3) (every C the models run has
// C/3 a multiple of 8), reads the valid slots' 16-byte vectors of those
// channels, 4 slots at once, and writes its 16 bytes of the output once.
// C/3 off the vector width, or views off 16 bytes, take scalar units of
// the same channels. Backward: two launches over a reverse neighbor index
// (row_terms.cuh), the index (and, for avg, g = dy / max(count, 1) by
// query), then a gather in which 16 bytes of channels of one coordinate
// of a support row take one lane (9 lanes a row at C = 72 bf16),
// recomputing each entry's D from the row's own position: no float
// atomics, no zeroed scratch, no cast.
//
// Bound on the H100: bytes (inputs read once, the output written once).
// The forward's term is one product and one add a channel, so its pace is
// set by memory latency, not by that bound: the chain of dependent loads a
// query (idx and mask, then positions, then rows) and the gathered rows,
// B*Nq*(valid slots)*C values that a cloud's queries read again and again
// from L2. At ModelNet40's bf16 step (NVIDIA H100 80GB HBM3, 700 W) it
// moves its bytes at 0.85 TB/s, a quarter of the bound; staging and stores
// take 28% of its time, and the slot loops read rows from L2 at 1.4-2.0
// TB/s where queries hold 3-5 valid slots and 3.3-3.9 TB/s at the strided
// calls (13-16). Hence no block barrier, valid slots only, 16 bytes a
// lane and 4 slots' rows in flight (2 ran 5% slower, 8 6% slower);
// groups of 8 lanes stage in 8 rounds, take 64 registers and spill, and
// lost 4-14% to 16 and 32. Backward: dy once (and g written and read
// once for avg) and df once; but each entry reads its query's g unit
// again, from L1 or L2 where Morton-adjacent support rows share queries,
// after a chain of dependent loads (offsets, entry, then position and g),
// as K9b's gather does with a quarter of its g bytes. At ModelNet40's
// bf16 step (NVIDIA H100 80GB HBM3, 700 W) it takes 0.79-0.86 ms against
// 1.76 for the atomic scatter, the index launch 0.35 of it; 16-byte
// units win (8 bytes ran 1.29x slower, 4 bytes 1.84x: every lane walks
// all its row's entries), and two entries' loads at once gain 1-7% (4:
// 80 registers, 1.12x slower).

#include "query_groups.cuh"
#include "row_terms.cuh"

namespace {

constexpr int kXyzBytes = 16;  // channels a lane's unit holds, in bytes
constexpr int kXyzBatch = 4;   // valid slots whose rows a lane loads at once
constexpr int kXyzLanes = 16;  // the narrowest group (see the note above)

// K1 forward in query groups (query_groups.cuh): a group of kG lanes per
// item, a query and a slice of its passes. Unit e * kG + lg of pass e
// belongs to lane lg: channels [unit * kW, unit * kW + kW). Each channel
// sums acc + v * D[d] over the valid slots in slot order from +0, each
// product and sum rounded to f32 (the intrinsics keep nvcc from
// contracting them), divides by max(n, 1) for avg and rounds once to T:
// the bits of a loop over all K slots that skips the invalid ones.
template <typename T, bool kVec, int kG>
__global__ void __launch_bounds__(kGroupThreads)
    pospool_xyz_kernel(const float* __restrict__ q,
                       const float* __restrict__ s,
                       const T* __restrict__ f,
                       const int32_t* __restrict__ idx,
                       const bool* __restrict__ mask, int nq, int ns, int c,
                       int k, float radius, int avg, long long items,
                       int slices, int per, T* __restrict__ out) {
  using U = ChannelUnit<T, kVec, kXyzBytes>;
  constexpr int kW = U::kW;
  __shared__ GroupSlots s_slots[kGroupThreads / kG];
  GroupSlots& st = s_slots[threadIdx.x / kG];
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
      [radius](float sv, float qv) {
        return to_f32(from_f32<T>(__fdiv_rn(__fsub_rn(sv, qv), radius)));
      },
      st);
  __syncwarp();
  if (!it.live) return;
  const int g = c / 3;
  const float cnt = static_cast<float>(max(n, 1));
  const unsigned row_bytes = static_cast<unsigned>(c) * sizeof(T);
  const int u_end = min(U::units(c), (it.slice + 1) * per * kG);
  for (int unit = it.slice * per * kG + lg; unit < u_end; unit += kG) {
    const int ch0 = unit * kW;
    const T* f0 = f + b * ns * c + ch0;  // the unit's channels of row 0
    int dd[kW];  // each channel's coordinate (one for a vector unit)
#pragma unroll
    for (int i = 0; i < kW; ++i)
      dd[i] = kVec ? ch0 / g : min((ch0 + i) / g, 2);
    float acc[kW] = {};
    for (int i0 = 0; i0 < n; i0 += kXyzBatch) {
      typename U::Raw r[kXyzBatch];
#pragma unroll
      for (int v = 0; v < kXyzBatch; ++v)
        r[v] = U::load(row_at(f0, st.j[min(i0 + v, n - 1)], row_bytes),
                       c - ch0);
#pragma unroll
      for (int v = 0; v < kXyzBatch; ++v) {
        if (i0 + v < n) {
          const float* x = st.x[i0 + v];
#pragma unroll
          for (int i = 0; i < kW; ++i)
            acc[i] = __fadd_rn(acc[i], __fmul_rn(to_f32(r[v].v[i]),
                                                 x[dd[i]]));
        }
      }
    }
    if (avg) {
#pragma unroll
      for (int i = 0; i < kW; ++i) acc[i] = __fdiv_rn(acc[i], cnt);
    }
    U::store(out + it.row * c + ch0, c - ch0, acc);
  }
}

template <typename T, bool kVec>
int launch_fwd_as(const float* q, const float* s, const T* f,
                  const int32_t* idx, const bool* mask, int b, int nq,
                  int ns, int c, int k, float radius, int avg, T* out,
                  cudaStream_t stream) {
  return launch_query_groups(
      static_cast<long long>(b) * nq,
      ChannelUnit<T, kVec, kXyzBytes>::units(c), kXyzLanes,
      [&](auto lanes, unsigned blocks, long long items, PassSplit sp) {
        pospool_xyz_kernel<T, kVec, decltype(lanes)::value>
            <<<blocks, kGroupThreads, 0, stream>>>(
                q, s, f, idx, mask, nq, ns, c, k, radius, avg, items,
                sp.slices, sp.per, out);
      });
}

// The forward in vector units where C/3 and the pointers allow them.
template <typename T>
int launch_fwd(const float* q, const float* s, const void* f,
               const int32_t* idx, const bool* mask, int b, int nq, int ns,
               int c, int k, float radius, int avg, void* out,
               cudaStream_t stream) {
  const T* fp = static_cast<const T*>(f);
  T* op = static_cast<T*>(out);
  if (runs_ok<T, ChannelUnit<T, true, kXyzBytes>::kW>(c / 3, f, out))
    return launch_fwd_as<T, true>(q, s, fp, idx, mask, b, nq, ns, c, k,
                                  radius, avg, op, stream);
  return launch_fwd_as<T, false>(q, s, fp, idx, mask, b, nq, ns, c, k,
                                 radius, avg, op, stream);
}

// K1 backward, launch 2 (row_terms.cuh): the lane of unit `unit` of
// support row s holds channels [unit * kW, unit * kW + kW), all of one
// coordinate d = ch / (C/3); for each entry (q, t) of the row, in (q, t)
// order,
//   df[s, c] += g[q, c] * D,   D = (s[s, d] - q[q, d]) / r in f32 rounded
// to T, the product and the sum rounded to f32 (the intrinsics keep nvcc
// from contracting them). A lane holds kW = 16 bytes of T (8 bf16
// channels; 1 channel where C/3 or the pointers do not allow vectors) and
// takes a row's entries two at once, both g units and query positions
// loaded first, then the last one alone. An entry holds its query
// (row_terms.cuh).
template <typename T, int kW>
__global__ void __launch_bounds__(kRowThreads)
    xyz_gather_kernel(const float* __restrict__ q,
                      const float* __restrict__ s, const T* __restrict__ g,
                      const int32_t* __restrict__ offsets,
                      const int32_t* __restrict__ entries, int nq, int ns,
                      int c, int k, int tiles, int per, float radius,
                      int lanes, int slices, T* __restrict__ df) {
  const RowItem it = row_item(ns, c / kW, lanes, slices);
  if (!it.live) return;
  const size_t b = blockIdx.y;
  const int ch = it.unit * kW;
  const int d = ch / (c / 3);
  const float sd = s[(b * ns + it.row) * 3 + d];
  const float* qb = q + b * nq * 3 + d;
  const T* gb = g + b * nq * c + ch;
  float acc[kW] = {};
  for_each_entry_tile(
      offsets, entries, b, nq, ns, k, tiles, per, it.row,
      [&](const int32_t* eb, int start, int end, int q0) {
        int e = start;
        for (; e + 1 < end; e += 2) {
          const int qa = q0 + eb[e], qz = q0 + eb[e + 1];
          T ga[kW], gz[kW];
          load_run<T, kW>(gb + static_cast<size_t>(qa) * c, ga);
          load_run<T, kW>(gb + static_cast<size_t>(qz) * c, gz);
          const float da = to_f32(
              from_f32<T>(__fdiv_rn(__fsub_rn(sd, qb[qa * 3]), radius)));
          const float dz = to_f32(
              from_f32<T>(__fdiv_rn(__fsub_rn(sd, qb[qz * 3]), radius)));
#pragma unroll
          for (int i = 0; i < kW; ++i)
            acc[i] = __fadd_rn(acc[i], __fmul_rn(to_f32(ga[i]), da));
#pragma unroll
          for (int i = 0; i < kW; ++i)
            acc[i] = __fadd_rn(acc[i], __fmul_rn(to_f32(gz[i]), dz));
        }
        if (e < end) {
          const int qi = q0 + eb[e];
          T gv[kW];
          load_run<T, kW>(gb + static_cast<size_t>(qi) * c, gv);
          const float dv = to_f32(
              from_f32<T>(__fdiv_rn(__fsub_rn(sd, qb[qi * 3]), radius)));
#pragma unroll
          for (int i = 0; i < kW; ++i)
            acc[i] = __fadd_rn(acc[i], __fmul_rn(to_f32(gv[i]), dv));
        }
      });
  store_run<T, kW>(df + (b * ns + it.row) * c + ch, acc);
}

template <typename T, int kW>
void launch_gather_as(const float* q, const float* s, const T* g,
                      const int32_t* offsets, const int32_t* entries, int b,
                      int nq, int ns, int c, int k, int tiles, float radius,
                      T* df, cudaStream_t stream) {
  const RowSplit sp = row_split(c / kW);
  xyz_gather_kernel<T, kW><<<row_grid(b, ns, sp), kRowThreads, 0, stream>>>(
      q, s, g, offsets, entries, nq, ns, c, k, tiles,
      (nq + tiles - 1) / tiles, radius, sp.lanes, sp.slices, df);
}

// K1's backward in two launches: the index (and g for avg), then the
// gather, in 16-byte units where C/3 and the pointers allow them.
template <typename T>
void launch_bwd(const float* q, const float* s, const int32_t* idx,
                const bool* mask, const void* dy, int b, int nq, int ns,
                int c, int k, int tiles, float radius, int avg,
                int32_t* offsets, int32_t* entries, int32_t* raw,
                int* counters, void* g, void* df, cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const T* dp = static_cast<const T*>(dy);
  T* gp = static_cast<T*>(g);
  T* fp = static_cast<T*>(df);
  launch_index_scale<T>(idx, mask, dp, b, nq, ns, k, tiles, c, avg, offsets,
                        entries, raw, counters, gp, stream);
  if (runs_ok<T, kV>(c / 3, g, df))
    launch_gather_as<T, kV>(q, s, gp, offsets, entries, b, nq, ns, c, k,
                            tiles, radius, fp, stream);
  else
    launch_gather_as<T, 1>(q, s, gp, offsets, entries, b, nq, ns, c, k,
                           tiles, radius, fp, stream);
}

bool bad_args(int b, int ns, int c, int k) {
  return b < 1 || b > 65535 || ns < 1 || c < 3 || c % 3 != 0 || k < 1 ||
         k > kMaxK;
}

}  // namespace

extern "C" int cl3d_pospool_xyz(const float* q, const float* s,
                                const void* f, const int32_t* idx,
                                const bool* mask, int b, int nq, int ns,
                                int c, int k, float radius, int avg,
                                int is_bf16, void* out,
                                cudaStream_t stream) {
  if (bad_args(b, ns, c, k) ||
      static_cast<long long>(c) * (is_bf16 ? 2 : 4) >= kMaxRowBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaSuccess);
  return is_bf16 ? launch_fwd<__nv_bfloat16>(q, s, f, idx, mask, b, nq, ns,
                                             c, k, radius, avg, out, stream)
                 : launch_fwd<float>(q, s, f, idx, mask, b, nq, ns, c, k,
                                     radius, avg, out, stream);
}

// df [B, Ns, C] in the features' dtype, written in full (no zeroing
// needed); dy is [B, Nq, C] in that dtype. g: for avg a [B, Nq, C] buffer
// in that dtype that launch 1 fills with dy / max(count, 1), for sum dy
// itself. The index in `tiles` query tiles a cloud (1 .. kMaxTiles, at
// most Nq). Scratch, none zeroed: offsets and counters [B * tiles, Ns + 1]
// (counters used where Ns outgrows shared memory), entries (each tile's
// queries, in the cloud's slot range of the tile) and raw [B, Nq * K].
// Two launches.
extern "C" int cl3d_pospool_xyz_bwd(const float* q, const float* s,
                                    const int32_t* idx, const bool* mask,
                                    const void* dy, int b, int nq, int ns,
                                    int c, int k, int tiles, float radius,
                                    int avg, int is_bf16, int32_t* offsets,
                                    int32_t* entries, int32_t* raw,
                                    int* counters, void* g, void* df,
                                    cudaStream_t stream) {
  if (bad_args(b, ns, c, k) || static_cast<long long>(nq) * k > INT_MAX - 1 ||
      tiles < 1 || tiles > kMaxTiles || (nq > 0 && tiles > nq))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaSuccess);
  if (is_bf16)
    launch_bwd<__nv_bfloat16>(q, s, idx, mask, dy, b, nq, ns, c, k, tiles,
                              radius, avg, offsets, entries, raw, counters, g,
                              df, stream);
  else
    launch_bwd<float>(q, s, idx, mask, dy, b, nq, ns, c, k, tiles, radius,
                      avg, offsets, entries, raw, counters, g, df, stream);
  return static_cast<int>(cudaGetLastError());
}
