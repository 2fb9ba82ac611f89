// Neighborhood moments, forward and backward in features. For query q with
// neighbor slots k (index idx[k], validity mask[k]) over support features
// f [Ns, C]:
//   out[q, 0*C + c] = R_k  mask[k] * f[idx[k], c],
//   out[q, (d+1)*C + c] = R_k  mask[k] * D[k, d] * f[idx[k], c],  d = 0..2,
//   D[k, d] = (s[idx[k], d] - q[d]) / r,
// with R = sum, or avg = sum / max(count of valid slots, 1): [B, Nq, 4C].
// The backward gathers onto the support rows:
//   df[s, c] = sum over (q, k) with idx[q, k] = s and mask[q, k] of
//              g[q, c] + g[q, C + c] D[k, 0] + g[q, 2C + c] D[k, 1]
//                      + g[q, 3C + c] D[k, 2],
//   g = dy (sum), or dy / max(count_q, 1) rounded to the features' type
//   (avg). Positions get no gradient, as in the JAX package.
//
// Replaces: closerlook3d_tpu/ops/pallas/moments.py:_fwd_kernel and
// _bwd_kernel (entry neighborhood_moments -> _moments_vjp). The TPU kernels
// build a masked multi-hot matrix per Morton support chunk and contract it
// (and its D-weighted copies) with the features on the MXU; here the
// forward reads each query's neighbor rows directly, and the backward
// gathers per support row over a reverse neighbor index (row_terms.cuh).
//
// Numerics: D is (s - q) / r in f32 rounded to the features' type before
// the products, as the TPU kernel rounds its weights (w.astype(f.dtype))
// and as pospool_xyz.cu does. The forward's four sums per channel are f32
// in slot order, each rounded once. The backward's per-slot term is
// ((g0 + g1 D0) + g2 D1) + g3 D2 in f32, and a support row adds its terms
// from +0 in (q, t) order and rounds once: the order of the plain twin's
// index_add_ on CPU tensors, so the two are equal to the bit, and every run
// gives the same bits.
//
// Forward layout (query_groups.cuh): a group of 8-32 lanes a query (and
// slice of its channels where queries are few), several groups a block
// and no block-wide barrier. The group compacts the query's valid slots
// in slot order and stages their support rows and D in its own shared
// memory; then each lane takes units of 8 bytes of channels (4 bf16, 2
// f32), so that one gathered 8-byte vector of a row feeds the unit's four
// moments (4 kW f32 sums in registers), and writes the output's four
// C-slices of the unit as four 8-byte stores. C off the vector width, or
// views off 8 bytes, take scalar units. Backward: two launches, the
// reverse index (and, for avg, g = dy / max(count, 1) by query), then a
// gather in which 16 bytes of channels of a support row take one lane (9
// lanes a row at C = 72 bf16), recomputing each entry's D from the row's
// own position: no float atomics, no zeroed scratch, no cast.
//
// Bound on the H100: bytes (inputs read once, the 4C-wide output written
// once). Forward: its pace is set by memory latency, not by that bound:
// the chain of dependent loads a query (idx and mask, positions, rows)
// and the gathered rows, B*Nq*(valid slots)*C values re-read from L2, each
// vector feeding kW conversions, 3 kW products and 4 kW adds. At
// ModelNet40's bf16 step (NVIDIA H100 80GB HBM3, 700 W) it moves its
// bytes at 0.96 TB/s, 29% of the bound; staging and the four stores take
// 35% of its time (52% at C = 72, 160000 queries of ~5 valid slots), and
// the slot loops read rows from L2 at 1.0-2.2 TB/s. Hence no block
// barrier, valid slots only, and 8-byte units (16 f32 sums: 48-64
// registers) with 4 slots' rows in flight: 16-byte units' 32 sums took
// 80 registers and ran 1.2x slower, 2 slots at once 4% slower.
// Backward: dy once (and g written and read once for avg) and df once;
// but each valid slot reads q's 4C-wide g row again
// (8C bytes in bf16), from L1 or L2 where Morton-adjacent support rows
// share queries, and each entry costs a chain of dependent loads (offsets,
// entry, then position and g): the gather is bound by that latency, at a
// quarter of the issue rate. A lane takes its entries one at a time (2
// or 4 at once cost registers and ran 3-14% slower; 8 bytes of channels
// a lane, 18 lanes a row, 28% slower). For avg, writing g moves dy's
// bytes twice more, which takes most of launch 1 at the wide calls.

#include "query_groups.cuh"
#include "row_terms.cuh"

namespace {

constexpr int kMomentsBytes = 8;  // channels a lane's unit holds, in bytes
constexpr int kMomentsBatch = 4;  // valid slots' rows a lane loads at once

// K9 forward in query groups (query_groups.cuh): a group of kG lanes per
// item, a query and a slice of its passes. Unit e * kG + lg of pass e
// belongs to lane lg: channels [unit * kW, unit * kW + kW) of each moment.
// Each channel's four sums run over the valid slots in slot order from +0:
// a0 + v and a(d+1) + v * D[d], each product and sum rounded to f32 (the
// intrinsics keep nvcc from contracting them); avg divides each by
// max(n, 1); each is rounded once to T: the bits of a loop over all K
// slots that skips the invalid ones.
template <typename T, bool kVec, int kG>
__global__ void __launch_bounds__(kGroupThreads)
    moments_kernel(const float* __restrict__ q, const float* __restrict__ s,
                   const T* __restrict__ f, const int32_t* __restrict__ idx,
                   const bool* __restrict__ mask, int nq, int ns, int c,
                   int k, float radius, int avg, long long items, int slices,
                   int per, T* __restrict__ out) {
  using U = ChannelUnit<T, kVec, kMomentsBytes>;
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
  const float cnt = static_cast<float>(max(n, 1));
  const unsigned row_bytes = static_cast<unsigned>(c) * sizeof(T);
  T* orow = out + it.row * 4 * c;
  const int u_end = min(U::units(c), (it.slice + 1) * per * kG);
  for (int unit = it.slice * per * kG + lg; unit < u_end; unit += kG) {
    const int ch0 = unit * kW;
    const T* f0 = f + b * ns * c + ch0;  // the unit's channels of row 0
    float acc[4][kW] = {};
    for (int i0 = 0; i0 < n; i0 += kMomentsBatch) {
      typename U::Raw r[kMomentsBatch];
#pragma unroll
      for (int v = 0; v < kMomentsBatch; ++v)
        r[v] = U::load(row_at(f0, st.j[min(i0 + v, n - 1)], row_bytes),
                       c - ch0);
#pragma unroll
      for (int v = 0; v < kMomentsBatch; ++v) {
        if (i0 + v < n) {
          const float* x = st.x[i0 + v];
          const float x0 = x[0], x1 = x[1], x2 = x[2];
#pragma unroll
          for (int i = 0; i < kW; ++i) {
            const float fv = to_f32(r[v].v[i]);
            acc[0][i] = __fadd_rn(acc[0][i], fv);
            acc[1][i] = __fadd_rn(acc[1][i], __fmul_rn(fv, x0));
            acc[2][i] = __fadd_rn(acc[2][i], __fmul_rn(fv, x1));
            acc[3][i] = __fadd_rn(acc[3][i], __fmul_rn(fv, x2));
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (avg) {
#pragma unroll
        for (int i = 0; i < kW; ++i) acc[m][i] = __fdiv_rn(acc[m][i], cnt);
      }
      U::store(orow + m * c + ch0, c - ch0, acc[m]);
    }
  }
}

template <typename T, bool kVec>
int launch_fwd_as(const float* q, const float* s, const T* f,
                  const int32_t* idx, const bool* mask, int b, int nq,
                  int ns, int c, int k, float radius, int avg, T* out,
                  cudaStream_t stream) {
  return launch_query_groups(
      static_cast<long long>(b) * nq,
      ChannelUnit<T, kVec, kMomentsBytes>::units(c), 8,  // any width
      [&](auto lanes, unsigned blocks, long long items, PassSplit sp) {
        moments_kernel<T, kVec, decltype(lanes)::value>
            <<<blocks, kGroupThreads, 0, stream>>>(
                q, s, f, idx, mask, nq, ns, c, k, radius, avg, items,
                sp.slices, sp.per, out);
      });
}

// The forward in vector units where C and the pointers allow them.
template <typename T>
int launch_fwd(const float* q, const float* s, const void* f,
               const int32_t* idx, const bool* mask, int b, int nq, int ns,
               int c, int k, float radius, int avg, void* out,
               cudaStream_t stream) {
  const T* fp = static_cast<const T*>(f);
  T* op = static_cast<T*>(out);
  if (runs_ok<T, ChannelUnit<T, true, kMomentsBytes>::kW>(c, f, out))
    return launch_fwd_as<T, true>(q, s, fp, idx, mask, b, nq, ns, c, k,
                                  radius, avg, op, stream);
  return launch_fwd_as<T, false>(q, s, fp, idx, mask, b, nq, ns, c, k,
                                 radius, avg, op, stream);
}

// K9 backward, launch 2 (row_terms.cuh): the lane of unit `unit` of
// support row s holds channels [unit * kW, unit * kW + kW); for each entry
// (q, t) of the row, in (q, t) order,
//   df[s, c] += ((g0 + g1 * D0) + g2 * D1) + g3 * D2,   gm = g[q, m*C + c],
// D = (s[s] - q[q]) / r in f32 rounded to T, each product and sum rounded
// to f32 (the intrinsics keep nvcc from contracting them). A lane holds
// kW = 16 bytes of T (8 bf16 channels; 1 channel where C or the pointers
// do not allow vectors). An entry holds its query (row_terms.cuh).
template <typename T, int kW>
__global__ void __launch_bounds__(kRowThreads)
    moments_gather_kernel(const float* __restrict__ q,
                          const float* __restrict__ s,
                          const T* __restrict__ g,
                          const int32_t* __restrict__ offsets,
                          const int32_t* __restrict__ entries, int nq, int ns,
                          int c, int k, int tiles, int per, float radius,
                          int lanes, int slices, T* __restrict__ df) {
  const RowItem it = row_item(ns, c / kW, lanes, slices);
  if (!it.live) return;
  const size_t b = blockIdx.y;
  const int ch = it.unit * kW;
  const float* sp = s + (b * ns + it.row) * 3;
  const float s0 = sp[0], s1 = sp[1], s2 = sp[2];
  const float* qb = q + b * nq * 3;
  const T* gb = g + b * nq * 4 * c + ch;
  float acc[kW] = {};
  for_each_entry_tile(
      offsets, entries, b, nq, ns, k, tiles, per, it.row,
      [&](const int32_t* eb, int start, int end, int q0) {
        for (int e = start; e < end; ++e) {
          const int qi = q0 + eb[e];
          T gv[4][kW];
#pragma unroll
          for (int m = 0; m < 4; ++m)
            load_run<T, kW>(gb + (static_cast<size_t>(qi) * 4 + m) * c,
                            gv[m]);
          const float* qp = qb + qi * 3;
          const float d0 =
              to_f32(from_f32<T>(__fdiv_rn(__fsub_rn(s0, qp[0]), radius)));
          const float d1 =
              to_f32(from_f32<T>(__fdiv_rn(__fsub_rn(s1, qp[1]), radius)));
          const float d2 =
              to_f32(from_f32<T>(__fdiv_rn(__fsub_rn(s2, qp[2]), radius)));
#pragma unroll
          for (int i = 0; i < kW; ++i) {
            float v = __fadd_rn(to_f32(gv[0][i]),
                                __fmul_rn(to_f32(gv[1][i]), d0));
            v = __fadd_rn(v, __fmul_rn(to_f32(gv[2][i]), d1));
            v = __fadd_rn(v, __fmul_rn(to_f32(gv[3][i]), d2));
            acc[i] = __fadd_rn(acc[i], v);
          }
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
  moments_gather_kernel<T, kW><<<row_grid(b, ns, sp), kRowThreads, 0,
                                 stream>>>(
      q, s, g, offsets, entries, nq, ns, c, k, tiles,
      (nq + tiles - 1) / tiles, radius, sp.lanes, sp.slices, df);
}

// K9's backward in two launches: the index (and g for avg), then the
// gather.
template <typename T>
void launch_bwd(const float* q, const float* s, const int32_t* idx,
                const bool* mask, const void* dy, int b, int nq, int ns,
                int c, int k, int tiles, float radius, int avg,
                int32_t* offsets, int32_t* entries, int32_t* raw,
                int* counters, void* g, void* df, cudaStream_t stream) {
  const T* dp = static_cast<const T*>(dy);
  T* gp = static_cast<T*>(g);
  T* fp = static_cast<T*>(df);
  launch_index_scale<T>(idx, mask, dp, b, nq, ns, k, tiles, 4 * c, avg,
                        offsets, entries, raw, counters, gp, stream);
  if (vec_ok<T>(c, g, df))
    launch_gather_as<T, static_cast<int>(16 / sizeof(T))>(
        q, s, gp, offsets, entries, b, nq, ns, c, k, tiles, radius, fp,
        stream);
  else
    launch_gather_as<T, 1>(q, s, gp, offsets, entries, b, nq, ns, c, k,
                           tiles, radius, fp, stream);
}

bool bad_args(int b, int ns, int c, int k) {
  return b < 1 || b > 65535 || ns < 1 || c < 1 || k < 1 || k > kMaxK;
}

}  // namespace

// f is [B, Ns, C], out [B, Nq, 4C], both in the features' dtype.
extern "C" int cl3d_moments(const float* q, const float* s, const void* f,
                            const int32_t* idx, const bool* mask, int b,
                            int nq, int ns, int c, int k, float radius,
                            int avg, int is_bf16, void* out,
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
// needed); dy is [B, Nq, 4C] in that dtype. g: for avg a [B, Nq, 4C]
// buffer in that dtype that launch 1 fills with dy / max(count, 1), for
// sum dy itself. The index in `tiles` query tiles a cloud (1 ..
// kMaxTiles, at most Nq). Scratch, none zeroed: offsets and counters
// [B * tiles, Ns + 1] (counters used where Ns outgrows shared memory),
// entries (each tile's queries, in the cloud's slot range of the tile)
// and raw [B, Nq * K]. Two launches.
extern "C" int cl3d_moments_bwd(const float* q, const float* s,
                                const int32_t* idx, const bool* mask,
                                const void* dy, int b, int nq, int ns, int c,
                                int k, int tiles, float radius, int avg,
                                int is_bf16, int32_t* offsets,
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
