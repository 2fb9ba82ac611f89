// PosPool, sinusoidal position embedding, forward and backward in features.
// For query q with neighbor slots k (index idx[k], validity mask[k]) over
// support features f [Ns, C], C = 6 * nf:
//   out[q, c] = R_k  mask[k] * E[k, c] * f[idx[k], c],
//   D[k, d]   = (s[idx[k], d] - q[d]) / r                      (f32),
//   A[k, d, j] = (alpha * D[k, d]) / freq[j]                  (f32),
//   E[k, d*2nf + j]      = sin(A[k, d, j]),
//   E[k, d*2nf + nf + j] = cos(A[k, d, j]),    rounded to the features' type,
// alpha = 100 and freq[j] = 1000 ** (j / nf), a table the wrapper passes in
// (computed as the plain version computes it). R = sum, or avg = sum /
// max(count of valid slots, 1). The backward gathers onto the support rows:
//   df[s, c] = sum over (q, k) with idx[q, k] = s and mask[q, k] of
//              g[q, c] * E[k, c],
//   g = dy (sum), or dy / max(count_q, 1) rounded to the features' type
//   (avg). Positions get no gradient, as in the JAX package.
//
// Replaces: closerlook3d_tpu/ops/pallas/aggregation.py:_sc_fwd_kernel and
// _sc_bwd_kernel (entry pospool_fused -> _sc2_vjp). The TPU splits the work
// three ways: XLA builds two support-side streams g1, g2 = f * sin/cos of
// absolute angles, the kernel sums them through multi-hot MXU matmuls, and
// a combine applies the query's trig (sin(u - v) identities). Here each
// slot's relative angle is computed directly, as the JAX gather path does:
// no [B, Ns, C] streams, and none of the absolute-angle reassociation error
// (~5e-4) that the TPU kernel carries.
//
// Numerics: D stays f32 for the angle (the TPU kernel takes its angles from
// f32 positions; the JAX gather path rounds D to bf16 first in a bf16
// model, which moves the top frequencies' angles by up to ~0.2 rad). sin
// and cos are the accurate sincosf (never __sinf or fast math: angles reach
// 100 rad). E is rounded to the features' type, as the gather path casts
// the embedding; products and sums are f32 and each result is rounded
// once. The forward sums over k in slot order; the backward sums a support
// row's terms from +0 in (q, t) order, the order of the plain twin's
// index_add_ on CPU tensors, and gives the same bits on every run.
//
// Forward layout (query_groups.cuh): a group of 8-32 lanes per query (and
// slice of its pairs where queries are few), several groups a block and no
// block-wide barrier. The group compacts the query's valid slots in slot
// order and stages their alpha * D in its own shared memory; then each
// lane takes one (coordinate, frequency) pair a pass, whose sin and cos
// channels share one angle and one sincosf, neighbouring lanes on
// neighbouring channels. Group widths follow the C / 2 pairs
// (group_lanes_for), so that most lanes run a sincosf: 8 lanes at C = 72
// (36 pairs, 5 passes). The backward takes two launches over a reverse
// neighbor index (row_terms.cuh): the index (and, for avg, g = dy /
// max(count, 1) by query), then a gather in which 4 frequencies of one
// coordinate of a support row take one lane (9 lanes a row at C = 72),
// recomputing each entry's D and angles from the row's own position: no
// float atomics, no zeroed scratch, no cast.
//
// Bound on the H100: bytes at these shapes by the count the smoke run uses
// (inputs read once, outputs written once). The forward runs ~60
// instructions a (valid slot, pair), a third of them the sincosf, and
// reaches ~40% of the SM's issue rate: warps wait on the chains of
// dependent loads a query (idx and mask, positions, rows from L2) and on
// the division's and sincosf's slow-path branches, which split the loop
// body. More warps in flight help (kSinCosBlocks); staging the terms in
// shared memory to keep all 32 lanes on one query did not (fewer warps).
// The backward runs the same sincosf a (valid slot, pair), so it too is
// bound by instructions, not bytes: one division for D a (entry, lane)
// and 4 frequencies a lane keep the rest small beside the sincosf. A lane
// takes its entries one at a time: 2 to 8 at once cost registers (the
// sincosf's slow path keeps a stack frame) and ran 7-28% slower, 2
// frequencies a lane 4% slower.

#include <climits>

#include "query_groups.cuh"
#include "row_terms.cuh"

namespace {

constexpr float kAlpha = 100.f;

// K5 forward in query groups (query_groups.cuh): a group of kG lanes per
// item, a query and a slice of its passes. Lane lg of pass e takes the
// (coordinate, frequency) pair e * kG + lg: neighbouring lanes read
// neighbouring sin channels of a row, then neighbouring cos channels, and
// write the output likewise. alpha * D of the valid slots is staged once an
// item; each (valid slot, pair) gets one division and one sincosf; a lane
// starts the row loads of kSlotBatch slots at once.
constexpr int kSlotBatch = 4;
// blocks an SM is sized for: at most 42 registers a thread. More warps in
// flight beat the few bytes the 8-lane groups then spill (their staging).
constexpr int kSinCosBlocks = 6;

template <typename T, int kG>
__global__ void __launch_bounds__(kGroupThreads, kSinCosBlocks)
    pospool_sincos_kernel(const float* __restrict__ q,
                          const float* __restrict__ s,
                          const T* __restrict__ f,
                          const float* __restrict__ freq,
                          const int32_t* __restrict__ idx,
                          const bool* __restrict__ mask, int nq, int ns,
                          int c, int k, float radius, int avg,
                          long long items, int slices, int per,
                          T* __restrict__ out) {
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
        return __fmul_rn(kAlpha, __fdiv_rn(__fsub_rn(sv, qv), radius));
      },
      st);
  __syncwarp();
  if (!it.live) return;
  const int nf = c / 6;
  const float cnt = static_cast<float>(max(n, 1));
  const T* fb = f + b * ns * c;
  T* orow = out + it.row * c;
  const unsigned row_bytes = static_cast<unsigned>(c) * sizeof(T);
  const int p_end = min(c / 2, (it.slice + 1) * per * kG);
  for (int p = it.slice * per * kG + lg; p < p_end; p += kG) {
    const int d = p / nf;
    const int j = p - d * nf;
    const int c_sin = d * 2 * nf + j;
    const int c_cos = c_sin + nf;
    const T* f_sin = fb + c_sin;  // the pair's channels of row 0
    const T* f_cos = fb + c_cos;
    const float fr = freq[j];
    float acc_s = 0.f, acc_c = 0.f;
    for (int i0 = 0; i0 < n; i0 += kSlotBatch) {
      T vs[kSlotBatch], vc[kSlotBatch];
#pragma unroll
      for (int u = 0; u < kSlotBatch; ++u) {
        const int row = st.j[min(i0 + u, n - 1)];
        vs[u] = __ldg(row_at(f_sin, row, row_bytes));
        vc[u] = __ldg(row_at(f_cos, row, row_bytes));
      }
#pragma unroll
      for (int u = 0; u < kSlotBatch; ++u) {
        if (i0 + u < n) {
          float sn, cs;
          sincosf(__fdiv_rn(st.x[i0 + u][d], fr), &sn, &cs);
          acc_s = __fadd_rn(acc_s, __fmul_rn(to_f32(vs[u]),
                                             to_f32(from_f32<T>(sn))));
          acc_c = __fadd_rn(acc_c, __fmul_rn(to_f32(vc[u]),
                                             to_f32(from_f32<T>(cs))));
        }
      }
    }
    if (avg) {
      acc_s = __fdiv_rn(acc_s, cnt);
      acc_c = __fdiv_rn(acc_c, cnt);
    }
    orow[c_sin] = from_f32<T>(acc_s);
    orow[c_cos] = from_f32<T>(acc_c);
  }
}

template <typename T, int kG>
int launch_fwd_lanes(const float* q, const float* s, const T* f,
                     const float* freq, const int32_t* idx, const bool* mask,
                     int b, int nq, int ns, int c, int k, float radius,
                     int avg, T* out, cudaStream_t stream) {
  constexpr int kGroups = kGroupThreads / kG;
  const long long queries = static_cast<long long>(b) * nq;
  const PassSplit sp = split_passes(queries, (c / 2 + kG - 1) / kG, kG);
  const long long items = queries * sp.slices;
  const long long blocks = (items + kGroups - 1) / kGroups;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  pospool_sincos_kernel<T, kG>
      <<<static_cast<unsigned>(blocks), kGroupThreads, 0, stream>>>(
          q, s, f, freq, idx, mask, nq, ns, c, k, radius, avg, items,
          sp.slices, sp.per, out);
  return static_cast<int>(cudaGetLastError());
}

// The forward at the group width that keeps most lanes busy over the C / 2
// pairs (group_lanes_for).
template <typename T>
int launch_fwd(const float* q, const float* s, const void* f,
               const float* freq, const int32_t* idx, const bool* mask,
               int b, int nq, int ns, int c, int k, float radius, int avg,
               void* out, cudaStream_t stream) {
  const T* fp = static_cast<const T*>(f);
  T* op = static_cast<T*>(out);
  switch (group_lanes_for(c / 2)) {
    case 8:
      return launch_fwd_lanes<T, 8>(q, s, fp, freq, idx, mask, b, nq, ns, c,
                                    k, radius, avg, op, stream);
    case 16:
      return launch_fwd_lanes<T, 16>(q, s, fp, freq, idx, mask, b, nq, ns,
                                     c, k, radius, avg, op, stream);
    default:
      return launch_fwd_lanes<T, 32>(q, s, fp, freq, idx, mask, b, nq, ns,
                                     c, k, radius, avg, op, stream);
  }
}

// K5 backward, launch 2 (row_terms.cuh): the lane of unit `unit` of
// support row s holds kU frequencies j0 .. j0 + kU - 1 of one coordinate
// d, i.e. the sin channels c_sin = d * 2nf + j0 .. and the cos channels
// c_sin + nf ..; for each entry (q, t) of the row, in (q, t) order,
//   A = (alpha * D) / freq[j],  D = (s[s, d] - q[q, d]) / r   (f32),
//   df[s, c_sin] += g[q, c_sin] * sin(A),  df[s, c_cos] += g[q, c_cos] *
//   cos(A),
// sin and cos rounded to T first, as the forward rounds the embedding; one
// division for D and one sincosf a (entry, frequency); g in runs of kU
// values (8 bytes at kU = 4 bf16). An entry holds its query
// (row_terms.cuh).
template <typename T, int kU>
__global__ void __launch_bounds__(kRowThreads)
    sincos_gather_kernel(const float* __restrict__ q,
                         const float* __restrict__ s,
                         const float* __restrict__ freq,
                         const T* __restrict__ g,
                         const int32_t* __restrict__ offsets,
                         const int32_t* __restrict__ entries, int nq, int ns,
                         int c, int k, int tiles, int per, float radius,
                         int lanes, int slices, T* __restrict__ df) {
  const int nf = c / 6;
  const int per_coord = nf / kU;  // units a coordinate
  const RowItem it = row_item(ns, 3 * per_coord, lanes, slices);
  if (!it.live) return;
  const int d = it.unit / per_coord;
  const int j0 = (it.unit - d * per_coord) * kU;
  const int c_sin = d * 2 * nf + j0;
  const int c_cos = c_sin + nf;
  float fr[kU];
#pragma unroll
  for (int i = 0; i < kU; ++i) fr[i] = freq[j0 + i];
  const size_t b = blockIdx.y;
  const float sd = s[(b * ns + it.row) * 3 + d];
  const float* qb = q + b * nq * 3 + d;
  const T* gb = g + b * nq * c;
  float acc_s[kU] = {}, acc_c[kU] = {};
  for_each_entry_tile(
      offsets, entries, b, nq, ns, k, tiles, per, it.row,
      [&](const int32_t* eb, int start, int end, int q0) {
        for (int e = start; e < end; ++e) {
          const int qi = q0 + eb[e];
          const T* gq = gb + static_cast<size_t>(qi) * c;
          T gs[kU], gc[kU];
          load_run<T, kU>(gq + c_sin, gs);
          load_run<T, kU>(gq + c_cos, gc);
          const float ad =
              __fmul_rn(kAlpha, __fdiv_rn(__fsub_rn(sd, qb[qi * 3]), radius));
#pragma unroll
          for (int i = 0; i < kU; ++i) {
            float sn, cs;
            sincosf(__fdiv_rn(ad, fr[i]), &sn, &cs);
            acc_s[i] = __fadd_rn(
                acc_s[i], __fmul_rn(to_f32(gs[i]), to_f32(from_f32<T>(sn))));
            acc_c[i] = __fadd_rn(
                acc_c[i], __fmul_rn(to_f32(gc[i]), to_f32(from_f32<T>(cs))));
          }
        }
      });
  T* orow = df + (b * ns + it.row) * c;
  store_run<T, kU>(orow + c_sin, acc_s);
  store_run<T, kU>(orow + c_cos, acc_c);
}

template <typename T, int kU>
void launch_gather_as(const float* q, const float* s, const float* freq,
                      const T* g, const int32_t* offsets,
                      const int32_t* entries, int b, int nq, int ns, int c,
                      int k, int tiles, float radius, T* df,
                      cudaStream_t stream) {
  const RowSplit sp = row_split(c / 2 / kU);
  sincos_gather_kernel<T, kU><<<row_grid(b, ns, sp), kRowThreads, 0,
                                stream>>>(
      q, s, freq, g, offsets, entries, nq, ns, c, k, tiles,
      (nq + tiles - 1) / tiles, radius, sp.lanes, sp.slices, df);
}

// K5's backward in two launches: the index (and g for avg), then the
// gather at the widest unit of frequencies that nf and the pointers allow.
template <typename T>
void launch_bwd(const float* q, const float* s, const float* freq,
                const int32_t* idx, const bool* mask, const void* dy, int b,
                int nq, int ns, int c, int k, int tiles, float radius,
                int avg, int32_t* offsets, int32_t* entries, int32_t* raw,
                int* counters, void* g, void* df, cudaStream_t stream) {
  const T* dp = static_cast<const T*>(dy);
  T* gp = static_cast<T*>(g);
  T* fp = static_cast<T*>(df);
  launch_index_scale<T>(idx, mask, dp, b, nq, ns, k, tiles, c, avg, offsets,
                        entries, raw, counters, gp, stream);
  const int nf = c / 6;
  if (runs_ok<T, 4>(nf, g, df))
    launch_gather_as<T, 4>(q, s, freq, gp, offsets, entries, b, nq, ns, c, k,
                           tiles, radius, fp, stream);
  else if (runs_ok<T, 2>(nf, g, df))
    launch_gather_as<T, 2>(q, s, freq, gp, offsets, entries, b, nq, ns, c, k,
                           tiles, radius, fp, stream);
  else
    launch_gather_as<T, 1>(q, s, freq, gp, offsets, entries, b, nq, ns, c, k,
                           tiles, radius, fp, stream);
}

bool bad_args(int b, int ns, int c, int k) {
  return b < 1 || b > 65535 || ns < 1 || c < 6 || c % 6 != 0 || k < 1 ||
         k > kMaxK;
}

}  // namespace

// freq is [C / 6] float32 on the device.
extern "C" int cl3d_pospool_sincos(const float* q, const float* s,
                                   const void* f, const float* freq,
                                   const int32_t* idx, const bool* mask,
                                   int b, int nq, int ns, int c, int k,
                                   float radius, int avg, int is_bf16,
                                   void* out, cudaStream_t stream) {
  if (bad_args(b, ns, c, k) ||
      static_cast<long long>(c) * (is_bf16 ? 2 : 4) >= kMaxRowBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaSuccess);
  return is_bf16 ? launch_fwd<__nv_bfloat16>(q, s, f, freq, idx, mask, b, nq,
                                             ns, c, k, radius, avg, out,
                                             stream)
                 : launch_fwd<float>(q, s, f, freq, idx, mask, b, nq, ns, c,
                                     k, radius, avg, out, stream);
}

// df [B, Ns, C] in the features' dtype, written in full (no zeroing
// needed); dy is [B, Nq, C] in that dtype. g: for avg a [B, Nq, C] buffer
// in that dtype that launch 1 fills with dy / max(count, 1), for sum dy
// itself. The index in `tiles` query tiles a cloud (1 .. kMaxTiles, at
// most Nq). Scratch, none zeroed: offsets and counters [B * tiles, Ns + 1]
// (counters used where Ns outgrows shared memory), entries (each tile's
// queries, in the cloud's slot range of the tile) and raw [B, Nq * K].
// Two launches.
extern "C" int cl3d_pospool_sincos_bwd(
    const float* q, const float* s, const float* freq, const int32_t* idx,
    const bool* mask, const void* dy, int b, int nq, int ns, int c, int k,
    int tiles, float radius, int avg, int is_bf16, int32_t* offsets,
    int32_t* entries, int32_t* raw, int* counters, void* g, void* df,
    cudaStream_t stream) {
  if (bad_args(b, ns, c, k) || static_cast<long long>(nq) * k > INT_MAX - 1 ||
      tiles < 1 || tiles > kMaxTiles || (nq > 0 && tiles > nq))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaSuccess);
  if (is_bf16)
    launch_bwd<__nv_bfloat16>(q, s, freq, idx, mask, dy, b, nq, ns, c, k,
                              tiles, radius, avg, offsets, entries, raw,
                              counters, g, df, stream);
  else
    launch_bwd<float>(q, s, freq, idx, mask, dy, b, nq, ns, c, k, tiles,
                      radius, avg, offsets, entries, raw, counters, g, df,
                      stream);
  return static_cast<int>(cudaGetLastError());
}
