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
// max(count of valid slots, 1). The backward scatters onto the support rows:
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
// once. The forward sums over k in slot order, the backward in atomic
// order into a zeroed f32 scratch that the wrapper casts once.
//
// Forward layout (query_groups.cuh): a group of 8-32 lanes per query (and
// slice of its pairs where queries are few), several groups a block and no
// block-wide barrier. The group compacts the query's valid slots in slot
// order and stages their alpha * D in its own shared memory; then each
// lane takes one (coordinate, frequency) pair a pass, whose sin and cos
// channels share one angle and one sincosf, neighbouring lanes on
// neighbouring channels. Group widths follow the C / 2 pairs
// (group_lanes_for), so that most lanes run a sincosf: 8 lanes at C = 72
// (36 pairs, 5 passes). The backward keeps the older layout
// (query_blocks.cuh): one block per kQPB queries, a query's slots and D
// staged in shared memory, a thread per pair, so that the atomics
// coalesce.
//
// Bound on the H100: bytes at these shapes by the count the smoke run uses
// (inputs read once, outputs written once). The forward runs ~60
// instructions a (valid slot, pair), a third of them the sincosf, and
// reaches ~40% of the SM's issue rate: warps wait on the chains of
// dependent loads a query (idx and mask, positions, rows from L2) and on
// the division's and sincosf's slow-path branches, which split the loop
// body. More warps in flight help (kSinCosBlocks); staging the terms in
// shared memory to keep all 32 lanes on one query did not (fewer warps).

#include <climits>

#include "query_blocks.cuh"
#include "query_groups.cuh"

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

template <typename T>
__global__ void pospool_sincos_bwd_kernel(const float* __restrict__ q,
                                          const float* __restrict__ s,
                                          const float* __restrict__ freq,
                                          const int32_t* __restrict__ idx,
                                          const bool* __restrict__ mask,
                                          const T* __restrict__ dy, int nq,
                                          int ns, int c, int k, float radius,
                                          int avg, float* __restrict__ df) {
  __shared__ int s_idx[kMaxK];
  __shared__ float s_d[kMaxK * 3];
  const int b = blockIdx.y;
  const int nf = c / 6;
  const int pairs = c / 2;
  float* dfb = df + static_cast<size_t>(b) * ns * c;
  const float* sb = s + static_cast<size_t>(b) * ns * 3;

  for (int qq = 0; qq < kQPB; ++qq) {
    const int qi = blockIdx.x * kQPB + qq;
    if (qi >= nq) break;
    const size_t row = static_cast<size_t>(b) * nq + qi;
    __syncthreads();
    stage_slots<float>(q, sb, idx, mask, row, k, radius, s_idx, s_d);
    __syncthreads();
    const int cnt = staged_count(s_idx, k);
    if (cnt == 0) continue;  // uniform: nothing to scatter
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      const int d = p / nf;
      const int j = p - d * nf;
      const int c_sin = d * 2 * nf + j;
      const int c_cos = c_sin + nf;
      const float fr = freq[j];
      float g_s = to_f32(dy[row * c + c_sin]);
      float g_c = to_f32(dy[row * c + c_cos]);
      if (avg) {
        g_s = to_f32(from_f32<T>(__fdiv_rn(g_s, static_cast<float>(cnt))));
        g_c = to_f32(from_f32<T>(__fdiv_rn(g_c, static_cast<float>(cnt))));
      }
      for (int t = 0; t < k; ++t) {
        const int sj = s_idx[t];
        if (sj >= 0) {
          float sn, cs;
          sincosf(__fdiv_rn(__fmul_rn(kAlpha, s_d[t * 3 + d]), fr), &sn, &cs);
          float* row_out = dfb + static_cast<size_t>(sj) * c;
          atomicAdd(row_out + c_sin, __fmul_rn(g_s, to_f32(from_f32<T>(sn))));
          atomicAdd(row_out + c_cos, __fmul_rn(g_c, to_f32(from_f32<T>(cs))));
        }
      }
    }
  }
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

// df32 must be zeroed [B, Ns, C] float32; dy is [B, Nq, C] in the
// features' dtype.
extern "C" int cl3d_pospool_sincos_bwd(const float* q, const float* s,
                                       const float* freq, const int32_t* idx,
                                       const bool* mask, const void* dy,
                                       int b, int nq, int ns, int c, int k,
                                       float radius, int avg, int is_bf16,
                                       float* df32, cudaStream_t stream) {
  if (bad_args(b, ns, c, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaSuccess);
  if (is_bf16) {
    pospool_sincos_bwd_kernel<__nv_bfloat16>
        <<<grid_for(b, nq), threads_for(c / 2), 0, stream>>>(
            q, s, freq, idx, mask, static_cast<const __nv_bfloat16*>(dy), nq,
            ns, c, k, radius, avg, df32);
  } else {
    pospool_sincos_bwd_kernel<float>
        <<<grid_for(b, nq), threads_for(c / 2), 0, stream>>>(
            q, s, freq, idx, mask, static_cast<const float*>(dy), nq, ns, c,
            k, radius, avg, df32);
  }
  return static_cast<int>(cudaGetLastError());
}
