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
// forward's blocks read their neighbor rows directly, and the backward
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
// Forward layout (query_blocks.cuh): one block per kQPB queries; slots
// and D in shared memory; threads stride over the C channels and keep four
// f32 accumulators each, so one gathered read of f[idx[k], c] feeds all
// four moments. Backward: two launches, the reverse index (and, for avg,
// g = dy / max(count, 1) by query), then a gather in which 16 bytes of
// channels of a support row take one lane (9 lanes a row at C = 72 bf16),
// recomputing each entry's D from the row's own position: no float
// atomics, no zeroed scratch, no cast.
//
// Bound on the H100: bytes. Forward: the gathered reads of B*Nq*K*C values
// hit L2; device-memory traffic is about one pass over the features plus
// the 4C-wide output. Backward: dy once (and g written and read once for
// avg) and df once; but each valid slot reads q's 4C-wide g row again
// (8C bytes in bf16), from L1 or L2 where Morton-adjacent support rows
// share queries, and each entry costs a chain of dependent loads (offsets,
// entry, then position and g): the gather is bound by that latency, at a
// quarter of the issue rate. A lane takes its entries one at a time (2
// or 4 at once cost registers and ran 3-14% slower; 8 bytes of channels
// a lane, 18 lanes a row, 28% slower). For avg, writing g moves dy's
// bytes twice more, which takes most of launch 1 at the wide calls.

#include "query_blocks.cuh"
#include "row_terms.cuh"

namespace {

template <typename T>
__global__ void moments_kernel(const float* __restrict__ q,
                               const float* __restrict__ s,
                               const T* __restrict__ f,
                               const int32_t* __restrict__ idx,
                               const bool* __restrict__ mask, int nq, int ns,
                               int c, int k, float radius, int avg,
                               T* __restrict__ out) {
  __shared__ int s_idx[kMaxK];
  __shared__ float s_d[kMaxK * 3];
  const int b = blockIdx.y;
  const T* fb = f + static_cast<size_t>(b) * ns * c;
  const float* sb = s + static_cast<size_t>(b) * ns * 3;

  for (int qq = 0; qq < kQPB; ++qq) {
    const int qi = blockIdx.x * kQPB + qq;
    if (qi >= nq) break;  // uniform across the block
    const size_t row = static_cast<size_t>(b) * nq + qi;
    __syncthreads();  // previous query's slots fully consumed
    stage_slots<T>(q, sb, idx, mask, row, k, radius, s_idx, s_d);
    __syncthreads();
    const float cnt = static_cast<float>(max(staged_count(s_idx, k), 1));
    T* orow = out + row * 4 * c;
    for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int t = 0; t < k; ++t) {
        const int j = s_idx[t];
        if (j >= 0) {
          const float v = to_f32(fb[static_cast<size_t>(j) * c + ch]);
          a0 = __fadd_rn(a0, v);
          a1 = __fadd_rn(a1, __fmul_rn(v, s_d[t * 3 + 0]));
          a2 = __fadd_rn(a2, __fmul_rn(v, s_d[t * 3 + 1]));
          a3 = __fadd_rn(a3, __fmul_rn(v, s_d[t * 3 + 2]));
        }
      }
      if (avg) {
        a0 = __fdiv_rn(a0, cnt);
        a1 = __fdiv_rn(a1, cnt);
        a2 = __fdiv_rn(a2, cnt);
        a3 = __fdiv_rn(a3, cnt);
      }
      orow[ch] = from_f32<T>(a0);
      orow[c + ch] = from_f32<T>(a1);
      orow[2 * c + ch] = from_f32<T>(a2);
      orow[3 * c + ch] = from_f32<T>(a3);
    }
  }
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
  if (bad_args(b, ns, c, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaSuccess);
  if (is_bf16) {
    moments_kernel<__nv_bfloat16>
        <<<grid_for(b, nq), threads_for(c), 0, stream>>>(
            q, s, static_cast<const __nv_bfloat16*>(f), idx, mask, nq, ns, c,
            k, radius, avg, static_cast<__nv_bfloat16*>(out));
  } else {
    moments_kernel<float><<<grid_for(b, nq), threads_for(c), 0, stream>>>(
        q, s, static_cast<const float*>(f), idx, mask, nq, ns, c, k, radius,
        avg, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
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
