// Neighborhood moments, forward and backward in features. For query q with
// neighbor slots k (index idx[k], validity mask[k]) over support features
// f [Ns, C]:
//   out[q, 0*C + c] = R_k  mask[k] * f[idx[k], c],
//   out[q, (d+1)*C + c] = R_k  mask[k] * D[k, d] * f[idx[k], c],  d = 0..2,
//   D[k, d] = (s[idx[k], d] - q[d]) / r,
// with R = sum, or avg = sum / max(count of valid slots, 1): [B, Nq, 4C].
// The backward scatters onto the support rows:
//   df[s, c] = sum over (q, k) with idx[q, k] = s and mask[q, k] of
//              g[q, c] + g[q, C + c] D[k, 0] + g[q, 2C + c] D[k, 1]
//                      + g[q, 3C + c] D[k, 2],
//   g = dy (sum), or dy / max(count_q, 1) rounded to the features' type
//   (avg). Positions get no gradient, as in the JAX package.
//
// Replaces: closerlook3d_tpu/ops/pallas/moments.py:_fwd_kernel and
// _bwd_kernel (entry neighborhood_moments -> _moments_vjp). The TPU kernels
// build a masked multi-hot matrix per Morton support chunk and contract it
// (and its D-weighted copies) with the features on the MXU; here each block
// reads its neighbor rows directly and the backward scatters with f32
// atomics into a zeroed f32 scratch that the wrapper casts once.
//
// Numerics: D is (s - q) / r in f32 rounded to the features' type before
// the products, as the TPU kernel rounds its weights (w.astype(f.dtype))
// and as pospool_xyz.cu does. The four sums per channel are f32 in slot
// order (the backward's in atomic order) and each result is rounded once.
//
// Layout (query_blocks.cuh): one block per kQPB queries; slots and D in
// shared memory; threads stride over the C channels and keep four f32
// accumulators each, so one gathered read of f[idx[k], c] feeds all four
// moments.
//
// Bound on the H100: bytes. Forward: the gathered reads of B*Nq*K*C values
// hit L2; device-memory traffic is about one pass over the features plus
// the 4C-wide output. Backward: the same gather pattern as atomics, plus
// the scratch write and the cast.

#include "query_blocks.cuh"

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

template <typename T>
__global__ void moments_bwd_kernel(const float* __restrict__ q,
                                   const float* __restrict__ s,
                                   const int32_t* __restrict__ idx,
                                   const bool* __restrict__ mask,
                                   const T* __restrict__ dy, int nq, int ns,
                                   int c, int k, float radius, int avg,
                                   float* __restrict__ df) {
  __shared__ int s_idx[kMaxK];
  __shared__ float s_d[kMaxK * 3];
  const int b = blockIdx.y;
  float* dfb = df + static_cast<size_t>(b) * ns * c;
  const float* sb = s + static_cast<size_t>(b) * ns * 3;

  for (int qq = 0; qq < kQPB; ++qq) {
    const int qi = blockIdx.x * kQPB + qq;
    if (qi >= nq) break;
    const size_t row = static_cast<size_t>(b) * nq + qi;
    __syncthreads();
    stage_slots<T>(q, sb, idx, mask, row, k, radius, s_idx, s_d);
    __syncthreads();
    const int cnt = staged_count(s_idx, k);
    if (cnt == 0) continue;  // uniform: nothing to scatter
    const T* grow = dy + row * 4 * c;
    for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
      float g[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        g[m] = to_f32(grow[m * c + ch]);
        if (avg) {
          g[m] = to_f32(from_f32<T>(__fdiv_rn(g[m], static_cast<float>(cnt))));
        }
      }
      for (int t = 0; t < k; ++t) {
        const int j = s_idx[t];
        if (j >= 0) {
          float v = __fadd_rn(g[0], __fmul_rn(g[1], s_d[t * 3 + 0]));
          v = __fadd_rn(v, __fmul_rn(g[2], s_d[t * 3 + 1]));
          v = __fadd_rn(v, __fmul_rn(g[3], s_d[t * 3 + 2]));
          atomicAdd(dfb + static_cast<size_t>(j) * c + ch, v);
        }
      }
    }
  }
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

// df32 must be zeroed [B, Ns, C] float32; dy is [B, Nq, 4C] in the
// features' dtype.
extern "C" int cl3d_moments_bwd(const float* q, const float* s,
                                const int32_t* idx, const bool* mask,
                                const void* dy, int b, int nq, int ns, int c,
                                int k, float radius, int avg, int is_bf16,
                                float* df32, cudaStream_t stream) {
  if (bad_args(b, ns, c, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaSuccess);
  if (is_bf16) {
    moments_bwd_kernel<__nv_bfloat16>
        <<<grid_for(b, nq), threads_for(c), 0, stream>>>(
            q, s, idx, mask, static_cast<const __nv_bfloat16*>(dy), nq, ns,
            c, k, radius, avg, df32);
  } else {
    moments_bwd_kernel<float><<<grid_for(b, nq), threads_for(c), 0, stream>>>(
        q, s, idx, mask, static_cast<const float*>(dy), nq, ns, c, k, radius,
        avg, df32);
  }
  return static_cast<int>(cudaGetLastError());
}
