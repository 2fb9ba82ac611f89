// PosPool, xyz position embedding, forward and backward in features.
// For query q with neighbor slots k (index idx[k], validity mask[k]) over
// support features f [Ns, C]:
//   out[q, c] = R_k  mask[k] * D[k, c / (C/3)] * f[idx[k], c],
//   D[k, d] = (s[idx[k], d] - q[d]) / r,
// with R = sum, or avg = sum / max(count of valid slots, 1). The backward
// scatters onto the support rows:
//   df[s, c] = sum over (q, k) with idx[q, k] = s and mask[q, k] of
//              g[q, c] * D[k, c / (C/3)],
//   g = dy (sum), or dy / max(count_q, 1) rounded to the features' dtype
//   (avg; the gather path's autograd rounds it there too).
// Positions get no gradient, as in the JAX package.
//
// Replaces: closerlook3d_tpu/ops/pallas/aggregation.py:_xyz_fwd_kernel
// (entry pospool_fused -> _pospool_call) and _xyz_bwd_kernel (the custom
// VJP's _pospool_bwd). The TPU kernels build multi-hot matrices and
// gather / scatter with MXU matmuls over Morton support chunks; here each
// block reads its neighbor rows directly, and the backward scatters with
// f32 atomics into a zeroed f32 scratch that the wrapper casts once to
// the features' dtype.
//
// Numerics: D is computed as (s - q) / r in f32 (the jnp gather path's
// form; the Pallas kernel multiplies by 1/r instead) and rounded to the
// features' dtype, as the gather path casts dp to f.dtype. Products and
// sums are f32; forward sums run over k in slot order, backward sums in
// atomic order (run to run). Each result is rounded once to the
// features' dtype. Against the plain PyTorch versions: f32 agrees to the
// rounding of the sum order; bf16 differs by the plain path's bf16
// rounding of each product and of the sum (the plain backward twin,
// pospool_xyz_bwd_plain, sums in f32 too and agrees to one bf16 ulp).
//
// Layout (query_blocks.cuh): one block per kQPB consecutive queries of
// one cloud. For each query the block stages idx and D of its K slots in
// shared memory once, then threads stride over the C channels; a
// thread's loads of f[idx[k]] (forward) and atomics on df[idx[k]]
// (backward) are coalesced across the warp (neighbouring channels of one
// row).
//
// Bound on the H100: bytes. Forward: gathered reads of B*Nq*K*C feature
// values, which hit L2 (a cloud's feature rows, <= 1.5 MB at the ModelNet40
// shapes, are re-read by every query whose neighborhood holds them);
// device-memory traffic is about one pass over features plus the output.
// Backward: the same pattern with f32 atomics into L2-resident rows, plus
// the scratch write and the cast.

#include "query_blocks.cuh"

namespace {

template <typename T>
__global__ void pospool_xyz_kernel(const float* __restrict__ q,
                                   const float* __restrict__ s,
                                   const T* __restrict__ f,
                                   const int32_t* __restrict__ idx,
                                   const bool* __restrict__ mask, int nq,
                                   int ns, int c, int k, float radius,
                                   int avg, T* __restrict__ out) {
  __shared__ int s_idx[kMaxK];       // support row, or -1 for a masked slot
  __shared__ float s_d[kMaxK * 3];   // D[k, d]
  const int b = blockIdx.y;
  const int g = c / 3;
  const T* fb = f + static_cast<size_t>(b) * ns * c;
  const float* sb = s + static_cast<size_t>(b) * ns * 3;

  for (int qq = 0; qq < kQPB; ++qq) {
    const int qi = blockIdx.x * kQPB + qq;
    if (qi >= nq) break;  // uniform across the block
    const size_t row = static_cast<size_t>(b) * nq + qi;
    __syncthreads();  // previous query's slots fully consumed
    stage_slots<T>(q, sb, idx, mask, row, k, radius, s_idx, s_d);
    __syncthreads();
    for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
      const int d = ch / g;
      float acc = 0.f;
      int cnt = 0;
      for (int t = 0; t < k; ++t) {
        const int j = s_idx[t];
        if (j >= 0) {
          acc = __fadd_rn(acc, __fmul_rn(to_f32(fb[static_cast<size_t>(j) * c
                                                   + ch]),
                                         s_d[t * 3 + d]));
          ++cnt;
        }
      }
      if (avg) acc = __fdiv_rn(acc, static_cast<float>(max(cnt, 1)));
      out[row * c + ch] = from_f32<T>(acc);
    }
  }
}

template <typename T>
__global__ void pospool_xyz_bwd_kernel(const float* __restrict__ q,
                                       const float* __restrict__ s,
                                       const int32_t* __restrict__ idx,
                                       const bool* __restrict__ mask,
                                       const T* __restrict__ dy, int nq,
                                       int ns, int c, int k, float radius,
                                       int avg, float* __restrict__ df) {
  __shared__ int s_idx[kMaxK];
  __shared__ float s_d[kMaxK * 3];
  const int b = blockIdx.y;
  const int g = c / 3;
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
    for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
      const int d = ch / g;
      float gv = to_f32(dy[row * c + ch]);
      if (avg) {
        gv = to_f32(from_f32<T>(__fdiv_rn(gv, static_cast<float>(cnt))));
      }
      for (int t = 0; t < k; ++t) {
        const int j = s_idx[t];
        if (j >= 0) {
          atomicAdd(dfb + static_cast<size_t>(j) * c + ch,
                    __fmul_rn(gv, s_d[t * 3 + d]));
        }
      }
    }
  }
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
  if (bad_args(b, ns, c, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaSuccess);
  if (is_bf16) {
    pospool_xyz_kernel<__nv_bfloat16>
        <<<grid_for(b, nq), threads_for(c), 0, stream>>>(
            q, s, static_cast<const __nv_bfloat16*>(f), idx, mask, nq, ns,
            c, k, radius, avg, static_cast<__nv_bfloat16*>(out));
  } else {
    pospool_xyz_kernel<float><<<grid_for(b, nq), threads_for(c), 0, stream>>>(
        q, s, static_cast<const float*>(f), idx, mask, nq, ns, c, k, radius,
        avg, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// df32 must be zeroed [B, Ns, C] float32; dy is [B, Nq, C] in the
// features' dtype.
extern "C" int cl3d_pospool_xyz_bwd(const float* q, const float* s,
                                    const int32_t* idx, const bool* mask,
                                    const void* dy, int b, int nq, int ns,
                                    int c, int k, float radius, int avg,
                                    int is_bf16, float* df32,
                                    cudaStream_t stream) {
  if (bad_args(b, ns, c, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaSuccess);
  if (is_bf16) {
    pospool_xyz_bwd_kernel<__nv_bfloat16>
        <<<grid_for(b, nq), threads_for(c), 0, stream>>>(
            q, s, idx, mask, static_cast<const __nv_bfloat16*>(dy), nq, ns,
            c, k, radius, avg, df32);
  } else {
    pospool_xyz_bwd_kernel<float>
        <<<grid_for(b, nq), threads_for(c), 0, stream>>>(
            q, s, idx, mask, static_cast<const float*>(dy), nq, ns, c, k,
            radius, avg, df32);
  }
  return static_cast<int>(cudaGetLastError());
}
