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
// chunks; here each block reads its neighbor rows directly.
//
// Numerics: the max is exact in the features' dtype. dy / n is computed
// in f32 and rounded to the features' dtype, as PyTorch's amax backward
// rounds it; the scatter sums in f32 with atomics (order varies run to
// run) into a zeroed f32 scratch that the wrapper casts once to the
// features' dtype. So f32 agrees with the plain version to the sum order,
// and bf16 to the plain version's bf16 rounding of its scatter sums.
//
// Layout (query_blocks.cuh): one block per kQPB consecutive queries of
// one cloud stages the K slot rows in shared memory; threads stride
// over the C channels, so a warp's loads (and atomics) of one support row
// are coalesced.
//
// Bound on the H100: bytes (one compare per gathered value). Device
// memory sees the features, indices, mask and output (and, backward, dy,
// the saved output and the f32 scratch); the K-fold re-reads of feature
// rows hit L2.

#include "query_blocks.cuh"

namespace {

template <typename T>
__global__ void nmax_fwd_kernel(const T* __restrict__ f,
                                const int32_t* __restrict__ idx,
                                const bool* __restrict__ mask, int nq, int ns,
                                int c, int k, T* __restrict__ out) {
  __shared__ int s_idx[kMaxK];  // support row, or -1 for a masked slot
  const int b = blockIdx.y;
  const T* fb = f + static_cast<size_t>(b) * ns * c;

  for (int qq = 0; qq < kQPB; ++qq) {
    const int qi = blockIdx.x * kQPB + qq;
    if (qi >= nq) break;  // uniform across the block
    const size_t row = static_cast<size_t>(b) * nq + qi;
    __syncthreads();  // previous query's slots fully consumed
    stage_rows(idx, mask, row, k, s_idx);
    __syncthreads();
    for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
      float acc = 0.f;
      bool any = false;
      for (int t = 0; t < k; ++t) {
        const int j = s_idx[t];
        if (j >= 0) {
          const float v = to_f32(fb[static_cast<size_t>(j) * c + ch]);
          // a NaN wins and stays, as amax propagates it (x != x is the
          // NaN test; nvcc does not assume finite math by default)
          if (!any) {
            acc = v;
          } else if (acc == acc && (v != v || v > acc)) {
            acc = v;
          }
          any = true;
        }
      }
      out[row * c + ch] = from_f32<T>(any ? acc : 0.f);
    }
  }
}

template <typename T>
__global__ void nmax_bwd_kernel(const T* __restrict__ f,
                                const int32_t* __restrict__ idx,
                                const bool* __restrict__ mask,
                                const T* __restrict__ out,
                                const T* __restrict__ dy, int nq, int ns,
                                int c, int k, float* __restrict__ df) {
  __shared__ int s_idx[kMaxK];
  const int b = blockIdx.y;
  const T* fb = f + static_cast<size_t>(b) * ns * c;
  float* dfb = df + static_cast<size_t>(b) * ns * c;

  for (int qq = 0; qq < kQPB; ++qq) {
    const int qi = blockIdx.x * kQPB + qq;
    if (qi >= nq) break;
    const size_t row = static_cast<size_t>(b) * nq + qi;
    __syncthreads();
    stage_rows(idx, mask, row, k, s_idx);
    __syncthreads();
    for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
      const float o = to_f32(out[row * c + ch]);
      int n = 0;
      for (int t = 0; t < k; ++t) {
        const int j = s_idx[t];
        n += j >= 0 && to_f32(fb[static_cast<size_t>(j) * c + ch]) == o;
      }
      if (n == 0) continue;  // empty neighborhood: no gradient
      const float gv = to_f32(from_f32<T>(
          __fdiv_rn(to_f32(dy[row * c + ch]), static_cast<float>(n))));
      for (int t = 0; t < k; ++t) {
        const int j = s_idx[t];
        if (j >= 0 && to_f32(fb[static_cast<size_t>(j) * c + ch]) == o) {
          atomicAdd(dfb + static_cast<size_t>(j) * c + ch, gv);
        }
      }
    }
  }
}

bool bad_args(int b, int ns, int c, int k) {
  return b < 1 || b > 65535 || ns < 1 || c < 1 || k < 1 || k > kMaxK;
}

}  // namespace

extern "C" int cl3d_neighborhood_max(const void* f, const int32_t* idx,
                                     const bool* mask, int b, int nq, int ns,
                                     int c, int k, int is_bf16, void* out,
                                     cudaStream_t stream) {
  if (bad_args(b, ns, c, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaSuccess);
  if (is_bf16) {
    nmax_fwd_kernel<__nv_bfloat16>
        <<<grid_for(b, nq), threads_for(c), 0, stream>>>(
            static_cast<const __nv_bfloat16*>(f), idx, mask, nq, ns, c, k,
            static_cast<__nv_bfloat16*>(out));
  } else {
    nmax_fwd_kernel<float><<<grid_for(b, nq), threads_for(c), 0, stream>>>(
        static_cast<const float*>(f), idx, mask, nq, ns, c, k,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// df32 must be zeroed [B, Ns, C] float32; f, out and dy are in the
// features' dtype, out being this op's forward output for f.
extern "C" int cl3d_neighborhood_max_bwd(const void* f, const int32_t* idx,
                                         const bool* mask, const void* out,
                                         const void* dy, int b, int nq,
                                         int ns, int c, int k, int is_bf16,
                                         float* df32, cudaStream_t stream) {
  if (bad_args(b, ns, c, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaSuccess);
  if (is_bf16) {
    nmax_bwd_kernel<__nv_bfloat16>
        <<<grid_for(b, nq), threads_for(c), 0, stream>>>(
            static_cast<const __nv_bfloat16*>(f), idx, mask,
            static_cast<const __nv_bfloat16*>(out),
            static_cast<const __nv_bfloat16*>(dy), nq, ns, c, k, df32);
  } else {
    nmax_bwd_kernel<float><<<grid_for(b, nq), threads_for(c), 0, stream>>>(
        static_cast<const float*>(f), idx, mask,
        static_cast<const float*>(out), static_cast<const float*>(dy), nq, ns,
        c, k, df32);
  }
  return static_cast<int>(cudaGetLastError());
}
