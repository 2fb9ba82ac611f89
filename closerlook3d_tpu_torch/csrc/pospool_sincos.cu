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
// Layout (query_blocks.cuh): one block per kQPB queries; a query's slots
// and D are staged in shared memory, then each thread takes one
// (coordinate, frequency) pair, whose sin and cos channels share one angle
// and one sincosf. Neighbouring threads read neighbouring channels of a
// row, so the gathered loads and the atomics coalesce.
//
// Bound on the H100: bytes at these shapes by the count the smoke run uses
// (inputs read once, outputs written once); the kernel itself is limited
// by the sincosf per slot and pair (a few tens of instructions each) and
// by the gathered row reads, which hit L2.

#include "query_blocks.cuh"

namespace {

constexpr float kAlpha = 100.f;

template <typename T>
__global__ void pospool_sincos_kernel(const float* __restrict__ q,
                                      const float* __restrict__ s,
                                      const T* __restrict__ f,
                                      const float* __restrict__ freq,
                                      const int32_t* __restrict__ idx,
                                      const bool* __restrict__ mask, int nq,
                                      int ns, int c, int k, float radius,
                                      int avg, T* __restrict__ out) {
  __shared__ int s_idx[kMaxK];
  __shared__ float s_d[kMaxK * 3];  // D[k, d], f32
  const int b = blockIdx.y;
  const int nf = c / 6;
  const int pairs = c / 2;
  const T* fb = f + static_cast<size_t>(b) * ns * c;
  const float* sb = s + static_cast<size_t>(b) * ns * 3;

  for (int qq = 0; qq < kQPB; ++qq) {
    const int qi = blockIdx.x * kQPB + qq;
    if (qi >= nq) break;  // uniform across the block
    const size_t row = static_cast<size_t>(b) * nq + qi;
    __syncthreads();  // previous query's slots fully consumed
    stage_slots<float>(q, sb, idx, mask, row, k, radius, s_idx, s_d);
    __syncthreads();
    const float cnt = static_cast<float>(max(staged_count(s_idx, k), 1));
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      const int d = p / nf;
      const int j = p - d * nf;
      const int c_sin = d * 2 * nf + j;
      const int c_cos = c_sin + nf;
      const float fr = freq[j];
      float acc_s = 0.f, acc_c = 0.f;
      for (int t = 0; t < k; ++t) {
        const int sj = s_idx[t];
        if (sj >= 0) {
          float sn, cs;
          sincosf(__fdiv_rn(__fmul_rn(kAlpha, s_d[t * 3 + d]), fr), &sn, &cs);
          const T* fr_row = fb + static_cast<size_t>(sj) * c;
          acc_s = __fadd_rn(acc_s, __fmul_rn(to_f32(fr_row[c_sin]),
                                             to_f32(from_f32<T>(sn))));
          acc_c = __fadd_rn(acc_c, __fmul_rn(to_f32(fr_row[c_cos]),
                                             to_f32(from_f32<T>(cs))));
        }
      }
      if (avg) {
        acc_s = __fdiv_rn(acc_s, cnt);
        acc_c = __fdiv_rn(acc_c, cnt);
      }
      out[row * c + c_sin] = from_f32<T>(acc_s);
      out[row * c + c_cos] = from_f32<T>(acc_c);
    }
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
  if (bad_args(b, ns, c, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaSuccess);
  if (is_bf16) {
    pospool_sincos_kernel<__nv_bfloat16>
        <<<grid_for(b, nq), threads_for(c / 2), 0, stream>>>(
            q, s, static_cast<const __nv_bfloat16*>(f), freq, idx, mask, nq,
            ns, c, k, radius, avg, static_cast<__nv_bfloat16*>(out));
  } else {
    pospool_sincos_kernel<float>
        <<<grid_for(b, nq), threads_for(c / 2), 0, stream>>>(
            q, s, static_cast<const float*>(f), freq, idx, mask, nq, ns, c,
            k, radius, avg, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
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
