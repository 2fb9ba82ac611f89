// Pseudo-grid (KPConv-style) kernel-point correlation, forward and
// backward in features. For query q with neighbor slots k (index idx[k],
// validity mask[k]) over support features f [Ns, C] and kernel points
// kp [Kp, 3]:
//   u_k     = (s[idx[k]] - q) * inv_r                        (f32)
//   d2[k,p] = ((u0 - kp0)^2 + (u1 - kp1)^2) + (u2 - kp2)^2   (f32)
//   w[k,p]  = mask[k] * infl(d2[k,p]),
//     linear:   max(1 - sqrt(d2) * coef, 0),   coef = 1 / extent
//     constant: d2 <= coef,                    coef = extent^2
//     gaussian: exp(-d2 * coef),               coef = 1 / (2 (0.3 extent)^2)
//   out[q, p*C + c] = sum_k w[k,p] * f[idx[k], c]   (p-major, f32, rounded
//                                                    once to f's dtype)
// and the backward scatters onto the support rows:
//   df[s, c] = sum over (q, k) with idx[q,k] = s of
//              sum_p w[k,p] * dy[q, p*C + c].
// Positions and kernel points get no gradient, as in the JAX package.
// Duplicated valid indices count once per slot.
//
// Replaces: closerlook3d_tpu/ops/pallas/pseudo_grid.py:_fwd_kernel (entry
// pseudo_grid_fused -> _call) and _bwd_kernel (the custom VJP's _bwd).
// The TPU kernels gather slot positions and features with one-hot MXU
// matmuls over Morton support chunks and evaluate the influences on a
// slot grid; here each block reads its neighbor rows by index.
//
// Numerics follow the TPU kernel (its _influence_rows): u multiplies by
// 1/r in f32 (the jnp gather path divides and rounds dp and the
// influences to the features' dtype first), every product and sum of u
// and d2 is rounded to f32 in that order (the intrinsics keep nvcc from
// contracting them into FMAs, so the influences equal the plain PyTorch
// version's bit for bit, up to exp's last ulp), and the sums over slots
// are f32, rounded once to the features' dtype.
//
// Layout (query_blocks.cuh): one block per kQPB consecutive queries of one
// cloud. For each query the block stages the K slots' indices and u, then
// the K x Kp influences, in shared memory, once; then threads stride over
// the C channels. A thread keeps up to kPChunk kernel-point sums in
// registers, so each gathered f[idx[k], c] is read once per chunk of
// kernel points (once at Kp = 15), and writes them at the end; a warp's
// loads and stores touch neighbouring channels of one row.
//
// Bound on the H100: bytes. The output is Kp = 15 times as wide as the
// features, so writing it dominates (B*Nq*Kp*C values); the gathered
// feature rows are L2-resident, as for the PosPool kernels. The backward
// reads dy once and makes one f32 atomic per valid slot and channel into
// a zeroed f32 scratch that the wrapper casts once to the features' dtype.

#include "query_blocks.cuh"

namespace {

constexpr int kMaxKp = 64;   // kernel points
constexpr int kPChunk = 16;  // kernel-point sums a thread keeps in registers
constexpr int kWStride = kMaxKp;  // row stride of the staged influences

enum Influence { kLinear = 0, kConstant = 1, kGaussian = 2 };

__device__ __forceinline__ float influence(float d2, int mode, float coef) {
  if (mode == kLinear) {
    return fmaxf(__fsub_rn(1.f, __fmul_rn(__fsqrt_rn(d2), coef)), 0.f);
  }
  if (mode == kConstant) return d2 <= coef ? 1.f : 0.f;
  return expf(-__fmul_rn(d2, coef));
}

// Stage query `row`'s slots: s_idx[t] = support row or -1 (masked), and
// s_w[t * kWStride + p] = w[t, p] for p < kpn, zero up to the next
// multiple of kPChunk. s_kp holds the kernel points.
__device__ __forceinline__ void stage_influences(
    const float* __restrict__ q, const float* __restrict__ sb,
    const int32_t* __restrict__ idx, const bool* __restrict__ mask,
    size_t row, int k, int kpn, float inv_r, float coef, int mode,
    const float* s_kp, int* s_idx, float* s_u, float* s_w) {
  if (threadIdx.x < k) {
    const int t = threadIdx.x;
    const bool v = mask[row * k + t];
    const int j = idx[row * k + t];
    s_idx[t] = v ? j : -1;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      s_u[t * 3 + d] =
          v ? __fmul_rn(__fsub_rn(sb[static_cast<size_t>(j) * 3 + d],
                                  q[row * 3 + d]),
                        inv_r)
            : 0.f;
    }
  }
  __syncthreads();
  const int kpp = (kpn + kPChunk - 1) / kPChunk * kPChunk;
  for (int e = threadIdx.x; e < k * kpp; e += blockDim.x) {
    const int t = e / kpp;
    const int p = e - t * kpp;
    float w = 0.f;
    if (p < kpn && s_idx[t] >= 0) {
      const float d0 = __fsub_rn(s_u[t * 3 + 0], s_kp[p * 3 + 0]);
      const float d1 = __fsub_rn(s_u[t * 3 + 1], s_kp[p * 3 + 1]);
      const float d2 = __fsub_rn(s_u[t * 3 + 2], s_kp[p * 3 + 2]);
      float dd = __fmul_rn(d0, d0);
      dd = __fadd_rn(dd, __fmul_rn(d1, d1));
      dd = __fadd_rn(dd, __fmul_rn(d2, d2));
      w = influence(dd, mode, coef);
    }
    s_w[t * kWStride + p] = w;
  }
}

__device__ __forceinline__ void load_kernel_points(const float* __restrict__ kp,
                                                   int kpn, float* s_kp) {
  for (int e = threadIdx.x; e < kpn * 3; e += blockDim.x) s_kp[e] = kp[e];
}

template <typename T>
__global__ void pseudo_grid_kernel(const float* __restrict__ q,
                                   const float* __restrict__ s,
                                   const T* __restrict__ f,
                                   const int32_t* __restrict__ idx,
                                   const bool* __restrict__ mask,
                                   const float* __restrict__ kp, int nq,
                                   int ns, int c, int k, int kpn,
                                   float inv_r, float coef, int mode,
                                   T* __restrict__ out) {
  __shared__ int s_idx[kMaxK];
  __shared__ float s_u[kMaxK * 3];
  __shared__ float s_kp[kMaxKp * 3];
  __shared__ float s_w[kMaxK * kWStride];
  const int b = blockIdx.y;
  const T* fb = f + static_cast<size_t>(b) * ns * c;
  const float* sb = s + static_cast<size_t>(b) * ns * 3;
  load_kernel_points(kp, kpn, s_kp);

  for (int qq = 0; qq < kQPB; ++qq) {
    const int qi = blockIdx.x * kQPB + qq;
    if (qi >= nq) break;  // uniform across the block
    const size_t row = static_cast<size_t>(b) * nq + qi;
    __syncthreads();  // previous query's slots fully consumed
    stage_influences(q, sb, idx, mask, row, k, kpn, inv_r, coef, mode, s_kp,
                     s_idx, s_u, s_w);
    __syncthreads();
    T* ob = out + row * static_cast<size_t>(kpn) * c;
    for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
      for (int p0 = 0; p0 < kpn; p0 += kPChunk) {
        float acc[kPChunk];
#pragma unroll
        for (int pp = 0; pp < kPChunk; ++pp) acc[pp] = 0.f;
        for (int t = 0; t < k; ++t) {
          const int j = s_idx[t];
          if (j < 0) continue;  // uniform across the block
          const float fv = to_f32(fb[static_cast<size_t>(j) * c + ch]);
          const float* w = s_w + t * kWStride + p0;
#pragma unroll
          for (int pp = 0; pp < kPChunk; ++pp) {
            acc[pp] = __fmaf_rn(w[pp], fv, acc[pp]);
          }
        }
#pragma unroll
        for (int pp = 0; pp < kPChunk; ++pp) {
          if (p0 + pp < kpn) {
            ob[static_cast<size_t>(p0 + pp) * c + ch] = from_f32<T>(acc[pp]);
          }
        }
      }
    }
  }
}

template <typename T>
__global__ void pseudo_grid_bwd_kernel(const float* __restrict__ q,
                                       const float* __restrict__ s,
                                       const int32_t* __restrict__ idx,
                                       const bool* __restrict__ mask,
                                       const float* __restrict__ kp,
                                       const T* __restrict__ dy, int nq,
                                       int ns, int c, int k, int kpn,
                                       float inv_r, float coef, int mode,
                                       float* __restrict__ df) {
  __shared__ int s_idx[kMaxK];
  __shared__ float s_u[kMaxK * 3];
  __shared__ float s_kp[kMaxKp * 3];
  __shared__ float s_w[kMaxK * kWStride];
  const int b = blockIdx.y;
  float* dfb = df + static_cast<size_t>(b) * ns * c;
  const float* sb = s + static_cast<size_t>(b) * ns * 3;
  load_kernel_points(kp, kpn, s_kp);

  for (int qq = 0; qq < kQPB; ++qq) {
    const int qi = blockIdx.x * kQPB + qq;
    if (qi >= nq) break;
    const size_t row = static_cast<size_t>(b) * nq + qi;
    __syncthreads();
    stage_influences(q, sb, idx, mask, row, k, kpn, inv_r, coef, mode, s_kp,
                     s_idx, s_u, s_w);
    __syncthreads();
    if (staged_count(s_idx, k) == 0) continue;  // uniform: nothing to add
    const T* dyb = dy + row * static_cast<size_t>(kpn) * c;
    for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
      for (int p0 = 0; p0 < kpn; p0 += kPChunk) {
        float g[kPChunk];
#pragma unroll
        for (int pp = 0; pp < kPChunk; ++pp) {
          g[pp] = p0 + pp < kpn
                      ? to_f32(dyb[static_cast<size_t>(p0 + pp) * c + ch])
                      : 0.f;
        }
        for (int t = 0; t < k; ++t) {
          const int j = s_idx[t];
          if (j < 0) continue;
          const float* w = s_w + t * kWStride + p0;
          float acc = 0.f;
#pragma unroll
          for (int pp = 0; pp < kPChunk; ++pp) {
            acc = __fmaf_rn(w[pp], g[pp], acc);
          }
          atomicAdd(dfb + static_cast<size_t>(j) * c + ch, acc);
        }
      }
    }
  }
}

bool bad_args(int b, int ns, int c, int k, int kpn, int mode) {
  return b < 1 || b > 65535 || ns < 1 || c < 1 || k < 1 || k > kMaxK ||
         kpn < 1 || kpn > kMaxKp || mode < kLinear || mode > kGaussian;
}

}  // namespace

extern "C" int cl3d_pseudo_grid_max_kernel_points() { return kMaxKp; }

// out is [B, Nq, Kp * C] in the features' dtype.
extern "C" int cl3d_pseudo_grid(const float* q, const float* s, const void* f,
                                const int32_t* idx, const bool* mask,
                                const float* kp, int b, int nq, int ns, int c,
                                int k, int kpn, float inv_r, float coef,
                                int mode, int is_bf16, void* out,
                                cudaStream_t stream) {
  if (bad_args(b, ns, c, k, kpn, mode)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nq == 0) return static_cast<int>(cudaSuccess);
  if (is_bf16) {
    pseudo_grid_kernel<__nv_bfloat16>
        <<<grid_for(b, nq), threads_for(c), 0, stream>>>(
            q, s, static_cast<const __nv_bfloat16*>(f), idx, mask, kp, nq,
            ns, c, k, kpn, inv_r, coef, mode,
            static_cast<__nv_bfloat16*>(out));
  } else {
    pseudo_grid_kernel<float><<<grid_for(b, nq), threads_for(c), 0, stream>>>(
        q, s, static_cast<const float*>(f), idx, mask, kp, nq, ns, c, k, kpn,
        inv_r, coef, mode, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// df32 must be zeroed [B, Ns, C] float32; dy is [B, Nq, Kp * C] in the
// features' dtype.
extern "C" int cl3d_pseudo_grid_bwd(const float* q, const float* s,
                                    const int32_t* idx, const bool* mask,
                                    const float* kp, const void* dy, int b,
                                    int nq, int ns, int c, int k, int kpn,
                                    float inv_r, float coef, int mode,
                                    int is_bf16, float* df32,
                                    cudaStream_t stream) {
  if (bad_args(b, ns, c, k, kpn, mode)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nq == 0) return static_cast<int>(cudaSuccess);
  if (is_bf16) {
    pseudo_grid_bwd_kernel<__nv_bfloat16>
        <<<grid_for(b, nq), threads_for(c), 0, stream>>>(
            q, s, idx, mask, kp, static_cast<const __nv_bfloat16*>(dy), nq,
            ns, c, k, kpn, inv_r, coef, mode, df32);
  } else {
    pseudo_grid_bwd_kernel<float>
        <<<grid_for(b, nq), threads_for(c), 0, stream>>>(
            q, s, idx, mask, kp, static_cast<const float*>(dy), nq, ns, c, k,
            kpn, inv_r, coef, mode, df32);
  }
  return static_cast<int>(cudaGetLastError());
}
