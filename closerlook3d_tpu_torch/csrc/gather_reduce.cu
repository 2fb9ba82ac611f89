// The factorized point-wise MLP's neighborhood reductions (K6, K7), forward
// and backward. For query q with neighbor slots k (support row idx[k],
// validity mask[k]), over per-point projections g [Ns, C] and, for K7,
// d [Nq, C], all in f32:
//   K6  gmax[q, c] = max_k g[idx[k], c]    gmin = min_k, the same
//       s1[q, c]   = sum_k g[idx[k], c]    s2   = sum_k gsq[idx[k], c]
//   K7  hmax[q, c] = max_k (g[idx[k], c] - d[q, c])    hmin = min_k
// over the valid slots; every output is 0 where no slot is valid (never a
// sentinel). Backward:
//   K6  dg[s, c]   += ds1 + dmax / n (if g == gmax) + dmin / m (if g == gmin)
//       dgsq[s, c] += ds2                          for each valid slot at s;
//   K7  dg[s, c]   += dmax / n (if h == hmax) + dmin / m (if h == hmin);
//       dd[q, c]    = -(dmax + dmin), 0 for an empty neighborhood,
// where n (m) counts the valid slots that reach the max (min). The
// cotangent of an extremum is thus split evenly over ties, as autograd of
// amax/amin (the plain versions) and JAX's jnp path split it. Ties are real
// on this path: duplicated points carry equal features, hence equal g.
//
// Replaces: closerlook3d_tpu/ops/pallas/gather_reduce.py
//   _pwstats_fwd_kernel, _pwstats_bwd_kernel (K6, pwmlp_minmax_stats),
//   _mm_fwd_kernel, _mm_bwd_kernel            (K7, gather_sub_minmax).
// The Pallas kernels gather with one-hot MXU matmuls over Morton support
// chunks into transposed [C, T] query tiles, and disagree on ties: K6 sends
// a cotangent to the FIRST extremal slot (through an argmax it saves), K7
// to EVERY tying slot. Here each block reads its neighbor rows directly,
// and both backward kernels find the ties again by re-reading g (and d)
// beside the saved extrema, so no argmax is stored.
//
// Numerics: g, gsq and d are bf16 or f32; the kernels compute in f32 and
// the forward outputs are f32. s1 and s2 accumulate in f64 and round once,
// as the plain version does, so the two agree whatever their summation
// order: the masked BN variance formed from them, E[h^2] - mean^2,
// cancels, and f32 summation noise would move a train step's gradients
// by percents. dmax / n is an f32 division; the scatters sum in
// f32 with atomics (order varies run to run) into zeroed f32 scratch that
// the wrapper casts once to g's dtype, as the plain twins do.
//
// Layout (query_blocks.cuh): one block per kQPB consecutive queries of one
// cloud stages the K slot rows in shared memory; threads stride over the
// C channels, so a warp's loads (and atomics) of one support row are
// coalesced.
//
// Bound on the H100: bytes. The forward does a few f32 (and two f64)
// operations per gathered value and writes f32 outputs (K6 four, K7 two),
// which dominate the bytes; the K-fold re-reads of support rows hit L2.

#include "query_blocks.cuh"

namespace {

// Running max and min of f32 values; a NaN wins and stays, as amax and
// amin propagate it (x != x is the NaN test; nvcc does not assume finite
// math by default).
struct MinMax {
  float hi = 0.f, lo = 0.f;
  bool any = false;
  __device__ __forceinline__ void add(float v) {
    if (!any) {
      hi = v;
      lo = v;
      any = true;
      return;
    }
    if (hi == hi && (v != v || v > hi)) hi = v;
    if (lo == lo && (v != v || v < lo)) lo = v;
  }
};

template <typename T>
__global__ void pwstats_fwd_kernel(const T* __restrict__ g,
                                   const T* __restrict__ gsq,
                                   const int32_t* __restrict__ idx,
                                   const bool* __restrict__ mask, int nq,
                                   int ns, int c, int k,
                                   float* __restrict__ gmax,
                                   float* __restrict__ gmin,
                                   float* __restrict__ s1,
                                   float* __restrict__ s2) {
  __shared__ int s_idx[kMaxK];  // support row, or -1 for a masked slot
  const int b = blockIdx.y;
  const T* gb = g + static_cast<size_t>(b) * ns * c;
  const T* qb = gsq + static_cast<size_t>(b) * ns * c;

  for (int qq = 0; qq < kQPB; ++qq) {
    const int qi = blockIdx.x * kQPB + qq;
    if (qi >= nq) break;  // uniform across the block
    const size_t row = static_cast<size_t>(b) * nq + qi;
    __syncthreads();  // previous query's slots fully consumed
    stage_rows(idx, mask, row, k, s_idx);
    __syncthreads();
    for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
      MinMax mm;
      double a1 = 0.0, a2 = 0.0;
      for (int t = 0; t < k; ++t) {
        const int j = s_idx[t];
        if (j >= 0) {
          const size_t off = static_cast<size_t>(j) * c + ch;
          const float v = to_f32(gb[off]);
          mm.add(v);
          a1 += v;
          a2 += to_f32(qb[off]);
        }
      }
      const size_t o = row * c + ch;
      gmax[o] = mm.any ? mm.hi : 0.f;
      gmin[o] = mm.any ? mm.lo : 0.f;
      s1[o] = __double2float_rn(a1);
      s2[o] = __double2float_rn(a2);
    }
  }
}

// (dmax / n, dmin / m) for one (query, channel): n (m) = valid slots whose
// value equals hi (lo), counted by the caller; clamped at 1 as the plain
// twins clamp.
__device__ __forceinline__ float share(float dy, int n) {
  return __fdiv_rn(dy, static_cast<float>(max(n, 1)));
}

template <typename T>
__global__ void pwstats_bwd_kernel(const T* __restrict__ g,
                                   const int32_t* __restrict__ idx,
                                   const bool* __restrict__ mask,
                                   const float* __restrict__ gmax,
                                   const float* __restrict__ gmin,
                                   const float* __restrict__ dmax,
                                   const float* __restrict__ dmin,
                                   const float* __restrict__ ds1,
                                   const float* __restrict__ ds2, int nq,
                                   int ns, int c, int k,
                                   float* __restrict__ dg,
                                   float* __restrict__ dgsq) {
  __shared__ int s_idx[kMaxK];
  const int b = blockIdx.y;
  const T* gb = g + static_cast<size_t>(b) * ns * c;
  float* dgb = dg + static_cast<size_t>(b) * ns * c;
  float* dqb = dgsq + static_cast<size_t>(b) * ns * c;

  for (int qq = 0; qq < kQPB; ++qq) {
    const int qi = blockIdx.x * kQPB + qq;
    if (qi >= nq) break;
    const size_t row = static_cast<size_t>(b) * nq + qi;
    __syncthreads();
    stage_rows(idx, mask, row, k, s_idx);
    __syncthreads();
    if (staged_count(s_idx, k) == 0) continue;  // uniform: no gradient
    for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
      const size_t o = row * c + ch;
      const float hi = gmax[o], lo = gmin[o];
      int n_hi = 0, n_lo = 0;
      for (int t = 0; t < k; ++t) {
        const int j = s_idx[t];
        if (j >= 0) {
          const float v = to_f32(gb[static_cast<size_t>(j) * c + ch]);
          n_hi += v == hi;
          n_lo += v == lo;
        }
      }
      const float sh_hi = share(dmax[o], n_hi), sh_lo = share(dmin[o], n_lo);
      const float d1 = ds1[o], d2 = ds2[o];
      for (int t = 0; t < k; ++t) {
        const int j = s_idx[t];
        if (j >= 0) {
          const size_t off = static_cast<size_t>(j) * c + ch;
          const float v = to_f32(gb[off]);
          float sh = 0.f;
          if (v == hi) sh += sh_hi;
          if (v == lo) sh += sh_lo;
          atomicAdd(dgb + off, d1 + sh);
          atomicAdd(dqb + off, d2);
        }
      }
    }
  }
}

template <typename T>
__global__ void mm_fwd_kernel(const T* __restrict__ g, const T* __restrict__ d,
                              const int32_t* __restrict__ idx,
                              const bool* __restrict__ mask, int nq, int ns,
                              int c, int k, float* __restrict__ hmax,
                              float* __restrict__ hmin) {
  __shared__ int s_idx[kMaxK];
  const int b = blockIdx.y;
  const T* gb = g + static_cast<size_t>(b) * ns * c;

  for (int qq = 0; qq < kQPB; ++qq) {
    const int qi = blockIdx.x * kQPB + qq;
    if (qi >= nq) break;
    const size_t row = static_cast<size_t>(b) * nq + qi;
    __syncthreads();
    stage_rows(idx, mask, row, k, s_idx);
    __syncthreads();
    for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
      const size_t o = row * c + ch;
      const float dv = to_f32(d[o]);
      MinMax mm;
      for (int t = 0; t < k; ++t) {
        const int j = s_idx[t];
        if (j >= 0) mm.add(to_f32(gb[static_cast<size_t>(j) * c + ch]) - dv);
      }
      hmax[o] = mm.any ? mm.hi : 0.f;
      hmin[o] = mm.any ? mm.lo : 0.f;
    }
  }
}

template <typename T>
__global__ void mm_bwd_kernel(const T* __restrict__ g, const T* __restrict__ d,
                              const int32_t* __restrict__ idx,
                              const bool* __restrict__ mask,
                              const float* __restrict__ hmax,
                              const float* __restrict__ hmin,
                              const float* __restrict__ dmax,
                              const float* __restrict__ dmin, int nq, int ns,
                              int c, int k, float* __restrict__ dg,
                              T* __restrict__ dd) {
  __shared__ int s_idx[kMaxK];
  const int b = blockIdx.y;
  const T* gb = g + static_cast<size_t>(b) * ns * c;
  float* dgb = dg + static_cast<size_t>(b) * ns * c;

  for (int qq = 0; qq < kQPB; ++qq) {
    const int qi = blockIdx.x * kQPB + qq;
    if (qi >= nq) break;
    const size_t row = static_cast<size_t>(b) * nq + qi;
    __syncthreads();
    stage_rows(idx, mask, row, k, s_idx);
    __syncthreads();
    const bool empty = staged_count(s_idx, k) == 0;  // uniform
    for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
      const size_t o = row * c + ch;
      if (empty) {
        dd[o] = from_f32<T>(0.f);
        continue;
      }
      const float dv = to_f32(d[o]);
      const float hi = hmax[o], lo = hmin[o];
      int n_hi = 0, n_lo = 0;
      for (int t = 0; t < k; ++t) {
        const int j = s_idx[t];
        if (j >= 0) {
          const float h = to_f32(gb[static_cast<size_t>(j) * c + ch]) - dv;
          n_hi += h == hi;
          n_lo += h == lo;
        }
      }
      const float sh_hi = share(dmax[o], n_hi), sh_lo = share(dmin[o], n_lo);
      for (int t = 0; t < k; ++t) {
        const int j = s_idx[t];
        if (j >= 0) {
          const size_t off = static_cast<size_t>(j) * c + ch;
          const float h = to_f32(gb[off]) - dv;
          if (h == hi || h == lo) {
            float sh = 0.f;
            if (h == hi) sh += sh_hi;
            if (h == lo) sh += sh_lo;
            atomicAdd(dgb + off, sh);
          }
        }
      }
      dd[o] = from_f32<T>(-(dmax[o] + dmin[o]));
    }
  }
}

bool bad_args(int b, int ns, int c, int k) {
  return b < 1 || b > 65535 || ns < 1 || c < 1 || k < 1 || k > kMaxK;
}

}  // namespace

// Outputs: gmax, gmin, s1, s2, each [B, Nq, C] float32. g and gsq are in
// one dtype (bf16 when is_bf16, else f32).
extern "C" int cl3d_pwmlp_stats(const void* g, const void* gsq,
                                const int32_t* idx, const bool* mask, int b,
                                int nq, int ns, int c, int k, int is_bf16,
                                float* gmax, float* gmin, float* s1, float* s2,
                                cudaStream_t stream) {
  if (bad_args(b, ns, c, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaSuccess);
  if (is_bf16) {
    pwstats_fwd_kernel<__nv_bfloat16>
        <<<grid_for(b, nq), threads_for(c), 0, stream>>>(
            static_cast<const __nv_bfloat16*>(g),
            static_cast<const __nv_bfloat16*>(gsq), idx, mask, nq, ns, c, k,
            gmax, gmin, s1, s2);
  } else {
    pwstats_fwd_kernel<float><<<grid_for(b, nq), threads_for(c), 0, stream>>>(
        static_cast<const float*>(g), static_cast<const float*>(gsq), idx,
        mask, nq, ns, c, k, gmax, gmin, s1, s2);
  }
  return static_cast<int>(cudaGetLastError());
}

// dg32 and dgsq32 must be zeroed [B, Ns, C] float32; gmax/gmin are this
// op's forward outputs for g, and the cotangents are f32 [B, Nq, C].
extern "C" int cl3d_pwmlp_stats_bwd(const void* g, const int32_t* idx,
                                    const bool* mask, const float* gmax,
                                    const float* gmin, const float* dmax,
                                    const float* dmin, const float* ds1,
                                    const float* ds2, int b, int nq, int ns,
                                    int c, int k, int is_bf16, float* dg32,
                                    float* dgsq32, cudaStream_t stream) {
  if (bad_args(b, ns, c, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaSuccess);
  if (is_bf16) {
    pwstats_bwd_kernel<__nv_bfloat16>
        <<<grid_for(b, nq), threads_for(c), 0, stream>>>(
            static_cast<const __nv_bfloat16*>(g), idx, mask, gmax, gmin, dmax,
            dmin, ds1, ds2, nq, ns, c, k, dg32, dgsq32);
  } else {
    pwstats_bwd_kernel<float><<<grid_for(b, nq), threads_for(c), 0, stream>>>(
        static_cast<const float*>(g), idx, mask, gmax, gmin, dmax, dmin, ds1,
        ds2, nq, ns, c, k, dg32, dgsq32);
  }
  return static_cast<int>(cudaGetLastError());
}

// Outputs: hmax, hmin, each [B, Nq, C] float32. g [B, Ns, C] and d
// [B, Nq, C] are in one dtype.
extern "C" int cl3d_gather_sub_minmax(const void* g, const void* d,
                                      const int32_t* idx, const bool* mask,
                                      int b, int nq, int ns, int c, int k,
                                      int is_bf16, float* hmax, float* hmin,
                                      cudaStream_t stream) {
  if (bad_args(b, ns, c, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaSuccess);
  if (is_bf16) {
    mm_fwd_kernel<__nv_bfloat16>
        <<<grid_for(b, nq), threads_for(c), 0, stream>>>(
            static_cast<const __nv_bfloat16*>(g),
            static_cast<const __nv_bfloat16*>(d), idx, mask, nq, ns, c, k,
            hmax, hmin);
  } else {
    mm_fwd_kernel<float><<<grid_for(b, nq), threads_for(c), 0, stream>>>(
        static_cast<const float*>(g), static_cast<const float*>(d), idx, mask,
        nq, ns, c, k, hmax, hmin);
  }
  return static_cast<int>(cudaGetLastError());
}

// dg32 must be zeroed [B, Ns, C] float32; dd [B, Nq, C] in d's dtype is
// written in full. hmax/hmin are this op's forward outputs for (g, d).
extern "C" int cl3d_gather_sub_minmax_bwd(const void* g, const void* d,
                                          const int32_t* idx, const bool* mask,
                                          const float* hmax, const float* hmin,
                                          const float* dmax, const float* dmin,
                                          int b, int nq, int ns, int c, int k,
                                          int is_bf16, float* dg32, void* dd,
                                          cudaStream_t stream) {
  if (bad_args(b, ns, c, k)) return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaSuccess);
  if (is_bf16) {
    mm_bwd_kernel<__nv_bfloat16>
        <<<grid_for(b, nq), threads_for(c), 0, stream>>>(
            static_cast<const __nv_bfloat16*>(g),
            static_cast<const __nv_bfloat16*>(d), idx, mask, hmax, hmin, dmax,
            dmin, nq, ns, c, k, dg32, static_cast<__nv_bfloat16*>(dd));
  } else {
    mm_bwd_kernel<float><<<grid_for(b, nq), threads_for(c), 0, stream>>>(
        static_cast<const float*>(g), static_cast<const float*>(d), idx, mask,
        hmax, hmin, dmax, dmin, nq, ns, c, k, dg32, static_cast<float*>(dd));
  }
  return static_cast<int>(cudaGetLastError());
}
