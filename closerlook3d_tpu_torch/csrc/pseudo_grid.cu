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
// Forward layout (query_blocks.cuh): one block per kQPB consecutive
// queries of one cloud. For each query the block stages the K slots'
// indices and u, then the K x Kp influences, in shared memory, once; then
// threads stride over the C channels. A thread keeps up to kPChunk
// kernel-point sums in registers, so each gathered f[idx[k], c] is read
// once per chunk of kernel points (once at Kp = 15), and writes them at
// the end; a warp's loads and stores touch neighbouring channels of one
// row. The backward takes two launches over a reverse neighbor index
// (reverse_index.cuh, row_gather.cuh): each valid slot's f32 sum over the
// kernel points by query (pseudo_grid_sums_kernel), then a gather per
// support row that adds its slots' sums in (q, t) order and writes the row
// once in the features' dtype: no float atomics, no zeroed scratch, no
// cast, and the same bits on every run.
//
// Bound on the H100: bytes. The output is Kp = 15 times as wide as the
// features, so writing it dominates (B*Nq*Kp*C values); the gathered
// feature rows are L2-resident, as for the PosPool kernels. The backward
// reads dy once and writes df once, but also writes and reads back an f32
// sum per valid slot and channel: at the strided calls (9.5 valid slots a
// query on ModelNet40's synthetic clouds) that is more than dy itself.
// Its launches are latency-bound (two to three dependent round trips to
// memory a query or row).

#include "query_blocks.cuh"
#include "reverse_index.cuh"

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

constexpr int kPrepThreads = 512;
constexpr int kSlotChunk = 4;  // valid slots whose sums a lane keeps
constexpr int kDyRows = 4;     // dy rows (kernel points) loaded at once

// Shared memory of a query group in the first launch of K10's backward:
// its valid slots' numbers and u, and one chunk's influences.
struct SlotStage {
  int t[kMaxK];
  float u[kMaxK][3];
  float w[kSlotChunk][kMaxKp];
};

// K10 backward, launch 1. Blocks [0, B) build cloud b's reverse index
// (reverse_index.cuh). The others, query-major, a group of kG lanes per
// query and channel slice, write each valid slot's f32 sum over the
// kernel points,
//   sums[q, t, c] = fma(w[t, Kp-1], dy[q, (Kp-1)*C + c], ...
//                       fma(w[t, 0], dy[q, c], 0)),
// with u and the influences w recomputed by the staging code's rounded
// intrinsics (bit-equal to the forward's). The group stages its valid
// slots' numbers and u in shared memory (dynamic, beside the index
// blocks' counters), then, kSlotChunk slots at a time, their influences (a
// lane per (slot, kernel point)) and their sums in registers, reading the
// query's dy row kDyRows kernel points at a time (the first with the
// slots) once a chunk. Masked slots are not written. A group takes about
// kPrepItems queries in turn where there are many (prep_blocks).
template <typename T, bool kVec, int kG, bool kSharedIndex>
__global__ void __launch_bounds__(kPrepThreads)
    pseudo_grid_sums_kernel(const float* __restrict__ q,
                            const float* __restrict__ s,
                            const float* __restrict__ kp,
                            const T* __restrict__ dy,
                            const int32_t* __restrict__ idx,
                            const bool* __restrict__ mask, int clouds,
                            int nq, int ns, int c, int k, int kpn,
                            float inv_r, float coef, int mode, int slices,
                            int32_t* __restrict__ offsets,
                            int32_t* __restrict__ slots,
                            int32_t* __restrict__ raw,
                            int* __restrict__ counters,
                            float* __restrict__ sums) {
  extern __shared__ int s_dyn[];
  if (blockIdx.x < clouds) {
    build_reverse_index<kPrepThreads, kSharedIndex>(
        idx, mask, nq, ns, k, blockIdx.x, s_dyn, offsets, slots, raw,
        counters);
    return;
  }
  using Lanes = GroupChannels<T, kVec, kG>;
  using Raw = typename Lanes::Raw;
  constexpr int kW = Lanes::kW;
  constexpr int kGroups = kPrepThreads / kG;  // queries a block
  const int grp = threadIdx.x / kG, lg = threadIdx.x % kG;
  SlotStage& st = reinterpret_cast<SlotStage*>(s_dyn)[grp];
  const long long queries = static_cast<long long>(clouds) * nq;
  const long long total = queries * slices;  // (slice, cloud, query) items
  const long long stride = static_cast<long long>(gridDim.x - clouds) * kGroups;
  // block-uniform trip count: every warp takes part in each round's staging
  for (long long item0 = static_cast<long long>(blockIdx.x - clouds) * kGroups;
       item0 < total; item0 += stride) {
    const long long item = item0 + grp;
    const bool live = item < total;  // group-uniform
    const int slice = static_cast<int>(item / queries);
    const size_t row = static_cast<size_t>(item % queries);  // b * nq + q
    const Lanes lc(slice, lg, c);
    const float* sb = s + row / nq * ns * 3;
    const T* dq = dy + row * kpn * c;
    Raw r[kDyRows];
    float qp[3] = {};
    if (live) {
#pragma unroll
      for (int v = 0; v < kDyRows; ++v)
        r[v] = lc.load(dq + static_cast<size_t>(min(v, kpn - 1)) * c);
#pragma unroll
      for (int d = 0; d < 3; ++d) qp[d] = q[row * 3 + d];
    }
    __syncwarp();  // the last round's staging is read
    const int n = stage_group_slots<kG>(
        idx + row * k, mask + row * k, k, live, [&](int at, int t, int j) {
          st.t[at] = t;
#pragma unroll
          for (int d = 0; d < 3; ++d)
            st.u[at][d] = __fmul_rn(
                __fsub_rn(sb[static_cast<size_t>(j) * 3 + d], qp[d]), inv_r);
        });
    __syncwarp();
    if (!live) continue;
    for (int i0 = 0; i0 < n; i0 += kSlotChunk) {
      for (int e = lg; e < kSlotChunk * kpn; e += kG) {
        const int i = e / kpn, p = e - i * kpn;
        float w = 0.f;
        if (i0 + i < n) {
          const float* u = st.u[i0 + i];
          const float d0 = __fsub_rn(u[0], __ldg(kp + p * 3 + 0));
          const float d1 = __fsub_rn(u[1], __ldg(kp + p * 3 + 1));
          const float d2 = __fsub_rn(u[2], __ldg(kp + p * 3 + 2));
          float dd = __fmul_rn(d0, d0);
          dd = __fadd_rn(dd, __fmul_rn(d1, d1));
          dd = __fadd_rn(dd, __fmul_rn(d2, d2));
          w = influence(dd, mode, coef);
        }
        st.w[i][p] = w;
      }
      __syncwarp(Lanes::group_mask());
      float sum[kSlotChunk][kW] = {};
      for (int p0 = 0; p0 < kpn; p0 += kDyRows) {
        if (p0 > 0 || (i0 > 0 && kpn > kDyRows)) {  // past the held rows
#pragma unroll
          for (int v = 0; v < kDyRows; ++v)
            r[v] = lc.load(dq + static_cast<size_t>(min(p0 + v, kpn - 1)) *
                                    c);
        }
#pragma unroll
        for (int v = 0; v < kDyRows; ++v) {
          if (p0 + v < kpn) {
            float x[kW];
            Lanes::to_floats(r[v], x);
#pragma unroll
            for (int i = 0; i < kSlotChunk; ++i) {
              const float w = st.w[i][p0 + v];
#pragma unroll
              for (int ii = 0; ii < kW; ++ii)
                sum[i][ii] = __fmaf_rn(w, x[ii], sum[i][ii]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kSlotChunk; ++i)
        if (i0 + i < n)
          lc.store_f32(sums + (row * k + st.t[i0 + i]) * c, sum[i]);
      __syncwarp(Lanes::group_mask());  // influences read before the next
    }
  }
}

// K10's backward in two launches: the index and the per-slot sums, then
// the gather.
template <typename T, bool kVec, int kG>
void launch_bwd_lanes(const float* q, const float* s, const float* kp,
                      const T* dy, const int32_t* idx, const bool* mask,
                      int b, int nq, int ns, int c, int k, int kpn,
                      float inv_r, float coef, int mode, int32_t* offsets,
                      int32_t* slots, int32_t* raw, int* counters,
                      float* sums, T* df, cudaStream_t stream) {
  // both take dynamic shared memory: the staging, and the counters too
  static const int room =
      (dynamic_smem_room(pseudo_grid_sums_kernel<T, kVec, kG, false>),
       dynamic_smem_room(pseudo_grid_sums_kernel<T, kVec, kG, true>));
  constexpr int kGroups = kPrepThreads / kG;
  constexpr int kStage = kGroups * static_cast<int>(sizeof(SlotStage));
  const int slices = slices_of<T, kG>(c);
  const int blocks =
      b + prep_blocks(kGroups, static_cast<long long>(b) * nq * slices);
  const int counts = (ns + 1) * static_cast<int>(sizeof(int));
  if (std::max(counts, kStage) <= room)
    pseudo_grid_sums_kernel<T, kVec, kG, true>
        <<<blocks, kPrepThreads, std::max(counts, kStage), stream>>>(
            q, s, kp, dy, idx, mask, b, nq, ns, c, k, kpn, inv_r, coef, mode,
            slices, offsets, slots, raw, counters, sums);
  else
    pseudo_grid_sums_kernel<T, kVec, kG, false>
        <<<blocks, kPrepThreads, kStage, stream>>>(
            q, s, kp, dy, idx, mask, b, nq, ns, c, k, kpn, inv_r, coef, mode,
            slices, offsets, slots, raw, counters, sums);
  launch_csr_gather<T, kVec, false>(offsets, slots, sums, nullptr, b, nq, ns,
                                    c, k, df, nullptr, stream);
}

template <typename T, bool kVec>
void launch_bwd_as(const float* q, const float* s, const float* kp,
                   const T* dy, const int32_t* idx, const bool* mask, int b,
                   int nq, int ns, int c, int k, int kpn, float inv_r,
                   float coef, int mode, int32_t* offsets, int32_t* slots,
                   int32_t* raw, int* counters, float* sums, T* df,
                   cudaStream_t stream) {
  if (prep_lanes<T>(c) == 16)
    launch_bwd_lanes<T, kVec, 16>(q, s, kp, dy, idx, mask, b, nq, ns, c, k,
                                  kpn, inv_r, coef, mode, offsets, slots, raw,
                                  counters, sums, df, stream);
  else
    launch_bwd_lanes<T, kVec, 32>(q, s, kp, dy, idx, mask, b, nq, ns, c, k,
                                  kpn, inv_r, coef, mode, offsets, slots, raw,
                                  counters, sums, df, stream);
}

template <typename T>
void launch_bwd(const float* q, const float* s, const float* kp,
                const void* dy, const int32_t* idx, const bool* mask, int b,
                int nq, int ns, int c, int k, int kpn, float inv_r,
                float coef, int mode, int32_t* offsets, int32_t* slots,
                int32_t* raw, int* counters, float* sums, void* df,
                cudaStream_t stream) {
  const T* dp = static_cast<const T*>(dy);
  T* fp = static_cast<T*>(df);
  if (vec_ok<T>(c, dy, sums, df))
    launch_bwd_as<T, true>(q, s, kp, dp, idx, mask, b, nq, ns, c, k, kpn,
                           inv_r, coef, mode, offsets, slots, raw, counters,
                           sums, fp, stream);
  else
    launch_bwd_as<T, false>(q, s, kp, dp, idx, mask, b, nq, ns, c, k, kpn,
                            inv_r, coef, mode, offsets, slots, raw, counters,
                            sums, fp, stream);
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

// df [B, Ns, C] in the features' dtype, written in full (no zeroing
// needed); dy is [B, Nq, Kp * C] in that dtype. Scratch, none zeroed:
// offsets [B, Ns + 1], slots and raw [B, Nq * K] (the reverse index;
// offsets/slots hold it afterwards), counters [B, Ns + 1] (used where Ns
// outgrows shared memory), sums [B, Nq * K, C] float32. Two launches.
extern "C" int cl3d_pseudo_grid_bwd(
    const float* q, const float* s, const int32_t* idx, const bool* mask,
    const float* kp, const void* dy, int b, int nq, int ns, int c, int k,
    int kpn, float inv_r, float coef, int mode, int is_bf16, int32_t* offsets,
    int32_t* slots, int32_t* raw, int* counters, float* sums, void* df,
    cudaStream_t stream) {
  if (bad_args(b, ns, c, k, kpn, mode) ||
      static_cast<long long>(nq) * k > INT_MAX - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nq == 0) return static_cast<int>(cudaSuccess);
  if (is_bf16)
    launch_bwd<__nv_bfloat16>(q, s, kp, dy, idx, mask, b, nq, ns, c, k, kpn,
                              inv_r, coef, mode, offsets, slots, raw,
                              counters, sums, df, stream);
  else
    launch_bwd<float>(q, s, kp, dy, idx, mask, b, nq, ns, c, k, kpn, inv_r,
                      coef, mode, offsets, slots, raw, counters, sums, df,
                      stream);
  return static_cast<int>(cudaGetLastError());
}
