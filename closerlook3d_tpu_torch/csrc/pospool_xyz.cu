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
// gather / scatter with MXU matmuls over Morton support chunks; here the
// forward reads each query's neighbor rows directly, and the backward
// scatters with f32 atomics into a zeroed f32 scratch that the wrapper
// casts once to the features' dtype.
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
// Forward layout (query_groups.cuh): a group of 16 or 32 lanes a query
// (and slice of its channels where queries are few), several groups a
// block and no block-wide barrier. The group compacts the query's valid
// slots in slot order and stages their support rows and D in its own
// shared memory; then each lane takes units of 16 bytes of channels (8
// bf16, 4 f32) of one coordinate d = c / (C/3) (every C the models run has
// C/3 a multiple of 8), reads the valid slots' 16-byte vectors of those
// channels, 4 slots at once, and writes its 16 bytes of the output once.
// C/3 off the vector width, or views off 16 bytes, take scalar units of
// the same channels. Backward layout (query_blocks.cuh): one block per
// kQPB consecutive queries of one cloud stages idx and D of its K slots in
// shared memory, then threads stride over the C channels and scatter with
// f32 atomics.
//
// Bound on the H100: bytes (inputs read once, the output written once).
// The forward's term is one product and one add a channel, so its pace is
// set by memory latency, not by that bound: the chain of dependent loads a
// query (idx and mask, then positions, then rows) and the gathered rows,
// B*Nq*(valid slots)*C values that a cloud's queries read again and again
// from L2. At ModelNet40's bf16 step (NVIDIA H100 80GB HBM3, 700 W) it
// moves its bytes at 0.85 TB/s, a quarter of the bound; staging and stores
// take 28% of its time, and the slot loops read rows from L2 at 1.4-2.0
// TB/s where queries hold 3-5 valid slots and 3.3-3.9 TB/s at the strided
// calls (13-16). Hence no block barrier, valid slots only, 16 bytes a
// lane and 4 slots' rows in flight (2 ran 5% slower, 8 6% slower);
// groups of 8 lanes stage in 8 rounds, take 64 registers and spill, and
// lost 4-14% to 16 and 32. Backward: the same pattern with f32 atomics
// into L2-resident rows, plus the scratch write and the cast.

#include "query_groups.cuh"

namespace {

constexpr int kXyzBytes = 16;  // channels a lane's unit holds, in bytes
constexpr int kXyzBatch = 4;   // valid slots whose rows a lane loads at once
constexpr int kXyzLanes = 16;  // the narrowest group (see the note above)

// K1 forward in query groups (query_groups.cuh): a group of kG lanes per
// item, a query and a slice of its passes. Unit e * kG + lg of pass e
// belongs to lane lg: channels [unit * kW, unit * kW + kW). Each channel
// sums acc + v * D[d] over the valid slots in slot order from +0, each
// product and sum rounded to f32 (the intrinsics keep nvcc from
// contracting them), divides by max(n, 1) for avg and rounds once to T:
// the bits of a loop over all K slots that skips the invalid ones.
template <typename T, bool kVec, int kG>
__global__ void __launch_bounds__(kGroupThreads)
    pospool_xyz_kernel(const float* __restrict__ q,
                       const float* __restrict__ s,
                       const T* __restrict__ f,
                       const int32_t* __restrict__ idx,
                       const bool* __restrict__ mask, int nq, int ns, int c,
                       int k, float radius, int avg, long long items,
                       int slices, int per, T* __restrict__ out) {
  using U = ChannelUnit<T, kVec, kXyzBytes>;
  constexpr int kW = U::kW;
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
        return to_f32(from_f32<T>(__fdiv_rn(__fsub_rn(sv, qv), radius)));
      },
      st);
  __syncwarp();
  if (!it.live) return;
  const int g = c / 3;
  const float cnt = static_cast<float>(max(n, 1));
  const unsigned row_bytes = static_cast<unsigned>(c) * sizeof(T);
  const int u_end = min(U::units(c), (it.slice + 1) * per * kG);
  for (int unit = it.slice * per * kG + lg; unit < u_end; unit += kG) {
    const int ch0 = unit * kW;
    const T* f0 = f + b * ns * c + ch0;  // the unit's channels of row 0
    int dd[kW];  // each channel's coordinate (one for a vector unit)
#pragma unroll
    for (int i = 0; i < kW; ++i)
      dd[i] = kVec ? ch0 / g : min((ch0 + i) / g, 2);
    float acc[kW] = {};
    for (int i0 = 0; i0 < n; i0 += kXyzBatch) {
      typename U::Raw r[kXyzBatch];
#pragma unroll
      for (int v = 0; v < kXyzBatch; ++v)
        r[v] = U::load(row_at(f0, st.j[min(i0 + v, n - 1)], row_bytes),
                       c - ch0);
#pragma unroll
      for (int v = 0; v < kXyzBatch; ++v) {
        if (i0 + v < n) {
          const float* x = st.x[i0 + v];
#pragma unroll
          for (int i = 0; i < kW; ++i)
            acc[i] = __fadd_rn(acc[i], __fmul_rn(to_f32(r[v].v[i]),
                                                 x[dd[i]]));
        }
      }
    }
    if (avg) {
#pragma unroll
      for (int i = 0; i < kW; ++i) acc[i] = __fdiv_rn(acc[i], cnt);
    }
    U::store(out + it.row * c + ch0, c - ch0, acc);
  }
}

template <typename T, bool kVec>
int launch_fwd_as(const float* q, const float* s, const T* f,
                  const int32_t* idx, const bool* mask, int b, int nq,
                  int ns, int c, int k, float radius, int avg, T* out,
                  cudaStream_t stream) {
  return launch_query_groups(
      static_cast<long long>(b) * nq,
      ChannelUnit<T, kVec, kXyzBytes>::units(c), kXyzLanes,
      [&](auto lanes, unsigned blocks, long long items, PassSplit sp) {
        pospool_xyz_kernel<T, kVec, decltype(lanes)::value>
            <<<blocks, kGroupThreads, 0, stream>>>(
                q, s, f, idx, mask, nq, ns, c, k, radius, avg, items,
                sp.slices, sp.per, out);
      });
}

// The forward in vector units where C/3 and the pointers allow them.
template <typename T>
int launch_fwd(const float* q, const float* s, const void* f,
               const int32_t* idx, const bool* mask, int b, int nq, int ns,
               int c, int k, float radius, int avg, void* out,
               cudaStream_t stream) {
  const T* fp = static_cast<const T*>(f);
  T* op = static_cast<T*>(out);
  if (runs_ok<T, ChannelUnit<T, true, kXyzBytes>::kW>(c / 3, f, out))
    return launch_fwd_as<T, true>(q, s, fp, idx, mask, b, nq, ns, c, k,
                                  radius, avg, op, stream);
  return launch_fwd_as<T, false>(q, s, fp, idx, mask, b, nq, ns, c, k,
                                 radius, avg, op, stream);
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
  if (bad_args(b, ns, c, k) ||
      static_cast<long long>(c) * (is_bf16 ? 2 : 4) >= kMaxRowBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return static_cast<int>(cudaSuccess);
  return is_bf16 ? launch_fwd<__nv_bfloat16>(q, s, f, idx, mask, b, nq, ns,
                                             c, k, radius, avg, out, stream)
                 : launch_fwd<float>(q, s, f, idx, mask, b, nq, ns, c, k,
                                     radius, avg, out, stream);
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
