// Masked k nearest neighbors: for each query point, the k supports with
// the smallest squared distance, ascending by (d2, index), and their d2.
//
// Replaces: closerlook3d_tpu/ops/pallas/neighbors.py:_knn1_chunked_kernel
// (entry knn1_pallas_chunked, the decoder's 1-NN over supports of >= 1024
// points) and :_knn_kernel (entry knn_pallas, every other k-NN). One
// source serves both; the 1-NN has its own kernel, which keeps its running
// minimum in registers. The TPU's bounding-box chunk lists and
// transposed tiles are not carried over.
//
// Semantics are the jnp reference's (closerlook3d_tpu/ops/neighbors.py
// knn with _topk_neighbors), not the Pallas kernels':
//   d2 = ((q0-s0)^2 + (q1-s1)^2) + (q2-s2)^2, each step rounded to f32
//   (dist2_rn: no FMA contraction, so d2 equals the plain PyTorch
//   version's bit for bit); masked supports get +1e10 added in f32, so
//   they come back only when a cloud has fewer than k valid points; ties
//   go to the lowest index first (jax.lax.top_k's order); when k > Ns
//   the trailing slots repeat the nearest index at d2 = 1e10. (The Pallas
//   1-NN moves masked supports to 1e6 coordinates instead; the two differ
//   only on a support cloud with no valid point.)
//
// Layout: one thread per query, kThreads queries of one cloud per block;
// supports are staged through shared memory in tiles, read once per block
// and broadcast to its threads. A thread keeps its k best (d2, index)
// pairs sorted, inserting with strict comparisons so that an equal d2
// found later (a higher index) never displaces an earlier one.
//
// Bound on the H100: the Nq x Ns distance evaluations (FP32 pipe, about
// 11 operations a pair with the bias and the compare), far above the
// bytes (B*(Nq+Ns)*12 in, B*Nq*k*8 out).

#include "common.cuh"

namespace {

constexpr int kMaxKnn = 16;   // neighbors held per thread
constexpr int kThreads = 128; // queries per block (one thread each)
constexpr int kTile = 512;    // supports staged in shared memory per step
constexpr float kBig = 1e10f;

__device__ __forceinline__ void stage_tile(const float* __restrict__ sb,
                                           const bool* __restrict__ mb,
                                           int t0, int nt, float* tx,
                                           float* ty, float* tz, float* tb) {
  for (int j = threadIdx.x; j < nt; j += blockDim.x) {
    const float* p = sb + static_cast<size_t>(t0 + j) * 3;
    tx[j] = p[0];
    ty[j] = p[1];
    tz[j] = p[2];
    tb[j] = mb[t0 + j] ? 0.f : kBig;
  }
}

__global__ void __launch_bounds__(kThreads)
knn1_kernel(const float* __restrict__ q, const float* __restrict__ s,
            const bool* __restrict__ smask, int nq, int ns,
            int32_t* __restrict__ out_idx, float* __restrict__ out_d2) {
  __shared__ float tx[kTile], ty[kTile], tz[kTile], tb[kTile];
  const int b = blockIdx.y;
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool active = qi < nq;
  const size_t row = static_cast<size_t>(b) * nq + qi;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = q[row * 3 + 0];
    qy = q[row * 3 + 1];
    qz = q[row * 3 + 2];
  }
  float best_d = INFINITY;
  int best_i = 0;
  const float* sb = s + static_cast<size_t>(b) * ns * 3;
  const bool* mb = smask + static_cast<size_t>(b) * ns;
  for (int t0 = 0; t0 < ns; t0 += kTile) {
    const int nt = min(kTile, ns - t0);
    __syncthreads();  // previous tile fully consumed
    stage_tile(sb, mb, t0, nt, tx, ty, tz, tb);
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < nt; ++j) {
      const float d2 =
          __fadd_rn(dist2_rn(qx, qy, qz, tx[j], ty[j], tz[j]), tb[j]);
      if (d2 < best_d) {  // strict: the lower index wins ties
        best_d = d2;
        best_i = t0 + j;
      }
    }
  }
  if (!active) return;
  out_idx[row] = best_i;
  out_d2[row] = best_d;
}

__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ q, const float* __restrict__ s,
           const bool* __restrict__ smask, int nq, int ns, int k,
           int32_t* __restrict__ out_idx, float* __restrict__ out_d2) {
  __shared__ float tx[kTile], ty[kTile], tz[kTile], tb[kTile];
  const int b = blockIdx.y;
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool active = qi < nq;
  const size_t row = static_cast<size_t>(b) * nq + qi;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = q[row * 3 + 0];
    qy = q[row * 3 + 1];
    qz = q[row * 3 + 2];
  }
  float ld[kMaxKnn];
  int li[kMaxKnn];
  int cnt = 0;  // entries held, <= k
  const float* sb = s + static_cast<size_t>(b) * ns * 3;
  const bool* mb = smask + static_cast<size_t>(b) * ns;
  for (int t0 = 0; t0 < ns; t0 += kTile) {
    const int nt = min(kTile, ns - t0);
    __syncthreads();
    stage_tile(sb, mb, t0, nt, tx, ty, tz, tb);
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < nt; ++j) {
      const float d2 =
          __fadd_rn(dist2_rn(qx, qy, qz, tx[j], ty[j], tz[j]), tb[j]);
      if (cnt < k || d2 < ld[cnt - 1]) {
        int pos = cnt < k ? cnt++ : k - 1;
        // shift strictly larger entries; equal ones (lower index) stay
        while (pos > 0 && ld[pos - 1] > d2) {
          ld[pos] = ld[pos - 1];
          li[pos] = li[pos - 1];
          --pos;
        }
        ld[pos] = d2;
        li[pos] = t0 + j;
      }
    }
  }
  if (!active) return;
  int32_t* oi = out_idx + row * k;
  float* od = out_d2 + row * k;
  for (int slot = 0; slot < k; ++slot) {
    const bool held = slot < cnt;  // cnt = min(k, Ns)
    oi[slot] = held ? li[slot] : li[0];
    od[slot] = held ? ld[slot] : kBig;
  }
}

}  // namespace

extern "C" int cl3d_knn_max_k() { return kMaxKnn; }

extern "C" int cl3d_knn(const float* q, const float* s, const bool* smask,
                        int b, int nq, int ns, int k, int32_t* out_idx,
                        float* out_d2, cudaStream_t stream) {
  if (k < 1 || k > kMaxKnn || ns < 1 || b < 1 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nq == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((nq + kThreads - 1) / kThreads, b);
  if (k == 1) {
    knn1_kernel<<<grid, kThreads, 0, stream>>>(q, s, smask, nq, ns, out_idx,
                                               out_d2);
  } else {
    knn_kernel<<<grid, kThreads, 0, stream>>>(q, s, smask, nq, ns, k,
                                              out_idx, out_d2);
  }
  return static_cast<int>(cudaGetLastError());
}
