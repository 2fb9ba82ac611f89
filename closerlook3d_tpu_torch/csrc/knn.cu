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
// Layout. The 1-NN from kPruneMinSupport supports up (the decoder's
// calls onto S3DIS's 4096 and 1152 grid points): support_tiles.cuh's
// preparation (tiles of 32 valid supports, chunks of 32 tiles, their
// boxes) and its exact
// pruned search, nearest_key, a warp a query: the nearest chunk's nearest
// tile, then every chunk and tile whose box bound is <= the best d2 so
// far, one support a lane, 64-bit keys (d2 bits << 32 | index) so that
// the lowest index wins ties whatever order tiles are visited in, and a
// scan of every support where the best is >= 1e10 (masked supports tie
// at 1e10 there; a cloud with no valid support). A block holds
// kNearQueries consecutive queries of one cloud (the loader's Morton
// order, grid_subsample's voxel order): neighbours read the same boxes and
// tiles from L1. The supports keep their order (grid_subsample's Morton
// order; a repack by cell would cost 4x the preparation at 1152 supports).
// Two device ops a call. Below kPruneMinSupport
// supports (ShapeNetPart's 512-8, S3DIS's 304 and 88), and for k > 1,
// one op: one thread per query, kThreads queries of one cloud per block;
// supports are staged through shared memory in tiles, read once per block
// and broadcast to its threads. A thread keeps its k best (d2, index)
// pairs sorted, inserting with strict comparisons so that an equal d2
// found later (a higher index) never displaces an earlier one.
//
// Bound on the H100. The all-pairs kernel: the Nq x Ns distance
// evaluations (FP32 pipe, about 11 operations a pair with the bias and
// the compare), far above the bytes (B*(Nq+Ns)*12 in, B*Nq*k*8 out). The
// pruned search does a few tiles of work a query, so its bound is the
// bytes, and its time a chain of dependent loads and warp reductions a
// query (latency and issue slots).

#include "support_tiles.cuh"

namespace {

constexpr int kMaxKnn = 16;   // neighbors held per thread
constexpr int kThreads = 128; // queries per block (one thread each)
constexpr int kStage = 512;   // supports staged in shared memory per step
constexpr int kNearWarps = 8;    // warps a block of the pruned 1-NN
constexpr int kNearPerWarp = 4;  // queries a warp takes in turn
constexpr int kNearQueries = kNearWarps * kNearPerWarp;  // a block's
// supports from which the 1-NN prunes (below: the all-pairs kernel)
constexpr int kPruneMinSupport = 1024;

bool prunes(int ns, int k) { return k == 1 && ns >= kPruneMinSupport; }

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
  __shared__ float tx[kStage], ty[kStage], tz[kStage], tb[kStage];
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
  for (int t0 = 0; t0 < ns; t0 += kStage) {
    const int nt = min(kStage, ns - t0);
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
  __shared__ float tx[kStage], ty[kStage], tz[kStage], tb[kStage];
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
  for (int t0 = 0; t0 < ns; t0 += kStage) {
    const int nt = min(kStage, ns - t0);
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

// The pruned 1-NN (see Layout): warp w of block x takes queries x *
// kNearQueries + i * kNearWarps + w, i < kNearPerWarp, of cloud blockIdx.y
// in turn and writes each one's nearest support's index and biased d2.
__global__ void __launch_bounds__(kNearWarps * 32)
knn1_pruned_kernel(const float* __restrict__ q,
                   const float4* __restrict__ pts,
                   const float* __restrict__ tile_box,
                   const float* __restrict__ chunk_box, int nq, int ns,
                   int ntp, int ncp, int32_t* __restrict__ out_idx,
                   float* __restrict__ out_d2) {
  const size_t b = blockIdx.y;
  const float4* pb = pts + b * ntp * kTile;
  const float* tbx = tile_box + b * 6 * ntp;
  const float* cbx = chunk_box + b * 6 * ncp;
  const int lane = threadIdx.x & 31;
  for (int i = 0; i < kNearPerWarp; ++i) {
    const int qi =
        blockIdx.x * kNearQueries + i * kNearWarps + (threadIdx.x >> 5);
    if (qi >= nq) return;  // warp-uniform
    const size_t row = b * nq + qi;
    const Key best = nearest_key(pb, tbx, cbx, ns, ntp, ncp, q[row * 3],
                                 q[row * 3 + 1], q[row * 3 + 2], lane);
    if (lane == 0) {
      out_idx[row] = key_index(best);
      out_d2[row] = key_d2(best);
    }
  }
}

}  // namespace

extern "C" int cl3d_knn_max_k() { return kMaxKnn; }

// Floats of scratch cl3d_knn takes for b clouds of ns supports at this k:
// the pruned 1-NN's workspace (support_tiles.cuh), else 0.
extern "C" long long cl3d_knn_workspace_floats(int b, int ns, int k) {
  return prunes(ns, k) ? workspace_floats(b, ns) : 0;
}

// Device ops a call of cl3d_knn launches at these sizes: 2 for the pruned
// 1-NN (the preparation, then the search), 1 for the all-pairs kernels.
extern "C" int cl3d_knn_device_ops(int ns, int k) {
  return prunes(ns, k) ? 2 : 1;
}

// workspace: scratch of ws_floats >= cl3d_knn_workspace_floats(b, ns, k)
// floats, 16-byte aligned (unused, and may be null, where that is 0).
extern "C" int cl3d_knn(const float* q, const float* s, const bool* smask,
                        int b, int nq, int ns, int k, int32_t* out_idx,
                        float* out_d2, float* workspace, long long ws_floats,
                        cudaStream_t stream) {
  if (k < 1 || k > kMaxKnn || ns < 1 || b < 1 || b > 65535 ||
      ws_floats < cl3d_knn_workspace_floats(b, ns, k) ||
      reinterpret_cast<uintptr_t>(workspace) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nq == 0) return static_cast<int>(cudaSuccess);
  if (prunes(ns, k)) {
    // the decoder's supports are grid_subsample's, in Morton order: kept
    // as they are (a repack cost 4x the preparation and saved nothing)
    const SupportTiles st =
        launch_prep(s, smask, b, ns, workspace, false, stream);
    const dim3 grid((nq + kNearQueries - 1) / kNearQueries, b);
    knn1_pruned_kernel<<<grid, kNearWarps * 32, 0, stream>>>(
        q, st.pts, st.tile_box, st.chunk_box, nq, ns, st.ntp, st.ncp,
        out_idx, out_d2);
    return static_cast<int>(cudaGetLastError());
  }
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
