// Masked ordered ball query: for each query point, up to K supports with
// d2 <= r2, ascending by (d2, index); invalid slots hold the index of the
// nearest support (slot 0) and mask false; the mask is ANDed with the
// query mask.
//
// Replaces: closerlook3d_tpu/ops/pallas/neighbors.py:_bq_kernel (entries
// ball_query_pallas and _bq_folded) and :_bq_chunked_kernel (entry
// ball_query_pallas_chunked). One kernel family serves every support
// size; the TPU's batch folding (a +1e10 bias between clouds) is not
// carried over.
//
// Semantics are the jnp reference's (closerlook3d_tpu/ops/neighbors.py):
//   d2 = ((q0-s0)^2 + (q1-s1)^2) + (q2-s2)^2, each step rounded to f32;
//   masked supports get +1e10 added in f32 (not excluded); the top-K is
//   taken over all Ns with the lowest index first on ties; when K > Ns
//   the extra slots carry distance 1e10; slot s is valid iff its
//   distance <= r2; invalid slots take slot 0's index. The result equals
//   the plain PyTorch version's bit for bit, masked query rows included.
//
// Design. A run of 32 spatially close supports (a tile) spans a small box,
// and at these radii few tiles can hold a neighbor.
//   1. A preparation pass (support_tiles.cuh) packs the supports and
//      boxes tiles of 32 valid supports and chunks of 32 tiles; clouds of
//      97 to 2048 supports are repacked by Morton cell, larger ones keep
//      their sorted order.
//   2. ball_query_kernel gives a block a group of consecutive queries
//      (1 to 8 a warp, so that small calls still fill the card). The
//      block sweeps the tile boxes once against the group's box and
//      lists, in shared memory, the tiles that can hold an in-radius
//      support of any of them. Each warp then takes one query at a time:
//      the lanes bound 32 listed tiles at a time (ballot of those within
//      reach) and scan each tile within reach, one support per lane.
//      A list over 96 tiles (queries spread apart) or no pruning falls
//      back to a sweep per query: 32 chunk boxes, then the 32 tiles of
//      each chunk within reach. Bounds repeat dist2_rn's rounded
//      operations with each coordinate difference taken to the nearer
//      box face (0 inside; for the group, from the group box's nearer
//      face); every step is monotone and a chunk's box holds its
//      tiles', so a chunk's or the group's bound <= a query's tile bound
//      <= the computed d2 of any valid support in the tile, bit for bit:
//      "skip iff bound > reach" drops nothing the plain version keeps.
//      Reach is r2, then the d2 of the K-th key once K keys are held.
//   3. Candidates are support_tiles.cuh's 64-bit keys (d2 bits << 32 |
//      index), which order as the stable sort does. In-radius keys go to
//      a per-warp buffer in shared memory. When it would overflow, each
//      key's rank (the count of smaller keys) places the K smallest; at
//      the end the ranks place them in a row buffer that the warp writes
//      out coalesced.
//   4. A row with no in-radius support still needs slot 0, the exact
//      nearest: support_tiles.cuh's nearest_key, which the decoder's 1-NN
//      (knn.cu) runs too.
//   5. r2 >= 1e10 (radius >= 1e5) makes masked supports valid
//      neighbors; the boxes know only valid ones, so nothing is pruned.
//
// Bound on the H100: latency and issue slots. Per query a dependent chain
// of loads (its list's tile boxes, then each tile scanned) and ~40
// instructions a tile, plus the ranking; the in-radius pairs (the work a
// perfect pruner does) are far below the card's f32 rate, and the bytes
// (points, masks, idx and mask) are a few MB.

#include "support_tiles.cuh"

namespace {

constexpr int kMaxK = 64;     // list length held per query
constexpr int kWarps = 8;     // warps a block, one query each at a time
constexpr int kCap = 128;     // keys buffered per warp
constexpr int kMaxGroup = 64; // queries per block, sharing a tile list
constexpr int kMaxCand = 96;  // tiles a block's list holds (3 sweeps)
constexpr int kBlocksPerSM = 4;  // resident, by the launch bounds

// face_gap (support_tiles.cuh) for every query in [glo, ghi] at once:
// never larger in size than any of their face_gap values, rounded the
// same way.
__device__ __forceinline__ float group_gap(float glo, float ghi, float lo,
                                           float hi) {
  return ghi < lo ? __fsub_rn(ghi, lo)
                  : (glo > hi ? __fsub_rn(glo, hi) : 0.f);
}

// Each of the warp's first n <= kCap buffered keys (lane l holds keys
// r * 32 + l) with its rank: the count of smaller keys. Unused: kNoKey.
__device__ __forceinline__ void rank_keys(const Key* kb, int n, int lane,
                                          Key (&v)[4], int (&rank)[4]) {
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    v[r] = kNoKey;
    rank[r] = 0;
    if (r * 32 < n) {  // the whole warp
      const int e = r * 32 + lane;
      if (e < n) v[r] = kb[e];
      for (int j = 0; j < n; ++j) rank[r] += kb[j] < v[r];
    }
  }
  __syncwarp();
}

// One query's running candidates: n keys in the warp's buffer kb; once
// K are held, a new key must be below kth, and no box whose bound
// exceeds reach (r2, then kth's d2) can add one.
struct Held {
  int n = 0;
  Key kth = kNoKey;
  float reach;
};

// Scans tile t for the query: its in-radius keys below kth go to kb,
// cut to the K smallest (ranks) when kb would overflow.
__device__ __forceinline__ void scan_tile(const float4* __restrict__ pb,
                                          int t, float qx, float qy,
                                          float qz, float r2, int k,
                                          Key* kb, Held& h, int lane) {
  const float4 p = pb[t * kTile + lane];
  const float d2 = support_d2(p, qx, qy, qz);  // NaN past Ns
  const Key key = make_key(d2, support_index(p));
  bool hit = d2 <= r2 && key < h.kth;
  unsigned hits = __ballot_sync(kFull, hit);
  if (!hits) return;
  if (h.n + __popc(hits) > kCap) {
    // keep the K smallest (n > kCap - 32 >= K): ranks place them
    Key v[4];
    int rank[4];
    rank_keys(kb, h.n, lane, v, rank);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (rank[r] < k && v[r] != kNoKey) kb[rank[r]] = v[r];
    }
    __syncwarp();
    h.n = k;
    h.kth = kb[k - 1];
    h.reach = key_d2(h.kth);
    hit = hit && key < h.kth;
    hits = __ballot_sync(kFull, hit);
  }
  if (hit) kb[h.n + __popc(hits & ((1u << lane) - 1u))] = key;
  h.n += __popc(hits);
  __syncwarp();
}

// Scans the tiles of a 32-tile set (lane l: tile tl, its bound bl) within
// the query's reach, in lane order; a NaN bound never is.
__device__ __forceinline__ void scan_set(const float4* __restrict__ pb,
                                         int tl, float bl, float qx,
                                         float qy, float qz, float r2, int k,
                                         Key* kb, Held& h, int lane) {
  unsigned act = __ballot_sync(kFull, bl <= h.reach);
  while (act) {
    const int l = __ffs(act) - 1;
    act &= act - 1;
    const int t = __shfl_sync(kFull, tl, l);
    if (__shfl_sync(kFull, bl, l) <= h.reach) {  // reach shrinks at cuts
      scan_tile(pb, t, qx, qy, qz, r2, k, kb, h, lane);
    }
  }
}

// grid (ceil(Nq / group), B), kWarps warps: the block's group of
// consecutive queries (warp w takes the w-th, then every kWarps-th)
// shares one sweep of the tile boxes (see the design note, 2 and 3).
__global__ void __launch_bounds__(kWarps * 32, kBlocksPerSM)
ball_query_kernel(const float* __restrict__ q, const bool* __restrict__ qmask,
                  const float4* __restrict__ pts,
                  const float* __restrict__ tile_box,
                  const float* __restrict__ chunk_box, int nq, int ns,
                  int ntp, int ncp, int k, float r2, int group,
                  int32_t* __restrict__ out_idx,
                  bool* __restrict__ out_mask) {
  __shared__ Key buf[kWarps][kCap];
  __shared__ int row_idx[kWarps][kMaxK];
  __shared__ bool row_valid[kWarps][kMaxK];
  __shared__ float gq[kMaxGroup * 3];
  __shared__ float gbox[6];
  __shared__ int cand[kMaxCand];
  __shared__ int ncand;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * group;
  const int nqg = min(group, nq - q0);
  const float4* pb = pts + static_cast<size_t>(b) * ntp * kTile;
  const float* tbx = tile_box + static_cast<size_t>(b) * 6 * ntp;
  const float* cbx = chunk_box + static_cast<size_t>(b) * 6 * ncp;
  Key* kb = buf[w];
  const int ntiles = (ns + kTile - 1) / kTile;
  const int nchunks = ntp / 32;
  // r2 >= 1e10: masked supports can be in radius, and the boxes (valid
  // supports only) bound nothing about them: scan every tile
  const bool prune = r2 < kBig;

  const float* qb = q + (static_cast<size_t>(b) * nq + q0) * 3;
  for (int i = threadIdx.x; i < nqg * 3; i += blockDim.x) gq[i] = qb[i];
  if (threadIdx.x == 0) ncand = 0;
  __syncthreads();
  if (w == 0) {
    float v[6];
    empty_box(v);
    for (int e = lane; e < nqg; e += 32) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        v[a] = fminf(v[a], gq[e * 3 + a]);
        v[a + 3] = fmaxf(v[a + 3], gq[e * 3 + a]);
      }
    }
    warp_box(v);
    if (lane < 6) gbox[lane] = pick(v, lane);
  }
  __syncthreads();
  if (prune) {
    for (int t = threadIdx.x; t < ntp; t += blockDim.x) {
      const float d2 =
          sum_sq(group_gap(gbox[0], gbox[3], tbx[t], tbx[3 * ntp + t]),
                 group_gap(gbox[1], gbox[4], tbx[ntp + t], tbx[4 * ntp + t]),
                 group_gap(gbox[2], gbox[5], tbx[2 * ntp + t],
                           tbx[5 * ntp + t]));
      if (d2 <= r2) {
        const int slot = atomicAdd(&ncand, 1);
        if (slot < kMaxCand) cand[slot] = t;
      }
    }
  }
  __syncthreads();
  // the list, unless it overflowed (queries far apart, such as FPS
  // picks): then every query sweeps the chunk and tile boxes itself, as
  // it does with nothing pruned
  const int nlisted = prune && ncand <= kMaxCand ? ncand : -1;
  // slots past Ns hold distance 1e10 in the reference's top-K padding
  const bool pad_valid = kBig <= r2;

  for (int e = w; e < nqg; e += kWarps) {
    const float qx = gq[e * 3], qy = gq[e * 3 + 1], qz = gq[e * 3 + 2];
    Held h;
    h.reach = r2;
    if (nlisted >= 0) {
      for (int i0 = 0; i0 < nlisted; i0 += 32) {
        const int i = i0 + lane;
        const int t = i < nlisted ? cand[i] : 0;
        const float bl =
            i < nlisted ? box_bound(tbx, ntp, t, qx, qy, qz) : NAN;
        scan_set(pb, t, bl, qx, qy, qz, r2, k, kb, h, lane);
      }
    } else {
      // unpruned, a real chunk or tile gets bound 0 (never above reach)
      // and a padding one NaN (never at or below it)
      for (int cc = 0; cc < ncp; cc += 32) {
        const float cb =
            prune ? box_bound(cbx, ncp, cc + lane, qx, qy, qz)
                  : (cc + lane < nchunks ? 0.f : NAN);
        unsigned cact = __ballot_sync(kFull, cb <= h.reach);
        while (cact) {
          const int l = __ffs(cact) - 1;
          cact &= cact - 1;
          if (__shfl_sync(kFull, cb, l) > h.reach) continue;
          const int t = (cc + l) * 32 + lane;
          const float bl = prune ? box_bound(tbx, ntp, t, qx, qy, qz)
                                 : (t < ntiles ? 0.f : NAN);
          scan_set(pb, t, bl, qx, qy, qz, r2, k, kb, h, lane);
        }
      }
    }

    int n = h.n;
    int first;
    if (n > 0) {
      // ranks place the K smallest keys in their slots; slot 0's is
      // the smallest key
      Key v[4];
      int rank[4];
      rank_keys(kb, n, lane, v, rank);
      Key m = kNoKey;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        m = kmin(m, v[r]);
        if (rank[r] < k && v[r] != kNoKey) {
          row_idx[w][rank[r]] = key_index(v[r]);
          row_valid[w][rank[r]] = true;
        }
      }
      first = key_index(warp_min(m));
      n = min(n, k);
    } else {
      first = key_index(
          nearest_key(pb, tbx, cbx, ns, ntp, ncp, qx, qy, qz, lane));
    }
    for (int slot = n + lane; slot < k; slot += 32) {
      row_idx[w][slot] = first;
      row_valid[w][slot] = slot >= ns && pad_valid;
    }
    __syncwarp();
    const size_t row = static_cast<size_t>(b) * nq + q0 + e;
    const bool qv = qmask[row];
    for (int slot = lane; slot < k; slot += 32) {
      out_idx[row * k + slot] = row_idx[w][slot];
      out_mask[row * k + slot] = row_valid[w][slot] && qv;
    }
    __syncwarp();
  }
}

}  // namespace

// Floats of scratch cl3d_ball_query takes for b clouds of ns supports.
extern "C" long long cl3d_ball_query_workspace_floats(int b, int ns) {
  return workspace_floats(b, ns);
}

// Launches the preparation pass, then the query kernel, on one stream.
// workspace: scratch of ws_floats >= workspace_floats(b, ns) floats,
// 16-byte aligned.
extern "C" int cl3d_ball_query(const float* q, const float* s,
                               const bool* qmask, const bool* smask, int b,
                               int nq, int ns, int k, float r2,
                               int32_t* out_idx, bool* out_mask,
                               float* workspace, long long ws_floats,
                               cudaStream_t stream) {
  if (k < 1 || k > kMaxK || ns < 1 || nq < 1 || b < 1 || b > 65535 ||
      ws_floats < workspace_floats(b, ns) ||
      reinterpret_cast<uintptr_t>(workspace) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const SupportTiles st =
      launch_prep(s, smask, b, ns, workspace, true, stream);
  // queries per warp: as many as still leave two waves of resident
  // warps, at most 8 (a block's group, 64); 1 for small calls
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long wave = 2LL * sms * kBlocksPerSM * kWarps;
  const int per_warp = static_cast<int>(
      std::max(1LL, std::min<long long>(kMaxGroup / kWarps,
                                        static_cast<long long>(b) * nq /
                                            wave)));
  const int group = per_warp * kWarps;
  const dim3 grid((nq + group - 1) / group, b);
  ball_query_kernel<<<grid, kWarps * 32, 0, stream>>>(
      q, qmask, st.pts, st.tile_box, st.chunk_box, nq, ns, st.ntp, st.ncp, k,
      r2, group, out_idx, out_mask);
  return static_cast<int>(cudaGetLastError());
}
