// Exact pruned nearest-support search over boxes of a cloud's valid
// supports, shared by the ball query (ball_query.cu: slot 0 of a row with
// no in-radius support) and the decoder's 1-NN (knn.cu).
//
// Preparation. A pass packs each support as a float4 (x, y, z, its index
// with bit 31 set if masked; NaN past Ns) into a workspace the wrapper
// allocates, and writes each tile's box (32 supports) over its *valid*
// supports (empty: lo = +inf, hi = -inf) and each chunk's (32 tiles')
// box. For the ball query a cloud of 97 to 2048 supports
// (prep_small_kernel, one block a cloud) is packed by a counting sort over
// 16^3 Morton cells: FPS picks, which later stages query, are spread over
// the whole cloud, so their tiles in input order prune nothing. Larger
// clouds arrive sorted (the loader's Morton order, grid_subsample's voxel
// order) and keep their order (prep_kernel, a block a chunk), as do clouds
// of at most 3 tiles and the 1-NN's supports (grid_subsample's).
// Keys carry the original index, so the order of a scan changes nothing
// in the result. Each cloud has its own workspace rows and blocks: clouds
// are never folded together.
//
// Keys. A candidate is the unique 64-bit key (f32 bits of d2) << 32 |
// index: d2 >= 0, so the keys order as (d2, index), the order of the
// plain versions' stable sort, and the smallest key is the nearest
// support with the lowest index on ties, whatever order tiles are
// visited in.
//
// Bounds. box_bound repeats dist2_rn's rounded operations with each
// coordinate difference taken to the nearer box face (0 inside); every
// step is monotone and a chunk's box holds its tiles', so a chunk's bound
// <= a tile's bound <= the computed d2 of any valid support in the tile,
// bit for bit: skipping a box whose bound exceeds the best d2 found drops
// no support that the plain version could pick, ties included.
//
// Search (nearest_key). The nearest chunk's nearest tile first, then
// every chunk and tile whose bound is <= the best d2 so far, one support a
// lane, the first tile not again; a warp's smallest key by two redux.sync
// (warp_min_key). If that best is >= 1e10 (or the cloud has no valid
// support) a masked support, biased by +1e10, could tie or win, and the
// boxes know only valid supports: every support is scanned, and the
// lowest index of the smallest biased d2 wins.
#pragma once

#include "common.cuh"

namespace {

constexpr int kTile = 32;        // supports per tile, one per lane
constexpr int kSortMax = 2048;   // clouds one block prepares
constexpr int kCells = 4096;     // Morton cells of the counting sort
constexpr float kBig = 1e10f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMasked = static_cast<int>(0x80000000u);
using Key = unsigned long long;  // (f32 bits of d2) << 32 | index
constexpr Key kNoKey = ~0ull;

// Tiles per cloud in the workspace: ceil(Ns / 32) rounded up to whole
// chunks of 32 tiles; chunks per cloud: that / 32 rounded up to 32, so
// every sweep reads 32 boxes at a time.
__host__ __device__ inline int padded_tiles(int ns) {
  return ((ns + kTile - 1) / kTile + 31) / 32 * 32;
}
__host__ __device__ inline int padded_chunks(int ns) {
  return (padded_tiles(ns) / 32 + 31) / 32 * 32;
}

// Workspace per call, in floats: points [B][ntp * 32] float4, then tile
// boxes [B][6][ntp], then chunk boxes [B][6][ncp]; a box row is lo x, y,
// z, hi x, y, z.
__host__ __device__ inline long long workspace_floats(int b, int ns) {
  return static_cast<long long>(b) *
         (134LL * padded_tiles(ns) + 6LL * padded_chunks(ns));
}

__device__ __forceinline__ Key make_key(float d2, int idx) {
  return (static_cast<Key>(__float_as_uint(d2)) << 32) |
         static_cast<uint32_t>(idx);
}

__device__ __forceinline__ float key_d2(Key key) {
  return __uint_as_float(static_cast<uint32_t>(key >> 32));
}

__device__ __forceinline__ int key_index(Key key) {
  return static_cast<int>(key & 0xffffffffu);
}

__device__ __forceinline__ Key kmin(Key a, Key b) { return b < a ? b : a; }

__device__ __forceinline__ Key warp_min(Key v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = kmin(v, __shfl_xor_sync(kFull, v, o));
  }
  return v;
}

// warp_min of make_key(d2, idx) over the lanes where `has` (kNoKey: none),
// d2 >= 0 or +inf: the smallest d2 bits, then the smallest index among
// the lanes that hold them, two redux.sync where warp_min shuffles ten
// times.
__device__ __forceinline__ Key warp_min_key(float d2, int idx, bool has) {
  const unsigned bits = has ? __float_as_uint(d2) : 0xffffffffu;
  const unsigned lo = __reduce_min_sync(kFull, bits);
  const unsigned at = __reduce_min_sync(
      kFull, has && bits == lo ? static_cast<unsigned>(idx) : 0xffffffffu);
  return at == 0xffffffffu ? kNoKey : (static_cast<Key>(lo) << 32) | at;
}

__device__ __forceinline__ void empty_box(float (&v)[6]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    v[a] = INFINITY;
    v[a + 3] = -INFINITY;
  }
}

__device__ __forceinline__ void warp_box(float (&v)[6]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      v[a] = fminf(v[a], __shfl_xor_sync(kFull, v[a], o));
      v[a + 3] = fmaxf(v[a + 3], __shfl_xor_sync(kFull, v[a + 3], o));
    }
  }
}

// v[i] for a run-time i < 6, by selects (no local-memory array).
__device__ __forceinline__ float pick(const float (&v)[6], int i) {
  float x = v[0];
#pragma unroll
  for (int a = 1; a < 6; ++a) x = i == a ? v[a] : x;
  return x;
}

// A packed support: coordinates and its index, bit 31 set if masked.
__device__ __forceinline__ float4 pack(const float* __restrict__ p, int j,
                                       bool valid) {
  return make_float4(p[0], p[1], p[2],
                     __int_as_float(valid ? j : (j | kMasked)));
}

// Padding past Ns: NaN coordinates (never in radius), masked.
__device__ __forceinline__ float4 padding() {
  return make_float4(NAN, NAN, NAN, __int_as_float(kMasked));
}

__device__ __forceinline__ bool support_valid(float4 p) {
  return __float_as_int(p.w) >= 0;
}

__device__ __forceinline__ int support_index(float4 p) {
  return __float_as_int(p.w) & ~kMasked;
}

// d2 of a packed support as the plain version biases it.
__device__ __forceinline__ float support_d2(float4 p, float qx, float qy,
                                            float qz) {
  const float d2 = dist2_rn(qx, qy, qz, p.x, p.y, p.z);
  return support_valid(p) ? d2 : __fadd_rn(d2, kBig);
}

// Extends a box by a packed support if it is valid.
__device__ __forceinline__ void box_add(float (&v)[6], float4 p) {
  if (support_valid(p)) {
    v[0] = fminf(v[0], p.x);
    v[1] = fminf(v[1], p.y);
    v[2] = fminf(v[2], p.z);
    v[3] = fmaxf(v[3], p.x);
    v[4] = fmaxf(v[4], p.y);
    v[5] = fmaxf(v[5], p.z);
  }
}

// A warp's tile t: packs its 32 positions (pk, one per lane), stores the
// box of their valid supports as tile t's and into red[w] for the
// chunk's box.
__device__ __forceinline__ void store_tile(float4 pk, float4* __restrict__ pts,
                                           float* __restrict__ tile_box,
                                           int b, int ntp, int t,
                                           float (*red)[6], int w, int lane) {
  pts[(static_cast<size_t>(b) * ntp + t) * kTile + lane] = pk;
  float v[6];
  empty_box(v);
  box_add(v, pk);
  warp_box(v);
  if (lane < 6) {
    tile_box[(static_cast<size_t>(b) * 6 + lane) * ntp + t] = pick(v, lane);
    red[w][lane] = pick(v, lane);
  }
}

// Warp 0 of a 1024-thread block: chunk c's box over the 32 tile boxes in
// red; the caller syncs before and after.
__device__ __forceinline__ void store_chunk_box(float (*red)[6],
                                                float* __restrict__ chunk_box,
                                                int b, int ncp, int c,
                                                int lane) {
  float v[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) v[a] = red[lane][a];
  warp_box(v);
  if (lane < 6) {
    chunk_box[(static_cast<size_t>(b) * 6 + lane) * ncp + c] = pick(v, lane);
  }
}

// Empty boxes for the padding chunks ntp / 32 .. ncp - 1 of cloud b.
__device__ __forceinline__ void pad_chunk_boxes(float* __restrict__ chunk_box,
                                                int b, int ntp, int ncp,
                                                int tid) {
  for (int e = ntp / 32 + tid; e < ncp; e += 1024) {
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      chunk_box[(static_cast<size_t>(b) * 6 + a) * ncp + e] =
          a < 3 ? INFINITY : -INFINITY;
    }
  }
}

// grid (ntp / 32, B), 1024 threads, Ns > kSortMax or Ns <= 96: warp w
// of block c packs and boxes tile c * 32 + w in the input order; warp 0
// then boxes chunk c.
__global__ void __launch_bounds__(1024)
prep_kernel(const float* __restrict__ s, const bool* __restrict__ smask,
            int ns, int ntp, int ncp, float4* __restrict__ pts,
            float* __restrict__ tile_box, float* __restrict__ chunk_box) {
  __shared__ float red[32][6];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int j = (c * 32 + w) * kTile + lane;
  float4 pk = padding();
  if (j < ns) {
    const size_t i = static_cast<size_t>(b) * ns + j;
    pk = pack(s + i * 3, j, smask[i]);
  }
  store_tile(pk, pts, tile_box, b, ntp, c * 32 + w, red, w, lane);
  if (c == 0) pad_chunk_boxes(chunk_box, b, ntp, ncp, threadIdx.x);
  __syncthreads();
  if (w == 0) store_chunk_box(red, chunk_box, b, ncp, c, lane);
}

__device__ __forceinline__ unsigned spread4(unsigned x) {
  x &= 0xfu;
  x = (x | (x << 4)) & 0x0c3u;
  x = (x | (x << 2)) & 0x249u;
  return x;
}

// grid (B), 1024 threads, 96 < Ns <= kSortMax: a counting sort by Morton
// cell (16 an axis over the valid box, masked supports after every cell)
// packs the cloud cell by cell, then boxes it as prep_kernel does. The
// order within a cell follows shared-memory atomics and may change from
// run to run; keys carry the original index, so the result does not.
__global__ void __launch_bounds__(1024)
prep_small_kernel(const float* __restrict__ s, const bool* __restrict__ smask,
                  int ns, int ntp, int ncp, float4* __restrict__ pts,
                  float* __restrict__ tile_box,
                  float* __restrict__ chunk_box) {
  __shared__ int cnt[kCells + 1];
  __shared__ short order[kSortMax];
  __shared__ float red[32][6];
  __shared__ float box[6];
  __shared__ int wsum[32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int b = blockIdx.x;
  const float* sb = s + static_cast<size_t>(b) * ns * 3;
  const bool* mb = smask + static_cast<size_t>(b) * ns;
  const int nc = ntp / 32;  // 1 or 2 chunks, a position per thread each

  // the valid supports' box
  float v[6];
  empty_box(v);
  for (int j = tid; j < ns; j += 1024) box_add(v, pack(sb + j * 3, j, mb[j]));
  warp_box(v);
  if (lane < 6) red[w][lane] = pick(v, lane);
  for (int i = tid; i <= kCells; i += 1024) cnt[i] = 0;
  __syncthreads();
  if (w == 0) {
#pragma unroll
    for (int a = 0; a < 6; ++a) v[a] = red[lane][a];
    warp_box(v);
    if (lane < 6) box[lane] = pick(v, lane);
  }
  __syncthreads();

  // each support's cell, counted
  const float ext = fmaxf(fmaxf(box[3] - box[0], box[4] - box[1]),
                          box[5] - box[2]);
  const float scale = 16.f / fmaxf(ext, 1e-9f);
  int cell[2] = {-1, -1};
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int p = c * 1024 + tid;
    if (c < nc && p < ns) {
      cell[c] = kCells;
      if (mb[p]) {
        unsigned code = 0;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float x = __fmul_rn(__fsub_rn(sb[p * 3 + a], box[a]), scale);
          code |= spread4(static_cast<unsigned>(fminf(x, 15.f))) << a;
        }
        cell[c] = static_cast<int>(code);
      }
      atomicAdd(&cnt[cell[c]], 1);
    }
  }
  __syncthreads();
  // exclusive prefix sums of the counts: 4 a thread, then across the
  // block; the masked bucket starts after every cell
  int run = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) run += cnt[tid * 4 + e];
  int incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += x;
  }
  if (lane == 31) wsum[w] = incl;
  __syncthreads();
  if (w == 0) {
    int x = wsum[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    wsum[lane] = x;
  }
  __syncthreads();
  int start = incl - run + (w > 0 ? wsum[w - 1] : 0);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int n = cnt[tid * 4 + e];
    cnt[tid * 4 + e] = start;
    start += n;
  }
  if (tid == 1023) cnt[kCells] = start;
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (cell[c] >= 0) {
      order[atomicAdd(&cnt[cell[c]], 1)] = static_cast<short>(c * 1024 + tid);
    }
  }
  __syncthreads();

  // positions below Ns hold the supports, in cell order
  for (int c = 0; c < nc; ++c) {
    const int p = c * 1024 + tid;  // tile c * 32 + w
    float4 pk = padding();
    if (p < ns) pk = pack(sb + order[p] * 3, order[p], mb[order[p]]);
    store_tile(pk, pts, tile_box, b, ntp, c * 32 + w, red, w, lane);
    __syncthreads();
    if (w == 0) store_chunk_box(red, chunk_box, b, ncp, c, lane);
    __syncthreads();
  }
  pad_chunk_boxes(chunk_box, b, ntp, ncp, tid);
}

// The query's signed difference to the nearer face of [lo, hi], rounded
// as dist2_rn rounds q - s; 0 inside.
__device__ __forceinline__ float face_gap(float qv, float lo, float hi) {
  return qv < lo ? __fsub_rn(qv, lo) : (qv > hi ? __fsub_rn(qv, hi) : 0.f);
}

__device__ __forceinline__ float sum_sq(float gx, float gy, float gz) {
  float d2 = __fmul_rn(gx, gx);
  d2 = __fadd_rn(d2, __fmul_rn(gy, gy));
  return __fadd_rn(d2, __fmul_rn(gz, gz));
}

// Lower bound on dist2_rn(q, s) over the valid supports s in box i of a
// box array with row stride n; +inf for an empty box.
__device__ __forceinline__ float box_bound(const float* __restrict__ bx,
                                           int n, int i, float qx, float qy,
                                           float qz) {
  return sum_sq(face_gap(qx, bx[i], bx[3 * n + i]),
                face_gap(qy, bx[n + i], bx[4 * n + i]),
                face_gap(qz, bx[2 * n + i], bx[5 * n + i]));
}

// The smallest key of a valid support in tile t (kNoKey: none).
__device__ __forceinline__ Key tile_min(const float4* __restrict__ pts,
                                        int t, float qx, float qy, float qz,
                                        int lane) {
  const float4 p = pts[t * kTile + lane];
  return warp_min_key(support_d2(p, qx, qy, qz), support_index(p),
                      support_valid(p));
}

// The smallest key over every support of a cloud, valid or masked (its
// d2 biased as the plain version biases it): the nearest support, the
// lowest index on ties (see the header's note, search).
__device__ __noinline__ Key nearest_key(const float4* __restrict__ pts,
                                        const float* __restrict__ tbx,
                                        const float* __restrict__ cbx,
                                        int ns, int ntp, int ncp, float qx,
                                        float qy, float qz, int lane) {
  Key ck = kNoKey;  // the nearest chunk box
  float cb0 = INFINITY;  // the lane's bound of chunk lane, kept
  for (int cc = 0; cc < ncp; cc += 32) {
    const float bound = box_bound(cbx, ncp, cc + lane, qx, qy, qz);
    if (cc == 0) cb0 = bound;
    ck = kmin(ck, warp_min_key(bound, cc + lane, bound < INFINITY));
  }
  Key best = kNoKey;
  if (ck != kNoKey) {
    // its nearest tile box (a chunk with a valid support has such a
    // tile), scanned first
    const int c0 = key_index(ck);
    const float tb0 = box_bound(tbx, ntp, c0 * 32 + lane, qx, qy, qz);
    const int t0 =
        key_index(warp_min_key(tb0, c0 * 32 + lane, tb0 < INFINITY));
    best = tile_min(pts, t0, qx, qy, qz, lane);
    // every chunk, then tile, that could hold a smaller key
    for (int cc = 0; cc < ncp; cc += 32) {
      const float cbound =
          cc == 0 ? cb0 : box_bound(cbx, ncp, cc + lane, qx, qy, qz);
      unsigned cact = __ballot_sync(kFull, cbound <= key_d2(best));
      while (cact) {
        const int c = cc + __ffs(cact) - 1;
        cact &= cact - 1;
        const int t = c * 32 + lane;
        const float bound =
            c == c0 ? tb0 : box_bound(tbx, ntp, t, qx, qy, qz);
        unsigned act = __ballot_sync(kFull, bound <= key_d2(best) && t != t0);
        while (act) {
          const int tt = c * 32 + __ffs(act) - 1;
          act &= act - 1;
          best = kmin(best, tile_min(pts, tt, qx, qy, qz, lane));
          act &= __ballot_sync(kFull, bound <= key_d2(best));
        }
        cact &= __ballot_sync(kFull, cbound <= key_d2(best));
      }
    }
  }
  if (best == kNoKey || key_d2(best) >= kBig) {
    // a masked support's biased d2 may tie or beat the best valid one
    for (int j = lane; j < ns; j += 32) {
      const float4 p = pts[j];
      best = kmin(best, make_key(support_d2(p, qx, qy, qz),
                                 support_index(p)));
    }
    best = warp_min(best);
  }
  return best;
}

// A prepared cloud set's workspace: packed supports [B][ntp * 32], tile
// boxes [B][6][ntp], chunk boxes [B][6][ncp].
struct SupportTiles {
  float4* pts;
  float* tile_box;
  float* chunk_box;
  int ntp, ncp;
};

// Launches the preparation of b clouds of ns supports into `workspace`
// (workspace_floats(b, ns) floats, 16-byte aligned) on `stream`; with
// `repack`, clouds of 97-2048 supports are repacked by Morton cell (the
// ball query's FPS-ordered supports), else every cloud keeps its order.
inline SupportTiles launch_prep(const float* s, const bool* smask, int b,
                                int ns, float* workspace, bool repack,
                                cudaStream_t stream) {
  const int ntp = padded_tiles(ns);
  const int ncp = padded_chunks(ns);
  float4* pts = reinterpret_cast<float4*>(workspace);
  float* tile_box = workspace + static_cast<size_t>(b) * ntp * kTile * 4;
  float* chunk_box = tile_box + static_cast<size_t>(b) * 6 * ntp;
  if (repack && ns <= kSortMax && ns > 3 * kTile) {  // 4 tiles or more
    prep_small_kernel<<<b, 1024, 0, stream>>>(s, smask, ns, ntp, ncp, pts,
                                              tile_box, chunk_box);
  } else {
    prep_kernel<<<dim3(ntp / 32, b), 1024, 0, stream>>>(
        s, smask, ns, ntp, ncp, pts, tile_box, chunk_box);
  }
  return {pts, tile_box, chunk_box, ntp, ncp};
}

}  // namespace
