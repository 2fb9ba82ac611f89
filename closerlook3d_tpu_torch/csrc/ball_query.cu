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
//   1. A preparation pass packs each support as a float4 (x, y, z, its
//      index with bit 31 set if masked; NaN past Ns) into a workspace the
//      wrapper allocates, and writes each tile's box over its *valid*
//      supports (empty: lo = +inf, hi = -inf) and each chunk's (32
//      tiles') box. A cloud of 97 to 2048 supports (prep_small_kernel,
//      one block a cloud) is packed by a counting sort over 16^3 Morton
//      cells: FPS picks, which later stages query, are spread over the
//      whole cloud, so their tiles in input order prune nothing. Larger
//      clouds arrive sorted (the loader's Morton order, grid_subsample's
//      voxel order) and keep their order (prep_kernel, a block a chunk),
//      as do clouds of at most 3 tiles. Keys carry the original index,
//      so the order of the scan changes nothing in the result.
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
//   3. A candidate is the unique 64-bit key (f32 bits of d2) << 32 |
//      index: d2 >= 0, so the keys order as (d2, index), the stable
//      sort's order. In-radius keys go to a per-warp buffer in shared
//      memory. When it would overflow, each key's rank (the count of
//      smaller keys) places the K smallest; at the end the ranks place
//      them in a row buffer that the warp writes out coalesced.
//   4. A row with no in-radius support still needs slot 0, the exact
//      nearest: the nearest chunk's nearest tile first, then every chunk
//      and tile whose bound is <= the best d2 so far. If that best is
//      >= 1e10 (or the cloud has no valid support) a masked support could
//      tie or win with its bias, so every support is scanned.
//   5. r2 >= 1e10 (radius >= 1e5) makes masked supports valid
//      neighbors; the boxes know only valid ones, so nothing is pruned.
//
// Bound on the H100: latency and issue slots. Per query a dependent chain
// of loads (its list's tile boxes, then each tile scanned) and ~40
// instructions a tile, plus the ranking; the in-radius pairs (the work a
// perfect pruner does) are far below the card's f32 rate, and the bytes
// (points, masks, idx and mask) are a few MB.

#include "common.cuh"

namespace {

constexpr int kMaxK = 64;     // list length held per query
constexpr int kWarps = 8;     // warps a block, one query each at a time
constexpr int kTile = 32;     // supports per tile, one per lane
constexpr int kCap = 128;     // keys buffered per warp
constexpr int kMaxGroup = 64; // queries per block, sharing a tile list
constexpr int kMaxCand = 96;  // tiles a block's list holds (3 sweeps)
constexpr int kBlocksPerSM = 4;  // resident, by the launch bounds
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

// The same for every query in [glo, ghi] at once: never larger in size
// than any of their face_gap values, rounded the same way.
__device__ __forceinline__ float group_gap(float glo, float ghi, float lo,
                                           float hi) {
  return ghi < lo ? __fsub_rn(ghi, lo)
                  : (glo > hi ? __fsub_rn(glo, hi) : 0.f);
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

// The smallest key of a valid support in tile t (kNoKey: none).
__device__ __forceinline__ Key tile_min(const float4* __restrict__ pts,
                                        int t, float qx, float qy, float qz,
                                        int lane) {
  const float4 p = pts[t * kTile + lane];
  return warp_min(support_valid(p)
                      ? make_key(support_d2(p, qx, qy, qz), support_index(p))
                      : kNoKey);
}

// Slot 0 of a row with no in-radius support: the index of the smallest
// key over every support (see the design note, 4).
__device__ __noinline__ int nearest_index(const float4* __restrict__ pts,
                                          const float* __restrict__ tbx,
                                          const float* __restrict__ cbx,
                                          int ns, int ntp, int ncp, float qx,
                                          float qy, float qz, int lane) {
  Key ck = kNoKey;  // the nearest chunk box
  for (int cc = 0; cc < ncp; cc += 32) {
    const float bound = box_bound(cbx, ncp, cc + lane, qx, qy, qz);
    if (bound < INFINITY) ck = kmin(ck, make_key(bound, cc + lane));
  }
  ck = warp_min(ck);
  Key best = kNoKey;
  if (ck != kNoKey) {
    // its nearest tile box (a chunk with a valid support has such a tile)
    const int t0 = key_index(ck) * 32 + lane;
    const float tb0 = box_bound(tbx, ntp, t0, qx, qy, qz);
    best = tile_min(pts, key_index(warp_min(
                             tb0 < INFINITY ? make_key(tb0, t0) : kNoKey)),
                    qx, qy, qz, lane);
    // every chunk, then tile, that could hold a smaller key
    for (int cc = 0; cc < ncp; cc += 32) {
      const float cbound = box_bound(cbx, ncp, cc + lane, qx, qy, qz);
      unsigned cact = __ballot_sync(kFull, cbound <= key_d2(best));
      while (cact) {
        const int c = cc + __ffs(cact) - 1;
        cact &= cact - 1;
        const float bound = box_bound(tbx, ntp, c * 32 + lane, qx, qy, qz);
        unsigned act = __ballot_sync(kFull, bound <= key_d2(best));
        while (act) {
          const int t = c * 32 + __ffs(act) - 1;
          act &= act - 1;
          best = kmin(best, tile_min(pts, t, qx, qy, qz, lane));
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
  return key_index(best);
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
      first = nearest_index(pb, tbx, cbx, ns, ntp, ncp, qx, qy, qz, lane);
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
  const int ntp = padded_tiles(ns);
  const int ncp = padded_chunks(ns);
  float4* pts = reinterpret_cast<float4*>(workspace);
  float* tile_box = workspace + static_cast<size_t>(b) * ntp * kTile * 4;
  float* chunk_box = tile_box + static_cast<size_t>(b) * 6 * ntp;
  if (ns <= kSortMax && ns > 3 * kTile) {  // 4 tiles or more
    prep_small_kernel<<<b, 1024, 0, stream>>>(s, smask, ns, ntp, ncp, pts,
                                              tile_box, chunk_box);
  } else {
    prep_kernel<<<dim3(ntp / 32, b), 1024, 0, stream>>>(
        s, smask, ns, ntp, ncp, pts, tile_box, chunk_box);
  }
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
      q, qmask, pts, tile_box, chunk_box, nq, ns, ntp, ncp, k, r2, group,
      out_idx, out_mask);
  return static_cast<int>(cudaGetLastError());
}
