// Backward gathers that recompute each slot's term from dy (K1b in
// pospool_xyz.cu, K5b in pospool_sincos.cu, K9b in moments.cu; K8b in
// neighborhood_max.cu, whose launch 1 writes g from the ties, and K7b in
// gather_reduce.cu, whose launch 1 writes the shares of the max and min
// ties and dd), in two launches over a reverse neighbor index
// (reverse_index.cuh) built in query tiles:
//
//   1. index_scale_kernel: each cloud's queries are cut into `tiles`
//      tiles of `per` consecutive queries (the last may hold fewer), and
//      block b * tiles + i builds the index of tile i of cloud b alone:
//      its own offsets [Ns + 1], and, in the cloud's slot range of the
//      tile, each entry's tile-local query (not its slot id: the gathers
//      need q alone, and the index's threads divide by K once an entry
//      where the gather's lanes would each divide). B * tiles blocks so
//      share the work that B blocks would do: the index's passes are
//      bound by each SM's scattered shared atomics and 4-byte stores, and
//      one block a cloud left 100 of the 132 SMs idle at B = 32. For avg,
//      the other blocks, beside them, write each query's g = dy /
//      max(n_q, 1) rounded to T (n_q: the query's mask count); for sum g
//      is dy itself.
//   2. the kernel's own gather: `lanes` consecutive threads own a support
//      row and a slice of its channel units (row_item); for each entry of
//      the row, tile by tile and in each tile in the index's order, i.e.
//      in (q, t) order, every lane loads q's position and its units of
//      g[q], recomputes D from the row's own position, adds the term to
//      f32 accumulators that start at +0, and writes its units once in T
//      (zeros where no slot names the row).
//
// The sum of a row's terms is thus in the order of the plain twins'
// index_add_ on CPU tensors, with no float atomics, no zeroed scratch, no
// cast, and the same bits on every run. Unlike the per-slot terms of K6b
// and K10b (launch 1 writes them, launch 2 reads them back: 8C bytes a
// valid slot), a term here is a cheap function of g[q] and D, so nothing
// per slot goes through memory but the index. Tiles cost the gather a
// walk per tile that holds a row's entries, which FPS-ordered queries
// spread over every tile: the wrapper takes them only where a cloud has
// many slots (ops/reverse_index.py index_tiles).
#pragma once

#include "reverse_index.cuh"

namespace {

// Threads of a launch-1 block: two blocks an SM (at most 64 registers a
// thread), so that the scaling blocks run beside the latency-bound index
// blocks rather than after them.
constexpr int kIndexThreads = 512;
constexpr int kMaxTiles = 16;  // query tiles a cloud at most
constexpr int kScaleUnroll = 4;  // vectors a thread loads at once

// Rows [r0, r1) of g = dy / max(n, 1) rounded to T (n: the row's mask
// count), by one block: the counts of kIndexThreads rows at a time in
// shared memory, then every (row, vector) of them a thread, kScaleUnroll
// vectors in flight; 16-byte vectors where kVec, else single values.
template <typename T, bool kVec>
__device__ void scale_rows(const bool* __restrict__ mask,
                           const T* __restrict__ dy, T* __restrict__ g,
                           long long r0, long long r1, int k, int width) {
  constexpr int kW = kVec ? 16 / sizeof(T) : 1;
  struct alignas(kW * sizeof(T)) Raw {
    T v[kW];
  };
  __shared__ float s_n[kIndexThreads];
  const int vpr = width / kW;  // vectors a row
  for (long long c0 = r0; c0 < r1; c0 += kIndexThreads) {
    const int rows = static_cast<int>(min(r1 - c0, 1LL * kIndexThreads));
    __syncthreads();  // the last chunk's counts are read
    if (threadIdx.x < rows) {
      const bool* m = mask + (c0 + threadIdx.x) * k;
      int n = 0;
      for (int t = 0; t < k; ++t) n += m[t];
      s_n[threadIdx.x] = static_cast<float>(max(n, 1));
    }
    __syncthreads();
    const Raw* src = reinterpret_cast<const Raw*>(dy + c0 * width);
    Raw* dst = reinterpret_cast<Raw*>(g + c0 * width);
    const int total = rows * vpr;
    for (int i0 = threadIdx.x; i0 < total;
         i0 += kIndexThreads * kScaleUnroll) {
      Raw v[kScaleUnroll];
#pragma unroll
      for (int u = 0; u < kScaleUnroll; ++u) {
        const int i = i0 + u * kIndexThreads;
        if (i < total) v[u] = src[i];
      }
#pragma unroll
      for (int u = 0; u < kScaleUnroll; ++u) {
        const int i = i0 + u * kIndexThreads;
        if (i < total) {
          const float cnt = s_n[i / vpr];
#pragma unroll
          for (int w = 0; w < kW; ++w)
            v[u].v[w] = from_f32<T>(__fdiv_rn(to_f32(v[u].v[w]), cnt));
          dst[i] = v[u];
        }
      }
    }
  }
}

// An index block of a launch 1 (blockIdx.x < B * tiles): the index of
// tile blockIdx.x % tiles of cloud blockIdx.x / tiles (see the header).
template <bool kShared>
__device__ __forceinline__ void index_tile(
    const int32_t* __restrict__ idx, const bool* __restrict__ mask, int nq,
    int ns, int k, int tiles, int per, int* s_cnt,
    int32_t* __restrict__ offsets, int32_t* __restrict__ slots,
    int32_t* __restrict__ raw, int* __restrict__ counters) {
  const int b = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - b * tiles) * per;
  const size_t first = (static_cast<size_t>(b) * nq + q0) * k;
  const size_t counts = static_cast<size_t>(blockIdx.x) * (ns + 1);
  build_reverse_index<kIndexThreads, kShared, true>(
      idx + first, mask + first, max(0, min(per, nq - q0)), ns, k, 0, s_cnt,
      offsets + counts, slots + first, raw + first, counters + counts);
}

// Launch 1 (see the header): blocks [0, B * tiles) build the tiles'
// indexes, the rest (avg only) scale `per_block` rows of dy each.
template <typename T, bool kShared, bool kVec>
__global__ void __launch_bounds__(kIndexThreads, 2)
    index_scale_kernel(const int32_t* __restrict__ idx,
                       const bool* __restrict__ mask,
                       const T* __restrict__ dy, int clouds, int nq, int ns,
                       int k, int tiles, int per, int width,
                       long long per_block, int32_t* __restrict__ offsets,
                       int32_t* __restrict__ slots, int32_t* __restrict__ raw,
                       int* __restrict__ counters, T* __restrict__ g) {
  extern __shared__ int s_cnt[];
  const int index_blocks = clouds * tiles;
  if (blockIdx.x < index_blocks) {
    index_tile<kShared>(idx, mask, nq, ns, k, tiles, per, s_cnt, offsets,
                        slots, raw, counters);
    return;
  }
  const long long r0 = (blockIdx.x - index_blocks) * per_block;
  scale_rows<T, kVec>(mask, dy, g, r0,
                      min(r0 + per_block, static_cast<long long>(clouds) * nq),
                      k, width);
}

template <typename T, bool kVec>
void launch_index_scale_as(const int32_t* idx, const bool* mask, const T* dy,
                           int b, int nq, int ns, int k, int tiles, int width,
                           int avg, int32_t* offsets, int32_t* slots,
                           int32_t* raw, int* counters, T* g,
                           cudaStream_t stream) {
  static const int room =
      dynamic_smem_room(index_scale_kernel<T, true, kVec>);
  const int per = (nq + tiles - 1) / tiles;
  // avg: the rows spread over about two blocks an SM
  const long long rows = static_cast<long long>(b) * nq;
  const long long per_block =
      std::max(1LL, (rows + 2LL * sm_count() - 1) / (2LL * sm_count()));
  const int blocks =
      b * tiles + (avg ? static_cast<int>((rows + per_block - 1) / per_block)
                       : 0);
  const int smem = (ns + 1) * static_cast<int>(sizeof(int));
  if (smem <= room)
    index_scale_kernel<T, true, kVec>
        <<<blocks, kIndexThreads, smem, stream>>>(
            idx, mask, dy, b, nq, ns, k, tiles, per, width, per_block,
            offsets, slots, raw, counters, g);
  else
    index_scale_kernel<T, false, kVec><<<blocks, kIndexThreads, 0, stream>>>(
        idx, mask, dy, b, nq, ns, k, tiles, per, width, per_block, offsets,
        slots, raw, counters, g);
}

// Launch 1 for dy [B, Nq, width] in T; g [B, Nq, width] is written only
// for avg (the caller then gathers from g, else from dy). offsets and
// counters hold B * tiles rows of Ns + 1.
template <typename T>
void launch_index_scale(const int32_t* idx, const bool* mask, const T* dy,
                        int b, int nq, int ns, int k, int tiles, int width,
                        int avg, int32_t* offsets, int32_t* slots,
                        int32_t* raw, int* counters, T* g,
                        cudaStream_t stream) {
  if (vec_ok<T>(width, dy, g))
    launch_index_scale_as<T, true>(idx, mask, dy, b, nq, ns, k, tiles,
                                   width, avg, offsets, slots, raw, counters,
                                   g, stream);
  else
    launch_index_scale_as<T, false>(idx, mask, dy, b, nq, ns, k, tiles,
                                    width, avg, offsets, slots, raw,
                                    counters, g, stream);
}

// The entries of support row `row` of cloud b, tile by tile in order:
// for each tile i that has some, visit(tile_entries, start, end, q0), its
// entries tile_entries[start .. end), an entry's query q0 plus the entry.
// The tiles' bounds are loaded at once; a tile with no entry costs
// nothing more.
template <typename Visit>
__device__ __forceinline__ void for_each_entry_tile(
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ entries,
    size_t b, int nq, int ns, int k, int tiles, int per, int row,
    Visit visit) {
  unsigned used = 0;  // tiles with entries
#pragma unroll
  for (int i = 0; i < kMaxTiles; ++i) {
    if (i < tiles) {
      const int32_t* off = offsets + (b * tiles + i) * (ns + 1) + row;
      used |= (off[1] > off[0] ? 1u : 0u) << i;
    }
  }
  while (used) {
    const int i = __ffs(used) - 1;
    used &= used - 1;
    const int32_t* off = offsets + (b * tiles + i) * (ns + 1) + row;
    visit(entries + (b * nq + static_cast<size_t>(i) * per) * k, off[0],
          off[1], i * per);
  }
}

// ---- launch 2's layout: `lanes` threads a row ------------------------------

constexpr int kRowThreads = 256;  // threads of a gather block
constexpr int kMaxRowLanes = 64;  // lanes a row at most; wider rows slice

// How a row's `units` (the kernel's channel units) are cut: `slices` items
// a row of `lanes` lanes, one unit a lane. Lanes need not be a power of
// two (9 at C = 72 bf16): nothing in the gathers is warp-wide, and a
// block of kRowThreads holds kRowThreads / lanes rows.
struct RowSplit {
  int lanes, slices;
};
inline RowSplit row_split(int units) {
  const int slices = (units + kMaxRowLanes - 1) / kMaxRowLanes;
  return {(units + slices - 1) / slices, slices};
}

inline dim3 row_grid(int b, int ns, RowSplit sp) {
  const int rows = kRowThreads / sp.lanes;  // a block's
  return dim3((ns + rows - 1) / rows * sp.slices, b);
}

// The calling thread's row of cloud blockIdx.y and its unit, in a grid of
// row_grid: blocks take consecutive rows (the slices of one block's rows
// adjacent), so that rows that share queries share L1 and L2 lines.
struct RowItem {
  bool live;
  int row, unit;
};
__device__ __forceinline__ RowItem row_item(int ns, int units, int lanes,
                                            int slices) {
  const int rows = kRowThreads / lanes;
  const int local = threadIdx.x / lanes;
  const int row = blockIdx.x / slices * rows + local;
  const int unit = blockIdx.x % slices * lanes + (threadIdx.x - local * lanes);
  return {local < rows && row < ns && unit < units, row, unit};
}

// kN consecutive values of T at p into out, in loads of up to 16 bytes (p
// aligned to them).
template <typename T, int kN>
__device__ __forceinline__ void load_run(const T* __restrict__ p,
                                         T (&out)[kN]) {
  constexpr int kBytes = kN * sizeof(T) < 16 ? kN * sizeof(T) : 16;
  constexpr int kPer = kBytes / sizeof(T);
  struct alignas(kBytes) Raw {
    T v[kPer];
  };
#pragma unroll
  for (int i = 0; i < kN; i += kPer) {
    const Raw r = *reinterpret_cast<const Raw*>(p + i);
#pragma unroll
    for (int u = 0; u < kPer; ++u) out[i + u] = r.v[u];
  }
}

// kN f32 values rounded to T, stored at p as load_run reads them.
template <typename T, int kN>
__device__ __forceinline__ void store_run(T* __restrict__ p,
                                          const float (&x)[kN]) {
  constexpr int kBytes = kN * sizeof(T) < 16 ? kN * sizeof(T) : 16;
  constexpr int kPer = kBytes / sizeof(T);
  struct alignas(kBytes) Raw {
    T v[kPer];
  };
#pragma unroll
  for (int i = 0; i < kN; i += kPer) {
    Raw r;
#pragma unroll
    for (int u = 0; u < kPer; ++u) r.v[u] = from_f32<T>(x[i + u]);
    *reinterpret_cast<Raw*>(p + i) = r;
  }
}

}  // namespace
