// Greedy furthest point sampling over masked clouds.
//
// Replaces: closerlook3d_tpu/ops/pallas/sampling.py:_fps_kernel (entry
// furthest_point_sample_pallas).
//
// Semantics are the jnp reference's (closerlook3d_tpu/ops/sampling.py):
//   the seed is the first valid point, or 0 for an all-masked cloud (the
//   jnp argmax; the Pallas kernel would give N there); invalid points hold
//   mindist -1 and so are picked only once every valid point is; each
//   step takes d = ((x-sx)^2 + (y-sy)^2) + (z-sz)^2 rounded to f32 at every
//   step, mindist = min(mindist, d), and the next pick is the argmax of
//   mindist with the lowest index on ties; sample_mask = slot < nvalid.
//
// Layout: a CTA a cloud; thread t owns the PPT consecutive points from
// t * PPT on, with their coordinates and running mindist in registers. So
// index order is the order of (warp, lane, point), and a reduce needs only
// the largest mindist and its first holder. A pick, with every thread
// holding the last pick's coordinates:
//   1. each thread updates its points' mindist and takes its best: the
//      max by a tree of fmaxf, then its first holder (index, coordinates).
//      Pruning, in a CTA of kPruneWarps warps or more: each thread first
//      bounds the new distances of its points from below by the distance
//      to their bounding box (each step rounded as dist2_rn rounds it, so
//      the bound is at most every computed distance); where that is at
//      least the thread's largest mindist, no point of the thread changes,
//      and a warp whose lanes all find so skips the pick's updates and its
//      reduce. Clouds come Morton-sorted, so a warp's points are close
//      together and, once the first picks have spread, most warps skip
//      most picks. That pays only where the updates of many warps wait
//      for issue slots; with fewer warps one warp's update sets the pace
//      and the bound would only add to it;
//   2. each warp takes the max of an order-preserving uint32 key of its
//      lanes' best mindist (sign-clear bits | 0x80000000, else ~bits: -inf
//      < -1 < +0 < ... < 1e10) by one redux.sync, and its first lane
//      holding it (ballot): argmax's lowest-index rule;
//   3. that lane writes the key to its warp's slot of the pick's buffer in
//      shared memory, and the point's coordinates and index beside it;
//   4. one __syncthreads;
//   5. every warp reads the (at most 32) slots' keys, takes their max and
//      its first slot as in 2, and reads that slot's point: every thread
//      learns the pick and its coordinates with no second barrier and no
//      global load.
// A cloud that one warp holds (at most 128 points) skips 3-5: the warp's
// pick is the cloud's, shuffled from its lane.
//
// The slot buffers alternate by pick parity, and one barrier a pick is
// enough: a warp past barrier `it` writes buffer (it + 1) & 1 while a
// slower warp may still read buffer it & 1, another buffer; it writes
// buffer it & 1 again only at pick it + 2, past barrier it + 1, which no
// warp reaches before it has read buffer it & 1 at pick it.
//
// Bound on the H100: the npoint steps are sequential, so the kernel is
// bound by each pick's chain (the distance updates of the warps that do
// not skip, a warp reduce, a barrier, a reduce of the slots), not by
// bytes or FLOPs: with no update at all, a pick of 20 warps takes ~770
// cycles (PERF.md). Splitting a cloud over the 2 or 4 CTAs of a thread
// block cluster (slots in distributed shared memory, a cluster barrier a
// pick) cuts each SM's share of the updates but measured slower at every
// call of the models (PERF.md); tools/variants/fps_cluster.json rebuilds
// it as a source variant. N up to 16384 (PPT up to 16, where registers
// spill, which stays correct).

#include <climits>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;     // threads of a CTA at most
constexpr int kMaxPPT = 16;           // points a thread at most
constexpr int kWarpPoints = 128;      // clouds of at most this many: a warp
constexpr int kMinPPT = 8;            // points a thread at least
constexpr int kPruneWarps = 16;       // warps a CTA from which it prunes

// Sign-clear floats map above 0x80000000 in their order, negative ones
// below it in reverse order: unsigned order is float order.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The largest key over the warp (one redux.sync), and the first lane
// holding it.
struct Best {
  unsigned key;
  int lane;
};
__device__ __forceinline__ Best warp_best(unsigned key) {
  const unsigned k = __reduce_max_sync(kFull, key);
  return {k, __ffs(__ballot_sync(kFull, key == k)) - 1};
}

// The distance from s to [lo, hi] along one axis, rounded as dist2_rn's
// difference of a point in it: at most that difference's magnitude (+inf
// for an empty box, lo = +inf and hi = -inf). Branch-free: a select chain
// here cost a quarter of the largest call's time.
__device__ __forceinline__ float gap(float s, float lo, float hi) {
  return fmaxf(fmaxf(__fsub_rn(lo, s), __fsub_rn(s, hi)), 0.f);
}

template <int PPT>
__global__ void __launch_bounds__(kMaxThreads)
fps_kernel(const float* __restrict__ xyz, const bool* __restrict__ mask,
           int n, int npoint, int32_t* __restrict__ out_idx,
           bool* __restrict__ out_mask) {
  // a pick's slots, by parity: the warp's key, and its point (x, y, z,
  // index as bits)
  __shared__ unsigned s_key[2][32];
  __shared__ float4 s_pt[2][32];
  __shared__ int s_first[32];
  __shared__ int s_count[32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* x = xyz + static_cast<size_t>(b) * n * 3;
  const bool* m = mask + static_cast<size_t>(b) * n;
  const int lo = tid * PPT;  // this thread's first point
  const int mine = max(0, min(PPT, n - lo));

  float px[PPT], py[PPT], pz[PPT], md[PPT];
  // the thread's bounding box (empty: +inf .. -inf, never reached)
  float x0 = INFINITY, x1 = -INFINITY, y0 = INFINITY, y1 = -INFINITY,
        z0 = INFINITY, z1 = -INFINITY;
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    if (p < mine) {
      const int i = lo + p;
      px[p] = x[i * 3 + 0];
      py[p] = x[i * 3 + 1];
      pz[p] = x[i * 3 + 2];
      md[p] = m[i] ? 1e10f : -1.f;
      x0 = fminf(x0, px[p]);
      x1 = fmaxf(x1, px[p]);
      y0 = fminf(y0, py[p]);
      y1 = fmaxf(y1, py[p]);
      z0 = fminf(z0, pz[p]);
      z1 = fmaxf(z1, pz[p]);
    } else {
      px[p] = py[p] = pz[p] = 0.f;
      md[p] = -INFINITY;  // never wins the argmax, and fminf keeps it
    }
  }
  // the seed and nvalid
  int first = INT_MAX;
  int count = 0;
  for (int i = tid; i < n; i += blockDim.x) {
    if (m[i]) {
      first = min(first, i);
      ++count;
    }
  }
  first = __reduce_min_sync(kFull, first);
  count = __reduce_add_sync(kFull, count);
  if (lane == 0) {
    s_first[warp] = first;
    s_count[warp] = count;
  }
  __syncthreads();
  first = __reduce_min_sync(kFull, lane < nwarps ? s_first[lane] : INT_MAX);
  const int nvalid = __reduce_add_sync(kFull,
                                       lane < nwarps ? s_count[lane] : 0);
  int cur = first == INT_MAX ? 0 : first;
  for (int slot = tid; slot < npoint; slot += blockDim.x) {
    out_mask[static_cast<size_t>(b) * npoint + slot] = slot < nvalid;
  }
  float sx = x[cur * 3 + 0];
  float sy = x[cur * 3 + 1];
  float sz = x[cur * 3 + 2];

  // the thread's best point, and the warp's best key and first lane
  float bv = INFINITY, bx = 0.f, by = 0.f, bz = 0.f;
  int bi = 0;
  Best w = {0u, 0};
  int32_t* out = out_idx + static_cast<size_t>(b) * npoint;
  const bool prune = nwarps >= kPruneWarps;  // uniform across the CTA
  for (int it = 0;; ++it) {
    if (tid == 0) out[it] = cur;
    if (it + 1 == npoint) break;  // the next pick would go unused
    bool skip = false;
    if (prune) {
      const float dx = gap(sx, x0, x1), dy = gap(sy, y0, y1),
                  dz = gap(sz, z0, z1);
      const float bound = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                              __fmul_rn(dy, dy)),
                                    __fmul_rn(dz, dz));
      skip = __all_sync(kFull, bound >= bv);
    }
    if (!skip) {
      float t[PPT];  // the max by a tree, then its first holder
#pragma unroll
      for (int p = 0; p < PPT; ++p) {
        md[p] = fminf(md[p], dist2_rn(px[p], py[p], pz[p], sx, sy, sz));
        t[p] = md[p];
      }
#pragma unroll
      for (int h = PPT / 2; h > 0; h /= 2)
#pragma unroll
        for (int p = 0; p < h; ++p) t[p] = fmaxf(t[p], t[p + h]);
      bv = t[0];
#pragma unroll
      for (int p = PPT - 1; p >= 0; --p) {
        if (md[p] == bv) {
          bi = p;
          bx = px[p];
          by = py[p];
          bz = pz[p];
        }
      }
      w = warp_best(order_key(bv));
    }
    if (nwarps == 1) {  // uniform: the warp's pick is the cloud's
      cur = __shfl_sync(kFull, lo + bi, w.lane);
      sx = __shfl_sync(kFull, bx, w.lane);
      sy = __shfl_sync(kFull, by, w.lane);
      sz = __shfl_sync(kFull, bz, w.lane);
      continue;
    }
    const int par = it & 1;
    if (lane == w.lane) {
      s_key[par][warp] = w.key;
      s_pt[par][warp] = make_float4(bx, by, bz, __int_as_float(lo + bi));
    }
    __syncthreads();
    const Best c = warp_best(lane < nwarps ? s_key[par][lane] : 0u);
    const float4 pt = s_pt[par][c.lane];
    cur = __float_as_int(pt.w);
    sx = pt.x;
    sy = pt.y;
    sz = pt.z;
  }
}

using KernelFn = void (*)(const float*, const bool*, int, int, int32_t*,
                          bool*);

// A launch's shape: PPT points a thread, `threads` threads a CTA.
struct Plan {
  int ppt, threads;
  KernelFn kernel() const {
    switch (ppt) {
      case 1:
        return fps_kernel<1>;
      case 2:
        return fps_kernel<2>;
      case 4:
        return fps_kernel<4>;
      case 8:
        return fps_kernel<8>;
      default:
        return fps_kernel<16>;
    }
  }
};

// One warp for a cloud of at most kWarpPoints; else at least kMinPPT points
// a thread (a power of two), more where n points need them to fit in 32
// warps (the slots a warp reduces: at most 32 a pick).
Plan plan_for(int n) {
  int ppt = 1;
  if (n <= kWarpPoints) {
    while (32 * ppt < n) ppt *= 2;
    return {ppt, 32};
  }
  ppt = kMinPPT;
  while (ppt * kMaxThreads < n) ppt *= 2;
  return {ppt, ((n + ppt - 1) / ppt + 31) / 32 * 32};
}

}  // namespace

extern "C" int cl3d_fps_max_points() { return kMaxPPT * kMaxThreads; }

// The launch plan at n points a cloud: points a thread, threads a CTA.
extern "C" void cl3d_fps_plan(int n, int* ppt, int* threads) {
  const Plan p = plan_for(n);
  *ppt = p.ppt;
  *threads = p.threads;
}

extern "C" int cl3d_fps(const float* xyz, const bool* mask, int b, int n,
                        int npoint, int32_t* out_idx, bool* out_mask,
                        cudaStream_t stream) {
  if (b < 1 || n < 1 || n > kMaxPPT * kMaxThreads || npoint < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan_for(n);
  p.kernel()<<<b, p.threads, 0, stream>>>(xyz, mask, n, npoint, out_idx,
                                          out_mask);
  return static_cast<int>(cudaGetLastError());
}
