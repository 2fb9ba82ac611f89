// The reverse (CSR) neighbor index alone (reverse_index.cuh), one block
// of 1024 threads per cloud, one launch: what the backward gathers of K6
// and K10 build in their first launch, exposed for the tests and the card
// checks that hold it to its plain version
// (ops/reverse_index.py::reverse_index_plain), and for later backward
// gathers. Output per cloud b: offsets [Ns + 1] and slots [Nq * K], each
// row's slot ids q * K + t in ascending order.
//
// Bound on the H100: bytes (idx and mask read once, 5 bytes a slot; the
// offsets and the valid slots written once); with one block per cloud
// (32 blocks at B = 32 on 132 SMs) a call is latency-bound instead.

#include "reverse_index.cuh"

namespace {

constexpr int kThreads = 1024;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    reverse_index_kernel(const int32_t* __restrict__ idx,
                         const bool* __restrict__ mask, int nq, int ns,
                         int k, int32_t* __restrict__ offsets,
                         int32_t* __restrict__ slots,
                         int32_t* __restrict__ raw,
                         int* __restrict__ counters) {
  extern __shared__ int s_cnt[];
  build_reverse_index<kThreads, kShared>(idx, mask, nq, ns, k, blockIdx.x,
                                         s_cnt, offsets, slots, raw,
                                         counters);
}

// Rows whose counters fit in shared memory on this device.
int shared_rows() {
  static const int rows =
      dynamic_smem_room(reverse_index_kernel<true>) /
          static_cast<int>(sizeof(int)) -
      1;
  return rows;
}

}  // namespace

// offsets [B, Ns + 1], slots and raw (scratch) [B, Nq * K], counters
// (scratch, used where Ns exceeds shared memory) [B, Ns + 1]; all int32,
// none zeroed by the caller.
extern "C" int cl3d_reverse_index(const int32_t* idx, const bool* mask, int b,
                                  int nq, int ns, int k, int32_t* offsets,
                                  int32_t* slots, int32_t* raw, int* counters,
                                  cudaStream_t stream) {
  if (b < 1 || b > 65535 || nq < 0 || ns < 1 || k < 1 ||
      static_cast<long long>(nq) * k > INT_MAX - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ns <= shared_rows()) {
    reverse_index_kernel<true>
        <<<b, kThreads, (ns + 1) * sizeof(int), stream>>>(
            idx, mask, nq, ns, k, offsets, slots, raw, counters);
  } else {
    reverse_index_kernel<false><<<b, kThreads, 0, stream>>>(
        idx, mask, nq, ns, k, offsets, slots, raw, counters);
  }
  return static_cast<int>(cudaGetLastError());
}
