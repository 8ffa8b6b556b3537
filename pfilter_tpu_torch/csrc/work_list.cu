// The work list of the tiled kernels (knn_tiled.cu, pca_radius.cu).
//
// No TPU kernel corresponds to it: the Pallas kernels walk a grid of query
// tiles in order.  Here a persistent grid takes work items, and this kernel
// lists them.  Tile t's sorted queries [bounds[t], bounds[t+1]) are cut into
// chunks of at most `chunk`; the items are the chunks of tile 0, then of tile
// 1, and so on.  `work` is int4 [1 + max_items]: work[0].x holds the item
// count, and work[1 + i] = (tile, first query, query count, 0) for item i.
// The plain version is ops/knn_tiled.py::work_list_plain.
//
// What bounds it: ~16 KB of `bounds` read and ~16 B per item written, so
// latency; one block of 1024 threads scans the NT*NT tile counts (a few per
// thread, a warp-shuffle scan and a scan of the warp totals) and writes each
// tile's items.  Computing the list once per call takes a binary search over a
// prefix (a dozen dependent loads) out of every item's critical path.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ int chunks_of(const int* __restrict__ bounds, int t, int chunk) {
  return (bounds[t + 1] - bounds[t] + chunk - 1) / chunk;
}

__global__ void __launch_bounds__(kThreads) work_list_kernel(const int* __restrict__ bounds,
                                                             int nt2, int chunk,
                                                             int4* __restrict__ work) {
  __shared__ int warp_pre[32];
  const int per = (nt2 + kThreads - 1) / kThreads;
  const int t0 = min(static_cast<int>(threadIdx.x) * per, nt2);
  const int t1 = min(t0 + per, nt2);
  int mine = 0;
  for (int t = t0; t < t1; ++t) mine += chunks_of(bounds, t, chunk);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_pre[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = warp_pre[lane];
    int inc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += u;
    }
    warp_pre[lane] = inc - v;
    if (lane == 31) work[0] = make_int4(inc, 0, 0, 0);
  }
  __syncthreads();
  int item = warp_pre[warp] + incl - mine;  // this thread's first item
  for (int t = t0; t < t1; ++t) {
    const int lo = bounds[t];
    const int hi = bounds[t + 1];
    for (int q0 = lo; q0 < hi; q0 += chunk) work[1 + item++] = make_int4(t, q0, min(chunk, hi - q0), 0);
  }
}

}  // namespace

// C interface, loaded with ctypes.  `work` holds at least 1 + (the item
// count) int4; the wrapper sizes it for Q / chunk + min(NT*NT, Q) items.
// Returns cudaGetLastError() after the launch.
extern "C" int pf_work_list(const int* bounds, int nt2, int chunk, int* work, void* stream) {
  work_list_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      bounds, nt2, chunk, reinterpret_cast<int4*>(work));
  return static_cast<int>(cudaGetLastError());
}
