// Tiled exact 5-NN of tile-sorted queries against a tile-sorted point map.
//
// Replaces the TPU kernel pfilter_tpu/ops/knn_tiled.py::_knn_kernel (launched
// from query_tiled_sorted).  It computes the same function, not the same
// blocks: for each sorted query p in tile t (t found from `bounds`), the
// candidates are the three halo-row slot ranges of t's 3x3 tile halo, each
// capped at w = 3*tile_cap slots; both the query and every candidate are
// recentered to t's center, the fp32 squared distance is dx*dx + dy*dy + dz*dz
// (each operation rounded on its own, no FMA contraction, so the plain PyTorch
// version in ops/knn_tiled.py reproduces it bit for bit), and an exact top-5 is
// kept ascending under the total order (distance, halo position), the
// position of candidate j of halo row r being r*w + j: ties go to the
// candidate the plain version's stable sort puts first.  That is the lower
// slot wherever the three rows are distinct; a query tile in the window's
// first or last tile row has a row read twice, and a slot tied with itself or
// with another there keeps that order too.  Results are written straight
// into the sorted-query rows; queries of the invalid tile (p >=
// bounds[NT*NT]) and empty result slots get inf and index 0.
//
// Dropped TPU workarounds: the packed (distance | lane) int32 keys (exact fp32
// distances here), the 128-aligned exclusive output regions and the gather
// back, and the augmented-coordinate matmul (a direct difference after
// recentering is exact).  The map is read through the transposed copy
// xyz_t [4, stride] the map already keeps (rows x, y, z; invalid slots at
// 1e4), so one halo row is one contiguous slice per coordinate.
//
// What bounds it on an H100: at kitti_config() shapes (<= 2,048 edge or
// 8,192 surf queries, tens to hundreds of live candidates per halo) the work
// is ~1e4-1e6 (query, candidate) pairs, ~10 MFLOP and ~1 MB of reads:
// nanoseconds at the card's rates, so latency bounds it — the launch, the
// wait for each halo's bytes, and the serial scan of one query.  Design:
//   * a compact work list (work_list.cu): items are (query tile, chunk of
//     <= `chunk` queries; the wrapper uses 8), walked round-robin by a
//     persistent grid sized to the card (blocks per SM from the occupancy
//     calculator, the SM count read once), so no block is spent on an empty
//     tile and a dense tile spreads over many blocks;
//   * several lanes per query: an item of n queries gives each query a group
//     of G = min(32, 128 / pow2ceil(n)) lanes; each lane scans an interleaved
//     share of the staged halo with its own top-5 in registers, and the group
//     merges its top-5s with warp shuffles under the same (distance,
//     position) order — the top-5 under a total order is unique, so the
//     result equals the plain version bit for bit, ties included; positions
//     become slots only when the result is written;
//   * the halo's nine row-coordinate slices land in shared memory by bulk
//     asynchronous copies (cp.async.bulk, completed on an mbarrier), double
//     buffered across a block's items: the next item's halo loads while the
//     current one is scanned.  Candidates are recentered on read.
// Tensor cores are not used, on purpose: a TF32 or bf16 product would change
// the distances and so the top-5, and the fp32 work is microseconds at most.
// The kernel launches on the caller's stream, allocates nothing and does not
// synchronise.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "async_stage.cuh"

namespace {

constexpr int kK = 5;
constexpr int kThreads = 128;
constexpr int kRowSlices = 9;  // 3 halo rows x 3 coordinates per staged item
constexpr int kBufs = 2;  // staged items in flight per block
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ bool key_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// Insert (d, i) into the ascending top-5 under the (distance, position) order.
__device__ __forceinline__ void insert_key(float (&bd)[kK], int (&bi)[kK], float d, int i) {
  if (!key_less(d, i, bd[kK - 1], bi[kK - 1])) return;
  bd[kK - 1] = d;
  bi[kK - 1] = i;
#pragma unroll
  for (int m = kK - 1; m > 0; --m) {
    if (key_less(bd[m], bi[m], bd[m - 1], bi[m - 1])) {
      const float td = bd[m];
      bd[m] = bd[m - 1];
      bd[m - 1] = td;
      const int ti = bi[m];
      bi[m] = bi[m - 1];
      bi[m - 1] = ti;
    }
  }
}

// Queue the bulk copies of `item`'s halo into `buf` on `bar`.  Called by one
// thread; an item whose halo is empty still completes the barrier's phase.
__device__ void issue_item(float* buf, uint64_t* bar, const float* __restrict__ xyz_t,
                           int stride, const int* __restrict__ tile_start,
                           const int4* __restrict__ work, const float* __restrict__ origin,
                           int nt, int tile_cells, int w, int pitch, int item) {
  const pf::WorkItem wi = pf::load_item(work, item);
  const pf::Halo h = pf::tile_halo(tile_start, origin, nt, tile_cells, w, wi.tile);
  uint32_t total = 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      if (h.cnt[r] > 0) total += pf::slice_bytes(static_cast<long long>(c) * stride + h.start[r], h.cnt[r]);
    }
  }
  pf::mbar_arrive_expect_tx(bar, total);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      pf::copy_slice(buf + (c * 3 + r) * pitch, xyz_t,
                     static_cast<long long>(c) * stride + h.start[r], h.cnt[r], bar);
    }
  }
}

__global__ void __launch_bounds__(kThreads) knn_tiled_kernel(
    const float* __restrict__ xyz_t, int stride, const int* __restrict__ tile_start,
    const int* __restrict__ bounds, const int4* __restrict__ work,
    const float* __restrict__ origin, const float* __restrict__ queries, int n_queries, int nt,
    int tile_cells, int w, int pitch, int* __restrict__ out_idx, float* __restrict__ out_sqdist) {
  extern __shared__ __align__(128) float stage[];  // kBufs x 9 slices x pitch floats
  __shared__ uint64_t bar[kBufs];
  const int nt2 = nt * nt;

  // Queries of the invalid tile are never matched.
  for (int p = bounds[nt2] + blockIdx.x * kThreads + threadIdx.x; p < n_queries;
       p += gridDim.x * kThreads) {
#pragma unroll
    for (int m = 0; m < kK; ++m) {
      out_sqdist[p * kK + m] = CUDART_INF_F;
      out_idx[p * kK + m] = 0;
    }
  }
  const int n_items = work[0].x;
  if (static_cast<int>(blockIdx.x) >= n_items) return;

  if (threadIdx.x == 0) {
    for (int b = 0; b < kBufs; ++b) pf::mbar_init(&bar[b], 1);
    pf::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int b = 0; b < kBufs; ++b) {
      const int item = blockIdx.x + b * gridDim.x;
      if (item < n_items) {
        issue_item(stage + b * kRowSlices * pitch, &bar[b], xyz_t, stride, tile_start, work,
                   origin, nt, tile_cells, w, pitch, item);
      }
    }
  }

  int k = 0;  // items this block has consumed
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++k) {
    const int b = k % kBufs;
    const float* buf = stage + b * kRowSlices * pitch;
    const pf::WorkItem wi = pf::load_item(work, item);
    const pf::Halo h = pf::tile_halo(tile_start, origin, nt, tile_cells, w, wi.tile);

    // Lanes per query: G = min(32, kThreads / pow2ceil(n)), a power of two.
    const int lg = 32 - __clz(wi.n - 1);  // ceil(log2 n); 0 for n == 1
    const int g_lanes = min(32, kThreads >> lg);
    const int grp = threadIdx.x / g_lanes;
    const int lane = threadIdx.x % g_lanes;
    const bool active = grp < wi.n;
    const int p = wi.q0 + grp;

    float bd[kK];
    int bi[kK];
#pragma unroll
    for (int m = 0; m < kK; ++m) {
      bd[m] = CUDART_INF_F;
      bi[m] = 0;
    }
    pf::mbar_wait(&bar[b], (k / kBufs) & 1);
    if (active) {
      const float qx = __fsub_rn(queries[3 * p + 0], h.cx);
      const float qy = __fsub_rn(queries[3 * p + 1], h.cy);
      const float qz = __fsub_rn(queries[3 * p + 2], h.cz);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const float* sx = buf + (0 * 3 + r) * pitch + ((0LL * stride + h.start[r]) & 3);
        const float* sy = buf + (1 * 3 + r) * pitch + ((1LL * stride + h.start[r]) & 3);
        const float* sz = buf + (2 * 3 + r) * pitch + ((2LL * stride + h.start[r]) & 3);
        // A lane's share ascends in position, so a strict comparison keeps
        // the lower position among equal distances.
        for (int j = lane; j < h.cnt[r]; j += g_lanes) {
          const float dx = __fsub_rn(qx, __fsub_rn(sx[j], h.cx));
          const float dy = __fsub_rn(qy, __fsub_rn(sy[j], h.cy));
          const float dz = __fsub_rn(qz, __fsub_rn(sz[j], h.cz));
          const float d =
              __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
          if (d < bd[kK - 1]) {
            bd[kK - 1] = d;
            bi[kK - 1] = r * w + j;
#pragma unroll
            for (int m = kK - 1; m > 0; --m) {
              if (bd[m] < bd[m - 1]) {
                const float td = bd[m];
                bd[m] = bd[m - 1];
                bd[m - 1] = td;
                const int ti = bi[m];
                bi[m] = bi[m - 1];
                bi[m - 1] = ti;
              }
            }
          }
        }
      }
    }
    // Merge the group's top-5s (butterfly over the group's lanes; every lane
    // of the warp takes part, inactive groups with empty lists).
    for (int o = g_lanes >> 1; o > 0; o >>= 1) {
      float pd[kK];
      int pi[kK];
#pragma unroll
      for (int m = 0; m < kK; ++m) {
        pd[m] = __shfl_xor_sync(0xffffffffu, bd[m], o);
        pi[m] = __shfl_xor_sync(0xffffffffu, bi[m], o);
      }
#pragma unroll
      for (int m = 0; m < kK; ++m) insert_key(bd, bi, pd[m], pi[m]);
    }
    if (active && lane == 0) {
#pragma unroll
      for (int m = 0; m < kK; ++m) {
        // Position r*w + j back to slot start[r] + j; selects rather than
        // start[r], which would move the halo to local memory.
        const int pos = bi[m];
        const int slot = pos < w ? h.start[0] + pos
                                 : (pos < 2 * w ? h.start[1] + pos - w : h.start[2] + pos - 2 * w);
        out_sqdist[p * kK + m] = bd[m];
        out_idx[p * kK + m] = isfinite(bd[m]) ? slot : 0;
      }
    }
    __syncthreads();  // every read of this buffer is done
    if (threadIdx.x == 0) {
      const int next = item + kBufs * gridDim.x;
      if (next < n_items) {
        pf::fence_proxy_async();
        issue_item(stage + b * kRowSlices * pitch, &bar[b], xyz_t, stride, tile_start, work,
                   origin, nt, tile_cells, w, pitch, next);
      }
    }
  }
}

}  // namespace

// C interface, loaded with ctypes.  `work` is the work list of work_list.cu,
// built with items of at most `chunk` queries; `w` is the per-row cap
// 3*tile_cap.  Returns a CUDA error code: cudaErrorInvalidValue for a chunk
// or cap the kernel does not take, else cudaGetLastError() after the launch.
extern "C" int pf_knn_tiled(const float* xyz_t, int stride, const int* tile_start,
                            const int* bounds, const int* work, const float* origin,
                            const float* queries, int n_queries, int nt, int tile_cells, int w,
                            int chunk, int* out_idx, float* out_sqdist, void* stream) {
  static int sms = 0;           // SMs of the card, read once
  static int set_smem = -1;     // the dynamic shared memory the attribute was set for
  static int blocks_per_sm = 0;
  if (chunk < 1 || chunk > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int pitch = (w + 6) & ~3;  // w floats after an offset of up to 3, in 16-byte units
  const long long smem = static_cast<long long>(kBufs) * kRowSlices * pitch * sizeof(float);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) {
      sms = 0;
      return static_cast<int>(e);
    }
  }
  if (smem != set_smem) {
    cudaError_t e = cudaFuncSetAttribute(knn_tiled_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, knn_tiled_kernel,
                                                        kThreads, static_cast<size_t>(smem));
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    set_smem = static_cast<int>(smem);
  }
  const int grid = sms * (blocks_per_sm > 0 ? blocks_per_sm : 1);
  knn_tiled_kernel<<<grid, kThreads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      xyz_t, stride, tile_start, bounds, reinterpret_cast<const int4*>(work), origin, queries,
      n_queries, nt, tile_cells, w, pitch, out_idx, out_sqdist);
  return static_cast<int>(cudaGetLastError());
}
