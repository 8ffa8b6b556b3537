// Shared pieces of the tiled kernels (knn_tiled.cu, pca_radius.cu): the
// work item, the halo of a query tile, and Hopper's bulk asynchronous copy
// from global into shared memory, completed on an mbarrier.
//
// Work items.  work_list.cu lists them on the device: tile t's sorted queries
// [bounds[t], bounds[t+1]) cut into chunks of at most `chunk`, as
// work[1 + i] = (tile, first query, query count, 0), with the count in
// work[0].x.  A persistent grid walks the items round-robin
// (item = blockIdx.x + i * gridDim.x) up to that count, read on the device:
// no host sync, no empty blocks, one load to decode an item.
//
// Bulk copies.  cp.async.bulk needs 16-byte aligned addresses and sizes, so a
// slice [e, e + n) of a float array is copied from e rounded down to a
// multiple of 4 elements, rounded up to whole 16-byte units; the reader skips
// the first `off = e % 4` floats of the landed slice and masks the rest.  The
// padding columns of the map's transposed copy (ops/knn_tiled.py,
// transposed_coords) make the over-read stay inside the tensor.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pf {

struct WorkItem {
  int tile;  // query tile
  int q0;    // first sorted query of the item
  int n;     // queries in the item, 1..chunk
};

__device__ __forceinline__ WorkItem load_item(const int4* __restrict__ work, int item) {
  const int4 v = work[1 + item];
  return WorkItem{v.x, v.y, v.z};
}

// The three halo-row slot ranges of query tile t (one per tile row of its
// 3x3 halo), each capped at w slots, and t's recentering point: tile center
// in x and y, window center in z.  The same arithmetic as the plain versions.
struct Halo {
  int start[3];
  int cnt[3];
  float cx, cy, cz;
};

__device__ __forceinline__ Halo tile_halo(const int* __restrict__ tile_start,
                                          const float* __restrict__ origin, int nt,
                                          int tile_cells, int w, int t) {
  Halo h;
  const int tx = t / nt;
  const int ty = t % nt;
  const int ylo = max(ty - 1, 0);
  const int yhi = min(ty + 1, nt - 1);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int row = min(max(tx + r - 1, 0), nt - 1);
    h.start[r] = tile_start[row * nt + ylo];
    h.cnt[r] = min(tile_start[row * nt + yhi + 1] - h.start[r], w);
  }
  const float ts = static_cast<float>(tile_cells);
  h.cx = __fadd_rn(origin[0], __fmul_rn(__fadd_rn(static_cast<float>(tx), 0.5f), ts));
  h.cy = __fadd_rn(origin[1], __fmul_rn(__fadd_rn(static_cast<float>(ty), 0.5f), ts));
  h.cz = __fadd_rn(origin[2], static_cast<float>(nt) * ts * 0.5f);
  return h;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of bulk copies before the phase
// completes; with bytes == 0 it completes the phase at once.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase with this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// Order this thread's earlier generic-proxy accesses to shared memory (the
// block's reads of a stage, made visible to it by __syncthreads) before the
// bulk copy that overwrites the stage.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Bytes of the aligned copy of floats [e, e + n): from e & ~3, whole 16-byte
// units; the slice starts at float (e & 3) of the landed copy.
__device__ __forceinline__ uint32_t slice_bytes(long long e, int n) {
  const int off = static_cast<int>(e & 3);
  return static_cast<uint32_t>(((off + n + 3) & ~3) * 4);
}

// Issue the aligned bulk copy of floats [e, e + n) of `src` to `dst`
// (16-byte aligned); returns its byte count (0 when n == 0: nothing issued).
__device__ __forceinline__ uint32_t copy_slice(float* dst, const float* __restrict__ src,
                                               long long e, int n, uint64_t* bar) {
  if (n <= 0) return 0;
  const uint32_t bytes = slice_bytes(e, n);
  bulk_copy_g2s(dst, src + (e & ~3LL), bytes, bar);
  return bytes;
}

}  // namespace pf
