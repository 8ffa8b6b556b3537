// Radius-neighbourhood PCA moments of tile-sorted queries against a
// tile-sorted point map.
//
// Replaces the TPU kernel pfilter_tpu/ops/pca_radius.py::_pca_kernel
// (launched from radius_pca_moments).  It computes the same function, not the
// same blocks: for each sorted query p in tile t (t found from `bounds`), the
// candidates are the three halo-row slot ranges of t's 3x3 tile halo, each
// capped at w = 3*tile_cap slots; query and candidates are recentered to t's
// center, the fp32 squared distance is dx*dx + dy*dy + dz*dz (each operation
// rounded on its own, no FMA contraction, so the plain PyTorch version in
// ops/pca_radius.py decides ball membership identically), and every candidate
// with d^2 < r^2 adds [1, x, y, z, xx, yy, zz, xy, xz, yz] of its recentered
// coordinates to the query's ten fp32 sums.  Rows of the invalid tile
// (p >= bounds[NT*NT]) are left as the caller zeroed them.
//
// Dropped TPU workarounds: the augmented-coordinate distance matmul and the
// moment matmul (a direct difference and per-pair sums here), the 16-row
// moment padding, the 128-aligned query regions and the gather back (results
// go straight to sorted rows), and the DMA semaphores.
//
// What bounds it on an H100: per frame of the BPF radius front-end at
// kitti_config() (frontend_tile_cap 5120), ~3e4-4e4 valid queries meet
// ~1e8-3e8 (query, candidate) pairs; at ~8 fp32 operations per distance that
// is tens of microseconds at the card's fp32 rate, while the bytes moved
// (queries, the map's coordinates, 40 B of sums per query) are a few MB.
// Design: one block of 128 threads per (query tile, 128-query chunk), so a
// dense near-sensor tile (thousands of queries) spreads over many blocks;
// blocks find their tile by binary search in the per-tile chunk prefix
// `chunk_start` and blocks past the last chunk exit at once.  The halo rows
// do not fit in shared memory at large caps (3 rows x 15,360 slots x 16 B =
// 737 KB at tile_cap 5120), so each row is streamed through a fixed 16 KB
// stage of kChunk float4 (x', y', z', 0) up to min(row count, w) slots; any
// tile_cap works.  One thread per query keeps its ten sums in registers;
// every thread reads the same staged candidate (a shared-memory broadcast).
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 1024;
constexpr int kMom = 10;

__global__ void __launch_bounds__(kThreads) pca_radius_kernel(
    const float* __restrict__ xyz_t, int stride, const int* __restrict__ tile_start,
    const int* __restrict__ bounds, const int* __restrict__ chunk_start,
    const float* __restrict__ origin, const float* __restrict__ queries, int nt, int tile_cells,
    int w, float radius_sq, float* __restrict__ out) {
  __shared__ float4 cand[kChunk];
  const int nt2 = nt * nt;
  const int b = blockIdx.x;
  if (b >= chunk_start[nt2]) return;

  // The tile whose chunk range holds b: the largest t with chunk_start[t] <= b.
  int lo = 0, hi = nt2;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (chunk_start[mid] <= b) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const int t = lo;
  const int p = bounds[t] + (b - chunk_start[t]) * kThreads + threadIdx.x;
  const bool active = p < bounds[t + 1];

  const int tx = t / nt;
  const int ty = t % nt;
  const int ylo = max(ty - 1, 0);
  const int yhi = min(ty + 1, nt - 1);
  int start[3], cnt[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int row = min(max(tx + r - 1, 0), nt - 1);
    start[r] = tile_start[row * nt + ylo];
    cnt[r] = min(tile_start[row * nt + yhi + 1] - start[r], w);
  }
  const float ts = static_cast<float>(tile_cells);
  const float cx = __fadd_rn(origin[0], __fmul_rn(__fadd_rn(static_cast<float>(tx), 0.5f), ts));
  const float cy = __fadd_rn(origin[1], __fmul_rn(__fadd_rn(static_cast<float>(ty), 0.5f), ts));
  const float cz = __fadd_rn(origin[2], static_cast<float>(nt) * ts * 0.5f);

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = __fsub_rn(queries[3 * p + 0], cx);
    qy = __fsub_rn(queries[3 * p + 1], cy);
    qz = __fsub_rn(queries[3 * p + 2], cz);
  }
  float acc[kMom];
#pragma unroll
  for (int m = 0; m < kMom; ++m) acc[m] = 0.f;

  for (int r = 0; r < 3; ++r) {  // start[r], cnt[r] are uniform over the block
    for (int base = 0; base < cnt[r]; base += kChunk) {
      const int n = min(kChunk, cnt[r] - base);
      __syncthreads();  // the previous stage has been read
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int s = start[r] + base + i;
        cand[i] = make_float4(__fsub_rn(xyz_t[s], cx), __fsub_rn(xyz_t[stride + s], cy),
                              __fsub_rn(xyz_t[2 * stride + s], cz), 0.f);
      }
      __syncthreads();
      if (active) {
        for (int j = 0; j < n; ++j) {
          const float4 c = cand[j];
          const float dx = __fsub_rn(qx, c.x);
          const float dy = __fsub_rn(qy, c.y);
          const float dz = __fsub_rn(qz, c.z);
          const float d =
              __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
          if (d < radius_sq) {
            acc[0] += 1.f;
            acc[1] += c.x;
            acc[2] += c.y;
            acc[3] += c.z;
            acc[4] += c.x * c.x;
            acc[5] += c.y * c.y;
            acc[6] += c.z * c.z;
            acc[7] += c.x * c.y;
            acc[8] += c.x * c.z;
            acc[9] += c.y * c.z;
          }
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int m = 0; m < kMom; ++m) out[p * kMom + m] = acc[m];
  }
}

}  // namespace

// C interface, loaded with ctypes.  Returns cudaGetLastError() after the launch.
extern "C" int pf_pca_radius(const float* xyz_t, int stride, const int* tile_start,
                             const int* bounds, const int* chunk_start, const float* origin,
                             const float* queries, int nt, int tile_cells, int w, float radius_sq,
                             int n_blocks, float* out, void* stream) {
  pca_radius_kernel<<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xyz_t, stride, tile_start, bounds, chunk_start, origin, queries, nt, tile_cells, w,
      radius_sq, out);
  return static_cast<int>(cudaGetLastError());
}
