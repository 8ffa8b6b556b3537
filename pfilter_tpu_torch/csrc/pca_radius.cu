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
// kitti_config() (frontend_tile_cap 5120), ~2.5e4 valid queries meet ~1e8
// (query, candidate) pairs of their 12 m x 12 m halos, of which ~13 % lie in
// the 1 m ball; the bytes that must move (queries, the map, 40 B of sums per
// query) are a few MB.  Testing every halo pair, the first version of this
// kernel took ~25x its operation bound.  Design:
//   * the work list and persistent grid of knn_tiled.cu: items are (query
//     tile, chunk of <= 32 queries), walked round-robin by a grid sized to
//     the card, so no block is spent on an empty tile;
//   * each halo row streams through two shared-memory stages of 1024 slots
//     (x, y, z slices by cp.async.bulk, completed on one mbarrier per stage):
//     the next stage — of this item or the block's next — loads while the
//     current one is culled and summed, and any tile_cap works;
//   * an exact conservative cull at staging time: a candidate is kept only if
//     each of its recentered coordinates lies within `reach` = r + margin of
//     the bounding box of the item's recentered queries.  fp32 d^2 < r^2
//     implies fl(dx*dx) < r^2, so |dx| < r (1 + 2^-23) and no candidate in
//     some query's ball is dropped; the margin (1e-3 m, set by the wrapper)
//     covers the rounding of the box and of the recentering many times over.
//     The cull uses the candidates' coordinates, never tile geometry: the
//     tile sort clamps out-of-window points into the border ring, so a
//     tile's points may lie outside it.  Survivors are compacted in slot
//     order (warp ballots, popcounts, a prefix over the stage's words), so
//     the compaction is deterministic;
//   * the item's 32 queries sit one per lane, and all 8 warps sum them, each
//     warp an interleaved share of the compacted candidates; the 8 partial
//     sums are reduced through shared memory in warp order.  No float
//     atomics: runs are bit-identical, and the result does not depend on the
//     grid size.
// The kernel launches on the caller's stream, allocates nothing and does not
// synchronise.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "async_stage.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // the most queries of a work item: one per lane
constexpr int kStage = 1024;  // slots per stage of a halo row
constexpr int kPitch = kStage + 4;  // a stage slice lands at an offset of up to 3 floats
constexpr int kRounds = kStage / kThreads;  // candidates per thread in a stage
constexpr int kWords = kStage / 32;  // ballot words of a stage
constexpr int kCompact = 1920;  // compacted candidates held before they are summed
constexpr int kMom = 10;

struct Stage {
  int row, base, n;  // slots [start[row] + base, + n) of the item's halo
};

// Stages of an item: each non-empty row in ceil(cnt / kStage) pieces; an item
// whose halo is empty has one empty stage, so every item has at least one.
__device__ __forceinline__ int stage_count(const pf::Halo& h) {
  int s = 0;
#pragma unroll
  for (int r = 0; r < 3; ++r) s += (h.cnt[r] + kStage - 1) / kStage;
  return max(s, 1);
}

__device__ __forceinline__ Stage stage_at(const pf::Halo& h, int s) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int ns = (h.cnt[r] + kStage - 1) / kStage;
    if (s < ns) return Stage{r, s * kStage, min(kStage, h.cnt[r] - s * kStage)};
    s -= ns;
  }
  return Stage{0, 0, 0};
}

// The block's producer: one thread walks the block's stages two ahead of the
// consumers and queues each one's three slices into a free stage buffer.
struct Producer {
  int item, s, ns;
  pf::Halo h;
};

__device__ void producer_load(Producer& pr, int item, const int* __restrict__ tile_start,
                              const int4* __restrict__ work, const float* __restrict__ origin,
                              int nt, int tile_cells, int w) {
  pr.item = item;
  pr.s = 0;
  const pf::WorkItem wi = pf::load_item(work, item);
  pr.h = pf::tile_halo(tile_start, origin, nt, tile_cells, w, wi.tile);
  pr.ns = stage_count(pr.h);
}

__device__ void producer_issue(Producer& pr, int n_items, float* buf, uint64_t* bar,
                               const float* __restrict__ xyz_t, int stride,
                               const int* __restrict__ tile_start, const int4* __restrict__ work,
                               const float* __restrict__ origin, int nt, int tile_cells, int w) {
  if (pr.item >= n_items) return;
  const Stage st = stage_at(pr.h, pr.s);
  const long long e0 = static_cast<long long>(pr.h.start[st.row]) + st.base;
  uint32_t total = 0;
  if (st.n > 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) total += pf::slice_bytes(c * static_cast<long long>(stride) + e0, st.n);
  }
  pf::mbar_arrive_expect_tx(bar, total);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    pf::copy_slice(buf + c * kPitch, xyz_t, c * static_cast<long long>(stride) + e0, st.n, bar);
  }
  if (++pr.s == pr.ns) {
    const int next = pr.item + gridDim.x;
    if (next < n_items) {
      producer_load(pr, next, tile_start, work, origin, nt, tile_cells, w);
    } else {
      pr.item = n_items;
    }
  }
}

__global__ void __launch_bounds__(kThreads) pca_radius_kernel(
    const float* __restrict__ xyz_t, int stride, const int* __restrict__ tile_start,
    const int4* __restrict__ work, const float* __restrict__ origin,
    const float* __restrict__ queries, int nt, int tile_cells, int w, float radius_sq, float reach,
    float* __restrict__ out) {
  __shared__ __align__(128) float stage[2][3][kPitch];
  __shared__ __align__(16) float comp[3][kCompact];  // compacted x', y', z'; then partial sums
  __shared__ uint32_t masks[kWords];
  __shared__ int word_pre[kWords + 1];
  __shared__ float box[6];  // lo x, y, z; hi x, y, z of the item's cull box
  __shared__ uint64_t bar[2];
  static_assert(kWarps * kMom * 32 <= 3 * kCompact, "partial sums must fit the compact buffer");

  const int n_items = work[0].x;
  if (static_cast<int>(blockIdx.x) >= n_items) return;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  Producer pr;
  if (threadIdx.x == 0) {
    pf::mbar_init(&bar[0], 1);
    pf::mbar_init(&bar[1], 1);
    pf::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    producer_load(pr, blockIdx.x, tile_start, work, origin, nt, tile_cells, w);
    for (int b = 0; b < 2; ++b) {
      producer_issue(pr, n_items, &stage[b][0][0], &bar[b], xyz_t, stride, tile_start, work,
                     origin, nt, tile_cells, w);
    }
  }

  int k = 0;  // stages this block has consumed
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const pf::WorkItem wi = pf::load_item(work, item);
    const pf::Halo h = pf::tile_halo(tile_start, origin, nt, tile_cells, w, wi.tile);
    const int ns = stage_count(h);

    // This lane's query (the same in every warp), recentered.
    const bool active = lane < wi.n;
    float qx = 0.f, qy = 0.f, qz = 0.f;
    if (active) {
      const int p = wi.q0 + lane;
      qx = __fsub_rn(queries[3 * p + 0], h.cx);
      qy = __fsub_rn(queries[3 * p + 1], h.cy);
      qz = __fsub_rn(queries[3 * p + 2], h.cz);
    }
    if (warp == 0) {  // the cull box: the queries' bounding box grown by reach
      float lo[3] = {active ? qx : CUDART_INF_F, active ? qy : CUDART_INF_F, active ? qz : CUDART_INF_F};
      float hi[3] = {active ? qx : -CUDART_INF_F, active ? qy : -CUDART_INF_F, active ? qz : -CUDART_INF_F};
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          lo[a] = fminf(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], o));
          hi[a] = fmaxf(hi[a], __shfl_xor_sync(0xffffffffu, hi[a], o));
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          box[a] = __fsub_rn(lo[a], reach);
          box[3 + a] = __fadd_rn(hi[a], reach);
        }
      }
    }
    float acc[kMom];
#pragma unroll
    for (int m = 0; m < kMom; ++m) acc[m] = 0.f;
    __syncthreads();  // box visible; the previous item's partial sums are read
    const float lox = box[0], loy = box[1], loz = box[2];
    const float hix = box[3], hiy = box[4], hiz = box[5];

    int n_comp = 0;  // compacted candidates not yet summed (uniform over the block)
    for (int s = 0; s < ns; ++s, ++k) {
      const int b = k & 1;
      const Stage st = stage_at(h, s);
      const long long e0 = static_cast<long long>(h.start[st.row]) + st.base;
      const float* sx = &stage[b][0][0] + ((0LL * stride + e0) & 3);
      const float* sy = &stage[b][1][0] + ((1LL * stride + e0) & 3);
      const float* sz = &stage[b][2][0] + ((2LL * stride + e0) & 3);
      pf::mbar_wait(&bar[b], (k >> 1) & 1);

      // Cull: one ballot word per 32 candidates, in slot order.
      uint32_t keep = 0;  // bit i: this thread's candidate of round i survives
      float cx[kRounds], cy[kRounds], cz[kRounds];
#pragma unroll
      for (int i = 0; i < kRounds; ++i) {
        const int j = i * kThreads + threadIdx.x;
        bool in = false;
        cx[i] = cy[i] = cz[i] = 0.f;
        if (j < st.n) {
          cx[i] = __fsub_rn(sx[j], h.cx);
          cy[i] = __fsub_rn(sy[j], h.cy);
          cz[i] = __fsub_rn(sz[j], h.cz);
          in = cx[i] >= lox && cx[i] <= hix && cy[i] >= loy && cy[i] <= hiy && cz[i] >= loz &&
               cz[i] <= hiz;
        }
        const uint32_t ballot = __ballot_sync(0xffffffffu, in);
        if (lane == 0) masks[i * kWarps + warp] = ballot;
        keep |= static_cast<uint32_t>(in) << i;
      }
      __syncthreads();
      if (warp == 0) {  // exclusive prefix of the words' popcounts
        const int v = __popc(masks[lane]);
        int incl = v;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int u = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += u;
        }
        word_pre[lane] = incl - v;
        if (lane == 31) word_pre[kWords] = incl;
      }
      __syncthreads();
      const uint32_t below = (1u << lane) - 1u;
#pragma unroll
      for (int i = 0; i < kRounds; ++i) {
        if (keep & (1u << i)) {
          const int word = i * kWarps + warp;
          const int pos = n_comp + word_pre[word] + __popc(masks[word] & below);
          comp[0][pos] = cx[i];
          comp[1][pos] = cy[i];
          comp[2][pos] = cz[i];
        }
      }
      n_comp += word_pre[kWords];
      __syncthreads();  // the stage is read and the compacted candidates are written
      if (threadIdx.x == 0) {
        pf::fence_proxy_async();
        producer_issue(pr, n_items, &stage[b][0][0], &bar[b], xyz_t, stride, tile_start, work,
                       origin, nt, tile_cells, w);
      }

      if (s == ns - 1 || n_comp > kCompact - kStage) {  // sum the compacted candidates
        if (active) {
          for (int j = warp; j < n_comp; j += kWarps) {
            const float x = comp[0][j];
            const float y = comp[1][j];
            const float z = comp[2][j];
            const float dx = __fsub_rn(qx, x);
            const float dy = __fsub_rn(qy, y);
            const float dz = __fsub_rn(qz, z);
            const float d =
                __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
            if (d < radius_sq) {
              acc[0] += 1.f;
              acc[1] += x;
              acc[2] += y;
              acc[3] += z;
              acc[4] += x * x;
              acc[5] += y * y;
              acc[6] += z * z;
              acc[7] += x * y;
              acc[8] += x * z;
              acc[9] += y * z;
            }
          }
        }
        n_comp = 0;
        __syncthreads();  // the compact buffer is free again
      }
    }

    // Reduce the warps' partial sums in warp order.
    float* part = &comp[0][0];
#pragma unroll
    for (int m = 0; m < kMom; ++m) part[(warp * kMom + m) * 32 + lane] = acc[m];
    __syncthreads();
    for (int t = threadIdx.x; t < kMom * 32; t += kThreads) {
      const int m = t >> 5;
      const int l = t & 31;
      if (l < wi.n) {
        float sum = part[m * 32 + l];
        for (int v = 1; v < kWarps; ++v) sum += part[(v * kMom + m) * 32 + l];
        out[(wi.q0 + l) * kMom + m] = sum;
      }
    }
    // The next item's box __syncthreads orders these reads before the buffer's reuse.
  }
}

}  // namespace

// C interface, loaded with ctypes.  `work` is the work list of work_list.cu,
// built with items of at most `chunk` <= 32 queries; `w` is the per-row cap
// 3*tile_cap; `reach` is the cull's r + margin.  Returns
// cudaErrorInvalidValue for a chunk the kernel does not take, else
// cudaGetLastError() after the launch.
extern "C" int pf_pca_radius(const float* xyz_t, int stride, const int* tile_start,
                             const int* work, const float* origin, const float* queries, int nt,
                             int tile_cells, int w, float radius_sq, float reach, int chunk,
                             float* out, void* stream) {
  static int sms = 0, blocks_per_sm = 0;  // read once
  if (chunk < 1 || chunk > kChunk) return static_cast<int>(cudaErrorInvalidValue);
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, pca_radius_kernel,
                                                        kThreads, 0);
    }
    if (e != cudaSuccess) {
      sms = 0;
      return static_cast<int>(e);
    }
  }
  pca_radius_kernel<<<sms * (blocks_per_sm > 0 ? blocks_per_sm : 1), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      xyz_t, stride, tile_start, reinterpret_cast<const int4*>(work), origin, queries, nt,
      tile_cells, w, radius_sq, reach, out);
  return static_cast<int>(cudaGetLastError());
}
