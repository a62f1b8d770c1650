// splat_zbuf_rows and splat_payload_rows: the two merge passes of the
// surface-splat renderer (ops/render_fast.py).
//
// Replace the TPU kernels splat_zbuf_rows (K4) and splat_payload_rows
// (K5) of disinfect_slam_tpu/ops/pallas/splat_kernel.py.  Those keep the
// whole z-buffer in VMEM, build a compact [16, 32] patch per surface
// block with masked lane reductions, roll it into an aligned window and
// send blocks whose footprint does not fit through a capped XLA scatter;
// they read [S, 512] planes of floor pixels and depths that XLA wrote.
//
// Both kernels here take the surface blocks' positions and pool indices,
// the pose (a device pointer, read once per CTA) and the camera, and project each voxel in registers from its
// tsdf word, read in place from the pool (splat_project.cuh): no [S, 512]
// plane is written or read.  The kernels only read pool rows; the live
// rows' pool indices are unique on both backends (dense: ascending; hash:
// in hash-slot order) and no order is assumed.  Both run a persistent grid of CTAs (K4: 512
// threads, a voxel each; K5: 128 threads, four voxels each), one
// surface-block row at a time up to the live count they read on the
// device, and reduce the row's footprint box (splat_zbuf_tile.cuh).
//
// K4 merges each row's footprint in a shared-memory tile of kTileH x
// kTileW pixels and sends the tile's pixels to the z-buffer with one
// global atomicMin each; rows whose footprint does not fit (near the
// camera) merge per voxel with global atomics (splat_zbuf_tile.cuh, where
// the design and its bound are described; the tile shape is the one the
// probe's sweep chose, splat_probe.cu).
//
// K5, for a row whose box fits the tile: stages the box's window of the
// final z-buffer into shared memory once (coalesced reads); each band
// voxel compares its depth with the staged depth at its <= 4 footprint
// pixels; only a voxel that wins a pixel reads its RGBW word and
// probability, in place from the pool, packs its payload word and
// atomicMax-es it into a shared u32 tile; the flush then issues one global
// atomicMax per box pixel with a nonzero word, skipped where a plain read
// already shows a value >= the word (safe: values only rise), and resets
// the tile.  Neighbouring voxels tie at a pixel by construction, so the
// global atomics fall from one per won footprint pixel to at most one per
// covered pixel per block.  A row whose box does not fit takes the
// per-voxel global path: the z-buffer read at each footprint pixel, one
// global atomicMax per won pixel.  The staged window beats reading the
// z-buffer at each footprint pixel through the read-only cache on the H100
// at this layout (scripts/port_render_stage.py, PERF.md).
//
// What bounds K5: device memory bytes: 16 B of block position and pool
// index per live row, 4 B of tsdf per live voxel, the z-buffer read once,
// 8 B of RGBW word and probability per winning voxel, the payload buffer
// written once.
//
// Min and max do not depend on the order of the updates, and a zero word
// merges nothing either way, so the buffers equal the plain torch scatter
// reductions bit for bit on either branch, with no footprint limit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "persistent_grid.cuh"
#include "splat_zbuf_tile.cuh"

namespace {

constexpr int kTileH = 32, kTileW = 32;

// (p8 << 24) | (r << 16) | (g << 8) | b from the stored RGBW word
// (r | g << 8 | b << 16 | w << 24) and the probability, p8 = clip(prob *
// 255, 0, 255) truncated (render_fast.pack_payload_rgbw)
__device__ __forceinline__ uint32_t payload_word(const uint32_t* rgbw, const float* prob,
                                                 int pool, int t) {
  const size_t pv = static_cast<size_t>(pool) * kSplatVoxels + t;
  const uint32_t w = __ldg(rgbw + pv);
  const uint32_t p8 = static_cast<uint32_t>(fminf(fmaxf(__ldg(prob + pv) * 255.f, 0.f), 255.f));
  return (p8 << 24) | ((w & 0xFFu) << 16) | (((w >> 8) & 0xFFu) << 8) | ((w >> 16) & 0xFFu);
}

// K5's CTA: 128 threads of 4 voxels each (voxel t + 128 j).  A row's
// fixed costs (its box reductions, three barriers, the window and flush
// loops) fall on a quarter of the threads of K4's layout, a thread's four
// projections overlap each other's latency, and 8 rows run at once on an
// SM instead of 4; a tuning sweep on the H100 found it faster than 64, 256
// and 512 threads a row, and the persistent grid faster than one CTA a
// row.
constexpr int kPayloadVoxelsPerThread = 4;
constexpr int kPayloadThreads = kSplatVoxels / kPayloadVoxelsPerThread;
constexpr int kPayloadWarps = kPayloadThreads / 32;

template <int TH, int TW>
__global__ void __launch_bounds__(kPayloadThreads, 8) splat_payload_tile_kernel(
    const BlockRows in, const uint32_t* __restrict__ rgbw, const float* __restrict__ prob,
    const int* __restrict__ count, int rows, int img_h, int img_w,
    const int* __restrict__ zbuf, uint32_t* __restrict__ pbuf, int* __restrict__ branches) {
  constexpr int kVpt = kPayloadVoxelsPerThread, kThreads = kPayloadThreads;
  __shared__ int zwin[TH * TW];        // the row's window of the final z-buffer
  __shared__ uint32_t ptile[TH * TW];  // the row's payload merge, 0 between rows
  __shared__ int part[2][4][kPayloadWarps];
  __shared__ SplatPose pose;
  const int t = threadIdx.x;
  const int n = min(__ldg(count), rows);
  in.load_pose(&pose);
  for (int i = t; i < TH * TW; i += kThreads) ptile[i] = 0;
  __syncthreads();

  // the software pipeline of splat_zbuf_tile_kernel: the current row's
  // inputs and the next row's pool row; during the current row, the next
  // row's inputs and the pool row of the one after it are loaded
  int row = blockIdx.x;
  BlockRows::Raw<kVpt> raw{};
  int pool_next = 0;
  if (row < n) raw = in.load<kVpt>(row, in.pool_row(row), t);
  if (row + gridDim.x < n) pool_next = in.pool_row(row + gridDim.x);

  for (int it = 0; row < n; row += gridDim.x, ++it) {
    const int r1 = row + gridDim.x, r2 = r1 + gridDim.x;
    BlockRows::Raw<kVpt> raw_next{};
    int pool_after = 0;
    if (r1 < n) raw_next = in.load<kVpt>(r1, pool_next, t);
    if (r2 < n) pool_after = in.pool_row(r2);

    SplatVoxel vox[kVpt];
    SplatBox box = empty_box();
#pragma unroll
    for (int j = 0; j < kVpt; ++j) {
      vox[j] = in.voxel(raw, t, j, pose);
      grow_box(box, vox[j], img_h, img_w);
    }
    box = reduce_box<kPayloadWarps>(box, part[it & 1]);
    if (box.bu <= box.eu) {
      const int bw = box.eu - box.bu + 1, bh = box.ev - box.bv + 1;
      if (bw <= TW && bh <= TH) {
        // the previous row's merges read zwin before its second barrier
        for (int i = t; i < bw * bh; i += kThreads) {
          zwin[i] = __ldcg(zbuf + static_cast<size_t>(box.bv + i / bw) * img_w + box.bu +
                           i % bw);
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kVpt; ++j) {
          if (vox[j].dq >= kSplatBig) continue;
          int won[4];
          bool any = false;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            int u, v;
            won[k] = -1;
            if (footprint_uv(vox[j].u0, vox[j].v0, k, img_h, img_w, &u, &v)) {
              const int i = (v - box.bv) * bw + (u - box.bu);
              if (zwin[i] == vox[j].dq) won[k] = i;
            }
            any |= won[k] >= 0;
          }
          if (any) {
            const uint32_t word = payload_word(rgbw, prob, raw.pool, t + kThreads * j);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (won[k] >= 0) atomicMax(&ptile[won[k]], word);
            }
          }
        }
        __syncthreads();
        for (int i = t; i < bw * bh; i += kThreads) {
          const uint32_t w = ptile[i];
          if (w) {
            ptile[i] = 0;
            uint32_t* p = pbuf + static_cast<size_t>(box.bv + i / bw) * img_w + box.bu + i % bw;
            if (__ldcg(p) < w) atomicMax(p, w);
          }
        }
        // the next row's __syncthreads orders these resets before its merges
        if (t == 0 && branches) atomicAdd(branches, 1);
      } else {
#pragma unroll
        for (int j = 0; j < kVpt; ++j) {
          if (vox[j].dq >= kSplatBig) continue;
          int won[4];
          bool any = false;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int q = footprint_pixel(vox[j].u0, vox[j].v0, k, img_h, img_w);
            won[k] = (q >= 0 && __ldg(zbuf + q) == vox[j].dq) ? q : -1;
            any |= won[k] >= 0;
          }
          if (any) {
            const uint32_t word = payload_word(rgbw, prob, raw.pool, t + kThreads * j);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (won[k] >= 0) atomicMax(pbuf + won[k], word);
            }
          }
        }
        if (t == 0 && branches) atomicAdd(branches + 1, 1);
      }
    }
    raw = raw_next;
    pool_next = pool_after;
  }
}

}  // namespace

// The rows: block_pos i32 [rows, 3], pool_idx i32 [rows], count i32 []
// live rows, the tsdf pool f32 [num_blocks, 512]; pose12: a device pointer
// to r00..r22, t0..t2; intrinsics4: fx, fy, cx, cy; consts4: voxel_size,
// truncation, max_depth, band_tsdf (host floats, as torch rounds them).  branches: null, or two
// counters that take the rows merged through the tile and through the
// per-voxel atomics.
extern "C" int dst_splat_zbuf_rows(const int* block_pos, const int* pool_idx,
                                   const int* count, int rows, int num_blocks,
                                   const float* tsdf, const float* pose12,
                                   const float* intrinsics4, const float* consts4,
                                   int img_h, int img_w, int* zbuf, int* branches,
                                   void* stream) {
  if (rows > 0) {
    auto kernel = splat_zbuf_tile_kernel<kTileH, kTileW>;
    static const int ctas = resident_ctas(kernel, kSplatVoxels);
    kernel<<<min(rows, ctas), kSplatVoxels, 0, static_cast<cudaStream_t>(stream)>>>(
        block_rows(block_pos, pool_idx, num_blocks, tsdf, pose12, intrinsics4, img_h, img_w,
                   consts4),
        count, rows, img_h, img_w, zbuf, branches);
  }
  return static_cast<int>(cudaGetLastError());
}

// the rows and scalars of dst_splat_zbuf_rows; rgbw, prob [num_blocks,
// 512] the pool's payload; zbuf the final z-buffer; pbuf the payload
// buffer, zeroed
extern "C" int dst_splat_payload_rows(const int* block_pos, const int* pool_idx,
                                      const int* count, int rows, int num_blocks,
                                      const float* tsdf, const uint32_t* rgbw,
                                      const float* prob, const float* pose12,
                                      const float* intrinsics4, const float* consts4,
                                      int img_h, int img_w, const int* zbuf,
                                      uint32_t* pbuf, int* branches, void* stream) {
  if (rows > 0) {
    auto kernel = splat_payload_tile_kernel<kTileH, kTileW>;
    static const int ctas = resident_ctas(kernel, kPayloadThreads);
    kernel<<<min(rows, ctas), kPayloadThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        block_rows(block_pos, pool_idx, num_blocks, tsdf, pose12, intrinsics4, img_h, img_w,
                   consts4),
        rgbw, prob, count, rows, img_h, img_w, zbuf, pbuf, branches);
  }
  return static_cast<int>(cudaGetLastError());
}
