// The z-buffer merge of the splat renderer with a shared-memory footprint
// tile per surface block: the body of splat_zbuf_rows (splat_rows.cu) and
// of the tile-shape sweep of its probe (splat_probe.cu), with the row
// inputs and the footprint box reduction that splat_payload_rows shares.
//
// Replaces the TPU kernel splat_zbuf_rows (K4,
// disinfect_slam_tpu/ops/pallas/splat_kernel.py), which builds a compact
// [16, 32] patch per surface block in VMEM and sends blocks whose
// footprint does not fit through a capped XLA scatter.  The same merge in
// fast memory, on Hopper: each CTA takes one surface-block row at a time
// (a persistent loop up to the live count it reads on the device, with
// the next row's inputs loaded while the current row merges), projects
// its voxels (BlockRows, splat_project.cuh; the rows' pool indices are
// unique on both backends, in no assumed order, and only read), reduces
// the bounding box of its
// in-band voxels' in-image 2x2 footprints (warp reductions, then each
// warp over the 16 partials), and
//   - if the box fits a TH x TW tile, min-merges the voxels into the tile
//     with shared-memory atomicMin, then issues one global atomicMin per
//     covered tile pixel, skipped where a plain read of the z-buffer
//     already shows a value <= the tile's (safe: values only fall), and
//     resets the pixels it sent, so the tile is clean for the next row;
//   - otherwise (a block near the camera with a large footprint) takes the
//     per-voxel global atomics of the earlier kernel.
// Min does not depend on the order of the updates, so the z-buffer equals
// the plain scatter-min (render_fast.zbuf_scatter) bit for bit on either
// branch.  The global atomics fall from up to 4 per band voxel to at most
// one per covered pixel per block.
//
// What bounds it: device memory bytes (16 B of block position and pool
// index per live row, 4 B of tsdf per live voxel, the z-buffer written
// once) once the atomics that tie at one pixel are merged on chip.
#pragma once
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "splat_project.cuh"

namespace {

// Pixel (u, v) of footprint pixel k (du = k >> 1, dv = k & 1) of a voxel
// whose floor pixel is (u0, v0); false off the image.  Unsigned sums wrap
// instead of overflowing, so u0 = -1 keeps its du = 1 pixel only and a
// saturated floor (INT_MAX) keeps none.
__device__ __forceinline__ bool footprint_uv(int u0, int v0, int k, int img_h, int img_w,
                                             int* u, int* v) {
  const unsigned uu = static_cast<unsigned>(u0) + static_cast<unsigned>(k >> 1);
  const unsigned vv = static_cast<unsigned>(v0) + static_cast<unsigned>(k & 1);
  *u = static_cast<int>(uu);
  *v = static_cast<int>(vv);
  return uu < static_cast<unsigned>(img_w) && vv < static_cast<unsigned>(img_h);
}

// Pixel index of footprint pixel k, or -1 off the image
__device__ __forceinline__ int footprint_pixel(int u0, int v0, int k, int img_h, int img_w) {
  int u, v;
  return footprint_uv(u0, v0, k, img_h, img_w, &u, &v) ? v * img_w + u : -1;
}

// The rows of K4 and K5: surface blocks by block position and pool index,
// each voxel projected from its tsdf word, read in place from the pool.
// A row's inputs come in two steps, so that the dependent load is issued
// a row ahead: pool_row() is the pool row (clipped into the pool, as the
// plain version clips it), load<N>() the tsdf words of a thread's N voxels
// (t + j * 512 / N: K4 takes one a thread, K5 four) and the block
// position.  The pose lives in device memory (a captured CUDA graph
// replays with each frame's pose): each CTA reads it once into shared
// memory with load_pose() and hands it to voxel().
struct BlockRows {
  const int* block_pos;  // i32 [rows, 3]
  const int* pool_idx;   // i32 [rows]
  const float* tsdf;     // f32 [num_blocks, 512]
  const float* pose12;   // f32 [12] in device memory: r00..r22, t0..t2
  int num_blocks;
  SplatCamera cam;
  SplatConsts consts;

  // the pose into the CTA's shared `pose` (the caller syncs before use)
  __device__ __forceinline__ void load_pose(SplatPose* pose) const {
    if (threadIdx.x < 12) reinterpret_cast<float*>(pose)[threadIdx.x] = __ldg(pose12 + threadIdx.x);
  }

  template <int N>
  struct Raw {
    float tsdf[N];
    int bx, by, bz, pool;
  };

  __device__ __forceinline__ int pool_row(int row) const {
    return min(max(__ldg(pool_idx + row), 0), num_blocks - 1);
  }
  template <int N>
  __device__ __forceinline__ Raw<N> load(int row, int pool, int t) const {
    Raw<N> r;
    const float* words = tsdf + static_cast<size_t>(pool) * kSplatVoxels + t;
#pragma unroll
    for (int j = 0; j < N; ++j) r.tsdf[j] = __ldg(words + (kSplatVoxels / N) * j);
    r.bx = __ldg(block_pos + 3 * row);
    r.by = __ldg(block_pos + 3 * row + 1);
    r.bz = __ldg(block_pos + 3 * row + 2);
    r.pool = pool;
    return r;
  }
  // the j-th of the thread's N voxels
  template <int N>
  __device__ __forceinline__ SplatVoxel voxel(const Raw<N>& r, int t, int j,
                                              const SplatPose& pose) const {
    return splat_project(r.bx, r.by, r.bz, t + (kSplatVoxels / N) * j, r.tsdf[j], pose, cam,
                         consts);
  }
};

// The rows of K4 and K5 from the C entries' arguments: pose12 a device
// pointer to r00..r22, t0..t2; intrinsics4 fx, fy, cx, cy and consts4
// voxel_size, truncation, max_depth, band_tsdf on the host.
BlockRows block_rows(const int* block_pos, const int* pool_idx, int num_blocks,
                     const float* tsdf, const float* pose12, const float* intrinsics4,
                     int img_h, int img_w, const float* consts4) {
  BlockRows in{};
  in.block_pos = block_pos;
  in.pool_idx = pool_idx;
  in.tsdf = tsdf;
  in.pose12 = pose12;
  in.num_blocks = num_blocks;
  in.cam = SplatCamera{intrinsics4[0], intrinsics4[1], intrinsics4[2], intrinsics4[3],
                       img_h, img_w};
  in.consts = SplatConsts{consts4[0], consts4[1], consts4[2], consts4[3]};
  return in;
}

// A row's footprint box, [bu, eu] x [bv, ev]; empty (bu > eu) when no
// footprint pixel of the row lies in the image.  The box lies in the
// image, so its sides are at most img_w, img_h.
struct SplatBox {
  int bu, bv, eu, ev;
};

__device__ __forceinline__ SplatBox empty_box() {
  return SplatBox{INT_MAX, INT_MAX, INT_MIN, INT_MIN};
}

// Grow `box` by the in-image footprint pixels of a band voxel
__device__ __forceinline__ void grow_box(SplatBox& box, const SplatVoxel& vox, int img_h,
                                         int img_w) {
  if (vox.dq >= kSplatBig) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int u, v;
    if (footprint_uv(vox.u0, vox.v0, k, img_h, img_w, &u, &v)) {
      box.bu = min(box.bu, u);
      box.eu = max(box.eu, u);
      box.bv = min(box.bv, v);
      box.ev = max(box.ev, v);
    }
  }
}

// The row's box from each thread's part of it, for every thread of a CTA
// of NW warps: warp reductions, then each warp over the NW partials in
// `part` (one of two sets that alternate between rows: a warp may write
// the next row's while another still reads this row's).  One
// __syncthreads.
template <int NW>
__device__ __forceinline__ SplatBox reduce_box(SplatBox box, int (*part)[NW]) {
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  box.bu = __reduce_min_sync(all, box.bu);
  box.bv = __reduce_min_sync(all, box.bv);
  box.eu = __reduce_max_sync(all, box.eu);
  box.ev = __reduce_max_sync(all, box.ev);
  if (lane == 0) {
    part[0][warp] = box.bu;
    part[1][warp] = box.bv;
    part[2][warp] = box.eu;
    part[3][warp] = box.ev;
  }
  __syncthreads();
  const bool has = lane < NW;
  return SplatBox{__reduce_min_sync(all, has ? part[0][lane] : INT_MAX),
                  __reduce_min_sync(all, has ? part[1][lane] : INT_MAX),
                  __reduce_max_sync(all, has ? part[2][lane] : INT_MIN),
                  __reduce_max_sync(all, has ? part[3][lane] : INT_MIN)};
}

template <int TH, int TW>
__global__ void __launch_bounds__(kSplatVoxels, 3) splat_zbuf_tile_kernel(
    const BlockRows in, const int* __restrict__ count, int rows, int img_h, int img_w,
    int* __restrict__ zbuf, int* __restrict__ branches) {
  __shared__ int tile[TH * TW];
  __shared__ int part[2][4][kSplatWarps];
  __shared__ SplatPose pose;
  const int t = threadIdx.x;
  const int n = min(__ldg(count), rows);
  in.load_pose(&pose);
  // the tile stays all BIG between rows: each flush resets what it sent
  for (int i = t; i < TH * TW; i += kSplatVoxels) tile[i] = kSplatBig;
  __syncthreads();

  // software pipeline over this CTA's rows: the current row's inputs and
  // the next row's pool row; during the current row, the next row's inputs
  // and the pool row of the one after it are loaded
  int row = blockIdx.x;
  BlockRows::Raw<1> raw{};
  int pool_next = 0;
  if (row < n) raw = in.load<1>(row, in.pool_row(row), t);
  if (row + gridDim.x < n) pool_next = in.pool_row(row + gridDim.x);

  for (int it = 0; row < n; row += gridDim.x, ++it) {
    const int r1 = row + gridDim.x, r2 = r1 + gridDim.x;
    BlockRows::Raw<1> raw_next{};
    int pool_after = 0;
    if (r1 < n) raw_next = in.load<1>(r1, pool_next, t);
    if (r2 < n) pool_after = in.pool_row(r2);

    const SplatVoxel vox = in.voxel(raw, t, 0, pose);
    const bool band = vox.dq < kSplatBig;
    SplatBox box = empty_box();
    grow_box(box, vox, img_h, img_w);
    box = reduce_box<kSplatWarps>(box, part[it & 1]);
    if (box.bu <= box.eu) {
      const int bw = box.eu - box.bu + 1, bh = box.ev - box.bv + 1;
      if (bw <= TW && bh <= TH) {
        if (band) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            int u, v;
            if (footprint_uv(vox.u0, vox.v0, k, img_h, img_w, &u, &v)) {
              atomicMin(&tile[(v - box.bv) * bw + (u - box.bu)], vox.dq);
            }
          }
        }
        __syncthreads();
        for (int i = t; i < bw * bh; i += kSplatVoxels) {
          const int d = tile[i];
          if (d < kSplatBig) {
            tile[i] = kSplatBig;
            int* z = zbuf + static_cast<size_t>(box.bv + i / bw) * img_w + box.bu + i % bw;
            if (__ldcg(z) > d) atomicMin(z, d);
          }
        }
        // the next row's __syncthreads orders these resets before its merges
        if (t == 0 && branches) atomicAdd(branches, 1);
      } else {
        if (band) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int q = footprint_pixel(vox.u0, vox.v0, k, img_h, img_w);
            if (q >= 0) atomicMin(zbuf + q, vox.dq);
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
