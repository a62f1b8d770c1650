// The z-buffer merge of the splat renderer with a shared-memory footprint
// tile per surface block: the body of splat_zbuf_rows (splat_rows.cu) and
// of the tile-shape sweep of its probe (splat_probe.cu).
//
// Replaces the TPU kernel splat_zbuf_rows (K4,
// disinfect_slam_tpu/ops/pallas/splat_kernel.py), which builds a compact
// [16, 32] patch per surface block in VMEM and sends blocks whose
// footprint does not fit through a capped XLA scatter.  The same merge in
// fast memory, on Hopper: each CTA takes one surface-block row at a time
// (a persistent loop up to the live count it reads on the device, with
// the next row's depths and floor pixels loaded while the current row
// merges), reduces the bounding box of its in-band voxels' in-image 2x2
// footprints (warp reductions, then each warp over the 16 partials), and
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
// What bounds it: device memory bytes (4 B of depth per live voxel, 8 B
// of floor pixel per band voxel, the z-buffer once) once the atomics that
// tie at one pixel are merged on chip.
#pragma once
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kSplatVoxels = 512;
constexpr int kSplatWarps = kSplatVoxels / 32;
constexpr int kSplatBig = 1 << 30;

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

template <int TH, int TW>
__global__ void __launch_bounds__(kSplatVoxels, 4) splat_zbuf_tile_kernel(
    const int* __restrict__ u0s, const int* __restrict__ v0s, const int* __restrict__ dqs,
    const int* __restrict__ count, int rows, int img_h, int img_w, int* __restrict__ zbuf,
    int* __restrict__ branches) {
  __shared__ int tile[TH * TW];
  // per-warp box partials, two sets: a warp may write the next row's
  // while another still reads this row's
  __shared__ int part[2][4][kSplatWarps];
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int n = min(__ldg(count), rows);
  const unsigned all = 0xffffffffu;
  // the tile stays all BIG between rows: each flush resets what it sent
  for (int i = t; i < TH * TW; i += kSplatVoxels) tile[i] = kSplatBig;

  // software pipeline over this CTA's rows: the current row's depth and
  // floor pixel, the next row's depth and, loaded during the current
  // row, the next row's floor pixels and the depth of the row after it
  auto at = [&](int r) { return static_cast<size_t>(r) * kSplatVoxels + t; };
  int row = blockIdx.x;
  int dq = kSplatBig, u0 = 0, v0 = 0, dq_next = kSplatBig;
  if (row < n) {
    dq = __ldg(dqs + at(row));
    if (dq < kSplatBig) {
      u0 = __ldg(u0s + at(row));
      v0 = __ldg(v0s + at(row));
    }
  }
  if (row + gridDim.x < n) dq_next = __ldg(dqs + at(row + gridDim.x));

  for (int it = 0; row < n; row += gridDim.x, ++it) {
    const int r1 = row + gridDim.x, r2 = r1 + gridDim.x;
    int u0_next = 0, v0_next = 0, dq_after = kSplatBig;
    if (r1 < n && dq_next < kSplatBig) {
      u0_next = __ldg(u0s + at(r1));
      v0_next = __ldg(v0s + at(r1));
    }
    if (r2 < n) dq_after = __ldg(dqs + at(r2));

    const bool band = dq < kSplatBig;
    // the box of this voxel's in-image footprint pixels (empty: min > max)
    int lo_u = INT_MAX, lo_v = INT_MAX, hi_u = INT_MIN, hi_v = INT_MIN;
    if (band) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int u, v;
        if (footprint_uv(u0, v0, k, img_h, img_w, &u, &v)) {
          lo_u = min(lo_u, u);
          hi_u = max(hi_u, u);
          lo_v = min(lo_v, v);
          hi_v = max(hi_v, v);
        }
      }
    }
    int(*p)[kSplatWarps] = part[it & 1];
    lo_u = __reduce_min_sync(all, lo_u);
    lo_v = __reduce_min_sync(all, lo_v);
    hi_u = __reduce_max_sync(all, hi_u);
    hi_v = __reduce_max_sync(all, hi_v);
    if (lane == 0) {
      p[0][warp] = lo_u;
      p[1][warp] = lo_v;
      p[2][warp] = hi_u;
      p[3][warp] = hi_v;
    }
    __syncthreads();
    // every warp reduces the 16 partials to the row's box
    const bool has = lane < kSplatWarps;
    const int bu = __reduce_min_sync(all, has ? p[0][lane] : INT_MAX);
    const int bv = __reduce_min_sync(all, has ? p[1][lane] : INT_MAX);
    const int eu = __reduce_max_sync(all, has ? p[2][lane] : INT_MIN);
    const int ev = __reduce_max_sync(all, has ? p[3][lane] : INT_MIN);
    // an empty box: no footprint pixel of the row lies in the image.  The
    // box lies in the image, so its sides are at most img_w, img_h.
    if (bu <= eu) {
      const int bw = eu - bu + 1, bh = ev - bv + 1;
      if (bw <= TW && bh <= TH) {
        if (band) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            int u, v;
            if (footprint_uv(u0, v0, k, img_h, img_w, &u, &v)) {
              atomicMin(&tile[(v - bv) * bw + (u - bu)], dq);
            }
          }
        }
        __syncthreads();
        for (int i = t; i < bw * bh; i += kSplatVoxels) {
          const int d = tile[i];
          if (d < kSplatBig) {
            tile[i] = kSplatBig;
            int* z = zbuf + static_cast<size_t>(bv + i / bw) * img_w + bu + i % bw;
            if (__ldcg(z) > d) atomicMin(z, d);
          }
        }
        // the next row's __syncthreads orders these resets before its merges
        if (t == 0 && branches) atomicAdd(branches, 1);
      } else {
        if (band) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int q = footprint_pixel(u0, v0, k, img_h, img_w);
            if (q >= 0) atomicMin(zbuf + q, dq);
          }
        }
        if (t == 0 && branches) atomicAdd(branches + 1, 1);
      }
    }
    dq = dq_next;
    u0 = u0_next;
    v0 = v0_next;
    dq_next = dq_after;
  }
}

}  // namespace
