// fuse_rows: projection, frame sampling and semantic TSDF fusion of the
// visible blocks, in place on the pool.  The kernel body, built by
// fuse_rows.cu (the fusion, kStage 3) and by the stage probe of
// sample_probe.cu (kStage 0-2, P5's stripped variants: the ring of pool
// rows alone; with the projection; with the frame sampling; each reduces
// min |tsdf| over the voxels its stages let through and writes back to the
// pool the three words it read for each of them, unchanged, so that it
// moves the bytes of the fusion without its arithmetic).
//
// Replaces the TPU kernels fuse_rows_packed (K2) and fuse_rows (K3) of
// disinfect_slam_tpu/ops/pallas/fuse_kernel.py, and the projection of
// every visible voxel that feeds them (fuse_visible in
// disinfect_slam_tpu/ops/integrate.py).  Those select each voxel's pixel
// from a VMEM patch with one-hot matmuls, take the pool rows from an XLA
// gather, hand updated rows back to an XLA scatter, read [V, 512] pixel,
// depth and gate planes that XLA wrote, and need a second, patch-DMA
// kernel (K3) for frames over 10 MB.  Here the kernel takes the visible
// blocks' coordinates and a device pointer to the pose (r00..r22, t0..t2,
// read once per CTA into shared memory, so that a captured CUDA graph
// replays with each frame's pose), projects each voxel in registers,
// loads its 32-byte pixel directly (no patch, no frame-size limit, so K3
// is this kernel at 1920x1080), and writes the updated pool words back in
// place through pool_idx.  The pool indices of the live rows are unique
// on both backends (dense: ascending; hash: in hash-slot order), and no
// order is assumed, so no two CTAs touch one row.
//
// Per voxel, op for op as the plain version (ops/cuda/fuse_kernel.py
// project_rows, then fuse_math): the world point
// ((block << 3) + offset) * voxel_size; the camera point in
// SE3.apply_xyz's order, ((r0 x + r1 y) + r2 z) + t, one rounding per op;
// the pixel round_half_away((fx x + cx z) / z) converted to int32 by
// cvt.rzi (saturating, NaN -> 0), as torch's .to(torch.int32) on CUDA
// converts, so voxels behind the camera or at z = 0 land where the torch
// path puts them; the in-image gate and the clamp; then the fusion
// formulas of voxel_tsdf.cu:149-205 as the JAX package states them
// (roundf rgb and weight, weight clamp, log-odds ht/lt with
// powf(0, 0) == 1, optional prob_eps clamp).  Built with -fmad=false, so
// no multiply-add is contracted.
//
// Layout: a persistent grid of a few 512-thread CTAs per SM, one thread
// per voxel (the CUDA original's tsdf_integrate_kernel layout,
// voxel_tsdf.cu:474-481, walked as a loop).  CTA b takes rows b,
// b + grid, ... below the live count, which it reads on the device.
// Thread 0 keeps kStages - 1 rows ahead in a shared-memory ring: per row
// three 2 KB bulk copies (cp.async.bulk, Hopper's TMA engine) of the
// tsdf, rgbw and prob pool rows, completing on the stage's mbarrier.  The
// projection and the pixel loads of the current row are issued before
// the CTA waits on its stage.  Each CTA reduces min |tsdf| over its row
// (warp shuffles, then one warp over 16 partials) for space carving.
//
// What bounds it: device memory bytes.  Per voxel it reads 12 B of pool
// words (the ring copies whole rows; only an updated voxel needs its rgbw
// and prob words, so the least traffic is 4 B per voxel and 8 B more per
// updated voxel) and writes back only the words that change (12 B for an
// updated voxel); per row 16 B of block coordinates and pool index and 4 B of
// min |tsdf|; the frame (9.8 MB at VGA, 66 MB at 1080p) is read through
// the 50 MB L2.  The [V, 512] planes of the earlier contract (13 B per
// voxel in, and about 20 torch ops writing them) are gone.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "persistent_grid.cuh"

namespace {

constexpr int kVoxels = 512;
constexpr int kChannels = 8;
constexpr int kWarps = kVoxels / 32;
constexpr int kStages = 3;
constexpr uint32_t kRowBytes = kVoxels * 4;

struct Pose {
  float r[9];  // rotation entries r00..r22, row-major
  float t[3];
};
static_assert(sizeof(Pose) == 12 * sizeof(float), "Pose is the 12 floats of pose12");

struct Camera {
  float fx, fy, cx, cy;
  int img_h, img_w;
};

struct FusionConsts {
  float voxel_size, truncation, max_depth, max_weight, prob_eps, prob_hi;
};

__device__ __forceinline__ float round_half_away(float x) {
  return x >= 0.f ? floorf(x + 0.5f) : ceilf(x - 0.5f);
}

// torch.minimum(x, hi) for a finite hi: a NaN x stays NaN
__device__ __forceinline__ float min_hi(float x, float hi) {
  return x > hi ? hi : x;
}

// min that propagates NaN, like torch.amin
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

// log(x ** e) with C powf edge semantics: e == 0 contributes 0
__device__ __forceinline__ float pow_log(float x, float e) {
  return e == 0.f ? 0.f : e * logf(x);
}

// kStage: 0 the ring of pool rows, 1 and the projection, 2 and the
// frame sampling, 3 and the fusion (fuse_rows)
template <int kStage>
__global__ void __launch_bounds__(kVoxels, 4) fuse_rows_kernel(
    const float* __restrict__ img, const int* __restrict__ block_pos,
    const int* __restrict__ pool_idx, const int* __restrict__ count, int rows,
    int num_blocks, float* tsdf, int* rgbw, float* prob, float* __restrict__ minabs,
    const float* __restrict__ pose12, const Camera cam, const FusionConsts fc) {
  constexpr bool kProject = kStage >= 1, kSample = kStage >= 2, kFuse = kStage >= 3;
  __shared__ __align__(128) float ring_tsdf[kStages][kVoxels];
  __shared__ __align__(128) int ring_rgbw[kStages][kVoxels];
  __shared__ __align__(128) float ring_prob[kStages][kVoxels];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ float warp_min[2][kWarps];
  __shared__ Pose pose;  // the frame's pose, read from device memory once

  const int t = threadIdx.x;
  const int n = min(__ldg(count), rows);
  if (t < 12) reinterpret_cast<float*>(&pose)[t] = __ldg(pose12 + t);
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();

  // thread 0: start the copies of row r's pool words into stage s; a row
  // without a pool row (none below the count, by contract) completes the
  // stage's phase with a plain arrival
  auto fetch = [&](int r, int s) {
    const int pool = __ldg(pool_idx + r);
    if (pool >= 0 && pool < num_blocks) {
      const size_t off = static_cast<size_t>(pool) * kVoxels;
      mbar_arrive_expect_tx(&full[s], 3 * kRowBytes);
      bulk_load(ring_tsdf[s], tsdf + off, kRowBytes, &full[s]);
      bulk_load(ring_rgbw[s], rgbw + off, kRowBytes, &full[s]);
      bulk_load(ring_prob[s], prob + off, kRowBytes, &full[s]);
    } else {
      mbar_arrive(&full[s]);
    }
  };
  if (t == 0) {
    for (int k = 0; k < kStages - 1; ++k) {
      const int r = blockIdx.x + k * gridDim.x;
      if (r < n) fetch(r, k);
    }
  }

  // the voxel's offset in its 8x8x8 block, x fastest (core/voxel.py)
  const int ox = t & 7, oy = (t >> 3) & 7, oz = t >> 6;
  int it = 0;
  for (int row = blockIdx.x; row < n; row += gridDim.x, ++it) {
    const int s = it % kStages;
    if (t == 0) {
      // the stage it refills was last read in iteration it - 1, which
      // every thread left through the __syncthreads below
      const int ahead = row + (kStages - 1) * gridDim.x;
      if (ahead < n) fetch(ahead, (it + kStages - 1) % kStages);
    }
    const int pool = __ldg(pool_idx + row);
    const bool has_pool = pool >= 0 && pool < num_blocks;

    // projection (project_rows)
    float z = 0.f;
    bool in_img = true;
    int uc = 0, vc = 0;
    if constexpr (kProject) {
      const float px = static_cast<float>((__ldg(block_pos + 3 * row) << 3) + ox) * fc.voxel_size;
      const float py = static_cast<float>((__ldg(block_pos + 3 * row + 1) << 3) + oy) * fc.voxel_size;
      const float pz = static_cast<float>((__ldg(block_pos + 3 * row + 2) << 3) + oz) * fc.voxel_size;
      const float xc = pose.r[0] * px + pose.r[1] * py + pose.r[2] * pz + pose.t[0];
      const float yc = pose.r[3] * px + pose.r[4] * py + pose.r[5] * pz + pose.t[1];
      z = pose.r[6] * px + pose.r[7] * py + pose.r[8] * pz + pose.t[2];
      const int u = __float2int_rz(round_half_away((cam.fx * xc + cam.cx * z) / z));
      const int v = __float2int_rz(round_half_away((cam.fy * yc + cam.cy * z) / z));
      in_img = u >= 0 && u < cam.img_w && v >= 0 && v < cam.img_h;
      uc = min(max(u, 0), cam.img_w - 1);
      vc = min(max(v, 0), cam.img_h - 1);
    }

    // the voxel's pixel (depth, depth->range, r, g, b, ht, lt, pad)
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if constexpr (kSample) {
      const float4* pix = reinterpret_cast<const float4*>(
          img + (static_cast<size_t>(vc) * cam.img_w + uc) * kChannels);
      a = __ldg(pix);
      b = __ldg(pix + 1);
    }
    const float depth = a.x, d2r = a.y, r_new = a.z, g_new = a.w;
    const float b_new = b.x, ht = b.y, lt = b.z;

    mbar_wait(&full[s], (it / kStages) & 1);
    float m = INFINITY;
    if (has_pool) {
      const float tsdf_old = ring_tsdf[s][t];
      const float sdf = d2r * (depth - z);
      const bool update = in_img && (!kSample || (depth > 0.f && depth <= fc.max_depth &&
                                                  sdf > -fc.truncation));
      float t_fin = tsdf_old;
      // the fusion formulas only where the voxel takes the update: the
      // others keep their words, so their arithmetic is never needed
      if (kFuse && update) {
        const int word = ring_rgbw[s][t];
        const float prob_old = ring_prob[s][t];
        const float tsdf_new = min_hi(sdf / fc.truncation, 1.f);
        const float w_new = (1.f - depth / fc.max_depth) * 4.f;

        const float w_old = static_cast<float>((word >> 24) & 0xFF);
        const float r_old = static_cast<float>(word & 0xFF);
        const float g_old = static_cast<float>((word >> 8) & 0xFF);
        const float b_old = static_cast<float>((word >> 16) & 0xFF);
        const float w_comb = w_old + w_new;
        const float w_safe = w_comb == 0.f ? 1.f : w_comb;
        const float tsdf_upd = (tsdf_old * w_old + tsdf_new * w_new) / w_safe;
        const float r_upd = round_half_away((r_old * w_old + r_new * w_new) / w_safe);
        const float g_upd = round_half_away((g_old * w_old + g_new * w_new) / w_safe);
        const float b_upd = round_half_away((b_old * w_old + b_new * w_new) / w_safe);
        const float w_upd = min_hi(round_half_away(w_comb), fc.max_weight);
        const float e_old = w_old / w_safe;
        const float e_new = w_new / w_safe;
        const float positive = expf(pow_log(prob_old, e_old) + pow_log(ht, e_new));
        const float negative = expf(pow_log(1.f - prob_old, e_old) + pow_log(lt, e_new));
        const float denom = positive + negative;
        float prob_upd = denom > 0.f ? positive / denom : prob_old;
        if (fc.prob_eps > 0.f) {
          prob_upd = prob_upd < fc.prob_eps ? fc.prob_eps : min_hi(prob_upd, fc.prob_hi);
        }
        const size_t pi = static_cast<size_t>(pool) * kVoxels + t;
        t_fin = tsdf_upd;
        tsdf[pi] = tsdf_upd;
        rgbw[pi] = static_cast<int>(r_upd) | (static_cast<int>(g_upd) << 8) |
                   (static_cast<int>(b_upd) << 16) | (static_cast<int>(w_upd) << 24);
        prob[pi] = prob_upd;
      }
      if (!kFuse && update) {
        // the stripped stages: the words they read, written back in place
        const size_t pi = static_cast<size_t>(pool) * kVoxels + t;
        tsdf[pi] = tsdf_old;
        rgbw[pi] = ring_rgbw[s][t];
        prob[pi] = ring_prob[s][t];
      }
      // the stripped stages: min |tsdf| over the voxels they let through
      m = (kFuse || update) ? fabsf(t_fin) : INFINITY;
    }

#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = nan_min(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    // two partial buffers: warp 0 may still read this iteration's while
    // the other warps write the next one's
    float* partial = warp_min[it & 1];
    if ((t & 31) == 0) partial[t >> 5] = m;
    __syncthreads();
    if (t < 32) {
      m = t < kWarps ? partial[t] : INFINITY;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        m = nan_min(m, __shfl_xor_sync(0xffffffffu, m, off));
      }
      if (t == 0 && has_pool) minabs[row] = m;
    }
  }
}

// One launch of fuse_rows_kernel<kStage> on a persistent grid (the
// arguments of dst_fuse_rows; pose12 is a device pointer).
template <int kStage>
int launch_fuse_rows(const float* img, int img_h, int img_w, const int* block_pos,
                     const int* pool_idx, const int* count, int rows, int num_blocks,
                     float* tsdf, int* rgbw, float* prob, float* minabs, const float* pose12,
                     const float* intrinsics4, float voxel_size, float truncation,
                     float max_depth, float max_weight, float prob_eps, float prob_hi,
                     cudaStream_t stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const Camera cam{intrinsics4[0], intrinsics4[1], intrinsics4[2], intrinsics4[3],
                   img_h, img_w};
  const FusionConsts fc{voxel_size, truncation, max_depth, max_weight, prob_eps, prob_hi};
  static const int ctas = resident_ctas(fuse_rows_kernel<kStage>, kVoxels);
  fuse_rows_kernel<kStage><<<min(rows, ctas), kVoxels, 0, stream>>>(
      img, block_pos, pool_idx, count, rows, num_blocks, tsdf, rgbw, prob, minabs, pose12, cam,
      fc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
