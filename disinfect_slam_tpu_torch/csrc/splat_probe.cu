// Hopper probes of the splat z-buffer merge (K4): the counterparts of the
// TPU probes scripts/probe_splat2.py (P8) and scripts/probe_splat2b.py
// (P9), run by ops/cuda/splat_probe.py.
//
// P8 timed the TPU's compact [16, 32] patch per surface block against the
// earlier formulation at S = 12288 blocks.  Here the A/B is the z-buffer
// body before the tile (one CTA per row, up to four global atomicMin per
// band voxel) against the tile kernel of splat_zbuf_tile.cuh.  Both take
// splat_zbuf_rows' block rows and project each voxel in registers
// (BlockRows), so that the two differ in the merge alone.
//
// P9 bisected which part of the compact patch Mosaic could lower.  Here it
// is the tile-shape sweep: the tile kernel built at 16x32, 32x32 and 64x64
// pixels, each with its registers, local (spill) bytes and shared bytes
// as the compiled kernel reports them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "persistent_grid.cuh"
#include "splat_zbuf_tile.cuh"

namespace {

// the per-voxel-atomic z-buffer body (splat_rows.cu before the tile)
__global__ void __launch_bounds__(kSplatVoxels) probe_zbuf_atomic_kernel(
    const BlockRows in, const int* __restrict__ count, int img_h, int img_w,
    int* __restrict__ zbuf) {
  __shared__ SplatPose pose;
  in.load_pose(&pose);
  __syncthreads();
  const int row = blockIdx.x;
  if (row >= __ldg(count)) return;
  const SplatVoxel vox =
      in.voxel(in.load<1>(row, in.pool_row(row), threadIdx.x), threadIdx.x, 0, pose);
  if (vox.dq >= kSplatBig) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p = footprint_pixel(vox.u0, vox.v0, k, img_h, img_w);
    if (p >= 0) atomicMin(zbuf + p, vox.dq);
  }
}

// the swept tile shapes, (rows, columns) = (TH, TW)
template <int I>
struct Shape;
template <>
struct Shape<0> {
  static constexpr int h = 16, w = 32;
};
template <>
struct Shape<1> {
  static constexpr int h = 32, w = 32;
};
template <>
struct Shape<2> {
  static constexpr int h = 64, w = 64;
};

template <int I>
int launch_tile(const BlockRows& in, const int* count, int rows, int img_h, int img_w,
                int* zbuf, int* branches, cudaStream_t stream) {
  auto kernel = splat_zbuf_tile_kernel<Shape<I>::h, Shape<I>::w>;
  static const int ctas = resident_ctas(kernel, kSplatVoxels);
  kernel<<<min(rows, ctas), kSplatVoxels, 0, stream>>>(in, count, rows, img_h, img_w, zbuf,
                                                      branches);
  return static_cast<int>(cudaGetLastError());
}

template <int I>
int tile_attributes(int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, splat_zbuf_tile_kernel<Shape<I>::h, Shape<I>::w>);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = attr.maxThreadsPerBlock;
  out[4] = Shape<I>::h;
  out[5] = Shape<I>::w;
  return static_cast<int>(err);
}
}  // namespace

// the rows and scalars of dst_splat_zbuf_rows (splat_rows.cu)
extern "C" int dst_probe_splat_zbuf_atomic(const int* block_pos, const int* pool_idx,
                                           const int* count, int rows, int num_blocks,
                                           const float* tsdf, const float* pose12,
                                           const float* intrinsics4, const float* consts4,
                                           int img_h, int img_w, int* zbuf, void* stream) {
  if (rows > 0) {
    probe_zbuf_atomic_kernel<<<rows, kSplatVoxels, 0, static_cast<cudaStream_t>(stream)>>>(
        block_rows(block_pos, pool_idx, num_blocks, tsdf, pose12, intrinsics4, img_h, img_w,
                   consts4),
        count, img_h, img_w, zbuf);
  }
  return static_cast<int>(cudaGetLastError());
}

// shape: 0, 1 or 2 (16x32, 32x32, 64x64); then the arguments of
// dst_splat_zbuf_rows
extern "C" int dst_probe_splat_zbuf_tile(int shape, const int* block_pos, const int* pool_idx,
                                         const int* count, int rows, int num_blocks,
                                         const float* tsdf, const float* pose12,
                                         const float* intrinsics4, const float* consts4,
                                         int img_h, int img_w, int* zbuf, int* branches,
                                         void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BlockRows in = block_rows(block_pos, pool_idx, num_blocks, tsdf, pose12, intrinsics4,
                                  img_h, img_w, consts4);
  switch (shape) {
    case 0: return launch_tile<0>(in, count, rows, img_h, img_w, zbuf, branches, s);
    case 1: return launch_tile<1>(in, count, rows, img_h, img_w, zbuf, branches, s);
    case 2: return launch_tile<2>(in, count, rows, img_h, img_w, zbuf, branches, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out[6]: registers, local bytes, static shared bytes, max threads per
// block, tile rows, tile columns
extern "C" int dst_probe_splat_tile_attributes(int shape, int* out) {
  switch (shape) {
    case 0: return tile_attributes<0>(out);
    case 1: return tile_attributes<1>(out);
    case 2: return tile_attributes<2>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
