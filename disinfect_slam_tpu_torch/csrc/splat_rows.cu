// splat_zbuf_rows and splat_payload_rows: the two merge passes of the
// surface-splat renderer (ops/render_fast.py).
//
// Replace the TPU kernels splat_zbuf_rows (K4) and splat_payload_rows
// (K5) of disinfect_slam_tpu/ops/pallas/splat_kernel.py.  Those keep the
// whole z-buffer in VMEM, build a compact [16, 32] patch per surface
// block with masked lane reductions, roll it into an aligned window and
// send blocks whose footprint does not fit through a capped XLA scatter.
//
// K4 merges each surface block's footprint in a shared-memory tile of
// kTileH x kTileW pixels and sends the tile's pixels to the z-buffer with
// one global atomicMin each; blocks whose footprint does not fit (near
// the camera) merge per voxel with global atomics (splat_zbuf_tile.cuh,
// where the design and its bound are described; the tile shape is the
// one the probe's sweep chose, splat_probe.cu).
//
// K5 is one atomicMax (u32) per winning footprint pixel in global memory:
// one CTA of 512 threads per surface-block row, one thread per voxel;
// rows at or past the device-side live count return at once, and a voxel
// outside the surface band (dq == BIG) returns after one 4-byte load.  It
// reads 12 B per surface voxel plus the final depth at the footprint, and
// the stored RGBW word and probability of only those voxels that win a
// pixel, read in place from the pool through pool_idx (no [S, 512] row
// gathers as on the TPU).
//
// Min and max do not depend on the order of the updates, so the buffers
// equal the plain torch scatter reductions bit for bit, with no footprint
// limit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "persistent_grid.cuh"
#include "splat_zbuf_tile.cuh"

namespace {

constexpr int kVoxels = kSplatVoxels;
constexpr int kBig = kSplatBig;
constexpr int kTileH = 32, kTileW = 32;

__global__ void __launch_bounds__(kVoxels) splat_payload_kernel(
    const int* __restrict__ u0s, const int* __restrict__ v0s,
    const int* __restrict__ dqs, const int* __restrict__ pool_idx,
    int num_blocks, const uint32_t* __restrict__ rgbw,
    const float* __restrict__ prob, const int* __restrict__ count,
    int img_h, int img_w, const int* __restrict__ zbuf,
    uint32_t* __restrict__ pbuf) {
  const int row = blockIdx.x;
  if (row >= __ldg(count)) return;
  const size_t vi = static_cast<size_t>(row) * kVoxels + threadIdx.x;
  const int dq = dqs[vi];
  if (dq >= kBig) return;
  const int u0 = u0s[vi];
  const int v0 = v0s[vi];
  int won[4];
  bool any = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p = footprint_pixel(u0, v0, k, img_h, img_w);
    won[k] = (p >= 0 && __ldg(zbuf + p) == dq) ? p : -1;
    any |= won[k] >= 0;
  }
  if (!any) return;
  const int pool = min(max(__ldg(pool_idx + row), 0), num_blocks - 1);
  const size_t pv = static_cast<size_t>(pool) * kVoxels + threadIdx.x;
  const uint32_t w = rgbw[pv];
  // (p8 << 24) | (r << 16) | (g << 8) | b, p8 = clip(prob * 255, 0, 255)
  // truncated (render_fast.pack_payload_rgbw)
  const uint32_t p8 = static_cast<uint32_t>(fminf(fmaxf(prob[pv] * 255.f, 0.f), 255.f));
  const uint32_t word = (p8 << 24) | ((w & 0xFFu) << 16) |
                        (((w >> 8) & 0xFFu) << 8) | ((w >> 16) & 0xFFu);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (won[k] >= 0) atomicMax(pbuf + won[k], word);
  }
}

}  // namespace

// branches: null, or two counters that take the rows merged through the
// tile and through the per-voxel atomics
extern "C" int dst_splat_zbuf_rows(const int* u0s, const int* v0s,
                                   const int* dqs, const int* count, int rows,
                                   int img_h, int img_w, int* zbuf, int* branches,
                                   void* stream) {
  if (rows > 0) {
    auto kernel = splat_zbuf_tile_kernel<kTileH, kTileW>;
    static const int ctas = resident_ctas(kernel, kVoxels);
    kernel<<<min(rows, ctas), kVoxels, 0,
             static_cast<cudaStream_t>(stream)>>>(u0s, v0s, dqs, count, rows, img_h,
                                                  img_w, zbuf, branches);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dst_splat_payload_rows(const int* u0s, const int* v0s,
                                      const int* dqs, const int* pool_idx,
                                      int num_blocks, const uint32_t* rgbw,
                                      const float* prob, const int* count,
                                      int rows, int img_h, int img_w,
                                      const int* zbuf, uint32_t* pbuf,
                                      void* stream) {
  if (rows > 0) {
    splat_payload_kernel<<<rows, kVoxels, 0, static_cast<cudaStream_t>(stream)>>>(
        u0s, v0s, dqs, pool_idx, num_blocks, rgbw, prob, count, img_h, img_w,
        zbuf, pbuf);
  }
  return static_cast<int>(cudaGetLastError());
}
