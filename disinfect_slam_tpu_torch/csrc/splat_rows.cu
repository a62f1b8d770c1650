// splat_zbuf_rows and splat_payload_rows: the two merge passes of the
// surface-splat renderer (ops/render_fast.py).
//
// Replace the TPU kernels splat_zbuf_rows (K4) and splat_payload_rows
// (K5) of disinfect_slam_tpu/ops/pallas/splat_kernel.py.  Those keep the
// whole z-buffer in VMEM, build a compact [16, 32] patch per surface
// block with masked lane reductions, roll it into an aligned window and
// send blocks whose footprint does not fit through a capped XLA scatter.
// On Hopper the merge is what it computes: one atomicMin (z-buffer) or
// atomicMax (payload) per footprint pixel in global memory.  Min and max
// do not depend on the order of the updates, so the buffers equal the
// plain torch scatter reductions bit for bit, with no footprint limit.
//
// Layout: one CTA of 512 threads per surface-block row, one thread per
// voxel (the layout of fuse_rows.cu); rows at or past the device-side
// live count return at once, and a voxel outside the surface band
// (dq == BIG) returns after one 4-byte load.
//
// What bounds them: device memory traffic and the atomics.  K4 reads
// 12 B per surface voxel (u0, v0, dq) and issues at most four 4-byte
// atomics to an image that stays in the 50 MB L2 (1.2 MB at VGA, 8.3 MB
// at 1080p); voxels tie at a pixel, so atomics to one address serialise
// in L2.  K5 reads the same 12 B plus the final depth at the footprint,
// and the stored RGBW word and probability of only those voxels that win
// a pixel, read in place from the pool through pool_idx (no [S, 512] row
// gathers as on the TPU).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVoxels = 512;
constexpr int kBig = 1 << 30;

// Pixel index of footprint pixel k (du = k >> 1, dv = k & 1) of a voxel
// whose floor pixel is (u0, v0), or -1 off the image.  Unsigned sums wrap
// instead of overflowing, so u0 = -1 keeps its du = 1 pixel only.
__device__ __forceinline__ int footprint_pixel(int u0, int v0, int k,
                                               int img_h, int img_w) {
  const unsigned u = static_cast<unsigned>(u0) + static_cast<unsigned>(k >> 1);
  const unsigned v = static_cast<unsigned>(v0) + static_cast<unsigned>(k & 1);
  if (u >= static_cast<unsigned>(img_w) || v >= static_cast<unsigned>(img_h)) return -1;
  return static_cast<int>(v) * img_w + static_cast<int>(u);
}

__global__ void __launch_bounds__(kVoxels) splat_zbuf_kernel(
    const int* __restrict__ u0s, const int* __restrict__ v0s,
    const int* __restrict__ dqs, const int* __restrict__ count,
    int img_h, int img_w, int* __restrict__ zbuf) {
  const int row = blockIdx.x;
  if (row >= __ldg(count)) return;
  const size_t vi = static_cast<size_t>(row) * kVoxels + threadIdx.x;
  const int dq = dqs[vi];
  if (dq >= kBig) return;
  const int u0 = u0s[vi];
  const int v0 = v0s[vi];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p = footprint_pixel(u0, v0, k, img_h, img_w);
    if (p >= 0) atomicMin(zbuf + p, dq);
  }
}

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

extern "C" int dst_splat_zbuf_rows(const int* u0s, const int* v0s,
                                   const int* dqs, const int* count, int rows,
                                   int img_h, int img_w, int* zbuf,
                                   void* stream) {
  if (rows > 0) {
    splat_zbuf_kernel<<<rows, kVoxels, 0, static_cast<cudaStream_t>(stream)>>>(
        u0s, v0s, dqs, count, img_h, img_w, zbuf);
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
