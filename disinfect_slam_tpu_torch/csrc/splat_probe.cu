// Hopper probes of the splat z-buffer merge (K4), run by
// ops/cuda/splat_probe.py.
//
// P8 and P9, the TPU probes scripts/probe_splat2.py (run_v2, run_v2i,
// run_v3) and scripts/probe_splat2b.py (run in five modes), build the
// padded 496x768 int32 z-buffer from given inputs: S blocks, each with a
// box origin (bu, bv) and 512 voxels at box-relative pixels (lu, lv) with
// a depth dq (BIG: dead).  Each Pallas kernel min-merges a block's
// voxels over their 2x2 footprints into a compact [16, 128] patch
// ([16, 32] in run_v3) in VMEM, rolls the patch by (bv - v0a, bu - u0a)
// inside an aligned 24x256 window at (u0a, v0a) (circular; not rolled in
// norollfull) and min-merges the window into the z-buffer; rmw, rowwrite
// and roll merge no voxel and give the BIG fill.  Here: a fill launch,
// then splat_zbuf_given_kernel<Mode>, one CTA a block of 128 threads,
// each reading four voxels' lu, lv and dq with one 16-byte load of each.
// The bound is those 75.5 MB at S = 12288 (0.023 ms); the z-buffer
// (1.5 MB) lives in L2, where its atomics land.  A footprint spans at
// most 14x14 pixels, so the block's live voxels (~128 at the probe's 75%
// dead) merge by shared atomicMin into a [16, 32] patch, and each patch
// pixel that is not BIG merges once into the z-buffer: at most 196
// global atomics a block, against ~512 for one a footprint pixel, which
// is 3.3x slower at S = 12288 (scripts/port_given_probes_stage.py builds
// that merge beside this one).  A footprint pixel in patch columns
// 32-127 (lu >= 31, which only the 128-column functions keep) merges
// straight into the z-buffer.  The fill is a launch of its own: a merge
// that needs initialised words cannot order itself after a fill in the
// same grid.
//
// K4's own instruments, on splat_zbuf_rows' block rows, each voxel
// projected in registers (BlockRows), so that the two differ in the merge
// alone: the z-buffer body before the tile (one CTA per row, up to four
// global atomicMin per band voxel) against the tile kernel of
// splat_zbuf_tile.cuh; and the tile-shape sweep: the tile kernel built at
// 16x32, 32x32 and 64x64 pixels, each with its registers, local (spill)
// bytes and shared bytes as the compiled kernel reports them.
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

// --- P8 / P9: the Pallas z-buffer from given inputs ---

constexpr int kGivenBig = 1 << 30;
constexpr int kHpad = 496, kWpad = 768;  // the padded z-buffer
constexpr int kWinH = 24, kWinW = 256;   // the aligned window
constexpr int kPatchH = 16, kPatchW = 32;  // the shared patch
constexpr int kGivenVoxels = 512, kGivenThreads = kGivenVoxels / 4;
// kernel modes: 0 the fill alone; 1 rolled, 128 patch columns (run_v2,
// run_v2i, full); 2 rolled, 32 columns (run_v3); 3 unrolled, 128 columns
// (norollfull)

__global__ void zbuf_given_fill_kernel(int4* __restrict__ zbuf, int n4) {
  const int4 big = make_int4(kGivenBig, kGivenBig, kGivenBig, kGivenBig);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += gridDim.x * blockDim.x)
    zbuf[i] = big;
}

// where patch pixel (r, c) of the block lands: its window pixel, rolled
// (wy, wx: the roll's shifts reduced into the window) or not; -1 outside
// the z-buffer (only for a negative origin)
template <bool Roll>
__device__ __forceinline__ int window_pixel(int r, int c, int v0a, int u0a, int wy, int wx) {
  int y = r, x = c;
  if constexpr (Roll) {
    y += wy;
    y -= y >= kWinH ? kWinH : 0;  // r < 16, wy < 24
    x = (x + wx) & (kWinW - 1);   // c < 128, wx < 256
  }
  y += v0a;
  x += u0a;
  return y >= 0 && x >= 0 ? y * kWpad + x : -1;
}

template <int Mode>
__global__ void __launch_bounds__(kGivenThreads) splat_zbuf_given_kernel(
    const int* __restrict__ bus, const int* __restrict__ bvs, const int* __restrict__ n,
    const int* __restrict__ lus, const int* __restrict__ lvs, const int* __restrict__ dqs,
    int blocks, int* __restrict__ zbuf) {
  constexpr bool kRoll = Mode != 3;
  constexpr int kCols = Mode == 2 ? 32 : 128;
  __shared__ int patch[kPatchH * kPatchW];
  const int b = blockIdx.x;
  if (b >= min(__ldg(n), blocks)) return;
  const int t = threadIdx.x;
  const size_t at = static_cast<size_t>(b) * kGivenVoxels + 4 * t;
  const int4 dq = __ldcs(reinterpret_cast<const int4*>(dqs + at));
  const int4 lu = __ldcs(reinterpret_cast<const int4*>(lus + at));
  const int4 lv = __ldcs(reinterpret_cast<const int4*>(lvs + at));
  const int bu = __ldg(bus + b), bv = __ldg(bvs + b);
  // the Pallas window: (bu >> 7) << 7 and (bv >> 3) << 3, clipped so the
  // window lies in the z-buffer; the roll's shifts bu - u0a, bv - v0a >= 0
  const int u0a = min(bu & ~127, kWpad - kWinW), v0a = min(bv & ~7, kHpad - kWinH);
  const int wx = static_cast<int>((static_cast<unsigned>(bu) - static_cast<unsigned>(u0a)) %
                                  kWinW);
  const int wy = static_cast<int>((static_cast<unsigned>(bv) - static_cast<unsigned>(v0a)) %
                                  kWinH);
#pragma unroll
  for (int k = 0; k < kPatchH * kPatchW / kGivenThreads; ++k)
    patch[k * kGivenThreads + t] = kGivenBig;
  __syncthreads();
  const int d4[4] = {dq.x, dq.y, dq.z, dq.w};
  const int u4[4] = {lu.x, lu.y, lu.z, lu.w};
  const int v4[4] = {lv.x, lv.y, lv.z, lv.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (d4[k] >= kGivenBig) continue;  // merges nothing into the BIG fill
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int r = v4[k] + (f >> 1), c = u4[k] + (f & 1);
      // unsigned: r in [0, 16) and c in [0, kCols) in one test each
      if (static_cast<unsigned>(r) >= kPatchH || static_cast<unsigned>(c) >= kCols) continue;
      if (c < kPatchW) {
        atomicMin(&patch[r * kPatchW + c], d4[k]);
      } else {
        const int p = window_pixel<kRoll>(r, c, v0a, u0a, wy, wx);
        if (p >= 0) atomicMin(zbuf + p, d4[k]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPatchH * kPatchW / kGivenThreads; ++k) {
    const int i = k * kGivenThreads + t;
    const int d = patch[i];
    if (d == kGivenBig) continue;
    const int p = window_pixel<kRoll>(i / kPatchW, i % kPatchW, v0a, u0a, wy, wx);
    if (p >= 0) atomicMin(zbuf + p, d);
  }
}

template <int Mode>
int launch_given(const int* bu, const int* bv, const int* n, const int* lu, const int* lv,
                 const int* dq, int blocks, int* zbuf, cudaStream_t s) {
  splat_zbuf_given_kernel<Mode><<<blocks, kGivenThreads, 0, s>>>(bu, bv, n, lu, lv, dq, blocks,
                                                                 zbuf);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

// P8 / P9: mode 0 (the fill alone), 1 (rolled, 128 patch columns), 2
// (rolled, 32), 3 (unrolled, 128); bu, bv i32 [blocks], n i32 [1] (on
// the device), lu, lv, dq i32 [blocks, 512] 16-byte aligned; zbuf i32
// [496, 768], filled with BIG, then merged into
extern "C" int dst_probe_splat_zbuf_given(int mode, const int* bu, const int* bv, const int* n,
                                          const int* lu, const int* lv, const int* dq,
                                          int blocks, int* zbuf, void* stream) {
  if (mode < 0 || mode > 3 || blocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int n4 = kHpad * kWpad / 4;
  zbuf_given_fill_kernel<<<(n4 + 255) / 256, 256, 0, s>>>(reinterpret_cast<int4*>(zbuf), n4);
  const int err = static_cast<int>(cudaGetLastError());
  if (err || mode == 0 || blocks == 0) return err;
  switch (mode) {
    case 1: return launch_given<1>(bu, bv, n, lu, lv, dq, blocks, zbuf, s);
    case 2: return launch_given<2>(bu, bv, n, lu, lv, dq, blocks, zbuf, s);
    default: return launch_given<3>(bu, bv, n, lu, lv, dq, blocks, zbuf, s);
  }
}

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
