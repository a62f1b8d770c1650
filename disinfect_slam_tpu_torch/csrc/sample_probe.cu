// Hopper probes of the frame sampler (K1, sample_rows.cu) and of the
// stages of fuse_rows (K2): the counterparts of the TPU probes
// scripts/probe_sample2.py, probe_sample3.py, probe_sample4.py (P1-P3),
// probe_sample_overhead.py (P4), probe_kernel_stages.py (P5) and
// probe_mxu_shapes.py (P6), run by ops/cuda/sample_probe.py.
//
// P4 split K1's time into its pixel loads and its writes.  Here:
// sample_direct_kernel<mode>, K1's body (kFull), its pixel loads with one
// word written per voxel (kLoadsOnly: the xor of the pixel's eight words)
// and its writes without a pixel load (kWritesOnly).
//
// P1, P2 and P6 tuned the TPU's patch selection: blocks per grid step,
// the patch layout and the one-hot matmul shapes.  Here the TPU design
// runs on Hopper: each block's aligned patch (origin the block's lowest
// in-image pixel, rounded down to 16 columns and 8 rows, clipped into the
// image, as ops/pallas/sample_kernel.py aligns it) is staged in shared
// memory by the bulk copy engine, one copy a patch row, completing on an
// mbarrier; each voxel reads its pixel from the patch, and a voxel in the
// image but outside the patch comes back invalid and is counted (the
// TPU's sampler_skipped: voxels, and rows with any).  sample_patch_kernel
// <PH, PW> at 24x32 and 48x64 pixels, each CTA taking rows_per_cta
// consecutive rows (1, 4, 16: P1's batching).
//
// P3 selected through exact bf16 / int8 one-hot matmuls on the MXU.
// sample_mma_kernel does that once on this card, at the 24x32 patch: the
// patch's words are split into four byte planes, transposed in shared
// memory, and each group of 16 voxels selects its patch row with a
// one-hot u8 matrix (built in registers from the voxels' patch rows)
// through mma.sync m16n8k32 (u8 x u8 -> s32, exact: one term per sum),
// for every 8-word pixel column of the patch; each voxel keeps the column
// of its own pixel.
//
// P5 attributed the TPU kernel's time to its stages.  Here:
// fuse_rows_kernel<kStage> (fuse_rows.cuh) stripped to the ring of pool
// rows (0), with the projection (1), with the frame sampling (2), each
// writing back unchanged the pool words of the voxels it lets through;
// the fusion (3) is fuse_rows itself, built in fuse_rows.cu.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "fuse_rows.cuh"

namespace {

constexpr int kFull = 0, kLoadsOnly = 1, kWritesOnly = 2;

template <int Mode>
__global__ void __launch_bounds__(kVoxels) sample_direct_kernel(
    const float* __restrict__ img, int img_h, int img_w, const int* __restrict__ us,
    const int* __restrict__ vs, const int* __restrict__ count, int rows,
    float* __restrict__ out, uint8_t* __restrict__ valid, uint32_t* __restrict__ words) {
  const int row = blockIdx.x;
  if (row >= __ldg(count)) return;
  const size_t vi = static_cast<size_t>(row) * kVoxels + threadIdx.x;
  const int u = us[vi];
  const int v = vs[vi];
  const bool ok = u >= 0 && u < img_w && v >= 0 && v < img_h;
  const size_t plane = static_cast<size_t>(rows) * kVoxels;
  if constexpr (Mode == kWritesOnly) {
#pragma unroll
    for (int c = 0; c < kChannels; ++c) out[c * plane + vi] = ok ? static_cast<float>(c) : 0.f;
    valid[vi] = ok;
  } else {
    const int uc = min(max(u, 0), img_w - 1);
    const int vc = min(max(v, 0), img_h - 1);
    const float4* px = reinterpret_cast<const float4*>(
        img + (static_cast<size_t>(vc) * img_w + uc) * kChannels);
    const float4 a = __ldg(px);
    const float4 b = __ldg(px + 1);
    if constexpr (Mode == kFull) {
      const float s[kChannels] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int c = 0; c < kChannels; ++c) out[c * plane + vi] = ok ? s[c] : 0.f;
      valid[vi] = ok;
    } else {
      const uint32_t x = __float_as_uint(a.x) ^ __float_as_uint(a.y) ^ __float_as_uint(a.z) ^
                         __float_as_uint(a.w) ^ __float_as_uint(b.x) ^ __float_as_uint(b.y) ^
                         __float_as_uint(b.z) ^ __float_as_uint(b.w);
      words[vi] = ok ? x : 0u;
    }
  }
}

// thread 0..31 of the CTA: stage the PH x PW patch at (u0, v0) into
// `patch` ([PH][PW * 8] words), one bulk copy a patch row, on `bar`
template <int PH, int PW>
__device__ __forceinline__ void stage_patch(float* patch, const float* img, int img_w, int u0,
                                            int v0, uint64_t* bar) {
  const int lane = threadIdx.x;
  if (lane == 0) mbar_arrive_expect_tx(bar, PH * PW * kChannels * 4);
  __syncwarp();
  for (int r = lane; r < PH; r += 32) {
    bulk_load(patch + r * PW * kChannels,
              img + (static_cast<size_t>(v0 + r) * img_w + u0) * kChannels,
              PW * kChannels * 4, bar);
  }
}

template <int PH, int PW>
__global__ void __launch_bounds__(kVoxels) sample_patch_kernel(
    const float* __restrict__ img, int img_h, int img_w, const int* __restrict__ us,
    const int* __restrict__ vs, const int* __restrict__ pu0, const int* __restrict__ pv0,
    const int* __restrict__ count, int rows, int rows_per_cta, float* __restrict__ out,
    uint8_t* __restrict__ valid, int* __restrict__ skipped) {
  extern __shared__ __align__(128) float patch[];  // [PH][PW * 8]
  __shared__ __align__(8) uint64_t bar;
  const int t = threadIdx.x;
  const int n = min(__ldg(count), rows);
  if (t == 0) {
    mbar_init(&bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  const size_t plane = static_cast<size_t>(rows) * kVoxels;
  const int first = blockIdx.x * rows_per_cta;
  const int last = min(first + rows_per_cta, n);
  for (int row = first, it = 0; row < last; ++row, ++it) {
    const int u0 = __ldg(pu0 + row), v0 = __ldg(pv0 + row);
    if (t < 32) stage_patch<PH, PW>(patch, img, img_w, u0, v0, &bar);
    const size_t vi = static_cast<size_t>(row) * kVoxels + t;
    const int u = us[vi], v = vs[vi];
    const int lu = u - u0, lv = v - v0;
    const bool in_patch = lu >= 0 && lu < PW && lv >= 0 && lv < PH;
    const bool in_img = u >= 0 && u < img_w && v >= 0 && v < img_h;
    mbar_wait(&bar, it & 1);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (in_patch) {
      const float4* px = reinterpret_cast<const float4*>(patch + (lv * PW + lu) * kChannels);
      a = px[0];
      b = px[1];
    }
    const float s[kChannels] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int c = 0; c < kChannels; ++c) out[c * plane + vi] = s[c];
    valid[vi] = in_patch;
    // every thread has read the patch before the next row's copies
    const int skip = __syncthreads_count(in_img && !in_patch);
    if (t == 0 && skip) {
      atomicAdd(skipped, skip);
      atomicAdd(skipped + 1, 1);
    }
  }
}

// four one-hot bytes: byte j is 1 where row == k0 + j
__device__ __forceinline__ uint32_t onehot4(int row, int k0) {
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) w |= static_cast<uint32_t>(row == k0 + j) << (8 * j);
  return w;
}

__device__ __forceinline__ void mma_u8(int* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(0));
}

constexpr int kMmaPH = 24, kMmaPW = 32, kMmaK = 32;  // patch rows padded to the mma's k
constexpr int kMmaWords = kMmaPW * kChannels;        // 256 words a patch row
constexpr int kMmaPatchBytes = kMmaPH * kMmaWords * 4;
constexpr int kMmaPlaneBytes = 4 * kMmaWords * kMmaK;
constexpr int kMmaSmem = kMmaPatchBytes + kMmaPlaneBytes + kVoxels * 4;

__global__ void __launch_bounds__(kVoxels) sample_mma_kernel(
    const float* __restrict__ img, int img_h, int img_w, const int* __restrict__ us,
    const int* __restrict__ vs, const int* __restrict__ pu0, const int* __restrict__ pv0,
    const int* __restrict__ count, int rows, int rows_per_cta, float* __restrict__ out,
    uint8_t* __restrict__ valid, int* __restrict__ skipped) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* patch = reinterpret_cast<float*>(smem);  // [24][256] words
  // byte plane b of word column n, patch rows 4q..4q+3 (rows past 24: 0)
  uint32_t* planes = reinterpret_cast<uint32_t*>(smem + kMmaPatchBytes);  // [4][256][8]
  int* cell = reinterpret_cast<int*>(smem + kMmaPatchBytes + kMmaPlaneBytes);  // [512]
  __shared__ __align__(8) uint64_t bar;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int n = min(__ldg(count), rows);
  if (t == 0) {
    mbar_init(&bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  const size_t plane = static_cast<size_t>(rows) * kVoxels;
  const int first = blockIdx.x * rows_per_cta;
  const int last = min(first + rows_per_cta, n);
  for (int row = first, it = 0; row < last; ++row, ++it) {
    const int u0 = __ldg(pu0 + row), v0 = __ldg(pv0 + row);
    if (t < 32) stage_patch<kMmaPH, kMmaPW>(patch, img, img_w, u0, v0, &bar);
    const size_t vi = static_cast<size_t>(row) * kVoxels + t;
    const int u = us[vi], v = vs[vi];
    const int lu = u - u0, lv = v - v0;
    const bool in_patch = lu >= 0 && lu < kMmaPW && lv >= 0 && lv < kMmaPH;
    const bool in_img = u >= 0 && u < img_w && v >= 0 && v < img_h;
    // the voxel's patch cell, clipped, and its validity
    cell[t] = min(max(lu, 0), kMmaPW - 1) | (min(max(lv, 0), kMmaPH - 1) << 8) |
              (in_patch ? 1 << 16 : 0);
    mbar_wait(&bar, it & 1);
    for (int i = t; i < kMmaWords * (kMmaK / 4); i += kVoxels) {
      const int col = i % kMmaWords, q = i / kMmaWords;
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * q + j;
        w[j] = k < kMmaPH ? __float_as_uint(patch[k * kMmaWords + col]) : 0u;
      }
      const uint32_t lo = __byte_perm(w[0], w[1], 0x5140), hi = __byte_perm(w[2], w[3], 0x5140);
      // lo: bytes (w0.b0, w1.b0, w0.b1, w1.b1); hi likewise for w2, w3
      planes[(0 * kMmaWords + col) * 8 + q] = __byte_perm(lo, hi, 0x5410);
      planes[(1 * kMmaWords + col) * 8 + q] = __byte_perm(lo, hi, 0x7632);
      const uint32_t lo2 = __byte_perm(w[0], w[1], 0x7362), hi2 = __byte_perm(w[2], w[3], 0x7362);
      planes[(2 * kMmaWords + col) * 8 + q] = __byte_perm(lo2, hi2, 0x5410);
      planes[(3 * kMmaWords + col) * 8 + q] = __byte_perm(lo2, hi2, 0x7632);
    }
    __syncthreads();
    // warp w selects voxels 16 w .. 16 w + 15 and 256 + 16 w .. + 15
    for (int mt = warp; mt < kVoxels / 16; mt += kVoxels / 32) {
      const int m0 = mt * 16;
      const int c0 = cell[m0 + g], c1 = cell[m0 + g + 8];
      const int lu0 = c0 & 0xFF, lv0 = (c0 >> 8) & 0xFF;
      const int lu1 = c1 & 0xFF, lv1 = (c1 >> 8) & 0xFF;
      const uint32_t a[4] = {onehot4(lv0, tig * 4), onehot4(lv1, tig * 4),
                             onehot4(lv0, tig * 4 + 16), onehot4(lv1, tig * 4 + 16)};
      uint32_t w00 = 0, w01 = 0, w10 = 0, w11 = 0;
      for (int j = 0; j < kMmaPW; ++j) {
        const int col = j * kChannels + g;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const uint32_t* pl = planes + (b * kMmaWords + col) * 8;
          int d[4];
          mma_u8(d, a, pl[tig], pl[tig + 4]);
          if (lu0 == j) {
            w00 |= static_cast<uint32_t>(d[0]) << (8 * b);
            w01 |= static_cast<uint32_t>(d[1]) << (8 * b);
          }
          if (lu1 == j) {
            w10 |= static_cast<uint32_t>(d[2]) << (8 * b);
            w11 |= static_cast<uint32_t>(d[3]) << (8 * b);
          }
        }
      }
      // this thread holds channels 2 tig, 2 tig + 1 of voxels m0 + g, m0 + g + 8
      const size_t base = static_cast<size_t>(row) * kVoxels + m0 + g;
      const bool ok0 = c0 >> 16, ok1 = c1 >> 16;
      out[(2 * tig) * plane + base] = ok0 ? __uint_as_float(w00) : 0.f;
      out[(2 * tig + 1) * plane + base] = ok0 ? __uint_as_float(w01) : 0.f;
      out[(2 * tig) * plane + base + 8] = ok1 ? __uint_as_float(w10) : 0.f;
      out[(2 * tig + 1) * plane + base + 8] = ok1 ? __uint_as_float(w11) : 0.f;
    }
    valid[vi] = in_patch;
    // every warp is done with the patch, the planes and the cells
    const int skip = __syncthreads_count(in_img && !in_patch);
    if (t == 0 && skip) {
      atomicAdd(skipped, skip);
      atomicAdd(skipped + 1, 1);
    }
  }
}

template <int PH, int PW>
int launch_patch(const float* img, int img_h, int img_w, const int* us, const int* vs,
                 const int* pu0, const int* pv0, const int* count, int rows, int rows_per_cta,
                 float* out, uint8_t* valid, int* skipped, cudaStream_t stream) {
  constexpr int smem = PH * PW * kChannels * 4;
  auto kernel = sample_patch_kernel<PH, PW>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<(rows + rows_per_cta - 1) / rows_per_cta, kVoxels, smem, stream>>>(
      img, img_h, img_w, us, vs, pu0, pv0, count, rows, rows_per_cta, out, valid, skipped);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// P4: mode 0 K1's body, 1 pixel loads with one word written, 2 writes only
extern "C" int dst_probe_sample_direct(int mode, const float* img, int img_h, int img_w,
                                       const int* us, const int* vs, const int* count,
                                       int rows, float* out, uint8_t* valid, uint32_t* words,
                                       void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto kernel) {
    kernel<<<rows, kVoxels, 0, s>>>(img, img_h, img_w, us, vs, count, rows, out, valid, words);
  };
  switch (mode) {
    case kFull: args(sample_direct_kernel<kFull>); break;
    case kLoadsOnly: args(sample_direct_kernel<kLoadsOnly>); break;
    case kWritesOnly: args(sample_direct_kernel<kWritesOnly>); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// P1/P2/P6: shape 0 a 24x32 patch, 1 a 48x64 patch; pu0, pv0 i32 [rows]
// the aligned patch origins; skipped i32 [2] (voxels, rows), added to
extern "C" int dst_probe_sample_patch(int shape, const float* img, int img_h, int img_w,
                                      const int* us, const int* vs, const int* pu0,
                                      const int* pv0, const int* count, int rows,
                                      int rows_per_cta, float* out, uint8_t* valid,
                                      int* skipped, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (shape) {
    case 0: return launch_patch<24, 32>(img, img_h, img_w, us, vs, pu0, pv0, count, rows,
                                        rows_per_cta, out, valid, skipped, s);
    case 1: return launch_patch<48, 64>(img, img_h, img_w, us, vs, pu0, pv0, count, rows,
                                        rows_per_cta, out, valid, skipped, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// P3: the one-hot u8 mma selection at the 24x32 patch (arguments as for
// dst_probe_sample_patch)
extern "C" int dst_probe_sample_mma(const float* img, int img_h, int img_w, const int* us,
                                    const int* vs, const int* pu0, const int* pv0,
                                    const int* count, int rows, int rows_per_cta, float* out,
                                    uint8_t* valid, int* skipped, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  cudaFuncSetAttribute(sample_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kMmaSmem);
  sample_mma_kernel<<<(rows + rows_per_cta - 1) / rows_per_cta, kVoxels, kMmaSmem,
                      static_cast<cudaStream_t>(stream)>>>(
      img, img_h, img_w, us, vs, pu0, pv0, count, rows, rows_per_cta, out, valid, skipped);
  return static_cast<int>(cudaGetLastError());
}

// P5: fuse_rows_kernel<stage> for stage 0, 1, 2 (the arguments of
// dst_fuse_rows; the pool words keep their values)
extern "C" int dst_probe_fuse_stage(int stage, const float* img, int img_h, int img_w,
                                    const int* block_pos, const int* pool_idx,
                                    const int* count, int rows, int num_blocks, float* tsdf,
                                    int* rgbw, float* prob, float* minabs,
                                    const float* pose12, const float* intrinsics4,
                                    float voxel_size, float truncation, float max_depth,
                                    float max_weight, float prob_eps, float prob_hi,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0: return launch_fuse_rows<0>(img, img_h, img_w, block_pos, pool_idx, count, rows,
                                       num_blocks, tsdf, rgbw, prob, minabs, pose12,
                                       intrinsics4, voxel_size, truncation, max_depth,
                                       max_weight, prob_eps, prob_hi, s);
    case 1: return launch_fuse_rows<1>(img, img_h, img_w, block_pos, pool_idx, count, rows,
                                       num_blocks, tsdf, rgbw, prob, minabs, pose12,
                                       intrinsics4, voxel_size, truncation, max_depth,
                                       max_weight, prob_eps, prob_hi, s);
    case 2: return launch_fuse_rows<2>(img, img_h, img_w, block_pos, pool_idx, count, rows,
                                       num_blocks, tsdf, rgbw, prob, minabs, pose12,
                                       intrinsics4, voxel_size, truncation, max_depth,
                                       max_weight, prob_eps, prob_hi, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
