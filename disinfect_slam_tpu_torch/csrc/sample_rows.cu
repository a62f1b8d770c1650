// sample_rows: the stacked frame channels at every voxel's pixel.
//
// Replaces the TPU kernel sample_patches (K1) of
// disinfect_slam_tpu/ops/pallas/sample_kernel.py, which DMAs a 24x32
// patch per block into VMEM and selects each voxel's pixel with one-hot
// bf16 matmuls (split three ways to stay exact), flagging voxels outside
// the patch.  On Hopper a load is a load: each thread reads its voxel's
// 32-byte pixel (two float4) directly, so every in-image voxel is sampled
// exactly and none is skipped.
//
// Layout: one CTA of 512 threads per visible block row (the CUDA
// original's tsdf_integrate_kernel layout, voxel_tsdf.cu:474-481); rows
// at or past the device-side live count return at once.
//
// What bounds it: device memory bytes.  Per voxel it reads 8 B of pixel
// coordinates and writes 8 x 4 B of channel planes plus 1 B of validity;
// the 9.8 MB VGA frame stays in the 50 MB L2, so the pixel loads are
// mostly L2 hits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVoxels = 512;
constexpr int kChannels = 8;

__global__ void __launch_bounds__(kVoxels) sample_rows_kernel(
    const float* __restrict__ img, int img_h, int img_w,
    const int* __restrict__ us, const int* __restrict__ vs,
    const int* __restrict__ count, int rows,
    float* __restrict__ out, uint8_t* __restrict__ valid) {
  const int row = blockIdx.x;
  if (row >= __ldg(count)) return;
  const size_t vi = static_cast<size_t>(row) * kVoxels + threadIdx.x;
  const int u = us[vi];
  const int v = vs[vi];
  const bool ok = u >= 0 && u < img_w && v >= 0 && v < img_h;
  const int uc = min(max(u, 0), img_w - 1);
  const int vc = min(max(v, 0), img_h - 1);
  const float4* px = reinterpret_cast<const float4*>(
      img + (static_cast<size_t>(vc) * img_w + uc) * kChannels);
  const float4 a = __ldg(px);
  const float4 b = __ldg(px + 1);
  const float s[kChannels] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const size_t plane = static_cast<size_t>(rows) * kVoxels;
#pragma unroll
  for (int c = 0; c < kChannels; ++c) out[c * plane + vi] = ok ? s[c] : 0.f;
  valid[vi] = ok;
}

}  // namespace

extern "C" int dst_sample_rows(const float* img, int img_h, int img_w,
                               const int* us, const int* vs, const int* count,
                               int rows, float* out, uint8_t* valid,
                               void* stream) {
  if (rows > 0) {
    sample_rows_kernel<<<rows, kVoxels, 0, static_cast<cudaStream_t>(stream)>>>(
        img, img_h, img_w, us, vs, count, rows, out, valid);
  }
  return static_cast<int>(cudaGetLastError());
}
