// fuse_rows: projection, frame sampling and semantic TSDF fusion of the
// visible blocks, in place on the pool (the kernel, its design and its
// bound: fuse_rows.cuh).  pose12 (r00..r22, t0..t2) is a device pointer;
// the intrinsics and the constants come by value.
#include "fuse_rows.cuh"

extern "C" int dst_fuse_rows(const float* img, int img_h, int img_w,
                             const int* block_pos, const int* pool_idx,
                             const int* count, int rows, int num_blocks,
                             float* tsdf, int* rgbw, float* prob, float* minabs,
                             const float* pose12, const float* intrinsics4,
                             float voxel_size, float truncation, float max_depth,
                             float max_weight, float prob_eps, float prob_hi,
                             void* stream) {
  return launch_fuse_rows<3>(img, img_h, img_w, block_pos, pool_idx, count, rows, num_blocks,
                             tsdf, rgbw, prob, minabs, pose12, intrinsics4, voxel_size,
                             truncation, max_depth, max_weight, prob_eps, prob_hi,
                             static_cast<cudaStream_t>(stream));
}
