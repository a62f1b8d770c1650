// Grid size of the persistent kernels (fuse_rows.cu, splat_zbuf_tile.cuh):
// each CTA loops over rows up to a live count it reads on the device, so
// a launch takes as many CTAs as the card holds at once, no more than the
// rows.
#pragma once
#include <cuda_runtime.h>

namespace {

// CTAs of `threads` threads of `kernel` resident on the current device at
// once.  Callers keep it in a function-local static, so the occupancy is
// asked once per kernel, not on every launch (one kind of card per
// process).
template <typename Kernel>
int resident_ctas(Kernel kernel, int threads) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return max(per_sm, 1) * max(sms, 1);
}

}  // namespace
