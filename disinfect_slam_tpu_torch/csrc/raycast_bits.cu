// superblock_bits: the dense block table's superblock occupancy, one bit a
// 4x4x4-block superblock, for the raycast kernel (csrc/raycast.cu).
//
// Replaces no TPU kernel: its counterpart is the JAX raycaster's
// superblock table (disinfect_slam_tpu/ops/raycast.py:114-130, XLA ops
// under jax.jit, no Pallas), which folds a -3 into every empty cell of an
// empty superblock.  The march needs only whether a superblock holds any
// block, so this writes that alone: bit sb & 31 of word sb >> 5 is set iff
// any of superblock sb's 64 cells holds a pool row (>= 0), with
// sb = (sx * s + sy) * s + sz over the s = grid_side / 4 superblocks a
// side, in the table's own x, y, z order; the words are padded with zeros
// to a multiple of four (16 bytes), so that one bulk copy moves them into
// shared memory.  Its plain version is
// ops/raycast.py:superblock_bits_reference.
//
// Layout: one thread a superblock, so one warp a word (__ballot_sync).
// A superblock's four z cells are 16 contiguous bytes, so a thread makes
// 16 int4 loads, one for each of its (x, y) rows; neighbouring lanes hold
// neighbouring z, so each of a warp's loads is one contiguous run.  A
// cell is occupied iff its sign bit is clear, so the AND of the 64 cells
// is negative iff none is.  What bounds it: the table's bytes, read once
// (67.1 MB at grid_log2 = 8, 0.020 ms at 3.35 TB/s); the bits are 32 KB.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    superblock_bits_kernel(const int4* __restrict__ table, unsigned* __restrict__ bits,
                           int glog2, int n_super, int words) {
  const int sb = blockIdx.x * kThreads + threadIdx.x;
  // a warp is one word: its lanes leave together
  if ((sb >> 5) >= words) return;
  bool occupied = false;
  if (sb < n_super) {
    const int sl = glog2 - 2;  // log2 of the superblocks a side
    const int sx = sb >> (2 * sl), sy = (sb >> sl) & ((1 << sl) - 1);
    const int sz = sb & ((1 << sl) - 1);
    int all = -1;
#pragma unroll
    for (int dx = 0; dx < 4; ++dx) {
#pragma unroll
      for (int dy = 0; dy < 4; ++dy) {
        // cells (x, y, 4 sz .. 4 sz + 3): int4 (x << (2 glog2 - 2)) | (y << (glog2 - 2)) | sz
        const int x = 4 * sx + dx, y = 4 * sy + dy;
        const int4 q = __ldg(table + ((x << (2 * glog2 - 2)) | (y << sl) | sz));
        all &= q.x & q.y & q.z & q.w;
      }
    }
    occupied = all >= 0;
  }
  const unsigned word = __ballot_sync(0xffffffffu, occupied);
  if ((threadIdx.x & 31) == 0) bits[sb >> 5] = word;
}

}  // namespace

// table: the dense block table, int32 [2^(3 glog2)], 16-byte aligned;
// bits: [words] out, words = the superblocks' words padded to a multiple
// of 4.  glog2 in [3, 10].
extern "C" int dst_superblock_bits(const int* table, unsigned* bits, int glog2, int words,
                                   void* stream) {
  if (glog2 < 3 || glog2 > 10) return static_cast<int>(cudaErrorInvalidValue);
  const int n_super = 1 << (3 * (glog2 - 2));
  if (words < (n_super + 31) / 32 || words % 4 != 0 ||
      (reinterpret_cast<uintptr_t>(table) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = words * 32;
  const int grid = (threads + kThreads - 1) / kThreads;
  superblock_bits_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(table), bits, glog2, n_super, words);
  return static_cast<int>(cudaGetLastError());
}
