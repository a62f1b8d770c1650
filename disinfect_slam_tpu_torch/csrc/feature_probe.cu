// Hopper feature probe: the counterpart of the TPU probe
// scripts/probe_mosaic_features.py (P7: roll_lanes :39, roll_sublanes :57,
// take_along_lanes :76, f32_dot :91, reshape_2d_split :104,
// reshape_2d_merge :116, strided_lane_slice :128, cast_2d_3d :139), run by
// ops/cuda/feature_probe.py.
//
// One launch of feature_probe_kernel computes the Pallas probe's eight
// functions at its shapes and on its inputs, and the port's own primitive
// checks, each as a role: a fixed set of CTAs of the one grid (Role, in
// the order of feature_probe.py's ROLES).  Every input sits in one buffer
// of 4-byte words and every output in a second, at the offsets of the
// role table (Table, passed by value; feature_probe.py's LAYOUT).  The
// roles that need shared memory carve up the one buffer; every
// __syncthreads sits in a branch that is uniform over the CTA (the role
// is the CTA's).  Each thread issues all its loads before it uses one (the
// regions the kernel only reads through the read-only path), so a role
// waits on memory once, not once a word.
//   - roll_lanes: (8, 256) rolled along the lanes by a runtime shift, each
//     warp taking its words from its two source warps by __shfl_sync at
//     the shift mod 32 (the lane exchange of pose_graph.cu and raycast.cu);
//   - roll_sublanes (whole rows by a runtime shift), reshape_2d_split /
//     _merge (a row-major reshape keeps every word's flat index),
//     strided_lane_slice, cast_2d_3d (sums of integer-valued words, exact
//     in any order): address arithmetic from registers to device memory;
//   - take_along_lanes: 16 rows a CTA staged in shared memory, gathered by
//     index;
//   - f32_dot: 256^3 in 16x32 output tiles (128 CTAs, one an SM), a and b
//     in chunks of 64 in j double-buffered in shared memory (b transposed),
//     two outputs a thread in registers, j ascending, as s = s + a b by
//     __fmul_rn / __fadd_rn (no contraction, whatever the flags) and as the
//     same sum by __fmaf_rn;
//   - __reduce_min_sync / __reduce_max_sync on int and unsigned words (the
//     footprint box of the splat kernels);
//   - shared and global atomicMin / atomicMax on int and on unsigned words
//     with the top bit set, 128 values a slot (the splat merges): one CTA
//     a shared merge; the global role's 32 CTAs merge into the initial
//     rows of the input buffer, a slot a 128-byte line, and the last CTA to
//     finish (a ticket) copies them out and resets the ticket;
//   - four cp.async.bulk copies into shared memory completing on one
//     mbarrier phase (fuse_rows' ring, the sample probe's staging);
//   - __float2int_rz on +-inf, NaN and large values (the projection's pixel);
//   - a double sqrt rounded to float beside __fsqrt_rn (the splat range),
//     over 5 CTAs.
// Where the caller asks, each CTA records its start and end on the
// device's nanosecond clock (scripts/port_feature_probe_stage.py reads
// each role's span from them).
// Bound: operations, the dot's 2 x 2 x 256^3 float32 operations (~1.0 us
// at the card's 67 TFLOP/s); its 50.3 M float32 instructions over 132 SMs
// x 128 lanes set an issue floor of ~1.5 us, and its 256 dependent adds a
// sum an order floor of ~0.5 us.  The dot's CTAs set the launch's time;
// the other roles run beside them, on the SMs they leave and on theirs.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "bulk_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBytes = 26112;  // the dot's two chunks
constexpr int kN = 256;  // take_along_lanes' and f32_dot's width
constexpr int kSlots = 64, kValues = 8192;
constexpr int kChunkWords = 512, kChunks = 4;
constexpr int kF2I = 10, kRoots = 4100;
constexpr int kLine = 32;  // the words of a 128-byte line

enum Role {
  kDot, kTake, kGlobalAtomics, kRollLanes, kRollRows, kSplit, kMerge, kStrided, kCast, kReduce,
  kSharedAtomics, kBulk, kFloat2Int, kSqrt, kRoles
};
constexpr int kDotCtas = 128, kTakeCtas = 16, kGlobalCtas = 32, kSharedCtas = 4, kRootCtas = 5;
constexpr int kRoleCtas[kRoles] = {kDotCtas, kTakeCtas, kGlobalCtas, 1, 1, 1, 1,
                                   1,        1,         1,           kSharedCtas, 1, 1, kRootCtas};

enum In {
  iRollLanes, iRollRows, iTakeX, iTakeIdx, iDotA, iDotB, iSplit, iMerge, iStrided, iCast,
  iReduce, iVals, iSlots, iGlobal, iBulk, iSqrt, iF2I, iTicket, kIns
};
constexpr int kInWords[kIns] = {8 * 256, 64 * 128, kN * kN, kN * kN, kN * kN, kN * kN,
                                24 * 256, 512 * 16, 8 * 256, 8 * 256, 16 * 32, kValues, kValues,
                                4 * kSlots * kLine, kChunks * kChunkWords, kRoots, kF2I, 1};

enum Out {
  oRollLanes, oRollRows, oTake, oDot, oDotFma, oSplit, oMerge, oStrided, oCast, oReduce,
  oShared, oGlobal, oBulk, oSqrt, oF2I, kOuts
};
constexpr int kOutWords[kOuts] = {8 * 256, 64 * 128, kN * kN, kN * kN, kN * kN, 768 * 8, 8192,
                                  8 * 32, 8 * 32, 4 * 16, 4 * kSlots, 4 * kSlots,
                                  kChunks * kChunkWords, 2 * kRoots, kF2I};

// each role's first CTA (first[kRoles]: the grid), each region's offset in
// words, the two shifts
struct Table {
  int first[kRoles + 1];
  int in[kIns];
  int out[kOuts];
  int lane_shift, row_shift;
};

__device__ __forceinline__ const float* fin(const int* in, const Table& T, int r) {
  return reinterpret_cast<const float*>(in + T.in[r]);
}
__device__ __forceinline__ float* fout(int* out, const Table& T, int r) {
  return reinterpret_cast<float*>(out + T.out[r]);
}
__device__ __forceinline__ const float4* fin4(const int* in, const Table& T, int r) {
  return reinterpret_cast<const float4*>(in + T.in[r]);
}
__device__ __forceinline__ float4* fout4(int* out, const Table& T, int r) {
  return reinterpret_cast<float4*>(out + T.out[r]);
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

// a row-major copy of kWords words, float4 t + q kThreads of a thread:
// a reshape keeps every word's flat index, (i, k) of (rows, 8) being word
// 8 i + k of (24, 256) and (i, 0) of (8192, 1) word i of (512, 16)
template <int kWords>
__device__ __forceinline__ void reshape(const float4* x, float4* o) {
  constexpr int kPer = kWords / (4 * kThreads);
  static_assert(kPer * 4 * kThreads == kWords, "whole float4s a thread");
  float4 v[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) v[q] = __ldg(x + threadIdx.x + q * kThreads);
#pragma unroll
  for (int q = 0; q < kPer; ++q) o[threadIdx.x + q * kThreads] = v[q];
}

// f32_dot: the output tile (16 rows, 32 columns) of CTA `cta`.  Warp w
// takes rows 8 (w / 4) + [0, 8) and columns 8 (w % 4) + [0, 8) of it, lane
// l rows l / 8 + 4 i (i < 2) of those and column l % 8, plain and fused:
// per 4 j a lane reads float4s along j (its rows of a, its column of b,
// which shared memory holds transposed), 4 and 8 distinct ones in a warp,
// in distinct banks (rows padded to kPad words).  a and b's chunks of
// kChunk in j are double-buffered, the next chunk's loads in flight while
// this one's products are summed.
constexpr int kTileR = 16, kTileC = 32, kRows = 2, kChunk = 64, kPad = kChunk + 4;
constexpr int kAPer = kTileR * kChunk / 4 / kThreads, kBPer = kChunk * kTileC / 4 / kThreads;
constexpr int kStageWords = (kTileR + kTileC) * kPad;  // sa [kTileR][kPad], sb [kTileC][kPad]
static_assert(kTileR * kTileC * kDotCtas == kN * kN && kRows * 8 == kTileR, "the dot's tiles");
static_assert(kAPer * kThreads * 4 == kTileR * kChunk && kBPer * kThreads * 4 == kChunk * kTileC,
              "whole float4s of a chunk a thread");
static_assert(2 * kStageWords * 4 <= kSmemBytes, "two chunks in the shared buffer");
__device__ void dot(const int* in, int* out, const Table& T, int cta, float* smem) {
  const float4* a = fin4(in, T, iDotA);
  const float4* b = fin4(in, T, iDotB);
  const int r0 = (cta / (kN / kTileC)) * kTileR, c0 = (cta % (kN / kTileC)) * kTileC;
  const int t = threadIdx.x, w = t >> 5, l = t & 31;
  // a chunk's float4 t + q kThreads: of a, row i / (kChunk / 4) and j 4 (i % (kChunk / 4));
  // of b, j i / (kTileC / 4) and columns 4 (i % (kTileC / 4)) + [0, 4)
  float4 va[kAPer], vb[kBPer];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < kAPer; ++q) {
      const int i = t + q * kThreads;
      va[q] = __ldg(a + ((r0 + i / (kChunk / 4)) * kN + k0) / 4 + i % (kChunk / 4));
    }
#pragma unroll
    for (int q = 0; q < kBPer; ++q) {
      const int i = t + q * kThreads;
      vb[q] = __ldg(b + ((k0 + i / (kTileC / 4)) * kN + c0) / 4 + i % (kTileC / 4));
    }
  };
  auto keep = [&](float* sa) {
    float* sb = sa + kTileR * kPad;
#pragma unroll
    for (int q = 0; q < kAPer; ++q) {
      const int i = t + q * kThreads;
      float* row = sa + (i / (kChunk / 4)) * kPad;
      *reinterpret_cast<float4*>(row + 4 * (i % (kChunk / 4))) = va[q];
    }
#pragma unroll
    for (int q = 0; q < kBPer; ++q) {
      const int i = t + q * kThreads, j = i / (kTileC / 4), c = 4 * (i % (kTileC / 4));
      sb[c * kPad + j] = vb[q].x;
      sb[(c + 1) * kPad + j] = vb[q].y;
      sb[(c + 2) * kPad + j] = vb[q].z;
      sb[(c + 3) * kPad + j] = vb[q].w;
    }
  };
  const int ra = 8 * (w >> 2) + (l >> 3), cb = 8 * (w & 3) + (l & 7);
  float p[kRows], f[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) p[i] = f[i] = 0.f;
  load(0);
  keep(smem);
  __syncthreads();
  for (int c = 0; c < kN / kChunk; ++c) {
    const float* sa = smem + (c & 1) * kStageWords;
    const float* sb = sa + kTileR * kPad;
    if (c + 1 < kN / kChunk) load((c + 1) * kChunk);
#pragma unroll 4
    for (int j = 0; j < kChunk; j += 4) {
      const float4 y4 = *reinterpret_cast<const float4*>(sb + cb * kPad + j);
      const float y[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 x4 = *reinterpret_cast<const float4*>(sa + (ra + 4 * i) * kPad + j);
        const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          p[i] = __fadd_rn(p[i], __fmul_rn(x[q], y[q]));
          f[i] = __fmaf_rn(x[q], y[q], f[i]);
        }
      }
    }
    if (c + 1 < kN / kChunk) {  // uniform
      keep(smem + ((c + 1) & 1) * kStageWords);  // the buffer read one chunk ago
      __syncthreads();
    }
  }
  float* plain = fout(out, T, oDot);
  float* fused = fout(out, T, oDotFma);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int o = (r0 + ra + 4 * i) * kN + c0 + cb;
    plain[o] = p[i];
    fused[o] = f[i];
  }
}

// take_along_lanes: rows [16 cta, 16 cta + 16) staged, out[r][c] = x[r][idx[r][c]]
constexpr int kTakeRows = kN / kTakeCtas, kTakePer = kTakeRows * kN / 4 / kThreads;
__device__ void take(const int* in, int* out, const Table& T, int cta, float* s) {
  const int base = cta * kTakeRows * kN / 4;  // in float4
  const float4* x = fin4(in, T, iTakeX) + base;
  const int4* idx = reinterpret_cast<const int4*>(in + T.in[iTakeIdx]) + base;
  float4 v[kTakePer];
  int4 k[kTakePer];
#pragma unroll
  for (int q = 0; q < kTakePer; ++q) {
    v[q] = __ldg(x + threadIdx.x + q * kThreads);
    k[q] = __ldg(idx + threadIdx.x + q * kThreads);
  }
#pragma unroll
  for (int q = 0; q < kTakePer; ++q) {
    reinterpret_cast<float4*>(s)[threadIdx.x + q * kThreads] = v[q];
  }
  __syncthreads();
  float4* o = fout4(out, T, oTake) + base;
#pragma unroll
  for (int q = 0; q < kTakePer; ++q) {
    const float* row = s + ((threadIdx.x + q * kThreads) * 4 / kN) * kN;
    o[threadIdx.x + q * kThreads] =
        make_float4(row[k[q].x], row[k[q].y], row[k[q].z], row[k[q].w]);
  }
}

// the global atomics: this CTA's share of the values (kGlobalPer a
// thread, loaded at once) merged into the initial rows (int min, int max,
// unsigned min, unsigned max) in place, each slot the first word of a
// 128-byte line of its own (kLine words), so that the slots' merges queue
// on 256 lines and not on 8; the last CTA of the role to finish copies the
// rows out
constexpr int kGlobalPer = kValues / kGlobalCtas / kThreads;
static_assert(kGlobalPer * kGlobalCtas * kThreads == kValues, "whole values a thread");
__device__ void global_atomics(int* in, int* out, const Table& T, int cta, int* s) {
  int* g = in + T.in[iGlobal];
  const int* vals = in + T.in[iVals];
  const int* slots = in + T.in[iSlots];
  int v[kGlobalPer], k[kGlobalPer];
#pragma unroll
  for (int q = 0; q < kGlobalPer; ++q) {
    const int i = (cta * kGlobalPer + q) * kThreads + threadIdx.x;
    v[q] = __ldg(vals + i);
    k[q] = __ldg(slots + i) * kLine;
  }
  unsigned* u = reinterpret_cast<unsigned*>(g);
#pragma unroll
  for (int q = 0; q < kGlobalPer; ++q) {
    atomicMin(g + k[q], v[q]);
    atomicMax(g + kSlots * kLine + k[q], v[q]);
    atomicMin(u + 2 * kSlots * kLine + k[q], static_cast<unsigned>(v[q]));
    atomicMax(u + 3 * kSlots * kLine + k[q], static_cast<unsigned>(v[q]));
  }
  __threadfence();
  __syncthreads();
  int* ticket = in + T.in[iTicket];
  if (threadIdx.x == 0) s[0] = atomicAdd(ticket, 1) == kGlobalCtas - 1;
  __syncthreads();
  if (s[0]) {  // uniform: every other CTA's merges are in
    __threadfence();
    for (int j = threadIdx.x; j < 4 * kSlots; j += kThreads) {
      out[T.out[oGlobal] + j] = __ldcg(g + j * kLine);
    }
    if (threadIdx.x == 0) *ticket = 0;
  }
}

// roll_lanes: out[r][c] = x[r][(c - shift) mod 256]; lane l of warp w reads
// x[r][32 w' + l] of its two source warps w' = w - q and w - q - 1 (q =
// shift / 32) and takes lane (l - p) mod 32 of one of them (p = shift mod 32)
__device__ void roll_lanes(const int* in, int* out, const Table& T) {
  const float* x = fin(in, T, iRollLanes);
  float* o = fout(out, T, oRollLanes);
  const int shift = ((T.lane_shift % 256) + 256) % 256;
  const int q = shift >> 5, p = shift & 31;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  float hi[8], lo[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    hi[r] = __ldg(x + r * 256 + 32 * ((w - q) & 7) + lane);
    lo[r] = __ldg(x + r * 256 + 32 * ((w - q - 1) & 7) + lane);
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const float vh = __shfl_sync(0xffffffffu, hi[r], (lane - p) & 31);
    const float vl = __shfl_sync(0xffffffffu, lo[r], (lane - p) & 31);
    o[r * 256 + t] = lane >= p ? vh : vl;
  }
}

// roll_sublanes: out[r][c] = x[(r - shift) mod 64][c], 32 float4 a row
__device__ void roll_rows(const int* in, int* out, const Table& T) {
  constexpr int kPer = 64 * 128 / 4 / kThreads;
  const int shift = ((T.row_shift % 64) + 64) % 64;
  const float4* x = fin4(in, T, iRollRows);
  float4* o = fout4(out, T, oRollRows);
  float4 v[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = threadIdx.x + q * kThreads, r = i / 32, c = i % 32;
    v[q] = __ldg(x + ((r - shift + 64) % 64) * 32 + c);
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) o[threadIdx.x + q * kThreads] = v[q];
}

// strided_lane_slice: (8, 256)[:, ::8], a word a thread
__device__ void strided(const int* in, int* out, const Table& T) {
  const int i = threadIdx.x;
  fout(out, T, oStrided)[i] = __ldg(fin(in, T, iStrided) + (i / 32) * 256 + 8 * (i % 32));
}

// cast_2d_3d: (8, 256) -> (8, 32, 8) summed over the last axis, a sum of
// two float4 a thread
__device__ void cast(const int* in, int* out, const Table& T) {
  const float4* x = fin4(in, T, iCast) + 2 * threadIdx.x;  // word 8 i of (8, 256)
  const float4 u = __ldg(x), v = __ldg(x + 1);
  const float w[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) acc = __fadd_rn(acc, w[k]);
  fout(out, T, oCast)[threadIdx.x] = acc;
}

// out[4][16]: each data warp's min and max as int, min and max as unsigned
__device__ void reduce(const int* in, int* out, const Table& T) {
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31, w0 = threadIdx.x >> 5;
  int* o = out + T.out[oReduce];
  int v[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) v[h] = __ldg(in + T.in[iReduce] + (w0 + 8 * h) * 32 + lane);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int w = w0 + 8 * h;
    const int mn = __reduce_min_sync(all, v[h]), mx = __reduce_max_sync(all, v[h]);
    const unsigned umn = __reduce_min_sync(all, static_cast<unsigned>(v[h]));
    const unsigned umx = __reduce_max_sync(all, static_cast<unsigned>(v[h]));
    if (lane == 0) {
      o[w] = mn;
      o[16 + w] = mx;
      o[32 + w] = static_cast<int>(umn);
      o[48 + w] = static_cast<int>(umx);
    }
  }
}

// the shared atomics: every value merged into its slot of a shared array,
// one merge a CTA (cta 0 int min, 1 int max, 2 unsigned min, 3 unsigned
// max), 128 values a slot: out[cta][64]; a thread's 32 values and slots
// loaded as int4s at once
constexpr int kSharedPer = kValues / 4 / kThreads;
static_assert(kSharedCtas == 4, "one CTA a merge");
__device__ void shared_atomics(const int* in, int* out, const Table& T, int cta, int* s) {
  const int4* vals = reinterpret_cast<const int4*>(in + T.in[iVals]);
  const int4* slots = reinterpret_cast<const int4*>(in + T.in[iSlots]);
  int4 v[kSharedPer], k[kSharedPer];
#pragma unroll
  for (int q = 0; q < kSharedPer; ++q) {
    v[q] = __ldg(vals + threadIdx.x + q * kThreads);
    k[q] = __ldg(slots + threadIdx.x + q * kThreads);
  }
  if (threadIdx.x < kSlots) {  // -1: the largest unsigned word
    s[threadIdx.x] = cta == 0 ? INT_MAX : cta == 1 ? INT_MIN : cta == 2 ? -1 : 0;
  }
  __syncthreads();
  unsigned* u = reinterpret_cast<unsigned*>(s);
#pragma unroll
  for (int q = 0; q < kSharedPer; ++q) {
    const int vs[4] = {v[q].x, v[q].y, v[q].z, v[q].w}, ks[4] = {k[q].x, k[q].y, k[q].z, k[q].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      switch (cta) {  // uniform over the CTA
        case 0: atomicMin(s + ks[e], vs[e]); break;
        case 1: atomicMax(s + ks[e], vs[e]); break;
        case 2: atomicMin(u + ks[e], static_cast<unsigned>(vs[e])); break;
        default: atomicMax(u + ks[e], static_cast<unsigned>(vs[e])); break;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < kSlots) out[T.out[oShared] + cta * kSlots + threadIdx.x] = s[threadIdx.x];
}

// four 2 KB bulk copies into shared memory on one mbarrier phase, written out
__device__ void bulk(const int* in, int* out, const Table& T, float* s) {
  uint64_t* bar = reinterpret_cast<uint64_t*>(s + kChunks * kChunkWords);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, kChunks * kChunkWords * 4);
    for (int c = 0; c < kChunks; ++c) {
      bulk_load(s + c * kChunkWords, fin(in, T, iBulk) + c * kChunkWords, kChunkWords * 4, bar);
    }
  }
  mbar_wait(bar, 0);
  float4* o = fout4(out, T, oBulk);
#pragma unroll
  for (int q = 0; q < kChunks * kChunkWords / 4 / kThreads; ++q) {
    o[threadIdx.x + q * kThreads] = reinterpret_cast<const float4*>(s)[threadIdx.x + q * kThreads];
  }
}

__device__ void float2int(const int* in, int* out, const Table& T) {
  if (threadIdx.x < kF2I) {
    out[T.out[oF2I] + threadIdx.x] = __float2int_rz(__ldg(fin(in, T, iF2I) + threadIdx.x));
  }
}

// out[2][n]: sqrt in double rounded to float, and __fsqrt_rn; a float4 a
// thread, kRootCtas CTAs
constexpr int kRootThreads = kRoots / 4 / kRootCtas;
static_assert(kRootThreads * kRootCtas * 4 == kRoots && kRootThreads <= kThreads,
              "a float4 a thread");
__device__ void roots(const int* in, int* out, const Table& T, int cta) {
  if (threadIdx.x >= kRootThreads) return;
  const int i = cta * kRootThreads + threadIdx.x;
  const float4 v = __ldg(fin4(in, T, iSqrt) + i);
  const float w[4] = {v.x, v.y, v.z, v.w};
  float d[4], f[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    d[e] = __double2float_rn(sqrt(static_cast<double>(w[e])));
    f[e] = __fsqrt_rn(w[e]);
  }
  float4* o = fout4(out, T, oSqrt);
  o[i] = make_float4(d[0], d[1], d[2], d[3]);
  o[kRoots / 4 + i] = make_float4(f[0], f[1], f[2], f[3]);
}

// clocks, where the caller asks for them: [2][grid] the device's
// nanosecond clock at each CTA's start and end
__global__ void __launch_bounds__(kThreads) feature_probe_kernel(int* __restrict__ in,
                                                                 int* __restrict__ out,
                                                                 const Table T,
                                                                 unsigned long long* clocks) {
  __shared__ __align__(128) float smem[kSmemBytes / 4];
  const uint64_t t0 = now_ns();
  int role = 0;
#pragma unroll
  for (int r = 1; r < kRoles; ++r) role += static_cast<int>(blockIdx.x) >= T.first[r];
  int cta = static_cast<int>(blockIdx.x);
#pragma unroll
  for (int r = 0; r < kRoles; ++r) cta -= r == role ? T.first[r] : 0;
  int* ismem = reinterpret_cast<int*>(smem);
  switch (role) {
    case kDot: dot(in, out, T, cta, smem); break;
    case kTake: take(in, out, T, cta, smem); break;
    case kGlobalAtomics: global_atomics(in, out, T, cta, ismem); break;
    case kRollLanes: roll_lanes(in, out, T); break;
    case kRollRows: roll_rows(in, out, T); break;
    case kSplit: reshape<24 * 256>(fin4(in, T, iSplit), fout4(out, T, oSplit)); break;
    case kMerge: reshape<512 * 16>(fin4(in, T, iMerge), fout4(out, T, oMerge)); break;
    case kStrided: strided(in, out, T); break;
    case kCast: cast(in, out, T); break;
    case kReduce: reduce(in, out, T); break;
    case kSharedAtomics: shared_atomics(in, out, T, cta, ismem); break;
    case kBulk: bulk(in, out, T, smem); break;
    case kFloat2Int: float2int(in, out, T); break;
    default: roots(in, out, T, cta); break;
  }
  if (clocks != nullptr) {
    __syncthreads();  // uniform: every role's threads are here
    if (threadIdx.x == 0) {
      clocks[blockIdx.x] = t0;
      clocks[gridDim.x + blockIdx.x] = now_ns();
    }
  }
}

// the table as feature_probe.py lays it out: each role its CTAs, regions
// ascending without overlap, the float4 and bulk-copy sources 16-byte aligned
bool valid(const Table& T) {
  if (T.first[0] != 0) return false;
  for (int r = 0; r < kRoles; ++r) {
    if (T.first[r + 1] - T.first[r] != kRoleCtas[r]) return false;
  }
  for (int i = 0; i < kIns; ++i) {
    if (T.in[i] < (i ? T.in[i - 1] + kInWords[i - 1] : 0)) return false;
  }
  for (int i = 0; i < kOuts; ++i) {
    if (T.out[i] < (i ? T.out[i - 1] + kOutWords[i - 1] : 0)) return false;
  }
  for (int i = 0; i < kIns; ++i) {
    if (i != iF2I && i != iTicket && T.in[i] % 4 != 0) return false;
  }
  for (int i = 0; i < kOuts; ++i) {
    if (T.out[i] % 4 != 0) return false;
  }
  return true;
}

}  // namespace

// in: the packed inputs (int32 words, 16-byte aligned; its atomics_global
// rows are merged in place); out: the packed outputs; table: int32 [n]
// host words, Table's fields in order; clocks: null, or uint64 [2][grid]
extern "C" int dst_feature_probe(int* in, int* out, const int* table, int n,
                                 unsigned long long* clocks, void* stream) {
  Table T;
  if (n * sizeof(int) != sizeof(Table)) return static_cast<int>(cudaErrorInvalidValue);
  memcpy(&T, table, sizeof(Table));
  if (!valid(T)) return static_cast<int>(cudaErrorInvalidValue);
  feature_probe_kernel<<<T.first[kRoles], kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, T, clocks);
  return static_cast<int>(cudaGetLastError());
}
