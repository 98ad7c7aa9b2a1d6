// P1: the per-tile cost ladder of the tile rasterizer, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of devtools/probe_kernel_floor.py:make (one
// pl.pallas_call per mode), which splits K1's per-tile cost into parts over
// 8160 tiles of 16x16 px (1080p). Every mode writes one [256 px, 72] f32 block
// per tile; the modes add work in order:
//   0 empty   zeros;
//   1 dma     + copy two windows of 3 payload blocks ([3, 72, 128] f32 each,
//             block start ranges[4t + r]) into shared memory; writes
//             zeros + the first copied float;
//   2 eval    + per pixel the nearest covered candidate over both windows'
//             3 x 128 candidates: planes b0 (rows 0-2), b1 (3-5), z (6-8) at
//             tile-local (px, py) = (p % 16, p / 16), b2 = (1 - b0) - b1,
//             covered when b0, b1, b2 >= 0 and 0 <= z <= 1; within a block
//             the lowest lane wins a tie, across blocks only a strictly
//             nearer block replaces the best; writes [z, index, z x 70]
//             (z = 3e38, index = -1 where nothing covers);
//   3 cond    + skip block j of window r unless ranges[4t + 2 + r] > 128 j;
//   4 select  + sum, over both windows' blocks that pass the same test, the
//             72-row payload column of the winner's window-local index
//             (the reference's one-hot MXU product, as a gather).
// Plane evaluations use explicit _rn intrinsics, as csrc/raster.cu, so they
// round like the plain PyTorch version.
//
// Design (first, simple version): one 256-thread block per tile, one pixel
// per thread. The two windows (221,184 B) are copied into dynamic shared
// memory with 16-byte loads, over the 48 KB default and so opted into with
// cudaFuncSetAttribute: one block per SM. Candidates are read from shared
// memory as broadcasts. The output is pixel-major (72 floats per pixel), so
// a thread writing its own row would store at a 288-byte stride across the
// warp; instead each block stages its [256, 72] result in shared memory (in
// the window buffer, once every thread is done reading it) and writes it out
// as contiguous 16-byte stores.
//
// Bound on the H100 (3.35 TB/s HBM, 67 T/s FP32 non-tensor), as
// devtools/probe_kernel_floor.py:bound_ms counts it: bytes = the output
// (601.6 MB at 8160 tiles) + the payload blocks the windows reference, read
// once, + the ranges; operations = 14 per (pixel, evaluated candidate) plane
// evaluation, + one add per selected row in select. empty and dma are bytes-
// bound, the evaluating modes operation-bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;
constexpr int kRows = 72;
constexpr int kNB = 3;
constexpr int kLanes = 128;
constexpr int kBlockFloats = kRows * kLanes;       // one [72, 128] payload block
constexpr int kWinFloats = kNB * kBlockFloats;     // one window of 3 blocks
constexpr int kOutFloats = kTile * kTile * kRows;  // one tile's output block
constexpr float kInf = 3.0e38f;

enum Mode { kEmpty = 0, kDma = 1, kEval = 2, kCond = 3, kSelect = 4 };

__device__ __forceinline__ float plane(float a, float b, float c, float x, float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

__device__ __forceinline__ void fill_out(float* out, int t, float v) {
  float4* o4 = reinterpret_cast<float4*>(out + static_cast<size_t>(t) * kOutFloats);
  const float4 f = make_float4(v, v, v, v);
  for (int e = threadIdx.x; e < kOutFloats / 4; e += kThreads) o4[e] = f;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
p1_floor_kernel(const int* __restrict__ ranges, const float* __restrict__ payload,
                int p_blocks, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int t = blockIdx.x;
  if (MODE == kEmpty) {
    fill_out(out, t, 0.0f);
    return;
  }
  float* data = reinterpret_cast<float*>(smem4);  // [2][3][72][128]
  for (int r = 0; r < 2; ++r) {
    // clamped so no window reads past the payload (the plain version clamps too)
    const int a = min(max(ranges[t * 4 + r], 0), p_blocks - kNB);
    const float4* src = reinterpret_cast<const float4*>(
        payload + static_cast<size_t>(a) * kBlockFloats);
    float4* dst = smem4 + r * (kWinFloats / 4);
    for (int e = threadIdx.x; e < kWinFloats / 4; e += kThreads) dst[e] = src[e];
  }
  __syncthreads();
  if (MODE == kDma) {
    fill_out(out, t, 0.0f + data[0]);
    return;
  }

  const int p = threadIdx.x;
  const float px = static_cast<float>(p % kTile);
  const float py = static_cast<float>(p / kTile);
  const int cnt[2] = {ranges[t * 4 + 2], ranges[t * 4 + 3]};
  float bz = kInf;
  int bi = -1;
  for (int r = 0; r < 2; ++r) {
    for (int j = 0; j < kNB; ++j) {
      if (MODE >= kCond && !(cnt[r] > kLanes * j)) continue;
      const float* geo = data + (r * kNB + j) * kBlockFloats;
      float m = kInf;
      int li = 0;
      for (int l = 0; l < kLanes; ++l) {
        const float b0 = plane(geo[l], geo[kLanes + l], geo[2 * kLanes + l], px, py);
        const float b1 = plane(geo[3 * kLanes + l], geo[4 * kLanes + l], geo[5 * kLanes + l],
                               px, py);
        const float z = plane(geo[6 * kLanes + l], geo[7 * kLanes + l], geo[8 * kLanes + l],
                              px, py);
        const float b2 = __fsub_rn(__fsub_rn(1.0f, b0), b1);
        const bool cov = (b0 >= 0.0f) & (b1 >= 0.0f) & (b2 >= 0.0f) & (z >= 0.0f) & (z <= 1.0f);
        const float zm = cov ? z : kInf;
        if (zm < m) {
          m = zm;
          li = l;
        }
      }
      if (m < bz) {
        bz = m;
        bi = j * kLanes + li;
      }
    }
  }

  // stage the tile's [256, 72] block in the window buffer, then write it out
  // contiguously
  float row[kRows];
  if (MODE == kSelect) {
#pragma unroll
    for (int c = 0; c < kRows; ++c) row[c] = 0.0f;
    if (bi >= 0) {
      const int j = bi / kLanes;
      const int l = bi - j * kLanes;
      for (int r = 0; r < 2; ++r) {
        if (!(cnt[r] > kLanes * j)) continue;
        const float* col = data + (r * kNB + j) * kBlockFloats + l;
#pragma unroll
        for (int c = 0; c < kRows; ++c) row[c] = __fadd_rn(row[c], col[c * kLanes]);
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < kRows; ++c) row[c] = bz;
    row[1] = static_cast<float>(bi);
  }
  __syncthreads();
  float4* stage4 = smem4;
#pragma unroll
  for (int q = 0; q < kRows / 4; ++q)
    stage4[p * (kRows / 4) + q] = make_float4(row[4 * q], row[4 * q + 1], row[4 * q + 2],
                                              row[4 * q + 3]);
  __syncthreads();
  float4* o4 = reinterpret_cast<float4*>(out + static_cast<size_t>(t) * kOutFloats);
  for (int e = threadIdx.x; e < kOutFloats / 4; e += kThreads) o4[e] = stage4[e];
}

template <int MODE>
int launch(const int* ranges, const float* payload, int p_blocks, float* out, int n_tiles,
           cudaStream_t stream) {
  const int smem = MODE == kEmpty ? 0 : 2 * kWinFloats * static_cast<int>(sizeof(float));
  if (smem > 0) {
    cudaError_t err = cudaFuncSetAttribute(p1_floor_kernel<MODE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  p1_floor_kernel<MODE><<<n_tiles, kThreads, smem, stream>>>(ranges, payload, p_blocks, out);
  return cudaGetLastError();
}

}  // namespace

// One P1 launch: ranges i32[n_tiles * 4] (two window starts in payload blocks,
// two candidate counts), payload f32[p_blocks, 72, 128], out f32[n_tiles, 256, 72].
extern "C" int p1_probe_floor(int mode, const void* ranges, const void* payload, int p_blocks,
                              void* out, int n_tiles, void* stream) {
  if (n_tiles <= 0 || p_blocks < kNB) return cudaErrorInvalidValue;
  const int* r = static_cast<const int*>(ranges);
  const float* pl = static_cast<const float*>(payload);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kEmpty: return launch<kEmpty>(r, pl, p_blocks, o, n_tiles, st);
    case kDma: return launch<kDma>(r, pl, p_blocks, o, n_tiles, st);
    case kEval: return launch<kEval>(r, pl, p_blocks, o, n_tiles, st);
    case kCond: return launch<kCond>(r, pl, p_blocks, o, n_tiles, st);
    case kSelect: return launch<kSelect>(r, pl, p_blocks, o, n_tiles, st);
    default: return cudaErrorInvalidValue;
  }
}
