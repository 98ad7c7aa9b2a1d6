// P1: the per-tile cost ladder of the tile rasterizer, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of devtools/probe_kernel_floor.py:make (one
// pl.pallas_call per mode), which splits K1's per-tile cost into parts over
// 8160 tiles of 16x16 px (1080p). Every mode writes one [256 px, 72] f32 block
// per tile:
//   0 empty   zeros;
//   1 dma     copies two windows of 3 payload blocks ([3, 72, 128] f32 each,
//             block start ranges[4t + r]) into shared memory; writes
//             zeros + the first copied float;
//   2 eval    per pixel the nearest covered candidate over both windows'
//             3 x 128 candidates: planes b0 (rows 0-2), b1 (3-5), z (6-8) at
//             tile-local (px, py) = (p % 16, p / 16), b2 = (1 - b0) - b1,
//             covered when b0, b1, b2 >= 0 and 0 <= z <= 1; within a block
//             the lowest lane wins a tie, across blocks, visited (r, j) =
//             (0, 0..2), (1, 0..2), only a strictly nearer block replaces the
//             best; writes [z, index, z x 70] with the window-local index
//             j * 128 + lane (z = 3e38, index = -1 where nothing covers);
//   3 cond    as eval, but block j of window r only where
//             ranges[4t + 2 + r] > 128 j;
//   4 select  as cond, then sums, over both windows' blocks that pass the
//             same test, the 72-row payload column of the winner's
//             window-local index (the reference's one-hot MXU product, as a
//             gather).
// A window start is clamped to [0, P - 3].
//
// Bound on the H100 (3.35 TB/s HBM, 67 T/s FP32 non-tensor), as
// devtools/probe_kernel_floor.py:bound_ms counts it: bytes = the output
// (601.6 MB at 8160 tiles) + the payload blocks the windows reference, read
// once, + the ranges; operations = 14 per (pixel, evaluated candidate) plane
// evaluation, + one add per selected row in select. empty and dma are bytes-
// bound, the evaluating modes operation-bound. The planes are written with
// _rn intrinsics so that they round like the plain PyTorch version: no FMA
// contraction, so the bound's 14 operations are 14 FP32 instructions, and at
// 128 FP32 lanes per SM and clock those alone take twice the bound (which
// counts an FMA as two). An exact kernel cannot reach half its bound.
//
// Design. empty and dma take one 256-thread block per tile; dma copies both
// whole windows, 221,184 B, into dynamic shared memory. On the H100 at 700 W
// they run at 0.96 and 0.50 of their bounds. The evaluating modes:
//   - copy only what they read: the 9 plane rows of each block they evaluate
//     (all 6 in eval, those passing the count test in cond and select),
//     transposed with 4-byte cp.async into K1's candidate-major layout (three
//     float4 a candidate: a0 b0 c0 a1 | b1 c1 za zb | zc pos - -, csrc/
//     raster.cu), 36,864 B for 768 candidates, so 3 blocks share an SM (at
//     most 80 registers a thread); the pad slot holds the candidate's visit
//     position pos = (3 r + j) 128 + l;
//   - each thread evaluates 4x4 pixels, so a*x of each plane is computed once
//     per column and b*y once per row (the sums keep plane()'s order), and
//     the 16 thread groups of a block (16 threads each, the whole tile) take
//     every 16th candidate. Within a group a thread visits its candidates in
//     increasing pos and keeps the first strictly nearer one, so its result
//     is the least (z, pos); the group pairs of a warp merge by shuffle and
//     the 8 warps in shared memory, both by (z, pos): the least z, then the
//     earliest visit. That is the reference's order; the index alone would
//     not do, since window 1 repeats window 0's indices;
//   - the coverage test and the arg-min are branch-free and cost five
//     integer instructions a pixel: b0, b1, b2 >= 0 is the sign bit of
//     b0 | b1 | b2, and as the best z starts at the float after 1.0,
//     0 <= z <= 1 and z < best are one unsigned compare of z's bits. That
//     needs no evaluation to be -0.0, which is >= 0 with its sign bit set:
//     (a x + b y) + c is -0.0 only where c is, and (1 - b0) - b1 never, so
//     each plane's c is staged as c + 0, which turns -0.0 into +0.0 and
//     changes no other sum's bits (a winning z of -0.0 is written as +0.0,
//     an equal float). The kernel equals the plain version for finite
//     planes whose evaluations stay finite (a NaN has no order), as the
//     probe's standard normal rows are;
//   - the output is written as contiguous 16-byte streaming stores
//     (st.global.cs), each thread building its float4s from the tile's 256
//     staged winners; select gathers the winner's two columns there, from L2
//     (the payload blocks are shared by the tiles).
// The TPU mechanics (whole-window DMAs, lane-major blocks, one-hot MXU select)
// are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;
constexpr int kS2 = kTile * kTile;
constexpr int kRows = 72;
constexpr int kNB = 3;
constexpr int kLanes = 128;
constexpr int kPlaneRows = 9;
constexpr int kBlockFloats = kRows * kLanes;       // one [72, 128] payload block
constexpr int kWinFloats = kNB * kBlockFloats;     // one window of 3 blocks
constexpr int kOutFloats = kS2 * kRows;            // one tile's output block
constexpr int kQuads = kRows / 4;                  // float4s per output pixel
constexpr int kSlots = 2 * kNB * kLanes;           // candidates of both windows
constexpr int kCandFloats = 12;                    // a staged candidate: three float4
constexpr int kGroups = 16;                        // thread groups of a block
constexpr int kSide = 4;                           // a thread's pixels: 4 x 4
constexpr int kPix = kSide * kSide;
constexpr float kInf = 3.0e38f;
constexpr float kAboveOne = 1.00000012f;           // the float after 1.0
constexpr int kNoPos = 0x7FFFFFFF;

enum Mode { kEmpty = 0, kDma = 1, kEval = 2, kCond = 3, kSelect = 4 };

__device__ __forceinline__ void fill_out(float* out, int t, float v) {
  float4* o4 = reinterpret_cast<float4*>(out + static_cast<size_t>(t) * kOutFloats);
  const float4 f = make_float4(v, v, v, v);
  for (int e = threadIdx.x; e < kOutFloats / 4; e += kThreads) o4[e] = f;
}

// empty and dma: one block per tile
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
  const float* data = reinterpret_cast<const float*>(smem4);  // [2][3][72][128]
  for (int r = 0; r < 2; ++r) {
    const int a = min(max(ranges[t * 4 + r], 0), p_blocks - kNB);
    const float4* src = reinterpret_cast<const float4*>(
        payload + static_cast<size_t>(a) * kBlockFloats);
    float4* dst = smem4 + r * (kWinFloats / 4);
    for (int e = threadIdx.x; e < kWinFloats / 4; e += kThreads) dst[e] = src[e];
  }
  __syncthreads();
  fill_out(out, t, 0.0f + data[0]);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

// b0, b1, b2 >= 0 for evaluations that are never -0.0: no sign bit set
__device__ __forceinline__ bool covers(float b0, float b1, float b2) {
  return (__float_as_int(b0) | __float_as_int(b1) | __float_as_int(b2)) >= 0;
}

// 0 <= z < best for best >= 0 and z never -0.0: one unsigned compare of the bits
__device__ __forceinline__ bool nearer(float z, float best) {
  return __float_as_uint(z) < __float_as_uint(best);
}

// (z, pos) before (bz, bpos): nearer, or as near and visited earlier
__device__ __forceinline__ bool before(float z, int pos, float bz, int bpos) {
  return z < bz || (z == bz && pos < bpos);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 3)
p1_eval_kernel(const int* __restrict__ ranges, const float* __restrict__ payload,
               int p_blocks, float* __restrict__ out) {
  __shared__ __align__(16) float4 cand[kSlots][3];  // the merge reuses it
  __shared__ float win_z[kS2];
  __shared__ int win_i[kS2];
  __shared__ int visit[2 * kNB];                    // staged block k: 3 r + j
  __shared__ int n_staged;
  const int t = blockIdx.x;
  const int start0 = min(max(__ldg(ranges + t * 4), 0), p_blocks - kNB);
  const int start1 = min(max(__ldg(ranges + t * 4 + 1), 0), p_blocks - kNB);
  const int cnt0 = __ldg(ranges + t * 4 + 2), cnt1 = __ldg(ranges + t * 4 + 3);
  if (threadIdx.x == 0) {
    int n = 0;
    for (int v = 0; v < 2 * kNB; ++v)
      if (MODE == kEval || (v < kNB ? cnt0 : cnt1) > kLanes * (v % kNB)) visit[n++] = v;
    n_staged = n;
  }
  __syncthreads();
  const int n_blk = n_staged;
  float* cf = reinterpret_cast<float*>(cand);
  for (int k = 0; k < n_blk; ++k) {
    const int v = visit[k];
    const float* src = payload + static_cast<size_t>((v < kNB ? start0 : start1) + v % kNB) *
                                     kBlockFloats;
    for (int e = threadIdx.x; e < kPlaneRows * kLanes; e += kThreads) {
      const int row = e / kLanes, l = e % kLanes;  // row is warp-uniform
      float* dst = cf + (k * kLanes + l) * kCandFloats + row;
      if (row % 3 == 2)  // a plane's constant, staged as c + 0: never -0.0
        *dst = __fadd_rn(__ldg(src + row * kLanes + l), 0.0f);
      else
        cp_async4(dst, src + row * kLanes + l);
    }
    if (threadIdx.x < kLanes) cand[k * kLanes + threadIdx.x][2].y =
        __int_as_float(v * kLanes + static_cast<int>(threadIdx.x));
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
  __syncthreads();

  // thread group g takes candidates g, g + 16, ...; thread s of the group
  // the pixels (yb + i, xb + u), i, u < 4
  const int g = threadIdx.x / kGroups;
  const int s = threadIdx.x % kGroups;
  const int xb = (s % kSide) * kSide, yb = (s / kSide) * kSide;
  float m[kPix];
  int mp[kPix];
#pragma unroll
  for (int q = 0; q < kPix; ++q) {
    m[q] = kAboveOne;
    mp[q] = kNoPos;
  }
  const int n = n_blk * kLanes;
#pragma unroll 2
  for (int c = g; c < n; c += kGroups) {
    const float4 g0 = cand[c][0], g1 = cand[c][1], g2 = cand[c][2];
    const int pos = __float_as_int(g2.y);
    float ax0[kSide], ax1[kSide], axz[kSide];
#pragma unroll
    for (int u = 0; u < kSide; ++u) {
      const float x = static_cast<float>(xb + u);
      ax0[u] = __fmul_rn(g0.x, x);
      ax1[u] = __fmul_rn(g0.w, x);
      axz[u] = __fmul_rn(g1.z, x);
    }
#pragma unroll
    for (int i = 0; i < kSide; ++i) {
      const float y = static_cast<float>(yb + i);
      const float by0 = __fmul_rn(g0.y, y), by1 = __fmul_rn(g1.x, y), byz = __fmul_rn(g1.w, y);
#pragma unroll
      for (int u = 0; u < kSide; ++u) {
        const float b0 = __fadd_rn(__fadd_rn(ax0[u], by0), g0.z);
        const float b1 = __fadd_rn(__fadd_rn(ax1[u], by1), g1.y);
        const float z = __fadd_rn(__fadd_rn(axz[u], byz), g2.x);
        const float b2 = __fsub_rn(__fsub_rn(1.0f, b0), b1);
        if (covers(b0, b1, b2) && nearer(z, m[i * kSide + u])) {
          m[i * kSide + u] = z;
          mp[i * kSide + u] = pos;
        }
      }
    }
  }
  // merge the two groups of each warp, then the eight warps
#pragma unroll
  for (int q = 0; q < kPix; ++q) {
    const float oz = __shfl_xor_sync(0xFFFFFFFFu, m[q], kGroups);
    const int op = __shfl_xor_sync(0xFFFFFFFFu, mp[q], kGroups);
    if (before(oz, op, m[q], mp[q])) {
      m[q] = oz;
      mp[q] = op;
    }
  }
  __syncthreads();  // every read of cand is done
  float2* part = reinterpret_cast<float2*>(cand);  // [8 warps][256 px]
  if ((threadIdx.x & kGroups) == 0) {
    const int w = threadIdx.x / 32;
#pragma unroll
    for (int q = 0; q < kPix; ++q)
      part[w * kS2 + (yb + q / kSide) * kTile + xb + q % kSide] =
          make_float2(m[q], __int_as_float(mp[q]));
  }
  __syncthreads();
  {
    const int p = threadIdx.x;
    float bz = part[p].x;
    int bp = __float_as_int(part[p].y);
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float2 o = part[w * kS2 + p];
      if (before(o.x, __float_as_int(o.y), bz, bp)) {
        bz = o.x;
        bp = __float_as_int(o.y);
      }
    }
    const bool hit = bz <= 1.0f;
    win_z[p] = hit ? bz : kInf;
    win_i[p] = hit ? bp % (kNB * kLanes) : -1;  // window-local index j * 128 + lane
  }
  __syncthreads();

  float4* o4 = reinterpret_cast<float4*>(out + static_cast<size_t>(t) * kOutFloats);
  for (int e = threadIdx.x; e < kOutFloats / 4; e += kThreads) {
    const int p = e / kQuads, q = e - p * kQuads;
    float4 v;
    if (MODE == kSelect) {
      v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const int bi = win_i[p];
      if (bi >= 0) {
        const int j = bi / kLanes, l = bi % kLanes;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (!((r ? cnt1 : cnt0) > kLanes * j)) continue;
          const float* col = payload + (static_cast<size_t>((r ? start1 : start0) + j) * kRows +
                                        4 * q) * kLanes + l;
          v.x = __fadd_rn(v.x, __ldg(col));
          v.y = __fadd_rn(v.y, __ldg(col + kLanes));
          v.z = __fadd_rn(v.z, __ldg(col + 2 * kLanes));
          v.w = __fadd_rn(v.w, __ldg(col + 3 * kLanes));
        }
      }
    } else {
      const float z = win_z[p];
      v = make_float4(z, q == 0 ? static_cast<float>(win_i[p]) : z, z, z);
    }
    __stcs(o4 + e, v);
  }
}

template <int MODE>
int launch(const int* ranges, const float* payload, int p_blocks, float* out, int n_tiles,
           cudaStream_t stream) {
  if constexpr (MODE >= kEval) {
    p1_eval_kernel<MODE><<<n_tiles, kThreads, 0, stream>>>(ranges, payload, p_blocks, out);
  } else {
    const int smem = MODE == kEmpty ? 0 : 2 * kWinFloats * static_cast<int>(sizeof(float));
    if (smem > 0) {
      cudaError_t err = cudaFuncSetAttribute(p1_floor_kernel<MODE>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    p1_floor_kernel<MODE><<<n_tiles, kThreads, smem, stream>>>(ranges, payload, p_blocks, out);
  }
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
