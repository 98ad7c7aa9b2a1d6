// P2: the depth-kernel ablation of the tile rasterizer, hand-written for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of devtools/probe_kernel_ablate.py
// (make_variant, launched by run_variant -> pl.pallas_call), a depth-only
// K1 variant at 512^2 that takes K1's per-tile cost apart. For each 16x16
// tile t and each of its first WINDOWS candidate windows (start s =
// ranges[8t + r], count c = ranges[8t + 4 + r]), the 256 candidates from
// a = s - s % 128 on are tested against every pixel centre: planes b0, b1, z
// (payload rows 0-8), b2 = (1 - b0) - b1, covered when min(b0, b1, b2) >= 0,
// 0 <= z <= 1 and the candidate's index lies in [s, s + c). Each pixel
// writes its nearest covered z, or 1.0. The big block is not read, as in the
// reference. The four flags map the TPU's mechanics to Hopper's:
//   CONDS   skip block j of a window when a + 128 j >= s + c (block-uniform,
//           known from the ranges): neither copied nor evaluated; else every
//           slot of the block is evaluated under the index mask;
//   MMA     evaluate the planes on the tensor cores: per plane one
//           mma.sync.m16n8k4 TF32 product of the [px, py, 1, 0] pixel rows
//           with the candidates' (a, b, c, 0) columns, the coefficients
//           rounded to TF32 (cvt.rna) once as they are staged; else CUDA-core
//           FP32 in raster.cu's order with explicit _rn intrinsics;
//   DBUF    persistent blocks that take tiles from a counter in device memory
//           and prefetch the next tile's windows with cp.async into the other
//           half of a double buffer (cp.async.wait_group) while they evaluate
//           this one; else one block per tile, which copies its windows, waits
//           and evaluates;
//   WINDOWS 4 (2x2 fine, 2x2 coarse bins) or 2 (fine only).
// The payload is the port's candidate-major layout ([P, 12] f32, padded by
// devtools/probe_kernel_ablate.py so every 256-candidate window is inside),
// so a candidate is three 16-byte copies; a window's load is clamped to
// [0, P - 256] all the same, as the plain version's (candidate indices keep
// the window's own start).
//
// Bound on the H100 (3.35 TB/s HBM; 67 T/s FP32 non-tensor, 495 T/s TF32
// tensor), as devtools/probe_kernel_ablate.py:bound_ms counts it from each
// run's data: bytes = 9 plane floats of every candidate a window holds, read
// once, + the ranges + 4 B per output pixel; operations = 14 per (pixel,
// window candidate), the 12 of the three planes at the TF32 tensor rate in
// the MMA variants. With the probe's own triangles every window is empty,
// so the bound is the output's bytes. The variants without CONDS evaluate
// every slot by design; dense_bound_ms there gives their all-slot bound.
//
// Design:
//   - a tile copies only the blocks it evaluates. A slot outside [s, s + c)
//     is not copied: it gets a z plane of -1 (a = b = 0, c = -1), which no
//     pixel takes, so the index mask costs no instruction per pixel and the
//     evaluation of every slot stays. On the probe's empty frame the CONDS
//     variants copy and evaluate nothing: they write 1.0;
//   - FP32: each thread evaluates 4x4 pixels, so a*x of each plane is
//     computed once per column and b*y once per row (the sums keep plane()'s
//     order), reading a candidate as three 16-byte shared loads; the 16
//     thread groups of a block (16 threads each, the whole tile) take every
//     16th slot and meet in a z-min, by shuffle within a warp and then in
//     shared memory (a min is exact in any order);
//   - the coverage test and the min are branch-free and cost three integer
//     instructions a pixel: the sign bit of b0 | b1 | b2, OR'd into z's
//     bits, gives a key that is z's bits where b0, b1, b2 >= 0 and above
//     every z >= 0 elsewhere (a z below 0 has its sign bit set too), and an
//     unsigned min of the keys, from the float after 1.0, keeps the
//     nearest z in [0, 1]. That needs no evaluation to be -0.0, which is
//     >= 0 with its sign bit set:
//     (a x + b y) + c is -0.0 only where c is, and (1 - b0) - b1 never, so
//     each plane's c is staged as c + 0, which turns -0.0 into +0.0 and
//     changes no sum's bits;
//   - MMA: warp w owns tile rows 2w and 2w + 1 as two m16 tiles; m16n8k4
//     uses 3 of its 4 K columns (m16n8k8 would use 3 of 8). The staged TF32
//     layout (a0 b0 c0 0 | a1 b1 c1 0 | za zb zc 0) gives each lane its B
//     element with one conflict-free 4-byte load per plane. The epilogue
//     (b2, the coverage test, the min) is the FP32 path's;
//   - DBUF: the persistent blocks take tiles from an atomic counter, so the
//     crowded middle of a dense frame spreads over every block; the last
//     block to finish sets the counter back to 0 for the next launch, so a
//     launch needs no memset (launches on one counter must not overlap);
//   - the launch configuration (shared memory opt-in, persistent grid) is
//     worked out once per variant and device: a launch is one kernel call.
// The FP32 variants equal the plain version for finite planes whose
// evaluations stay finite (a NaN has no order).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16;
constexpr int kS2 = kTile * kTile;
constexpr int kGeom = 12;
constexpr int kLanes = 128;
constexpr int kNBlocks = 2;                         // 256-candidate window
constexpr int kWinCand = kNBlocks * kLanes;
constexpr int kMaxWindows = 4;
constexpr int kGroups = 16;                         // FP32: thread groups of a block
constexpr int kSide = 4;                            // FP32: a thread's pixels, 4 x 4
constexpr int kPix = kSide * kSide;
constexpr float kAboveOne = 1.00000012f;            // the float after 1.0

typedef float4 Cand[3];

// A tile's blocks to evaluate, in shared memory
struct TileState {
  int tile;                          // >= n_tiles: no tile left
  int n_blk;                         // blocks staged
  int blk[kMaxWindows * kNBlocks];   // staged block k: window r = blk >> 1, j = blk & 1
  int s[kMaxWindows];                // window start
  int e[kMaxWindows];                // window start + count
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return u;
}

__device__ __forceinline__ float tf32f(float x) { return __uint_as_float(to_tf32(x)); }

// d = [16 x 4] a times [4 x 8] b, TF32 in, FP32 out
__device__ __forceinline__ void mma_k4(float d[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%8,%9,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "f"(0.0f), "f"(0.0f), "f"(0.0f), "f"(0.0f));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// z's bits where b0, b1, b2 >= 0, else a key above every z >= 0 (the sign
// bit set); a z below 0 has its sign bit set too. For evaluations that are
// never -0.0, the unsigned min of the keys is the nearest covered z >= 0.
__device__ __forceinline__ unsigned depth_key(float b0, float b1, float b2, float z) {
  return ((__float_as_uint(b0) | __float_as_uint(b1) | __float_as_uint(b2)) & 0x80000000u) |
         __float_as_uint(z);
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// (thread 0) tile t's windows and the blocks the variant evaluates
template <bool CONDS, int WINDOWS>
__device__ __forceinline__ void fetch(TileState& S, int t, const int* __restrict__ ranges,
                                      int n_tiles) {
  int n = 0;
  if (t < n_tiles) {
    for (int r = 0; r < WINDOWS; ++r) {
      const int s = __ldg(ranges + t * 8 + r);
      const int e = s + __ldg(ranges + t * 8 + 4 + r);
      S.s[r] = s;
      S.e[r] = e;
      const int a = s - s % kLanes;
      for (int j = 0; j < kNBlocks; ++j)
        if (!CONDS || a + kLanes * j < e) S.blk[n++] = r * kNBlocks + j;
    }
  }
  S.tile = t;
  S.n_blk = n;
}

// slot i of S's staged blocks: its payload row, or -1 outside the index mask
__device__ __forceinline__ int slot_row(const TileState& S, int i, int p_rows) {
  const int b = S.blk[i / kLanes];
  const int r = b / kNBlocks, j = b % kNBlocks;
  const int s = S.s[r];
  const int a = s - s % kLanes;
  const int off = kLanes * j + i % kLanes;
  const int idx = a + off;
  if (idx < s || idx >= S.e[r]) return -1;
  return min(max(a, 0), p_rows - kWinCand) + off;
}

// copy S's slots into buf (cp.async); a masked slot gets a z plane of -1
template <bool MMA>
__device__ __forceinline__ void stage(Cand* buf, const TileState& S,
                                      const float* __restrict__ payload, int p_rows) {
  for (int i = threadIdx.x; i < S.n_blk * kLanes; i += kThreads) {
    const int row = slot_row(S, i, p_rows);
    if (row >= 0) {
      const float* src = payload + static_cast<size_t>(row) * kGeom;
      cp_async16(&buf[i][0], src);
      cp_async16(&buf[i][1], src + 4);
      cp_async16(&buf[i][2], src + 8);
    } else {
      const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      buf[i][0] = zero;
      buf[i][1] = zero;
      buf[i][2] = MMA ? make_float4(0.0f, 0.0f, -1.0f, 0.0f)   // za zb zc 0
                      : make_float4(-1.0f, 0.0f, 0.0f, 0.0f);  // zc iw0 iw1 iw2
    }
  }
}

// (after the copies) this thread's copied slots with each plane's c as
// c + 0, never -0.0; with MMA rounded to TF32 in the layout
// a0 b0 c0 0 | a1 b1 c1 0 | za zb zc 0
template <bool MMA>
__device__ __forceinline__ void finish_stage(Cand* buf, const TileState& S, int p_rows) {
  for (int i = threadIdx.x; i < S.n_blk * kLanes; i += kThreads) {
    if (slot_row(S, i, p_rows) < 0) continue;
    const float4 g0 = buf[i][0], g1 = buf[i][1], g2 = buf[i][2];
    if (MMA) {
      buf[i][0] = make_float4(tf32f(g0.x), tf32f(g0.y), __fadd_rn(tf32f(g0.z), 0.0f), 0.0f);
      buf[i][1] = make_float4(tf32f(g0.w), tf32f(g1.x), __fadd_rn(tf32f(g1.y), 0.0f), 0.0f);
      buf[i][2] = make_float4(tf32f(g1.z), tf32f(g1.w), __fadd_rn(tf32f(g2.x), 0.0f), 0.0f);
    } else {
      buf[i][0].z = __fadd_rn(g0.z, 0.0f);
      buf[i][1].y = __fadd_rn(g1.y, 0.0f);
      buf[i][2].x = __fadd_rn(g2.x, 0.0f);
    }
  }
}

// FP32: the tile's nearest covered z per pixel -> out[t, 0, :]
__device__ __forceinline__ void eval_fp32(const Cand* buf, const TileState& S, float* part,
                                          float* __restrict__ out, int tw) {
  const int t = S.tile;
  const int n = S.n_blk * kLanes;
  float* o = out + static_cast<size_t>(t) * kS2;
  if (n == 0) {
    o[threadIdx.x] = 1.0f;
    return;
  }
  const int g = threadIdx.x / kGroups;
  const int sl = threadIdx.x % kGroups;
  const int xb = (sl % kSide) * kSide, yb = (sl / kSide) * kSide;
  const float x0 = static_cast<float>((t % tw) * kTile);
  const float y0 = static_cast<float>((t / tw) * kTile);
  float px[kSide], py[kSide];
  unsigned best[kPix];  // depth keys
#pragma unroll
  for (int u = 0; u < kSide; ++u) {
    px[u] = __fadd_rn(__fadd_rn(x0, static_cast<float>(xb + u)), 0.5f);
    py[u] = __fadd_rn(__fadd_rn(y0, static_cast<float>(yb + u)), 0.5f);
  }
#pragma unroll
  for (int q = 0; q < kPix; ++q) best[q] = __float_as_uint(kAboveOne);
  for (int c = g; c < n; c += kGroups) {
    const float4 g0 = buf[c][0], g1 = buf[c][1], g2 = buf[c][2];
    float ax0[kSide], ax1[kSide], axz[kSide];
#pragma unroll
    for (int u = 0; u < kSide; ++u) {
      ax0[u] = __fmul_rn(g0.x, px[u]);
      ax1[u] = __fmul_rn(g0.w, px[u]);
      axz[u] = __fmul_rn(g1.z, px[u]);
    }
#pragma unroll
    for (int i = 0; i < kSide; ++i) {
      const float by0 = __fmul_rn(g0.y, py[i]), by1 = __fmul_rn(g1.x, py[i]);
      const float byz = __fmul_rn(g1.w, py[i]);
#pragma unroll
      for (int u = 0; u < kSide; ++u) {
        const float b0 = __fadd_rn(__fadd_rn(ax0[u], by0), g0.z);
        const float b1 = __fadd_rn(__fadd_rn(ax1[u], by1), g1.y);
        const float z = __fadd_rn(__fadd_rn(axz[u], byz), g2.x);
        const float b2 = __fsub_rn(__fsub_rn(1.0f, b0), b1);
        best[i * kSide + u] = min(best[i * kSide + u], depth_key(b0, b1, b2, z));
      }
    }
  }
  // the keys are floats >= 0 from here: their min is the float min
#pragma unroll
  for (int q = 0; q < kPix; ++q)
    best[q] = min(best[q], __shfl_xor_sync(0xFFFFFFFFu, best[q], kGroups));
  if ((threadIdx.x & kGroups) == 0) {
    const int w = threadIdx.x / 32;
#pragma unroll
    for (int q = 0; q < kPix; ++q)
      part[w * kS2 + (yb + q / kSide) * kTile + xb + q % kSide] = __uint_as_float(best[q]);
  }
  __syncthreads();
  float v = part[threadIdx.x];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = fminf(v, part[w * kS2 + threadIdx.x]);
  o[threadIdx.x] = fminf(v, 1.0f);
}

// MMA: the tile's nearest covered z per pixel -> out[t, 0, :]
__device__ __forceinline__ void eval_mma(const Cand* buf, const TileState& S,
                                         float* __restrict__ out, int tw) {
  const int t = S.tile;
  const int n = S.n_blk * kLanes;
  float* o = out + static_cast<size_t>(t) * kS2;
  if (n == 0) {
    o[threadIdx.x] = 1.0f;
    return;
  }
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int w = threadIdx.x >> 5;
  const float x0 = static_cast<float>((t % tw) * kTile);
  const float y0 = static_cast<float>((t / tw) * kTile);
  // m tile mt is tile row 2w + mt; A row g (g + 8) is its pixel x = g (g + 8)
  uint32_t afr[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float px = __fadd_rn(__fadd_rn(x0, static_cast<float>(g + 8 * h)), 0.5f);
      const float py = __fadd_rn(__fadd_rn(y0, static_cast<float>(2 * w + mt)), 0.5f);
      afr[mt][h] = to_tf32(q == 0 ? px : q == 1 ? py : q == 2 ? 1.0f : 0.0f);
    }
  unsigned best[2][4];  // depth keys
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) best[mt][e] = __float_as_uint(kAboveOne);
  const float* bf = reinterpret_cast<const float*>(buf);
#pragma unroll 4
  for (int nt = 0; nt < n / 8; ++nt) {
    // B row q of column g: coefficient q of candidate 8 nt + g (0 at q = 3)
    const float* cb = bf + (nt * 8 + g) * kGeom + q;
    const uint32_t bb0 = __float_as_uint(cb[0]), bb1 = __float_as_uint(cb[4]),
                   bbz = __float_as_uint(cb[8]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float d0[4], d1[4], dz[4];
      mma_k4(d0, afr[mt][0], afr[mt][1], bb0);
      mma_k4(d1, afr[mt][0], afr[mt][1], bb1);
      mma_k4(dz, afr[mt][0], afr[mt][1], bbz);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float b2 = __fsub_rn(__fsub_rn(1.0f, d0[e]), d1[e]);
        best[mt][e] = min(best[mt][e], depth_key(d0[e], d1[e], b2, dz[e]));
      }
    }
  }
  // accumulator e holds row g (e < 2) or g + 8, columns 2q and 2q + 1
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = __uint_as_float(min(best[mt][2 * h], best[mt][2 * h + 1]));
      v = fminf(v, __shfl_xor_sync(0xFFFFFFFFu, v, 1));
      v = fminf(v, __shfl_xor_sync(0xFFFFFFFFu, v, 2));
      if (q == 0) o[(2 * w + mt) * kTile + g + 8 * h] = fminf(v, 1.0f);
    }
}

template <bool MMA>
__device__ __forceinline__ void evaluate(const Cand* buf, const TileState& S, float* part,
                                         float* __restrict__ out, int tw) {
  if (MMA)
    eval_mma(buf, S, out, tw);
  else
    eval_fp32(buf, S, part, out, tw);
}

template <bool CONDS, bool MMA, bool DBUF, int WINDOWS>
__global__ void __launch_bounds__(kThreads)
p2_ablate_kernel(const int* __restrict__ ranges, const float* __restrict__ payload,
                 int p_rows, float* __restrict__ out, int n_tiles, int tw,
                 int* __restrict__ counter) {
  constexpr int kBufSlots = WINDOWS * kWinCand;
  extern __shared__ float4 smem4[];
  Cand* bufs = reinterpret_cast<Cand*>(smem4);  // [DBUF ? 2 : 1][kBufSlots]
  __shared__ TileState st[DBUF ? 2 : 1];
  __shared__ float part[MMA ? 1 : kWarps * kS2];
  if (!DBUF) {
    if (threadIdx.x == 0) fetch<CONDS, WINDOWS>(st[0], blockIdx.x, ranges, n_tiles);
    __syncthreads();
    stage<MMA>(bufs, st[0], payload, p_rows);
    cp_async_commit();
    asm volatile("cp.async.wait_group 0;\n" ::);
    finish_stage<MMA>(bufs, st[0], p_rows);
    __syncthreads();
    evaluate<MMA>(bufs, st[0], part, out, tw);
    return;
  }
  if (threadIdx.x == 0) fetch<CONDS, WINDOWS>(st[0], atomicAdd(counter, 1), ranges, n_tiles);
  __syncthreads();
  if (st[0].tile < n_tiles) {
    stage<MMA>(bufs, st[0], payload, p_rows);
    cp_async_commit();
    for (int k = 0;; ++k) {
      const int cur = k & 1, nxt = cur ^ 1;
      if (threadIdx.x == 0) fetch<CONDS, WINDOWS>(st[nxt], atomicAdd(counter, 1), ranges, n_tiles);
      __syncthreads();
      const bool more = st[nxt].tile < n_tiles;
      if (more) stage<MMA>(bufs + nxt * kBufSlots, st[nxt], payload, p_rows);
      cp_async_commit();
      asm volatile("cp.async.wait_group 1;\n" ::);  // this tile's copies (the next's may fly)
      finish_stage<MMA>(bufs + cur * kBufSlots, st[cur], p_rows);
      __syncthreads();
      evaluate<MMA>(bufs + cur * kBufSlots, st[cur], part, out, tw);
      __syncthreads();  // buffer cur and st[cur] are refilled in the next round
      if (!more) break;
    }
  }
  // the last block out sets the counter back for the next launch
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(counter + 1, 1) == static_cast<int>(gridDim.x) - 1) {
      counter[0] = 0;
      counter[1] = 0;
      __threadfence();
    }
  }
}

constexpr int kMaxDevices = 64;

template <bool CONDS, bool MMA, bool DBUF, int WINDOWS>
int launch(const int* ranges, const float* payload, int p_rows, float* out, int n_tiles,
           int tw, int* counter, cudaStream_t stream) {
  auto kernel = p2_ablate_kernel<CONDS, MMA, DBUF, WINDOWS>;
  const int smem = (DBUF ? 2 : 1) * WINDOWS * kWinCand * static_cast<int>(sizeof(Cand));
  // per device: the shared memory opt-in done, and the persistent grid
  static int grid[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (grid[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    grid[dev] = std::max(1, sms * per_sm);
  }
  const int blocks = DBUF ? std::min(n_tiles, grid[dev]) : n_tiles;
  kernel<<<blocks, kThreads, smem, stream>>>(ranges, payload, p_rows, out, n_tiles, tw, counter);
  return cudaGetLastError();
}

}  // namespace

// One P2 launch of variant (conds, mma, dbuf, windows): ranges i32[n_tiles, 8],
// payload f32[p_rows, 12], out f32[n_tiles, 256]; counter i32[2], zero before
// the first launch on it (DBUF variants take tiles from it and leave it zero).
extern "C" int p2_probe_ablate(int conds, int mma, int dbuf, int windows, const void* ranges,
                               const void* payload, int p_rows, void* out, int n_tiles, int tw,
                               void* counter, void* stream) {
  if (n_tiles <= 0 || tw <= 0 || p_rows < kWinCand || (windows != 2 && windows != 4) ||
      (dbuf && counter == nullptr))
    return cudaErrorInvalidValue;
  const int* r = static_cast<const int*>(ranges);
  const float* p = static_cast<const float*>(payload);
  float* o = static_cast<float*>(out);
  int* c = static_cast<int*>(counter);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int key = (conds ? 8 : 0) | (mma ? 4 : 0) | (dbuf ? 2 : 0) | (windows == 4 ? 1 : 0);
  switch (key) {
    case 0b1111: return launch<true, true, true, 4>(r, p, p_rows, o, n_tiles, tw, c, st);
    case 0b0111: return launch<false, true, true, 4>(r, p, p_rows, o, n_tiles, tw, c, st);
    case 0b1011: return launch<true, false, true, 4>(r, p, p_rows, o, n_tiles, tw, c, st);
    case 0b0011: return launch<false, false, true, 4>(r, p, p_rows, o, n_tiles, tw, c, st);
    case 0b1101: return launch<true, true, false, 4>(r, p, p_rows, o, n_tiles, tw, c, st);
    case 0b1110: return launch<true, true, true, 2>(r, p, p_rows, o, n_tiles, tw, c, st);
    default: return cudaErrorInvalidValue;  // not one of the reference's six variants
  }
}
