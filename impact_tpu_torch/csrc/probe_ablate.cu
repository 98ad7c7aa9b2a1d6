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
//   CONDS   skip block j of a window when a + 128 j >= s + c (block-uniform),
//           else evaluate it under the index mask;
//   MMA     evaluate the planes on the tensor cores: per plane one
//           mma.sync.m16n8k8 TF32 product of the [px, py, 1, 0...] pixel rows
//           with the candidates' (a, b, c) columns, the coefficients rounded
//           to TF32 (cvt.rna); else CUDA-core FP32 in raster.cu's order with
//           explicit _rn intrinsics;
//   DBUF    persistent blocks that walk the tiles and prefetch the next
//           tile's windows with cp.async into the other half of a double
//           buffer (cp.async.wait_group), else one block per tile that loads
//           its windows with plain loads before it evaluates;
//   WINDOWS 4 (2x2 fine, 2x2 coarse bins) or 2 (fine only).
// The payload is the port's candidate-major layout ([P, 12] f32, padded by
// devtools/probe_kernel_ablate.py so every 256-candidate window is inside),
// so a window is one contiguous 12 KB run; its load is clamped to [0, P - 256]
// all the same, as the plain version's (candidate indices keep the window's
// own start).
//
// Bound on the H100 (3.35 TB/s HBM; 67 T/s FP32 non-tensor, 495 T/s TF32
// tensor), as devtools/probe_kernel_ablate.py:bound_ms counts it from each
// run's data: bytes = 9 plane floats of every candidate a window holds, read
// once, + the ranges + 4 B per output pixel; operations = 14 per (pixel,
// window candidate), the 12 of the three planes at the TF32 tensor rate in
// the MMA variants. With the probe's own triangles every window is empty,
// so the bound is the output's bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;
constexpr int kGeom = 12;
constexpr int kLanes = 128;
constexpr int kNBlocks = 2;                         // 256-candidate window
constexpr int kWinCand = kNBlocks * kLanes;
constexpr int kWinFloats = kWinCand * kGeom;        // 3072 floats, 12 KB
constexpr float kInf = 3.0e38f;

__device__ __forceinline__ float plane(float a, float b, float c, float x, float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return u;
}

__device__ __forceinline__ void mma_tf32(float d[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(0u), "r"(0u), "r"(b0), "r"(0u), "f"(0.0f), "f"(0.0f),
        "f"(0.0f), "f"(0.0f));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ float covered_z(float b0, float b1, float z, bool have) {
  const float b2 = __fsub_rn(__fsub_rn(1.0f, b0), b1);
  const float m = fminf(b0, fminf(b1, b2));
  const bool cov = (m >= 0.0f) & (z >= 0.0f) & (z <= 1.0f) & have;
  return cov ? z : kInf;
}

// copy tile t's windows into buf: cp.async (DBUF) or plain 16-byte loads
template <int WINDOWS, bool ASYNC>
__device__ __forceinline__ void load_windows(float* buf, const float* __restrict__ payload,
                                             int p_rows, const int* __restrict__ ranges, int t) {
  for (int r = 0; r < WINDOWS; ++r) {
    const int s = ranges[t * 8 + r];
    const int a = min(max(s - s % kLanes, 0), p_rows - kWinCand);
    const float4* src = reinterpret_cast<const float4*>(payload + static_cast<size_t>(a) * kGeom);
    float4* dst = reinterpret_cast<float4*>(buf + r * kWinFloats);
    for (int e = threadIdx.x; e < kWinFloats / 4; e += kThreads) {
      if (ASYNC)
        cp_async16(dst + e, src + e);
      else
        dst[e] = src[e];
    }
  }
}

// nearest covered z of tile t from the windows in buf; writes out[t, 0, :]
template <bool CONDS, bool MMA, int WINDOWS>
__device__ __forceinline__ void eval_tile(const float* buf, const int* __restrict__ ranges,
                                          float* __restrict__ out, int t, int tw) {
  const float x0 = static_cast<float>((t % tw) * kTile);
  const float y0 = static_cast<float>((t / tw) * kTile);
  if (!MMA) {
    const int p = threadIdx.x;
    const float px = __fadd_rn(__fadd_rn(x0, static_cast<float>(p % kTile)), 0.5f);
    const float py = __fadd_rn(__fadd_rn(y0, static_cast<float>(p / kTile)), 0.5f);
    float best = kInf;
    for (int r = 0; r < WINDOWS; ++r) {
      const int s = ranges[t * 8 + r];
      const int cnt = ranges[t * 8 + 4 + r];
      const int a = s - s % kLanes;
      for (int j = 0; j < kNBlocks; ++j) {
        if (CONDS && !(a + kLanes * j < s + cnt)) continue;
        const float* blk = buf + r * kWinFloats + j * kLanes * kGeom;
        for (int l = 0; l < kLanes; ++l) {
          const float* g = blk + l * kGeom;
          const int gidx = a + j * kLanes + l;
          const float b0 = plane(g[0], g[1], g[2], px, py);
          const float b1 = plane(g[3], g[4], g[5], px, py);
          const float z = plane(g[6], g[7], g[8], px, py);
          best = fminf(best, covered_z(b0, b1, z, (gidx >= s) & (gidx < s + cnt)));
        }
      }
    }
    out[static_cast<size_t>(t) * kTile * kTile + p] = best >= kInf ? 1.0f : best;
    return;
  }
  // tensor cores: warp w owns pixels 32w .. 32w + 31 as two m16 row tiles;
  // lane (g = lane / 4, q = lane % 4) holds rows g and g + 8 of each
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int pix0 = (threadIdx.x >> 5) * 32;
  uint32_t afr[2][2];  // [m tile][row g, row g + 8]: pixel-matrix column q
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = pix0 + mt * 16 + h * 8 + g;
      const float px = __fadd_rn(__fadd_rn(x0, static_cast<float>(p % kTile)), 0.5f);
      const float py = __fadd_rn(__fadd_rn(y0, static_cast<float>(p / kTile)), 0.5f);
      afr[mt][h] = to_tf32(q == 0 ? px : q == 1 ? py : q == 2 ? 1.0f : 0.0f);
    }
  float best[2][2] = {{kInf, kInf}, {kInf, kInf}};
  for (int r = 0; r < WINDOWS; ++r) {
    const int s = ranges[t * 8 + r];
    const int cnt = ranges[t * 8 + 4 + r];
    const int a = s - s % kLanes;
    for (int j = 0; j < kNBlocks; ++j) {
      if (CONDS && !(a + kLanes * j < s + cnt)) continue;
      const float* blk = buf + r * kWinFloats + j * kLanes * kGeom;
      for (int n = 0; n < kLanes / 8; ++n) {
        // B: row k = q of column g is coefficient q of candidate 8n + g
        const float* gb = blk + (n * 8 + g) * kGeom;
        uint32_t bfr[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) bfr[k] = q < 3 ? to_tf32(gb[3 * k + q]) : 0u;
        const int gidx0 = a + j * kLanes + n * 8 + 2 * q;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float d0[4], d1[4], dz[4];
          mma_tf32(d0, afr[mt][0], afr[mt][1], bfr[0]);
          mma_tf32(d1, afr[mt][0], afr[mt][1], bfr[1]);
          mma_tf32(dz, afr[mt][0], afr[mt][1], bfr[2]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int gidx = gidx0 + (e & 1);
            const float zc = covered_z(d0[e], d1[e], dz[e], (gidx >= s) & (gidx < s + cnt));
            best[mt][e >> 1] = fminf(best[mt][e >> 1], zc);
          }
        }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = best[mt][h];
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (q == 0) {
        const int p = pix0 + mt * 16 + h * 8 + g;
        out[static_cast<size_t>(t) * kTile * kTile + p] = v >= kInf ? 1.0f : v;
      }
    }
}

template <bool CONDS, bool MMA, bool DBUF, int WINDOWS>
__global__ void __launch_bounds__(kThreads)
p2_ablate_kernel(const int* __restrict__ ranges, const float* __restrict__ payload,
                 int p_rows, float* __restrict__ out, int n_tiles, int tw) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  if (!DBUF) {
    const int t = blockIdx.x;
    load_windows<WINDOWS, false>(smem, payload, p_rows, ranges, t);
    __syncthreads();
    eval_tile<CONDS, MMA, WINDOWS>(smem, ranges, out, t, tw);
    return;
  }
  float* bufs[2] = {smem, smem + WINDOWS * kWinFloats};
  int t = blockIdx.x;
  if (t >= n_tiles) return;
  load_windows<WINDOWS, true>(bufs[0], payload, p_rows, ranges, t);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int k = 0; t < n_tiles; ++k, t += gridDim.x) {
    const int next = t + gridDim.x;
    if (next < n_tiles)
      load_windows<WINDOWS, true>(bufs[(k + 1) & 1], payload, p_rows, ranges, next);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    eval_tile<CONDS, MMA, WINDOWS>(bufs[k & 1], ranges, out, t, tw);
    __syncthreads();  // buf k & 1 is refilled by the next iteration's prefetch
  }
}

template <bool CONDS, bool MMA, bool DBUF, int WINDOWS>
int launch(const int* ranges, const float* payload, int p_rows, float* out, int n_tiles,
           int tw, cudaStream_t stream) {
  auto kernel = p2_ablate_kernel<CONDS, MMA, DBUF, WINDOWS>;
  const int smem = (DBUF ? 2 : 1) * WINDOWS * kWinFloats * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int blocks = n_tiles;
  if (DBUF) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    blocks = std::min(n_tiles, std::max(1, sms * per_sm));
  }
  kernel<<<blocks, kThreads, smem, stream>>>(ranges, payload, p_rows, out, n_tiles, tw);
  return cudaGetLastError();
}

}  // namespace

// One P2 launch of variant (conds, mma, dbuf, windows): ranges i32[n_tiles, 8],
// payload f32[p_rows, 12], out f32[n_tiles, 256].
extern "C" int p2_probe_ablate(int conds, int mma, int dbuf, int windows, const void* ranges,
                               const void* payload, int p_rows, void* out, int n_tiles, int tw,
                               void* stream) {
  if (n_tiles <= 0 || tw <= 0 || p_rows < kWinCand || (windows != 2 && windows != 4))
    return cudaErrorInvalidValue;
  const int* r = static_cast<const int*>(ranges);
  const float* p = static_cast<const float*>(payload);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int key = (conds ? 8 : 0) | (mma ? 4 : 0) | (dbuf ? 2 : 0) | (windows == 4 ? 1 : 0);
  switch (key) {
    case 0b1111: return launch<true, true, true, 4>(r, p, p_rows, o, n_tiles, tw, st);
    case 0b0111: return launch<false, true, true, 4>(r, p, p_rows, o, n_tiles, tw, st);
    case 0b1011: return launch<true, false, true, 4>(r, p, p_rows, o, n_tiles, tw, st);
    case 0b0011: return launch<false, false, true, 4>(r, p, p_rows, o, n_tiles, tw, st);
    case 0b1101: return launch<true, true, false, 4>(r, p, p_rows, o, n_tiles, tw, st);
    case 0b1110: return launch<true, true, true, 2>(r, p, p_rows, o, n_tiles, tw, st);
    default: return cudaErrorInvalidValue;  // not one of the reference's six variants
  }
}
