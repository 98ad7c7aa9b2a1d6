// K1: the screen-tile triangle rasterizer, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel impact_tpu/render/raster_pallas.py:_make_kernel
// (launched by _run -> pl.pallas_call). It computes the same function: for each
// screen tile, the candidates of four bin windows (2x2 fine, 2x2 coarse; ranges
// made by the torch prologue in render/raster_pallas.py) plus one shared
// nearest-first "big" block are tested against every pixel centre with their
// barycentric (b0, b1) and depth (z) screen planes. A pixel is covered by a
// candidate when min(b0, b1, 1-b0-b1) >= 0 and 0 <= z <= 1.
//   depth variant:     per-pixel z-min, 1.0 where nothing covers.
//   attribute variant: per-pixel min of an i32 key (z bits with the low
//                      pos_bits masked | window position), i.e. the reduced-
//                      precision z test of the reference with ties broken by
//                      window position; then the winner's perspective-correct
//                      attributes, its nearest-corner attributes, exact z and
//                      a valid flag.
// Plane evaluations are written with explicit _rn intrinsics (no FMA
// contraction) so they round exactly like the plain PyTorch version.
//
// Design (first, simple version): one 256-thread block per 32x32 (or 16x16)
// tile, each thread owning TILE*TILE/256 pixels with its running min in
// registers; candidate geometry (12 floats) is staged through shared memory
// CHUNK candidates at a time and read as broadcasts; the winner's attribute
// rows are fetched once per pixel at the end. The TPU mechanics (lane-major
// [P/128,R,128] blocks, 128-aligned DMA floors, one-hot MXU select, double-
// buffered grid steps) are not carried over.
//
// Bound on the H100 (3.35 TB/s HBM, 67 TFLOP/s FP32 non-tensor), as
// render/raster_pallas.py:bound_ms counts it from each call's inputs:
//   bytes: every payload row a window (or the big block) references, read
//          once (12+3A floats), plus the ranges; every output pixel written
//          once (4 B depth; 8A+5 B for interp, near, z and valid).
//   operations: 14 FP32 operations per (pixel, candidate) plane evaluation
//          (three planes at 2 multiplies + 2 adds, b2 at 2 subtracts).
// The 1080p G-buffer view (A = 20) is bytes-bound: its 165 output bytes per
// pixel (interp and near, 80 B each) outweigh both the payload reads and the
// evaluations of the few candidates per tile the bench scene gives. The
// evaluations never reach device memory: candidates sit in shared memory and
// the running min in registers. The output writes do, and this first design
// leaves them uncoalesced: each thread writes its pixels' interp and near
// rows (80 B each) at a stride of 80 B between neighbouring threads, one
// float per store. Staging a tile's rows in shared memory and writing them
// out contiguously is the next step. The shadow views (depth only, 4 B per
// pixel) are operation-bound where they hold candidates. chip_smoke.py
// measures the time and computes the bound from each run's data.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 128;     // candidates staged in shared memory per pass
constexpr int kGeom = 12;       // a0 b0 c0 a1 b1 c1 za zb zc iw0 iw1 iw2
constexpr int kWindows = 4;
constexpr int kLanes = 128;
constexpr float kInf = 3.0e38f;

__device__ __forceinline__ float plane(float a, float b, float c, float x, float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

// coverage + depth of one candidate (geometry row g) at pixel (x, y)
__device__ __forceinline__ bool covers(const float* g, float x, float y, float* z) {
  float b0 = plane(g[0], g[1], g[2], x, y);
  float b1 = plane(g[3], g[4], g[5], x, y);
  float zz = plane(g[6], g[7], g[8], x, y);
  float b2 = __fsub_rn(__fsub_rn(1.0f, b0), b1);
  *z = zz;
  return (b0 >= 0.0f) && (b1 >= 0.0f) && (b2 >= 0.0f) && (zz >= 0.0f) && (zz <= 1.0f);
}

template <int TILE>
__global__ void __launch_bounds__(kThreads)
k1_depth_kernel(const float* __restrict__ payload, int rows,
                const int* __restrict__ ranges, const float* __restrict__ big,
                const unsigned char* __restrict__ big_have, int nbig,
                float* __restrict__ out, int height, int width, int tw) {
  constexpr int PPT = TILE * TILE / kThreads;
  __shared__ float sg[kChunk][kGeom];
  __shared__ unsigned char sh[kChunk];
  const int t = blockIdx.x;
  const float x0 = (float)((t % tw) * TILE);
  const float y0 = (float)((t / tw) * TILE);
  float px[PPT], py[PPT], best[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    int p = threadIdx.x + i * kThreads;
    px[i] = __fadd_rn(__fadd_rn(x0, (float)(p % TILE)), 0.5f);
    py[i] = __fadd_rn(__fadd_rn(y0, (float)(p / TILE)), 0.5f);
    best[i] = kInf;
  }
  // four windows from the payload, then the big block (window index 4)
  for (int r = 0; r <= kWindows; ++r) {
    const float* src;
    int cnt;
    if (r < kWindows) {
      src = payload + (size_t)ranges[t * 8 + r] * rows;
      cnt = ranges[t * 8 + 4 + r];
    } else {
      src = big;
      cnt = nbig;
    }
    for (int base = 0; base < cnt; base += kChunk) {
      const int n = min(kChunk, cnt - base);
      __syncthreads();
      for (int e = threadIdx.x; e < n * kGeom; e += kThreads) {
        int c = e / kGeom;
        sg[c][e - c * kGeom] = src[(size_t)(base + c) * rows + (e - c * kGeom)];
      }
      for (int c = threadIdx.x; c < n; c += kThreads)
        sh[c] = (r < kWindows) ? 1 : big_have[base + c];
      __syncthreads();
      for (int c = 0; c < n; ++c) {
        if (!sh[c]) continue;
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          float z;
          if (covers(sg[c], px[i], py[i], &z)) best[i] = fminf(best[i], z);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    int p = threadIdx.x + i * kThreads;
    int x = (int)x0 + p % TILE, y = (int)y0 + p / TILE;
    if (x < width && y < height)
      out[(size_t)y * width + x] = best[i] >= kInf ? 1.0f : best[i];
  }
}

template <int TILE>
__global__ void __launch_bounds__(kThreads)
k1_attr_kernel(const float* __restrict__ payload, int rows,
               const int* __restrict__ ranges, const float* __restrict__ big,
               const unsigned char* __restrict__ big_have, int nbig, int n_attr,
               int n_blocks, int pos_bits, float* __restrict__ interp,
               float* __restrict__ nearc, float* __restrict__ zout,
               unsigned char* __restrict__ valid, int height, int width, int tw) {
  constexpr int PPT = TILE * TILE / kThreads;
  __shared__ float sg[kChunk][kGeom];
  __shared__ unsigned char sh[kChunk];
  __shared__ int win_start[kWindows];
  const int t = blockIdx.x;
  const float x0 = (float)((t % tw) * TILE);
  const float y0 = (float)((t / tw) * TILE);
  const int span = n_blocks * kLanes;  // positions per window
  const int zmask = (0x7FFFFFFF >> pos_bits) << pos_bits;
  const int key_inf = 0x7FFFFFFF;
  if (threadIdx.x < kWindows) win_start[threadIdx.x] = ranges[t * 8 + threadIdx.x];
  float px[PPT], py[PPT];
  int key[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    int p = threadIdx.x + i * kThreads;
    px[i] = __fadd_rn(__fadd_rn(x0, (float)(p % TILE)), 0.5f);
    py[i] = __fadd_rn(__fadd_rn(y0, (float)(p / TILE)), 0.5f);
    key[i] = key_inf;
  }
  for (int r = 0; r <= kWindows; ++r) {
    const float* src;
    int cnt, pos0;
    if (r < kWindows) {
      const int s = ranges[t * 8 + r];
      src = payload + (size_t)s * rows;
      cnt = ranges[t * 8 + 4 + r];
      pos0 = r * span + (s % kLanes);
    } else {
      src = big;
      cnt = nbig;
      pos0 = kWindows * span;
    }
    for (int base = 0; base < cnt; base += kChunk) {
      const int n = min(kChunk, cnt - base);
      __syncthreads();
      for (int e = threadIdx.x; e < n * kGeom; e += kThreads) {
        int c = e / kGeom;
        sg[c][e - c * kGeom] = src[(size_t)(base + c) * rows + (e - c * kGeom)];
      }
      for (int c = threadIdx.x; c < n; c += kThreads)
        sh[c] = (r < kWindows) ? 1 : big_have[base + c];
      __syncthreads();
      for (int c = 0; c < n; ++c) {
        if (!sh[c]) continue;
        const int pos = pos0 + base + c;
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          float z;
          if (covers(sg[c], px[i], py[i], &z)) {
            int k = (__float_as_int(z) & zmask) | pos;
            key[i] = min(key[i], k);
          }
        }
      }
    }
  }
  __syncthreads();
  const int pos_mask = (1 << pos_bits) - 1;
  const int a = n_attr;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    int p = threadIdx.x + i * kThreads;
    int x = (int)x0 + p % TILE, y = (int)y0 + p / TILE;
    if (x >= width || y >= height) continue;
    const size_t pix = (size_t)y * width + x;
    float* io = interp + pix * a;
    float* no = nearc + pix * a;
    if (key[i] == key_inf) {
      for (int j = 0; j < a; ++j) { io[j] = 0.0f; no[j] = 0.0f; }
      zout[pix] = 1.0f;
      valid[pix] = 0;
      continue;
    }
    const int pos = key[i] & pos_mask;
    const float* g;
    if (pos >= kWindows * span) {
      g = big + (size_t)(pos - kWindows * span) * rows;
    } else {
      const int r = pos / span;
      const int s = win_start[r];
      g = payload + (size_t)(s + (pos - r * span) - (s % kLanes)) * rows;
    }
    const float X = px[i], Y = py[i];
    float b0 = plane(g[0], g[1], g[2], X, Y);
    float b1 = plane(g[3], g[4], g[5], X, Y);
    float b2 = __fsub_rn(__fsub_rn(1.0f, b0), b1);
    float pb0 = __fmul_rn(b0, g[9]);
    float pb1 = __fmul_rn(b1, g[10]);
    float pb2 = __fmul_rn(b2, g[11]);
    float norm = __frcp_rn(fmaxf(__fadd_rn(__fadd_rn(pb0, pb1), pb2), 1e-12f));
    pb0 = __fmul_rn(pb0, norm);
    pb1 = __fmul_rn(pb1, norm);
    pb2 = __fmul_rn(pb2, norm);
    const float* a0 = g + kGeom;
    const float* a1 = a0 + a;
    const float* a2 = a1 + a;
    const bool m01 = pb0 >= pb1;
    const float m = m01 ? pb0 : pb1;
    const float* nc = (m >= pb2) ? (m01 ? a0 : a1) : a2;
    for (int j = 0; j < a; ++j) {
      io[j] = __fadd_rn(__fadd_rn(__fmul_rn(pb0, a0[j]), __fmul_rn(pb1, a1[j])),
                        __fmul_rn(pb2, a2[j]));
      no[j] = nc[j];
    }
    zout[pix] = plane(g[6], g[7], g[8], X, Y);
    valid[pix] = 1;
  }
}

}  // namespace

extern "C" int k1_raster_depth(const float* payload, int rows, const int* ranges,
                               const float* big, const unsigned char* big_have, int nbig,
                               float* out, int height, int width, int tile, int tw,
                               int n_tiles, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_tiles <= 0) return (int)cudaSuccess;
  if (tile == 32) {
    k1_depth_kernel<32><<<n_tiles, kThreads, 0, s>>>(payload, rows, ranges, big, big_have,
                                                      nbig, out, height, width, tw);
  } else if (tile == 16) {
    k1_depth_kernel<16><<<n_tiles, kThreads, 0, s>>>(payload, rows, ranges, big, big_have,
                                                      nbig, out, height, width, tw);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int k1_raster_attributes(const float* payload, int rows, const int* ranges,
                                    const float* big, const unsigned char* big_have,
                                    int nbig, int n_attr, int n_blocks, int pos_bits,
                                    float* interp, float* nearc, float* zout,
                                    unsigned char* valid, int height, int width, int tile,
                                    int tw, int n_tiles, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_tiles <= 0) return (int)cudaSuccess;
  if (tile == 32) {
    k1_attr_kernel<32><<<n_tiles, kThreads, 0, s>>>(
        payload, rows, ranges, big, big_have, nbig, n_attr, n_blocks, pos_bits, interp,
        nearc, zout, valid, height, width, tw);
  } else if (tile == 16) {
    k1_attr_kernel<16><<<n_tiles, kThreads, 0, s>>>(
        payload, rows, ranges, big, big_have, nbig, n_attr, n_blocks, pos_bits, interp,
        nearc, zout, valid, height, width, tw);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
