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
// contraction) so they round exactly like the plain PyTorch version; z-min
// and key-min are exact and keys are unique per tile, so the order in which
// candidates are visited does not change a bit of the result.
//
// Bound on the H100 (3.35 TB/s HBM, 67 TFLOP/s FP32 non-tensor), as
// render/raster_pallas.py:bound_ms counts it from each call's inputs:
//   bytes: every payload row a window (or the big block) references, read
//          once (12+3A floats), plus the ranges; every output pixel written
//          once (4 B depth; 8A+5 B for interp, near, z and valid).
//   operations: 14 FP32 operations per (pixel, candidate) plane evaluation
//          (three planes at 2 multiplies + 2 adds, b2 at 2 subtracts).
// The 1080p G-buffer view (A = 20, ~13 candidates per tile) is bytes-bound:
// 165 output bytes per pixel. The 512^2 shadow views (4 B per pixel) are
// operation-bound where they hold candidates, up to 515 per tile in the
// crowded middle of a view.
//
// Design. Both kernels walk a tile's candidates in chunks of 128, staged in
// shared memory candidate-major as three float4 (a0 b0 c0 a1 | b1 c1 za zb |
// zc iw0 iw1 iw2), so a thread reads a candidate as three 16-byte broadcast
// loads. Thread c of the block copies candidate c with cp.async (three
// 16-byte copies where the payload rows are 16-byte aligned, i.e. rows % 4 ==
// 0 and aligned bases; twelve 4-byte copies otherwise, e.g. A = 7), and the
// next chunk is copied while this one is evaluated (double buffer). The big
// block's slots with a candidate (big_have 1) are listed once per block
// (warp ballots), so its empty slots are neither copied nor evaluated: a
// frame's big block has 128 slots and 0-3 candidates.
//   k1_depth_kernel: the shadow views are few tiles (256 at 512^2, tile 32)
//          with very uneven work: the candidates crowd a few dozen tiles, up
//          to 515 a tile, and one block per tile leaves that tile's work on
//          one SM while the others idle. So each tile is served by a cluster
//          of kParts = 8 blocks of 256 threads (2048 threads a tile) on eight
//          SMs: block q evaluates all the tile's pixels (four a thread, one
//          column, so a*x of each plane is shared) against the q-th eighth of
//          the tile's candidates, and the eight partial z-mins meet through
//          distributed shared memory (block q reduces and writes the q-th
//          eighth of the pixels). A 512^2 view is 2048 blocks on all 132 SMs.
//          Each block reads its share of the windows itself (48 B a
//          candidate, from L2). On the H100 at 700 W, four parts (one wave of
//          1024 blocks) took 0.004 ms less on a bench frame's empty shadow
//          views and 0.008-0.014 ms more on its crowded ones.
//   k1_attr_kernel: one 256-thread block per tile, four pixels per thread
//          for the key min. Its cost is the G-buffer write, and [H, W, A]
//          makes each tile row of interp (and of near) one contiguous run of
//          wpx*A floats. So the epilogue first stages each pixel's winner in
//          shared memory (normalized perspective weights, winner row, nearest
//          corner: 16 B a pixel), then each warp takes whole tile rows and
//          computes the runs in order, four consecutive floats per lane, and
//          stores them as 16-byte vector stores from neighbouring lanes (512
//          contiguous bytes a warp instruction). Computing the runs in place
//          keeps the interp and near values out of shared memory: only the
//          16 B of winner state per pixel is staged, not the 160 KB of a
//          tile's outputs. A run starts at (y*W + x0)*A floats, so odd W or
//          odd A misalign it: the first 0-3 floats (head) and the last 0-3
//          (tail) are scalar stores, the rest float4 (interp and near share
//          their alignment mod 16, which the entry point checks). A lane's
//          attribute reads a0[j], a1[j], a2[j] come from the winner's payload
//          row; neighbouring lanes read neighbouring floats of mostly one row,
//          so the gather is coalesced and L1-resident. Where A % 4 == 0 and
//          the rows are 16-byte aligned (the G-buffer's A = 20), runs start
//          aligned and no float4 straddles two pixels, so a lane reads its
//          winner's a0, a1, a2 as three 16-byte loads for its two float4
//          stores, not twelve scalar loads. z and valid go out as
//          one contiguous 128 B and 32 B run per warp (a tile row). interp
//          and near are stored with the streaming hint (st.global.cs): the
//          342 MB G-buffer outgrows L2, the payload rows it reads do not.
// The TPU mechanics (lane-major [P/128,R,128] blocks, 128-aligned DMA floors,
// one-hot MXU select, double-buffered grid steps) are not carried over.
// chip_smoke.py measures each kernel alone (torch.profiler) and computes the
// bound from each run's data.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;     // candidates staged in shared memory per pass
constexpr int kGeom = 12;       // a0 b0 c0 a1 b1 c1 za zb zc iw0 iw1 iw2
constexpr int kWindows = 4;
constexpr int kLanes = 128;
constexpr int kBigRow = 1 << 28;  // winner code: a big-block row, not a payload row
constexpr int kMaxAttr = 2048;    // e / A by __umulhi is exact for e < 32 A up to here
constexpr float kInf = 3.0e38f;

typedef float4 Chunk[kChunk][3];

__device__ __forceinline__ float plane(float a, float b, float c, float x, float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// A tile's candidate lists: windows 0-3 from the payload, then the big
// block's occupied slots (list 4), numbered 0 .. first[5) - 1 in that order.
// Block-uniform, kept in shared memory.
struct TileList {
  const float* src[kWindows + 1];
  int start[kWindows + 1];
  int first[kWindows + 2];           // list r holds candidates first[r] .. first[r+1]-1
  int pos0[kWindows + 1];            // key position of the list's first slot
  int warp_cnt[kChunk / 32];
  unsigned char big_slot[kChunk];    // list 4's candidates: their big-block slots
};

// fill L (two barriers; every thread of the block calls it)
__device__ __forceinline__ void load_list(TileList& L, const float* payload, int rows,
                                          const int* ranges, const float* big,
                                          const unsigned char* __restrict__ big_have, int nbig,
                                          int t, int span) {
  const int r = threadIdx.x;
  const int lane = r & 31;
  if (r < kWindows) {
    const int s = ranges[t * 8 + r];
    L.src[r] = payload + static_cast<size_t>(s) * rows;
    L.start[r] = s;
    L.pos0[r] = r * span + s % kLanes;
  } else if (r == kWindows) {
    L.src[r] = big;
    L.start[r] = 0;
    L.pos0[r] = kWindows * span;
  }
  const bool have = r < nbig && big_have[r];
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, have);
  if (lane == 0 && r < kChunk) L.warp_cnt[r >> 5] = __popc(ballot);
  __syncthreads();
  if (have) {
    int slot = __popc(ballot & ((1u << lane) - 1u));
    for (int w = 0; w < (r >> 5); ++w) slot += L.warp_cnt[w];
    L.big_slot[slot] = static_cast<unsigned char>(r);
  }
  if (r == 0) {
    int n = 0;
    for (int w = 0; w < kWindows; ++w) {
      L.first[w] = n;
      n += ranges[t * 8 + 4 + w];
    }
    L.first[kWindows] = n;
    for (int w = 0; w < kChunk / 32; ++w) n += L.warp_cnt[w];
    L.first[kWindows + 1] = n;
  }
  __syncthreads();
}

// thread c copies candidate i0 + c into dst[c] (c < n <= kChunk) and, where
// spos is given, its key position into spos[c]
__device__ __forceinline__ void stage(Chunk& dst, int* spos, const TileList& L, int i0, int n,
                                      int rows, bool vec) {
  const int c = threadIdx.x;
  if (c >= n) return;
  const int i = i0 + c;
  int r = 0;
  while (i >= L.first[r + 1]) ++r;
  const int off = i - L.first[r];
  const int row = r < kWindows ? off : L.big_slot[off];
  const float* g = L.src[r] + static_cast<size_t>(row) * rows;
  if (vec) {
    cp_async16(&dst[c][0], g);
    cp_async16(&dst[c][1], g + 4);
    cp_async16(&dst[c][2], g + 8);
  } else {
    float* d = reinterpret_cast<float*>(&dst[c][0]);
#pragma unroll
    for (int q = 0; q < kGeom; ++q) cp_async4(d + q, g + q);
  }
  if (spos) spos[c] = L.pos0[r] + row;
}

// Walk candidates [i0, i1) of the tile's lists chunk by chunk, copying chunk
// k + 1 while chunk k is evaluated: eval(chunk, positions, n) gets n staged
// candidates (and their key positions where spos is given).
template <class Eval>
__device__ __forceinline__ void for_each_chunk(const TileList& L, Chunk* buf, int (*spos)[kChunk],
                                               int i0, int i1, int rows, bool vec, Eval eval) {
  if (i0 >= i1) return;
  int cur = 0;
  stage(buf[0], spos ? spos[0] : nullptr, L, i0, min(kChunk, i1 - i0), rows, vec);
  cp_async_commit();
  for (int i = i0; i < i1; i += kChunk) {
    const int next = i + kChunk;
    if (next < i1)
      stage(buf[cur ^ 1], spos ? spos[cur ^ 1] : nullptr, L, next, min(kChunk, i1 - next), rows,
            vec);
    cp_async_commit();
    cp_async_wait_prior();  // this chunk's copies (the next chunk's may fly)
    __syncthreads();
    eval(buf[cur], spos ? spos[cur] : nullptr, min(kChunk, i1 - i));
    __syncthreads();  // buf[cur] is refilled in the next round
    cur ^= 1;
  }
}

// b0, b1 and z of a staged candidate at the pixel (x, y), given a*x of the
// three planes (ax0, ax1, axz): the rounding of plane(), a*x shared by the
// pixels of one column
__device__ __forceinline__ bool covers_at(const float4 (&g)[3], float ax0, float ax1, float axz,
                                          float y, float* z) {
  const float b0 = __fadd_rn(__fadd_rn(ax0, __fmul_rn(g[0].y, y)), g[0].z);
  const float b1 = __fadd_rn(__fadd_rn(ax1, __fmul_rn(g[1].x, y)), g[1].y);
  const float zz = __fadd_rn(__fadd_rn(axz, __fmul_rn(g[1].w, y)), g[2].x);
  const float b2 = __fsub_rn(__fsub_rn(1.0f, b0), b1);
  *z = zz;
  return (b0 >= 0.0f) & (b1 >= 0.0f) & (b2 >= 0.0f) & (zz >= 0.0f) & (zz <= 1.0f);
}

// The depth kernel's cluster: kParts blocks per tile on kParts SMs, block q
// evaluating the whole tile against the q-th part of its candidates; the
// partial z-mins meet through distributed shared memory.
constexpr int kParts = 8;
constexpr int kDepthThreads = 256;

template <int TILE>
__global__ void __cluster_dims__(kParts, 1, 1) __launch_bounds__(kDepthThreads)
k1_depth_kernel(const float* __restrict__ payload, int rows,
                const int* __restrict__ ranges, const float* __restrict__ big,
                const unsigned char* __restrict__ big_have, int nbig, bool vec,
                float* __restrict__ out, int height, int width, int tw) {
  constexpr int PPT = TILE * TILE / kDepthThreads;  // pixels per thread, one column
  constexpr int kRowStep = kDepthThreads / TILE;
  constexpr int kOwn = TILE * TILE / kParts;   // pixels each block reduces and writes
  __shared__ __align__(16) Chunk buf[2];
  __shared__ float part[TILE * TILE];
  __shared__ TileList L;
  cg::cluster_group cluster = cg::this_cluster();
  const int q = static_cast<int>(cluster.block_rank());
  const int t = blockIdx.x / kParts;
  const int x0 = (t % tw) * TILE, y0 = (t / tw) * TILE;
  const float px = __fadd_rn(__fadd_rn(static_cast<float>(x0),
                                       static_cast<float>(threadIdx.x % TILE)), 0.5f);
  float py[PPT], best[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    py[i] = __fadd_rn(__fadd_rn(static_cast<float>(y0),
                                static_cast<float>(threadIdx.x / TILE + i * kRowStep)), 0.5f);
    best[i] = kInf;
  }
  load_list(L, payload, rows, ranges, big, big_have, nbig, t, 0);
  const int n = L.first[kWindows + 1];
  for_each_chunk(L, buf, nullptr, n * q / kParts, n * (q + 1) / kParts, rows, vec,
                 [&](const Chunk& g, const int*, int m) {
#pragma unroll 2
    for (int c = 0; c < m; ++c) {
      const float ax0 = __fmul_rn(g[c][0].x, px);
      const float ax1 = __fmul_rn(g[c][0].w, px);
      const float axz = __fmul_rn(g[c][1].z, px);
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        float z;
        if (covers_at(g[c], ax0, ax1, axz, py[i], &z)) best[i] = fminf(best[i], z);
      }
    }
  });
#pragma unroll
  for (int i = 0; i < PPT; ++i) part[threadIdx.x + i * kDepthThreads] = best[i];
  cluster.sync();
  if (threadIdx.x < kOwn) {
    const int p = q * kOwn + threadIdx.x;
    float v = kInf;
#pragma unroll
    for (int k = 0; k < kParts; ++k) v = fminf(v, cluster.map_shared_rank(part, k)[p]);
    const int x = x0 + p % TILE, y = y0 + p / TILE;
    if (x < width && y < height) out[static_cast<size_t>(y) * width + x] = v >= kInf ? 1.0f : v;
  }
  cluster.sync();  // no block leaves while the others read its part
}

// payload or big-block row of a winner code's row id
__device__ __forceinline__ const float* winner_row(int rid, const float* __restrict__ payload,
                                                   const float* __restrict__ big, int rows) {
  return (rid & kBigRow) ? big + static_cast<size_t>(rid & (kBigRow - 1)) * rows
                         : payload + static_cast<size_t>(rid) * rows;
}

__device__ __forceinline__ float interp3(const float4& m, float a0, float a1, float a2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(m.x, a0), __fmul_rn(m.y, a1)), __fmul_rn(m.z, a2));
}

__device__ __forceinline__ float nearest(int sel, float a0, float a1, float a2) {
  return sel == 0 ? a0 : (sel == 1 ? a1 : a2);
}

// interp and near of element e (pixel e / A, attribute e % A) of a tile row
// run, from the row's staged winners
__device__ __forceinline__ void attr_at(int e, const float4* __restrict__ mrow, int a,
                                        unsigned magic, const float* __restrict__ payload,
                                        const float* __restrict__ big, int rows, float* vi,
                                        float* vn) {
  const int c = a == 1 ? e : static_cast<int>(__umulhi(static_cast<unsigned>(e), magic));
  const int j = e - c * a;
  const float4 m = mrow[c];
  const int code = __float_as_int(m.w);
  if (code < 0) {
    *vi = 0.0f;
    *vn = 0.0f;
    return;
  }
  const float* at = winner_row(code >> 2, payload, big, rows) + kGeom + j;
  const float a0 = __ldg(at), a1 = __ldg(at + a), a2 = __ldg(at + 2 * a);
  *vi = interp3(m, a0, a1, a2);
  *vn = nearest(code & 3, a0, a1, a2);
}

template <int TILE>
__global__ void __launch_bounds__(kThreads)
k1_attr_kernel(const float* __restrict__ payload, int rows,
               const int* __restrict__ ranges, const float* __restrict__ big,
               const unsigned char* __restrict__ big_have, int nbig, bool vec, int n_attr,
               int n_blocks, int pos_bits, float* __restrict__ interp,
               float* __restrict__ nearc, float* __restrict__ zout,
               unsigned char* __restrict__ valid, int height, int width, int tw) {
  constexpr int PPT = TILE * TILE / kThreads;  // pixels per thread, one column
  constexpr int kRowStep = kThreads / TILE;
  __shared__ __align__(16) Chunk buf[2];
  __shared__ int spos[2][kChunk];
  __shared__ float4 meta[TILE * TILE];  // per pixel: pb0 pb1 pb2, winner code
  __shared__ TileList L;
  const int t = blockIdx.x;
  const int x0 = (t % tw) * TILE, y0 = (t / tw) * TILE;
  const int span = n_blocks * kLanes;  // positions per window
  const int zmask = (0x7FFFFFFF >> pos_bits) << pos_bits;
  const int key_inf = 0x7FFFFFFF;
  load_list(L, payload, rows, ranges, big, big_have, nbig, t, span);
  const float px = __fadd_rn(__fadd_rn(static_cast<float>(x0),
                                       static_cast<float>(threadIdx.x % TILE)), 0.5f);
  float py[PPT];
  int key[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    py[i] = __fadd_rn(__fadd_rn(static_cast<float>(y0),
                                static_cast<float>(threadIdx.x / TILE + i * kRowStep)), 0.5f);
    key[i] = key_inf;
  }
  for_each_chunk(L, buf, spos, 0, L.first[kWindows + 1], rows, vec,
                 [&](const Chunk& g, const int* pos, int m) {
    for (int c = 0; c < m; ++c) {
      const float ax0 = __fmul_rn(g[c][0].x, px);
      const float ax1 = __fmul_rn(g[c][0].w, px);
      const float axz = __fmul_rn(g[c][1].z, px);
      const int cpos = pos[c];
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        float z;
        if (covers_at(g[c], ax0, ax1, axz, py[i], &z))
          key[i] = min(key[i], (__float_as_int(z) & zmask) | cpos);
      }
    }
  });

  // stage each pixel's winner; write z and valid (a warp holds a tile row)
  const int pos_mask = (1 << pos_bits) - 1;
  const int a = n_attr;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = threadIdx.x + i * kThreads;
    const int x = x0 + p % TILE, y = y0 + p / TILE;
    if (key[i] == key_inf) {
      meta[p] = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(-1));
      if (x < width && y < height) {
        zout[static_cast<size_t>(y) * width + x] = 1.0f;
        valid[static_cast<size_t>(y) * width + x] = 0;
      }
      continue;
    }
    const int pos = key[i] & pos_mask;
    int rid;
    if (pos >= kWindows * span) {
      rid = kBigRow | (pos - kWindows * span);
    } else {
      const int r = pos / span;
      rid = L.start[r] + (pos - L.pos0[r]);
    }
    const float* g = winner_row(rid, payload, big, rows);
    const float X = px, Y = py[i];
    const float b0 = plane(g[0], g[1], g[2], X, Y);
    const float b1 = plane(g[3], g[4], g[5], X, Y);
    const float b2 = __fsub_rn(__fsub_rn(1.0f, b0), b1);
    float pb0 = __fmul_rn(b0, g[9]);
    float pb1 = __fmul_rn(b1, g[10]);
    float pb2 = __fmul_rn(b2, g[11]);
    const float norm = __frcp_rn(fmaxf(__fadd_rn(__fadd_rn(pb0, pb1), pb2), 1e-12f));
    pb0 = __fmul_rn(pb0, norm);
    pb1 = __fmul_rn(pb1, norm);
    pb2 = __fmul_rn(pb2, norm);
    const bool m01 = pb0 >= pb1;
    const float m = m01 ? pb0 : pb1;
    const int sel = (m >= pb2) ? (m01 ? 0 : 1) : 2;
    meta[p] = make_float4(pb0, pb1, pb2, __int_as_float((rid << 2) | sel));
    if (x < width && y < height) {
      zout[static_cast<size_t>(y) * width + x] = plane(g[6], g[7], g[8], X, Y);
      valid[static_cast<size_t>(y) * width + x] = 1;
    }
  }
  __syncthreads();

  // interp and near: each warp writes whole tile rows as contiguous runs of
  // wpx*A floats, 16-byte stores between a scalar head and tail
  const int lane = threadIdx.x & 31;
  const int wpx = min(TILE, width - x0);
  if (vec && a % 4 == 0 && (reinterpret_cast<uintptr_t>(interp) & 15u) == 0) {
    // A % 4 == 0 with 16-byte aligned rows and outputs: every run starts
    // aligned and no float4 straddles two pixels, so each lane reads the
    // winner's three attribute float4s and writes one float4 of each output
    const int a4 = a >> 2;
    const unsigned magic = a4 == 1 ? 0u : 0xFFFFFFFFu / static_cast<unsigned>(a4) + 1u;
    for (int ty = threadIdx.x >> 5; ty < TILE && y0 + ty < height; ty += kWarps) {
      const size_t off = (static_cast<size_t>(y0 + ty) * width + x0) * a;
      float4* gi = reinterpret_cast<float4*>(interp + off);
      float4* gn = reinterpret_cast<float4*>(nearc + off);
      const float4* mrow = meta + ty * TILE;
      for (int q = lane; q < wpx * a4; q += 32) {
        const int c = a4 == 1 ? q : static_cast<int>(__umulhi(static_cast<unsigned>(q), magic));
        const float4 m = mrow[c];
        const int code = __float_as_int(m.w);
        float4 vi = make_float4(0.0f, 0.0f, 0.0f, 0.0f), vn = vi;
        if (code >= 0) {
          const float4* at = reinterpret_cast<const float4*>(
                                 winner_row(code >> 2, payload, big, rows) + kGeom) +
                             (q - c * a4);
          const float4 a0 = __ldg(at), a1 = __ldg(at + a4), a2 = __ldg(at + 2 * a4);
          const int sel = code & 3;
          vi = make_float4(interp3(m, a0.x, a1.x, a2.x), interp3(m, a0.y, a1.y, a2.y),
                           interp3(m, a0.z, a1.z, a2.z), interp3(m, a0.w, a1.w, a2.w));
          vn = make_float4(nearest(sel, a0.x, a1.x, a2.x), nearest(sel, a0.y, a1.y, a2.y),
                           nearest(sel, a0.z, a1.z, a2.z), nearest(sel, a0.w, a1.w, a2.w));
        }
        __stcs(gi + q, vi);  // streaming: the G-buffer outgrows L2, the payload not
        __stcs(gn + q, vn);
      }
    }
    return;
  }
  const int len = wpx * a;
  const unsigned magic = a == 1 ? 0u : 0xFFFFFFFFu / static_cast<unsigned>(a) + 1u;
  for (int ty = threadIdx.x >> 5; ty < TILE && y0 + ty < height; ty += kWarps) {
    const size_t off = (static_cast<size_t>(y0 + ty) * width + x0) * a;
    float* gi = interp + off;
    float* gn = nearc + off;
    const float4* mrow = meta + ty * TILE;
    const int head = min(len, static_cast<int>((16u - (reinterpret_cast<uintptr_t>(gi) & 15u)) &
                                               15u) >> 2);
    const int nvec = (len - head) >> 2;
    const int body_end = head + 4 * nvec;
    for (int k = lane; k < head + (len - body_end); k += 32) {
      const int e = k < head ? k : body_end + (k - head);
      float vi, vn;
      attr_at(e, mrow, a, magic, payload, big, rows, &vi, &vn);
      gi[e] = vi;
      gn[e] = vn;
    }
    for (int q = lane; q < nvec; q += 32) {
      const int e = head + 4 * q;
      float4 vi, vn;
      attr_at(e, mrow, a, magic, payload, big, rows, &vi.x, &vn.x);
      attr_at(e + 1, mrow, a, magic, payload, big, rows, &vi.y, &vn.y);
      attr_at(e + 2, mrow, a, magic, payload, big, rows, &vi.z, &vn.z);
      attr_at(e + 3, mrow, a, magic, payload, big, rows, &vi.w, &vn.w);
      __stcs(reinterpret_cast<float4*>(gi + e), vi);
      __stcs(reinterpret_cast<float4*>(gn + e), vn);
    }
  }
}

// cp.async may copy a candidate's 12 geometry floats as three 16-byte pieces
bool rows_aligned(const float* payload, const float* big, int rows) {
  return rows % 4 == 0 && (reinterpret_cast<uintptr_t>(payload) & 15u) == 0 &&
         (reinterpret_cast<uintptr_t>(big) & 15u) == 0;
}

}  // namespace

extern "C" int k1_raster_depth(const float* payload, int rows, const int* ranges,
                               const float* big, const unsigned char* big_have, int nbig,
                               float* out, int height, int width, int tile, int tw,
                               int n_tiles, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_tiles <= 0) return (int)cudaSuccess;
  if (nbig < 0 || nbig > kChunk) return (int)cudaErrorInvalidValue;
  const bool vec = rows_aligned(payload, big, rows);
  if (tile == 32) {
    k1_depth_kernel<32><<<n_tiles * kParts, kDepthThreads, 0, s>>>(
        payload, rows, ranges, big, big_have, nbig, vec, out, height, width, tw);
  } else if (tile == 16) {
    k1_depth_kernel<16><<<n_tiles * kParts, kDepthThreads, 0, s>>>(
        payload, rows, ranges, big, big_have, nbig, vec, out, height, width, tw);
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
  // interp and near must share their alignment mod 16 bytes to share the
  // vector body of each run
  if (nbig < 0 || nbig > kChunk || n_attr < 1 || n_attr > kMaxAttr ||
      ((reinterpret_cast<uintptr_t>(interp) ^ reinterpret_cast<uintptr_t>(nearc)) & 15u))
    return (int)cudaErrorInvalidValue;
  const bool vec = rows_aligned(payload, big, rows);
  if (tile == 32) {
    k1_attr_kernel<32><<<n_tiles, kThreads, 0, s>>>(
        payload, rows, ranges, big, big_have, nbig, vec, n_attr, n_blocks, pos_bits, interp,
        nearc, zout, valid, height, width, tw);
  } else if (tile == 16) {
    k1_attr_kernel<16><<<n_tiles, kThreads, 0, s>>>(
        payload, rows, ranges, big, big_have, nbig, vec, n_attr, n_blocks, pos_bits, interp,
        nearc, zout, valid, height, width, tw);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
