// K2: connected-component labelling, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel impact_tpu/ops/ccl_pallas.py:_ccl_kernel
// (:45; ccl_propagate_sweeps -> pl.pallas_call), which runs n_sweeps Jacobi
// min-sweeps over one VMEM-resident [G,G,G] i32 label grid, and its host
// fixpoint loop (connected_component_labels_pallas, :75-100: one kernel call
// per 16 sweeps until nothing changes). This file holds two designs.
//
// 1. The labels (k2_ccl_labels, the engine's split detection): for each grid
//    of a batch, i32 labels equal to the sweeps' fixpoint, the minimum linear
//    index i*G^2 + j*G + k of each voxel's 6-connected component, -1 where
//    empty. (The Pallas kernel composes its three axis passes through the
//    intermediate minimum, which also joins voxels that touch only along an
//    edge or corner; these labels are the 6-connected ones of the
//    reference's XLA path, whose fixpoint the split detection means.)
//
//    Design: a union-find whose roots are minima. parent[v] starts at v and
//    a union hooks the larger root under the smaller with atomicCAS, so
//    parent[v] <= v always holds and each component's root is its minimum
//    index: the sweeps' label, whatever order the atomics take. Three
//    launches over the whole batch, none of which reads anything back to
//    the host, whatever the data:
//      tile pass     one 512-thread block per 8^3 tile of one grid (ragged
//                    tiles masked): each voxel starts under the first voxel
//                    of its run along k (a warp ballot), the runs of
//                    neighbouring rows are joined in shared memory, then
//                    each voxel's tile-local root is written as a grid index
//                    into the label array, which from then on is the parent
//                    array;
//      face pass     one thread per voxel pair across a tile's three low
//                    faces: a union in global memory;
//      compress pass one thread per voxel: its root, written in place
//                    (no other cell written, so a root once written stays).
//    A label moves by pointer, not one voxel per sweep, so no path through a
//    grid (a serpentine needs G^2/2 sweeps) costs more than a chain of tile
//    roots, and every find shortens the chains it walks (each node re-pointed
//    to its grandparent, as in ECL-CC). A pair of voxels is joined only where
//    its neighbours one step along the run are not a joined pair already,
//    so a full grid costs a union per run and not per voxel: the extreme
//    where every union lands on root 0. Finds in global memory read past L1
//    (ld.global.cg), which is not coherent across SMs; a stale parent only
//    costs a retry of the union.
//
//    Bound on the H100 (ops/ccl_pallas.py:labels_bound_ms): 1 B of
//    occupancy in and 4 B of label out per voxel, bytes-bound (0.2 us for
//    four 32^3 grids). The design moves about 14 B a voxel (occupancy twice,
//    the labels written, read and rewritten), all of it L2-resident at the
//    split detection's sizes, and pays three launches of a few microseconds
//    each, which no bytes bound counts: on small batches the passes are
//    latency, not bytes. Tiles are 8^3: k-long tiles (4x4x32), which give a
//    warp a whole row, cost fewer unions on full grids and more face unions
//    on random fills (PERF.md).
//
// 2. The sweeps (k2_ccl_sweeps, k2_ccl_wide: ops/ccl_pallas.py:ccl_sweeps,
//    the port of ccl_propagate_sweeps): up to max_sweeps sweeps of
//        new[v] = occ[v] ? min(lab[v], lab[six face neighbours]) : big
//    from arbitrary start labels, with big = G^3 past the border, stopping a
//    grid after the first sweep that changes nothing, with sweep counts.
//    One 1024-thread block owns one grid; gridDim.x counts the grids. The
//    labels stay in shared memory for every sweep as two u16 buffers (G^3 <=
//    65535, big included) plus a G^3-bit occupancy mask, opted into with
//    cudaFuncSetAttribute; that fits a block's 232,448 bytes up to G = 38
//    (ops/ccl_pallas.py:k2_shared_bytes), and larger grids take K2-wide
//    below. Each sweep reads one buffer and writes the other, and ends in
//    __syncthreads_or(changed), both the barrier between sweeps and the
//    fixpoint test. Bound (ops/ccl_pallas.py:bound_ms): 1 B of occupancy + 4
//    B of labels in + 4 B out per voxel; 8 operations per voxel and sweep
//    run. One block per grid uses as many SMs as there are grids, and every
//    sweep re-reads seven u16 per voxel from shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ uint16_t min16(uint16_t a, uint16_t b) { return a < b ? a : b; }

__global__ void __launch_bounds__(kThreads)
k2_ccl_kernel(const uint8_t* __restrict__ occ, const int32_t* __restrict__ labels_in,
              int32_t* __restrict__ labels_out, int32_t* __restrict__ sweeps_out,
              int g, int max_sweeps) {
  extern __shared__ uint16_t smem[];
  const int n = g * g * g;
  const int gg = g * g;
  const uint16_t big = static_cast<uint16_t>(n);
  uint16_t* cur = smem;
  uint16_t* nxt = smem + n;
  // occupancy bits after the two label buffers (2n u16 = 4n bytes: 4-aligned)
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + 2 * n);
  const int n_words = (n + 31) / 32;

  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const uint8_t* o = occ + base;
  const int32_t* lin = labels_in + base;
  int32_t* lout = labels_out + base;

  for (int w = threadIdx.x; w < n_words; w += blockDim.x) {
    uint32_t bits = 0;
    for (int b = 0; b < 32; ++b) {
      const int v = w * 32 + b;
      if (v < n && o[v]) bits |= 1u << b;
    }
    mask[w] = bits;
  }
  for (int v = threadIdx.x; v < n; v += blockDim.x) cur[v] = static_cast<uint16_t>(lin[v]);
  __syncthreads();

  int sweeps = 0;
  while (sweeps < max_sweeps) {
    int changed = 0;
    for (int v = threadIdx.x; v < n; v += blockDim.x) {
      const uint16_t old = cur[v];
      uint16_t m = big;
      if ((mask[v >> 5] >> (v & 31)) & 1u) {
        const int i = v / gg;
        const int j = (v / g) - i * g;
        const int k = v - (v / g) * g;
        m = old;
        if (i > 0) m = min16(m, cur[v - gg]);
        if (i < g - 1) m = min16(m, cur[v + gg]);
        if (j > 0) m = min16(m, cur[v - g]);
        if (j < g - 1) m = min16(m, cur[v + g]);
        if (k > 0) m = min16(m, cur[v - 1]);
        if (k < g - 1) m = min16(m, cur[v + 1]);
      }
      nxt[v] = m;
      changed |= (m != old);
    }
    ++sweeps;
    const int any = __syncthreads_or(changed);
    uint16_t* t = cur;
    cur = nxt;
    nxt = t;
    if (!any) break;
  }

  for (int v = threadIdx.x; v < n; v += blockDim.x) lout[v] = cur[v];
  if (threadIdx.x == 0) sweeps_out[blockIdx.x] = sweeps;
}

// --- K2-wide: grids past the shared-memory kernel (G >= 39) -----------------
//
// Same function as k2_ccl_kernel, for grids whose two u16 label buffers and
// occupancy mask do not fit a block's shared memory (G >= 39). The
// labels stay i32 in two global-memory ping-pong buffers, one thread per
// voxel, one launch per sweep: the reference's own fixpoint loop
// (impact_tpu/ops/ccl_pallas.py:connected_component_labels_pallas), which
// reads "changed" on the host once per group of up to 16 sweeps.
//
// flags holds (kGroup + 1) x batch ints for one group: row 0 is "grid b still
// runs" at the group's start, row s + 1 is "sweep s changed grid b". Grid b
// sweeps in step s when row 0 holds and, for s > 0, sweep s - 1 changed it;
// a grid that stops has just had a sweep that changed nothing, so both
// buffers hold its labels and neither needs a copy. k2_wide_finish folds the
// group into running[b] and sweeps[b], which the host reads.
//
// Bound: the same count as K2's (ops/ccl_pallas.py:bound_ms), operation-
// bound for a fixpoint that needs more than a sweep or two. This design
// moves every voxel's seven labels through L2 (a 63^3 grid's two buffers,
// 2 MB, stay resident) on every sweep and pays one launch per sweep.

constexpr int kWideThreads = 256;
constexpr int kGroup = 16;

__global__ void __launch_bounds__(kWideThreads)
k2_wide_sweep(const uint8_t* __restrict__ occ, const int32_t* __restrict__ src,
              int32_t* __restrict__ dst, int32_t* __restrict__ flags, int batch, int g,
              int s) {
  const int n = g * g * g;
  const int gg = g * g;
  const long long total = static_cast<long long>(batch) * n;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int b = static_cast<int>(idx / n);
    const int v = static_cast<int>(idx - static_cast<long long>(b) * n);
    if (!flags[b] || (s > 0 && !flags[s * batch + b])) continue;
    const int32_t old = src[idx];
    int32_t m = n;
    if (occ[idx]) {
      const int i = v / gg;
      const int j = (v / g) - i * g;
      const int k = v - (v / g) * g;
      m = old;
      if (i > 0) m = min(m, src[idx - gg]);
      if (i < g - 1) m = min(m, src[idx + gg]);
      if (j > 0) m = min(m, src[idx - g]);
      if (j < g - 1) m = min(m, src[idx + g]);
      if (k > 0) m = min(m, src[idx - 1]);
      if (k < g - 1) m = min(m, src[idx + 1]);
    }
    dst[idx] = m;
    if (m != old) flags[(s + 1) * batch + b] = 1;
  }
}

__global__ void k2_wide_finish(int32_t* __restrict__ flags, int32_t* __restrict__ running,
                               int32_t* __restrict__ sweeps, int batch, int n_sweeps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch || !running[b]) return;
  int done = 0;
  int run = 1;
  for (int s = 0; s < n_sweeps && run; ++s) {
    ++done;
    run = flags[(s + 1) * batch + b];
  }
  sweeps[b] += done;
  running[b] = run;
}

__global__ void k2_wide_start(const int32_t* __restrict__ running, int32_t* __restrict__ flags,
                              int batch) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < (kGroup + 1) * batch) flags[e] = e < batch ? running[e] : 0;
}

// --- The labels: min-root union-find ------------------------------------------

// tile shape (i, j, k); k, the contiguous axis, a power of two up to 32
constexpr int kTileI = 8, kTileJ = 8, kTileK = 8;
constexpr int kTileJK = kTileJ * kTileK;
constexpr int kTileVoxels = kTileI * kTileJK;  // a thread each
constexpr int kFaceI = kTileJ * kTileK, kFaceJ = kTileI * kTileK, kFaceK = kTileI * kTileJ;
constexpr int kFaceThreads = kFaceI + kFaceJ + kFaceK;  // a tile's three low faces
constexpr int kCompressThreads = 256;
static_assert(kTileK <= 32 && (kTileK & (kTileK - 1)) == 0, "a warp holds whole k rows");

// A node's parent changes only in two ways: a root is hooked under a smaller
// root (atomicCAS, which fails if the root was hooked meanwhile), and a find
// re-points a node it walks to its grandparent (intermediate pointer
// jumping, a plain store). Either way the new parent is in the node's set
// and below the node, so no store can split a set, whatever order the
// threads take (the hooks and jumps of ECL-CC, with minima as roots).

// Root of x in a tile's parent array while other threads hook roots.
__device__ __forceinline__ int find_shared(volatile int* par, int x) {
  int cur = par[x];
  if (cur == x) return x;
  int prev = x, next;
  while (cur > (next = par[cur])) {
    par[prev] = next;
    prev = cur;
    cur = next;
  }
  return cur;
}

// Hooks the larger of a's and b's roots under the smaller; a failed hook
// hands back the hooked root's new parent, and the loop goes on from it.
__device__ void union_shared(int* par, int a, int b) {
  a = find_shared(par, a);
  b = find_shared(par, b);
  while (a != b) {
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicCAS(par + b, b, a);
    if (old == b) return;
    b = old;
  }
}

// The same in a grid's label array, reading and writing past the SM's L1.
__device__ __forceinline__ int find_global(int32_t* lab, int x) {
  int cur = __ldcg(lab + x);
  if (cur == x) return x;
  int prev = x, next;
  while (cur > (next = __ldcg(lab + cur))) {
    __stcg(lab + prev, next);
    prev = cur;
    cur = next;
  }
  return cur;
}

__device__ void union_global(int32_t* lab, int a, int b) {
  a = find_global(lab, a);
  b = find_global(lab, b);
  while (a != b) {
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicCAS(lab + b, b, a);
    if (old == b) return;
    b = old;
  }
}

// Block -> (grid b, tile ti, tj, tk).
struct Tile {
  int base, i0, j0, k0, ti, tj, tk;
};

// A grid is [gx, g, g]: a whole grid (gx == g) or a slab of x planes.
__device__ __forceinline__ Tile tile_of_block(int gx, int g) {
  const int nti = (gx + kTileI - 1) / kTileI, ntj = (g + kTileJ - 1) / kTileJ;
  const int ntk = (g + kTileK - 1) / kTileK;
  const int per_grid = nti * ntj * ntk;
  const int b = blockIdx.x / per_grid;
  int t = blockIdx.x - b * per_grid;
  Tile r;
  r.ti = t / (ntj * ntk);
  t -= r.ti * ntj * ntk;
  r.tj = t / ntk;
  r.tk = t - r.tj * ntk;
  r.base = b * gx * g * g;
  r.i0 = r.ti * kTileI;
  r.j0 = r.tj * kTileJ;
  r.k0 = r.tk * kTileK;
  return r;
}

__global__ void __launch_bounds__(kTileVoxels)
k2_labels_tile(const uint8_t* __restrict__ occ, int32_t* __restrict__ lab, int gx, int g) {
  __shared__ int par[kTileVoxels];
  const Tile t = tile_of_block(gx, g);
  const int l = threadIdx.x;
  const int ii = l / kTileJK, jj = (l / kTileK) % kTileJ, kk = l % kTileK;
  const int i = t.i0 + ii, j = t.j0 + jj, k = t.k0 + kk;
  const bool in = i < gx && j < g && k < g;
  const int v = t.base + (i * g + j) * g + k;
  const bool o = in && occ[v];
  // a warp holds 32 / kTileK whole rows along k; each voxel starts under the
  // first voxel of its run in the row, which needs no atomics
  const unsigned row = (__ballot_sync(0xffffffffu, o) >> (l & 31 & ~(kTileK - 1))) &
                       (0xffffffffu >> (32 - kTileK));
  const unsigned gaps = ~row & ((1u << kk) - 1u);
  const int start = gaps ? 32 - __clz(gaps) : 0;
  par[l] = o ? l - kk + start : -1;  // local order is the grid's order inside a tile
  __syncthreads();
  // join the runs of neighbouring rows: a pair whose left neighbours along k
  // are both occupied is joined through them already
  if (o) {
    const bool left = kk > start;
    if (jj > 0 && par[l - kTileK] >= 0 && !(left && par[l - kTileK - 1] >= 0))
      union_shared(par, l, l - kTileK);
    const int up = l - kTileJK;
    if (ii > 0 && par[up] >= 0 && !(left && par[up - 1] >= 0)) union_shared(par, l, up);
  }
  __syncthreads();
  if (o) {
    const int r = find_shared(par, l);
    lab[v] = ((t.i0 + r / kTileJK) * g + t.j0 + (r / kTileK) % kTileJ) * g + t.k0 + r % kTileK;
  } else if (in) {
    lab[v] = -1;
  }
}

// One thread per voxel pair across a tile's low faces. A pair whose
// neighbours one step along the face (k, or j on the k face) are both
// occupied is joined through them already: those are adjacent to this pair
// inside the two tiles, which the tile pass joined.
__global__ void __launch_bounds__(kFaceThreads)
k2_labels_faces(const uint8_t* __restrict__ occ, int32_t* __restrict__ lab, int gx, int g) {
  const Tile t = tile_of_block(gx, g);
  int f = threadIdx.x;
  int i = t.i0, j = t.j0, k = t.k0, step, along, w;
  if (f < kFaceI) {
    if (t.ti == 0) return;
    w = f % kTileK;
    j += f / kTileK;
    k += w;
    step = g * g;
    along = 1;
  } else if ((f -= kFaceI) < kFaceJ) {
    if (t.tj == 0) return;
    w = f % kTileK;
    i += f / kTileK;
    k += w;
    step = g;
    along = 1;
  } else {
    f -= kFaceJ;
    if (t.tk == 0) return;
    w = f % kTileJ;
    i += f / kTileJ;
    j += w;
    step = 1;
    along = g;
  }
  if (i >= gx || j >= g || k >= g) return;
  const uint8_t* o = occ + t.base;
  const int v = (i * g + j) * g + k;
  if (!o[v] || !o[v - step]) return;
  if (w > 0 && o[v - along] && o[v - along - step]) return;
  union_global(lab + t.base, v, v - step);
}

// Each voxel's root, found without stores (a jump store could overwrite a
// root another thread has just written) and written to its own cell only.
__global__ void __launch_bounds__(kCompressThreads)
k2_labels_compress(int32_t* __restrict__ lab, int n, int total) {
  const int idx = blockIdx.x * kCompressThreads + threadIdx.x;
  if (idx >= total) return;
  const int p = __ldcg(lab + idx);
  if (p < 0) return;
  const int32_t* grid = lab + idx / n * n;
  int r = p, next;
  while (r > (next = __ldcg(grid + r))) r = next;
  if (r != p) lab[idx] = r;
}

}  // namespace

// Labels of a batch of bool slabs [batch, gx, g, g] (occupancy read as
// bytes) into i32 labels of the same shape, each the minimum linear index
// (i * g + j) * g + k of its component inside the slab: three launches, no
// host read.
extern "C" int k2_ccl_labels_slab(const void* occ, void* labels, int batch, int gx, int g,
                                  void* stream) {
  const long long total = static_cast<long long>(batch) * gx * g * g;
  if (batch <= 0 || g <= 0 || gx <= 0 || gx > g || total >= (1LL << 31))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* o = static_cast<const uint8_t*>(occ);
  int32_t* lab = static_cast<int32_t*>(labels);
  const long long tiles = static_cast<long long>(batch) * ((gx + kTileI - 1) / kTileI) *
                          ((g + kTileJ - 1) / kTileJ) * ((g + kTileK - 1) / kTileK);
  k2_labels_tile<<<static_cast<int>(tiles), kTileVoxels, 0, st>>>(o, lab, gx, g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k2_labels_faces<<<static_cast<int>(tiles), kFaceThreads, 0, st>>>(o, lab, gx, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int blocks = static_cast<int>((total + kCompressThreads - 1) / kCompressThreads);
  k2_labels_compress<<<blocks, kCompressThreads, 0, st>>>(lab, gx * g * g,
                                                          static_cast<int>(total));
  return cudaGetLastError();
}

// Labels of a batch of bool grids [batch, g, g, g]: the slab entry at gx = g.
extern "C" int k2_ccl_labels(const void* occ, void* labels, int batch, int g, void* stream) {
  return k2_ccl_labels_slab(occ, labels, batch, g, g, stream);
}

// Up to 16 sweeps of K2-wide from buffer a (parity 0) or b (parity 1); sweep
// s writes the other buffer. running/sweeps (i32[batch]) carry the fixpoint
// state between calls; flags is i32[17 * batch] scratch.
extern "C" int k2_ccl_wide(const void* occ, void* labels_a, void* labels_b, void* flags,
                           void* running, void* sweeps, int batch, int g, int parity,
                           int n_sweeps, void* stream) {
  const long long total = static_cast<long long>(batch) * g * g * g;
  if (batch <= 0 || g <= 0 || n_sweeps <= 0 || n_sweeps > kGroup || total >= (1LL << 31))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* f = static_cast<int32_t*>(flags);
  int32_t* bufs[2] = {static_cast<int32_t*>(labels_a), static_cast<int32_t*>(labels_b)};
  const int fb = ((kGroup + 1) * batch + 255) / 256;
  k2_wide_start<<<fb, 256, 0, st>>>(static_cast<const int32_t*>(running), f, batch);
  const int blocks = static_cast<int>(std::min<long long>((total + kWideThreads - 1) / kWideThreads,
                                                          132LL * 16));
  for (int s = 0; s < n_sweeps; ++s) {
    const int from = (parity + s) & 1;
    k2_wide_sweep<<<blocks, kWideThreads, 0, st>>>(static_cast<const uint8_t*>(occ), bufs[from],
                                                   bufs[from ^ 1], f, batch, g, s);
  }
  k2_wide_finish<<<(batch + 255) / 256, 256, 0, st>>>(f, static_cast<int32_t*>(running),
                                                      static_cast<int32_t*>(sweeps), batch,
                                                      n_sweeps);
  return cudaGetLastError();
}

extern "C" int k2_ccl_sweeps(const void* occ, const void* labels_in, void* labels_out,
                             void* sweeps_out, int batch, int g, int max_sweeps,
                             void* stream) {
  const int n = g * g * g;
  if (batch <= 0 || g <= 0 || n > 65535 || max_sweeps < 0) return cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(uint16_t) * n + sizeof(uint32_t) * ((n + 31) / 32);
  cudaError_t err = cudaFuncSetAttribute(k2_ccl_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  k2_ccl_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(occ), static_cast<const int32_t*>(labels_in),
      static_cast<int32_t*>(labels_out), static_cast<int32_t*>(sweeps_out), g, max_sweeps);
  return cudaGetLastError();
}
