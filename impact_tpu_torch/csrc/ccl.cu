// K2: connected-component min-label propagation, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel impact_tpu/ops/ccl_pallas.py:_ccl_kernel
// (ccl_propagate_sweeps -> pl.pallas_call), which runs n_sweeps sweeps over
// one VMEM-resident [G,G,G] i32 label grid, and its host fixpoint loop
// (connected_component_labels_pallas: one kernel call per 16 sweeps until
// nothing changes). It computes, for each grid of a batch, up to max_sweeps
// Jacobi sweeps of
//     new[v] = occ[v] ? min(lab[v], lab[six face neighbours]) : big
// with big = G^3 past the border, stopping a grid after the first sweep that
// changes nothing. Labels converge to the minimum linear index of each
// 6-connected component. (The Pallas kernel composes its three axis passes
// through the intermediate minimum, which also joins voxels that touch only
// along an edge or corner; this kernel keeps the 6-connected sweep of the
// reference's XLA path, whose fixpoint the engine's split detection means.)
//
// Design (first, simple version): one 1024-thread block owns one grid;
// gridDim.x counts the grids. The labels stay in shared memory for every
// sweep as two u16 buffers (G^3 <= 65535, big included: 2 x 64 KB at G = 32)
// plus a G^3-bit occupancy mask (4 KB), 132 KB of dynamic shared memory in
// all, above the 48 KB default and so opted into with
// cudaFuncSetAttribute. Each sweep reads one buffer and writes the other,
// and ends in __syncthreads_or(changed), which is both the barrier between
// sweeps and the fixpoint test: the loop that the TPU ran from the host, one
// launch and one device-to-host read of "changed" per 16 sweeps, runs on the
// card in one launch.
//
// Bound on the H100 (3.35 TB/s HBM, 67 T/s non-tensor operations), as
// ops/ccl_pallas.py:bound_ms counts it from each call's data: bytes = 1 B of
// occupancy + 4 B of labels in + 4 B out per voxel; operations = 8 per voxel
// and sweep actually run. The work is operation-bound for any fixpoint that
// needs more than a sweep or two. This design is far from that bound: one
// block per grid uses as many SMs as there are grids (4 of 132 for the
// split candidates of one engine step), and every sweep re-reads seven u16
// per voxel from shared memory with one voxel per thread per pass.
// Bit-packed occupancy with warp-wide propagation, or union-find in place of
// sweeps, is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

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
