// Dependent-operation latencies on Hopper (sm_90a), for the chain bound of
// the scan kernels (physics/scan_solver.py:OP_LATENCY_CYCLES).
//
// One thread runs n x 32 operations of one kind, each reading the result of
// the one before, between two clock64() reads. Each operation is inline PTX
// that the compiler keeps as written and in order:
//   0 add.rn.f32   x = x + y
//   1 mul.rn.f32   x = x * y
//   2 clamp        x = x < y ? y : x (setp.lt, selp: csrc/scan_solver.cu's clamp_min)
//   3 select       x = flag ? x : y (selp on a predicate that x does not feed)
//   4 sqrt.rn.f32  x = sqrt(x)
//   5 div.rn.f32   x = y / x (through the divisor, as the kernels' divisions)
// Run by devtools/probe_scan_walk.py, which takes the difference of two
// lengths so that the clock reads and the launch drop out.

#include <cuda_runtime.h>

namespace {

template <int KIND>
__device__ __forceinline__ void op(float& x, float y, int flag) {
  if (KIND == 0) {
    asm volatile("add.rn.f32 %0, %0, %1;" : "+f"(x) : "f"(y));
  } else if (KIND == 1) {
    asm volatile("mul.rn.f32 %0, %0, %1;" : "+f"(x) : "f"(y));
  } else if (KIND == 2) {
    asm volatile("{ .reg .pred p; setp.lt.f32 p, %0, %1; selp.f32 %0, %1, %0, p; }"
                 : "+f"(x) : "f"(y));
  } else if (KIND == 3) {
    asm volatile("{ .reg .pred p; setp.ne.s32 p, %2, 0; selp.f32 %0, %0, %1, p; }"
                 : "+f"(x) : "f"(y), "r"(flag));
  } else if (KIND == 4) {
    asm volatile("sqrt.rn.f32 %0, %0;" : "+f"(x));
  } else {
    asm volatile("div.rn.f32 %0, %1, %0;" : "+f"(x) : "f"(y));
  }
}

template <int KIND>
__global__ void op_chain_kernel(const float* in, float* out, long long* cycles, int n) {
  float x = in[0];
  const float y = in[1];
  const int flag = in[2] != 0.0f;
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int k = 0; k < 32; ++k) op<KIND>(x, y, flag);
  }
  const long long t1 = clock64();
  out[0] = x;
  cycles[0] = t1 - t0;
}

}  // namespace

// in: x, y, flag (float32 [3]); out: x after the chain; cycles: int64 [1].
extern "C" int scan_op_latency(int kind, const void* in, void* out, void* cycles, int n,
                               void* stream) {
  const float* i = static_cast<const float*>(in);
  float* o = static_cast<float*>(out);
  long long* c = static_cast<long long*>(cycles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: op_chain_kernel<0><<<1, 1, 0, s>>>(i, o, c, n); break;
    case 1: op_chain_kernel<1><<<1, 1, 0, s>>>(i, o, c, n); break;
    case 2: op_chain_kernel<2><<<1, 1, 0, s>>>(i, o, c, n); break;
    case 3: op_chain_kernel<3><<<1, 1, 0, s>>>(i, o, c, n); break;
    case 4: op_chain_kernel<4><<<1, 1, 0, s>>>(i, o, c, n); break;
    case 5: op_chain_kernel<5><<<1, 1, 0, s>>>(i, o, c, n); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
