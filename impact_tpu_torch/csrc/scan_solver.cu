// The sequential (Gauss-Seidel) contact solve, hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference solves in this order with two
// lax.scans over the contact slots (impact_tpu/physics/solver.py:258-298,
// one_contact inside n_iterations velocity sweeps, and :415-448,
// one_correction inside n_positional_correction_iterations sweeps). On the
// card an eager loop would cost ~30 launches per slot and sweep; here each
// of the two loops is one launch:
//
//   scan_velocity_iterations   all velocity sweeps over the C slots: per
//                              slot the relative velocity at the contact,
//                              three impulse rows, the Coulomb clamp of the
//                              accumulated impulse, and the change scattered
//                              into v and w of bodies a and b;
//   scan_position_correction   all pseudo-impulse sweeps: per slot the
//                              separation along the normal from the current
//                              poses, the effective mass, and the correction
//                              applied to position and orientation of a and
//                              b (the orientations renormalized).
//
// Every slot is walked, inactive ones included: an inactive slot changes no
// velocity, but its correction still renormalizes ori[a] and ori[b]
// (quaternion integrate with a zero rate), as the reference's does.
//
// Design. One block; a slot's update reads what the previous slot wrote,
// so one thread walks the slots in slot order and the block's other
// threads only stage data in and out. Bodies (v, w or pos, ori, inverse
// mass, world inverse inertia) and, where they fit beside them, the
// contacts live in dynamic shared memory for the whole walk; past the
// 232,448 bytes a block can hold, the walk reads and writes global memory
// in the same kernel. Every float operation is written as a rounded
// intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn) in
// the reference's order (dot = (x0*y0 + x1*y1) + x2*y2, rows of I @ x the
// same, cross componentwise as a mul, a mul and a sub), so nothing is
// contracted into an FMA and the plain version
// (physics/scan_solver.py:scan_iterations_plain), whose elementwise torch
// ops round each operation, gives the same bits.
//
// Bound on the H100 (physics/scan_solver.py:bound_ms): the prepared
// contacts and the bodies read once and written once, bytes-bound at a few
// hundredths of a microsecond. The walk is a dependency chain instead: each
// slot waits on the previous slot's stores (~0.1-0.3 us of dependent
// arithmetic and shared-memory latency), so the time is about
// C x (iterations + correction sweeps) x that latency, not bytes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxShared = 232448;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ V3 ld3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ void st3(float* p, V3 a) {
  p[0] = a.x;
  p[1] = a.y;
  p[2] = a.z;
}
__device__ __forceinline__ V3 vadd(V3 a, V3 b) { return {add(a.x, b.x), add(a.y, b.y), add(a.z, b.z)}; }
__device__ __forceinline__ V3 vsub(V3 a, V3 b) { return {sub(a.x, b.x), sub(a.y, b.y), sub(a.z, b.z)}; }
__device__ __forceinline__ V3 vscale(float s, V3 a) { return {mul(s, a.x), mul(s, a.y), mul(s, a.z)}; }
__device__ __forceinline__ V3 vneg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {sub(mul(a.y, b.z), mul(a.z, b.y)), sub(mul(a.z, b.x), mul(a.x, b.z)),
          sub(mul(a.x, b.y), mul(a.y, b.x))};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return add(add(mul(a.x, b.x), mul(a.y, b.y)), mul(a.z, b.z));
}
__device__ __forceinline__ V3 matvec(const float* m, V3 x) {
  return {dot(ld3(m), x), dot(ld3(m + 3), x), dot(ld3(m + 6), x)};
}
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// v + w*t + u x t with t = 2 (u x v), u = q.xyz, w = q.w (math/quaternion.py:rotate)
__device__ __forceinline__ V3 rotate(const float* q, V3 v) {
  const V3 u = ld3(q);
  const float w = q[3];
  const V3 t = vscale(2.0f, cross(u, v));
  return vadd(vadd(v, vscale(w, t)), cross(u, t));
}

// normalize(q + 1 * (0.5 * (omega, 0) (x) q)) (math/quaternion.py:integrate_angular_velocity)
__device__ __forceinline__ void integrate(float* q, V3 om) {
  const float x1 = om.x, y1 = om.y, z1 = om.z, w1 = 0.0f;
  const float x2 = q[0], y2 = q[1], z2 = q[2], w2 = q[3];
  const float mx = sub(add(add(mul(w1, x2), mul(x1, w2)), mul(y1, z2)), mul(z1, y2));
  const float my = add(add(sub(mul(w1, y2), mul(x1, z2)), mul(y1, w2)), mul(z1, x2));
  const float mz = add(sub(add(mul(w1, z2), mul(x1, y2)), mul(y1, x2)), mul(z1, w2));
  const float mw = sub(sub(sub(mul(w1, w2), mul(x1, x2)), mul(y1, y2)), mul(z1, z2));
  const float nx = add(x2, mul(1.0f, mul(0.5f, mx)));
  const float ny = add(y2, mul(1.0f, mul(0.5f, my)));
  const float nz = add(z2, mul(1.0f, mul(0.5f, mz)));
  const float nw = add(w2, mul(1.0f, mul(0.5f, mw)));
  const float len = __fsqrt_rn(add(add(add(mul(nx, nx), mul(ny, ny)), mul(nz, nz)), mul(nw, nw)));
  const float d = clamp_min(len, 1e-12f);
  q[0] = __fdiv_rn(nx, d);
  q[1] = __fdiv_rn(ny, d);
  q[2] = __fdiv_rn(nz, d);
  q[3] = __fdiv_rn(nw, d);
}

// copy n floats (or ints) between two arrays with the whole block
template <typename T>
__device__ __forceinline__ void block_copy(T* dst, const T* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

struct VelocityArgs {
  float* v;
  float* w;
  const float* inv_mass;
  const float* inv_inertia;
  const int32_t* body_a;
  const int32_t* body_b;
  const float* active;
  const float* normal;
  const float* tangent;
  const float* bitangent;
  const float* disp_a;
  const float* disp_b;
  const float* eff_mass;
  const float* friction;
  const float* target;
  float* acc;
  int n_bodies, n_contacts, n_iterations;
  int bodies_shared, contacts_shared;
};

__global__ void __launch_bounds__(kThreads) scan_velocity_kernel(VelocityArgs g) {
  extern __shared__ float smem[];
  const int n = g.n_bodies, c_n = g.n_contacts;
  float *v = g.v, *w = g.w, *acc = g.acc;
  const float *im = g.inv_mass, *inv_i = g.inv_inertia;
  const int32_t *ba = g.body_a, *bb = g.body_b;
  const float *act = g.active, *nrm = g.normal, *tan1 = g.tangent, *tan2 = g.bitangent;
  const float *dsa = g.disp_a, *dsb = g.disp_b, *em = g.eff_mass, *fr = g.friction,
              *tsv = g.target;
  float* next = smem;
  if (g.bodies_shared) {
    float* sv = next;
    float* sw = sv + 3 * n;
    float* sim = sw + 3 * n;
    float* si = sim + n;
    next = si + 9 * n;
    block_copy(sv, v, 3 * n);
    block_copy(sw, w, 3 * n);
    block_copy(sim, im, n);
    block_copy(si, inv_i, 9 * n);
    v = sv, w = sw, im = sim, inv_i = si;
  }
  if (g.contacts_shared) {
    int32_t* sa = reinterpret_cast<int32_t*>(next);
    int32_t* sb = sa + c_n;
    float* f = reinterpret_cast<float*>(sb + c_n);
    block_copy(sa, ba, c_n);
    block_copy(sb, bb, c_n);
    float* s_act = f;
    float* s_fr = s_act + c_n;
    float* s_tsv = s_fr + c_n;
    float* s_n = s_tsv + c_n;
    float* s_t1 = s_n + 3 * c_n;
    float* s_t2 = s_t1 + 3 * c_n;
    float* s_da = s_t2 + 3 * c_n;
    float* s_db = s_da + 3 * c_n;
    float* s_em = s_db + 3 * c_n;
    float* s_acc = s_em + 3 * c_n;
    block_copy(s_act, act, c_n);
    block_copy(s_fr, fr, c_n);
    block_copy(s_tsv, tsv, c_n);
    block_copy(s_n, nrm, 3 * c_n);
    block_copy(s_t1, tan1, 3 * c_n);
    block_copy(s_t2, tan2, 3 * c_n);
    block_copy(s_da, dsa, 3 * c_n);
    block_copy(s_db, dsb, 3 * c_n);
    block_copy(s_em, em, 3 * c_n);
    block_copy(s_acc, acc, 3 * c_n);
    ba = sa, bb = sb, act = s_act, fr = s_fr, tsv = s_tsv, nrm = s_n, tan1 = s_t1,
    tan2 = s_t2, dsa = s_da, dsb = s_db, em = s_em, acc = s_acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int it = 0; it < g.n_iterations; ++it) {
      for (int c = 0; c < c_n; ++c) {
        const int a = ba[c], b = bb[c];
        const float on = act[c];
        const V3 nn = ld3(nrm + 3 * c), t1 = ld3(tan1 + 3 * c), t2 = ld3(tan2 + 3 * c);
        const V3 da = ld3(dsa + 3 * c), db = ld3(dsb + 3 * c), e = ld3(em + 3 * c);
        const V3 old = ld3(acc + 3 * c);
        const V3 va = ld3(v + 3 * a), wa = ld3(w + 3 * a);
        const V3 vb = ld3(v + 3 * b), wb = ld3(w + 3 * b);
        const V3 rel = vsub(vadd(va, cross(wa, da)), vadd(vb, cross(wb, db)));
        const float s0 = add(old.x, mul(-e.x, sub(dot(nn, rel), tsv[c])));
        const float s1 = add(old.y, mul(-e.y, dot(t1, rel)));
        const float s2 = add(old.z, mul(-e.z, dot(t2, rel)));
        // Coulomb clamp (solver.py:_clamp_impulses): max(t_mag, 1e-12) and a select
        const float n0 = clamp_min(s0, 0.0f);
        const float max_t = mul(fr[c], n0);
        const float t_mag = __fsqrt_rn(add(mul(s1, s1), mul(s2, s2)));
        const float scale = t_mag > max_t ? __fdiv_rn(max_t, clamp_min(t_mag, 1e-12f)) : 1.0f;
        const V3 fresh = {n0, mul(s1, scale), mul(s2, scale)};
        const float d0 = mul(sub(fresh.x, old.x), on);
        const float d1 = mul(sub(fresh.y, old.y), on);
        const float d2 = mul(sub(fresh.z, old.z), on);
        const V3 dp = {add(add(mul(d0, nn.x), mul(d1, t1.x)), mul(d2, t2.x)),
                       add(add(mul(d0, nn.y), mul(d1, t1.y)), mul(d2, t2.y)),
                       add(add(mul(d0, nn.z), mul(d1, t1.z)), mul(d2, t2.z))};
        st3(v + 3 * a, vadd(va, vscale(im[a], dp)));
        st3(v + 3 * b, vadd(ld3(v + 3 * b), vscale(-im[b], dp)));
        st3(w + 3 * a, vadd(wa, matvec(inv_i + 9 * a, cross(da, dp))));
        st3(w + 3 * b, vadd(ld3(w + 3 * b), vneg(matvec(inv_i + 9 * b, cross(db, dp)))));
        if (on != 0.0f) st3(acc + 3 * c, fresh);
      }
    }
  }
  __syncthreads();
  if (g.bodies_shared) {
    block_copy(g.v, v, 3 * n);
    block_copy(g.w, w, 3 * n);
  }
  if (g.contacts_shared) block_copy(g.acc, acc, 3 * c_n);
}

struct CorrectionArgs {
  float* pos;
  float* ori;
  const float* inv_mass;
  const float* inv_inertia;
  const int32_t* body_a;
  const int32_t* body_b;
  const float* active;
  const float* normal;
  const float* local_a;
  const float* local_b;
  float factor;
  int n_bodies, n_contacts, n_iterations;
  int bodies_shared, contacts_shared;
};

__global__ void __launch_bounds__(kThreads) scan_correction_kernel(CorrectionArgs g) {
  extern __shared__ float smem[];
  const int n = g.n_bodies, c_n = g.n_contacts;
  float *pos = g.pos, *ori = g.ori;
  const float *im = g.inv_mass, *inv_i = g.inv_inertia;
  const int32_t *ba = g.body_a, *bb = g.body_b;
  const float *act = g.active, *nrm = g.normal, *la_p = g.local_a, *lb_p = g.local_b;
  float* next = smem;
  if (g.bodies_shared) {
    float* sp = next;
    float* so = sp + 3 * n;
    float* sim = so + 4 * n;
    float* si = sim + n;
    next = si + 9 * n;
    block_copy(sp, pos, 3 * n);
    block_copy(so, ori, 4 * n);
    block_copy(sim, im, n);
    block_copy(si, inv_i, 9 * n);
    pos = sp, ori = so, im = sim, inv_i = si;
  }
  if (g.contacts_shared) {
    int32_t* sa = reinterpret_cast<int32_t*>(next);
    int32_t* sb = sa + c_n;
    float* s_act = reinterpret_cast<float*>(sb + c_n);
    float* s_n = s_act + c_n;
    float* s_la = s_n + 3 * c_n;
    float* s_lb = s_la + 3 * c_n;
    block_copy(sa, ba, c_n);
    block_copy(sb, bb, c_n);
    block_copy(s_act, act, c_n);
    block_copy(s_n, nrm, 3 * c_n);
    block_copy(s_la, la_p, 3 * c_n);
    block_copy(s_lb, lb_p, 3 * c_n);
    ba = sa, bb = sb, act = s_act, nrm = s_n, la_p = s_la, lb_p = s_lb;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int it = 0; it < g.n_iterations; ++it) {
      for (int c = 0; c < c_n; ++c) {
        const int a = ba[c], b = bb[c];
        const V3 nn = ld3(nrm + 3 * c);
        const V3 xa = ld3(pos + 3 * a), xb = ld3(pos + 3 * b);
        const V3 pa = vadd(xa, rotate(ori + 4 * a, ld3(la_p + 3 * c)));
        const V3 pb = vadd(xb, rotate(ori + 4 * b, ld3(lb_p + 3 * c)));
        const float depth = dot(nn, vsub(pb, pa));
        const V3 da = vsub(pb, xa), db = vsub(pb, xb);
        // effective mass along the normal (solver.py:_effective_mass) with the
        // inverse inertia from before the correction
        const float ima = im[a], imb = im[b];
        const V3 ca = cross(da, nn), cb = cross(db, nn);
        const float denom = add(add(add(ima, imb), dot(ca, matvec(inv_i + 9 * a, ca))),
                                dot(cb, matvec(inv_i + 9 * b, cb)));
        const float e = __fdiv_rn(1.0f, clamp_min(denom, 1e-12f));
        const float do_it = mul(act[c], depth > 0.0f ? 1.0f : 0.0f);
        const float pseudo = mul(mul(mul(e, g.factor), depth), do_it);
        const V3 dp = vscale(pseudo, nn);
        st3(pos + 3 * a, vadd(xa, vscale(ima, dp)));
        st3(pos + 3 * b, vadd(ld3(pos + 3 * b), vscale(-imb, dp)));
        const V3 dwa = matvec(inv_i + 9 * a, cross(da, dp));
        const V3 dwb = vneg(matvec(inv_i + 9 * b, cross(db, dp)));
        integrate(ori + 4 * a, dwa);
        integrate(ori + 4 * b, dwb);
      }
    }
  }
  __syncthreads();
  if (g.bodies_shared) {
    block_copy(g.pos, pos, 3 * n);
    block_copy(g.ori, ori, 4 * n);
  }
}

// Which parts go to shared memory: the bodies first, then the contacts
// beside them; returns the bytes.
size_t plan(size_t body_bytes, size_t contact_bytes, int* bodies_shared, int* contacts_shared) {
  *bodies_shared = body_bytes <= kMaxShared;
  *contacts_shared = *bodies_shared && body_bytes + contact_bytes <= kMaxShared;
  return (*bodies_shared ? body_bytes : 0) + (*contacts_shared ? contact_bytes : 0);
}

template <typename K, typename A>
int launch(K kernel, const A& args, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args);
  return cudaGetLastError();
}

}  // namespace

extern "C" int scan_velocity_iterations(void* v, void* w, const void* inv_mass,
                                        const void* inv_inertia, const void* body_a,
                                        const void* body_b, const void* active,
                                        const void* normal, const void* tangent,
                                        const void* bitangent, const void* disp_a,
                                        const void* disp_b, const void* eff_mass,
                                        const void* friction, const void* target, void* acc,
                                        int n_bodies, int n_contacts, int n_iterations,
                                        void* stream) {
  if (n_bodies <= 0 || n_contacts < 0 || n_iterations < 0) return cudaErrorInvalidValue;
  VelocityArgs g{static_cast<float*>(v), static_cast<float*>(w),
                 static_cast<const float*>(inv_mass), static_cast<const float*>(inv_inertia),
                 static_cast<const int32_t*>(body_a), static_cast<const int32_t*>(body_b),
                 static_cast<const float*>(active), static_cast<const float*>(normal),
                 static_cast<const float*>(tangent), static_cast<const float*>(bitangent),
                 static_cast<const float*>(disp_a), static_cast<const float*>(disp_b),
                 static_cast<const float*>(eff_mass), static_cast<const float*>(friction),
                 static_cast<const float*>(target), static_cast<float*>(acc),
                 n_bodies, n_contacts, n_iterations, 0, 0};
  const size_t smem = plan(sizeof(float) * 16 * static_cast<size_t>(n_bodies),
                           sizeof(float) * 26 * static_cast<size_t>(n_contacts),
                           &g.bodies_shared, &g.contacts_shared);
  return launch(scan_velocity_kernel, g, smem, stream);
}

extern "C" int scan_position_correction(void* pos, void* ori, const void* inv_mass,
                                        const void* inv_inertia, const void* body_a,
                                        const void* body_b, const void* active,
                                        const void* normal, const void* local_a,
                                        const void* local_b, float factor, int n_bodies,
                                        int n_contacts, int n_iterations, void* stream) {
  if (n_bodies <= 0 || n_contacts < 0 || n_iterations < 0) return cudaErrorInvalidValue;
  CorrectionArgs g{static_cast<float*>(pos), static_cast<float*>(ori),
                   static_cast<const float*>(inv_mass), static_cast<const float*>(inv_inertia),
                   static_cast<const int32_t*>(body_a), static_cast<const int32_t*>(body_b),
                   static_cast<const float*>(active), static_cast<const float*>(normal),
                   static_cast<const float*>(local_a), static_cast<const float*>(local_b),
                   factor, n_bodies, n_contacts, n_iterations, 0, 0};
  const size_t smem = plan(sizeof(float) * 17 * static_cast<size_t>(n_bodies),
                           sizeof(float) * 12 * static_cast<size_t>(n_contacts),
                           &g.bodies_shared, &g.contacts_shared);
  return launch(scan_correction_kernel, g, smem, stream);
}
