// The sequential (Gauss-Seidel) contact solve, hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference solves in this order with two
// lax.scans over the contact slots (impact_tpu/physics/solver.py:258-298,
// one_contact inside n_iterations velocity sweeps, and :415-448,
// one_correction inside n_positional_correction_iterations sweeps). Each
// of the two loops is one launch of one block:
//
//   scan_velocity_iterations   all velocity sweeps: per slot the relative
//                              velocity at the contact, three impulse rows,
//                              the Coulomb clamp of the accumulated impulse,
//                              and the change scattered into v and w of
//                              bodies a and b;
//   scan_position_correction   all pseudo-impulse sweeps: per slot the
//                              separation along the normal from the current
//                              poses, the effective mass, and the correction
//                              applied to position and orientation of a and
//                              b (the orientations renormalized).
//
// Design. Each kernel stages the bodies, then its schedule, then the
// contacts into dynamic shared memory while they fit (past the 232,448
// bytes a block can hold, a part stays in global memory; within one block
// __syncthreads orders global stores too), and builds the schedule of one
// sweep with the whole block:
//   fixed bodies   zero inverse mass and all-zero world inverse inertia;
//                  for the correction also a finite orientation that a
//                  zero-rate integration leaves bitwise as it is (the
//                  ground plane's body at identity);
//   nodes          velocity: the active slots; correction: the active slots
//                  and the runs, each a maximal stretch of consecutive
//                  inactive slots on one (a, b) pair (the compacted tail is
//                  one run on (0, 0)); compacted with a block prefix sum;
//   levels         one thread walks the nodes in slot order: level = 1 +
//                  the largest level of an earlier node on body a or b,
//                  fixed bodies not counted (a run whose two bodies are
//                  fixed gets none); a counting sort buckets them.
// Each sweep then runs level by level, a level's nodes in parallel, a
// barrier after each level. While the nodes fit the block, thread t owns
// the node at position t of the level order for the whole kernel and keeps
// its slot's data (and impulse) in registers, so a level costs one round
// trip to the bodies' state and one slot's arithmetic; past the block,
// threads loop over a level's nodes, loading each. A slot keeps its
// bodies' state in registers from its loads to its stores and never
// stores to a fixed body. A run applies the
// renormalization to ori[a] and ori[b] up to k times each (2k when a = b),
// stopping once a step changes nothing. Every float operation is a
// rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn) in the reference's order (dot = (x0*y0 + x1*y1) + x2*y2,
// rows of I @ x the same, cross componentwise as a mul, a mul and a sub),
// so nothing is contracted into an FMA and the plain version
// (physics/scan_solver.py:scan_iterations_plain) gives the same numbers.
//
// Why the schedule is exact. A slot reads and writes only bodies a and b
// (and its own impulse), so a body that sees the same slots in the same
// order on the same values ends with the same bits; the levels keep each
// body's slots in slot order. The rest rests on finite values, where
// x * 0 is ±0 and y + ±0 is y up to the sign of a zero, which == (and
// torch.equal) does not see. An inactive velocity slot adds (fresh - old)
// * 0 = ±0 and stores no impulse: skipped. An inactive correction slot
// adds a ±0 pseudo-impulse, so it only renormalizes ori[a] and ori[b]
// (q -> q / max(|q|, 1e-12)), which depends on q's values alone: a run
// repeats that map, and once it maps q onto q's values it always will. A
// fixed body receives only im * dp = ±0 and I @ x = ±0 (the velocity sweep
// reads no orientation) and, in the correction, a renormalization that
// keeps it: never stored, so not a dependency, and slots on the ground do
// not chain through it. Where a value is not finite the argument fails,
// so the kernel checks: if any input is not finite, if the scheduled walk
// ends with a state that is not (a non-finite body state stays so under
// every later update), or if a change it skipped on a fixed body is not
// ±0, it stages the inputs again and one thread walks every slot in slot
// order, storing everything, as the plain loop does. Left outside: an
// inactive slot whose
// own arithmetic overflows from finite values (the plain loop then writes
// NaN, this walk does not); compaction's padding cannot, its a = b and
// equal contact points make that arithmetic exactly zero.
//
// Bound on the H100 (physics/scan_solver.py): bytes, a few hundredths of
// a microsecond (bound_ms); the dependency chain (chain_bound_ms), sweeps
// x levels x the longest dependent path of one slot's own arithmetic at
// the latencies devtools/probe_scan_walk.py measures on the card, which
// is what bounds it now. Staging, the schedule's build, the shared-memory
// round trip of a body's state and the barrier of a level are this
// design's, not the function's, and lie outside that bound.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// a block's shared memory less the kernels' static shared bytes
constexpr size_t kMaxShared = 232448 - 256;

struct V3 {
  float x, y, z;
};
struct Q4 {
  float x, y, z, w;
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
__device__ __forceinline__ Q4 ld4(const float* p) { return {p[0], p[1], p[2], p[3]}; }
__device__ __forceinline__ void st4(float* p, Q4 q) {
  p[0] = q.x;
  p[1] = q.y;
  p[2] = q.z;
  p[3] = q.w;
}
__device__ __forceinline__ bool fin(V3 a) { return isfinite(a.x) && isfinite(a.y) && isfinite(a.z); }
__device__ __forceinline__ bool fin(Q4 q) {
  return isfinite(q.x) && isfinite(q.y) && isfinite(q.z) && isfinite(q.w);
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
__device__ __forceinline__ V3 rotate(Q4 q, V3 v) {
  const V3 u = {q.x, q.y, q.z};
  const V3 t = vscale(2.0f, cross(u, v));
  return vadd(vadd(v, vscale(q.w, t)), cross(u, t));
}

// normalize(q + 1 * (0.5 * (omega, 0) (x) q)) (math/quaternion.py:integrate_angular_velocity)
__device__ __forceinline__ Q4 integrate(Q4 q, V3 om) {
  const float x1 = om.x, y1 = om.y, z1 = om.z, w1 = 0.0f;
  const float x2 = q.x, y2 = q.y, z2 = q.z, w2 = q.w;
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
  return {__fdiv_rn(nx, d), __fdiv_rn(ny, d), __fdiv_rn(nz, d), __fdiv_rn(nw, d)};
}

__device__ __forceinline__ bool same_bits(Q4 a, Q4 b) {
  return __float_as_uint(a.x) == __float_as_uint(b.x) &&
         __float_as_uint(a.y) == __float_as_uint(b.y) &&
         __float_as_uint(a.z) == __float_as_uint(b.z) &&
         __float_as_uint(a.w) == __float_as_uint(b.w);
}

// Zero inverse mass and inertia (velocity: ori null), and for the
// correction an orientation the zero-rate step keeps bitwise: no slot can
// change the body (physics/scan_solver.py:fixed_bodies).
__device__ bool body_fixed(float im, const float* inv_i, const float* ori) {
  bool zero = im == 0.0f;
  for (int k = 0; k < 9; ++k) zero = zero && inv_i[k] == 0.0f;
  if (!zero || ori == nullptr) return zero;
  const Q4 q = ld4(ori);
  return fin(q) && same_bits(integrate(q, {0.0f, 0.0f, 0.0f}), q);
}

// Apply the zero-rate step to q up to n times, stopping once it maps q
// onto q's values.
__device__ void renormalize(float* p, int n) {
  Q4 q = ld4(p);
  for (int k = 0; k < n; ++k) {
    const Q4 r = integrate(q, {0.0f, 0.0f, 0.0f});
    if (r.x == q.x && r.y == q.y && r.z == q.z && r.w == q.w) break;
    q = r;
  }
  st4(p, q);
}

// copy n floats with the whole block; false where one is not finite
__device__ __forceinline__ bool stage(float* dst, const float* src, int n) {
  bool ok = true;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float x = src[i];
    ok = ok && isfinite(x);
    dst[i] = x;
  }
  return ok;
}

__device__ __forceinline__ bool all_finite(const float* p, int n) {
  bool ok = true;
  for (int i = threadIdx.x; i < n; i += blockDim.x) ok = ok && isfinite(p[i]);
  return ok;
}

__device__ __forceinline__ void stage_ids(int32_t* dst, const int32_t* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Stage count floats at next (and advance it) when shared, else leave p on
// global memory; false where one is not finite.
__device__ __forceinline__ bool take(const float*& p, float*& next, bool shared, int count) {
  if (!shared) return all_finite(p, count);
  float* dst = next;
  next += count;
  const bool ok = stage(dst, p, count);
  p = dst;
  return ok;
}

// Exclusive prefix sum over the block; *total gets the sum.
__device__ int block_exclusive_scan(int x, int* total) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
    for (int off = 1; off < kWarps; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += y;
    }
    if (lane < kWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int base = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kWarps - 1];
  __syncthreads();
  return base + incl - x;
}

// Scratch of one sweep's schedule (4C + 2 + 2N ints): node[C] the nodes'
// first slots in slot order, lvl[C] their levels, order[C] the nodes by
// level, cnt[C + 2] the level bounds (level L spans [cnt[L-1], cnt[L])),
// last[N] the last level on each body, fixed[N].
struct Schedule {
  int *node, *lvl, *order, *cnt, *last, *fixed;
  int n_nodes, depth;
};

__device__ __forceinline__ Schedule carve(int* p, int c_n, int n) {
  Schedule s;
  s.node = p;
  s.lvl = s.node + c_n;
  s.order = s.lvl + c_n;
  s.cnt = s.order + c_n;
  s.last = s.cnt + c_n + 2;
  s.fixed = s.last + n;
  s.n_nodes = s.depth = 0;
  return s;
}

// Build the schedule with the whole block. Velocity (runs = false, ori
// null): a node per active slot. Correction (runs = true): a node per
// active slot and per run of inactive slots on one pair; a run on two fixed
// bodies gets level 0. order[] holds node indices.
__device__ void build_schedule(Schedule& s, bool runs, const int32_t* ba, const int32_t* bb,
                               const float* act, int c_n, int n, const float* im,
                               const float* inv_i, const float* ori) {
  __shared__ int n_nodes, depth;
  for (int b = threadIdx.x; b < n; b += blockDim.x) {
    s.fixed[b] = body_fixed(im[b], inv_i + 9 * b, ori ? ori + 4 * b : nullptr);
    s.last[b] = 0;
  }
  auto is_node = [&](int c) {
    return act[c] != 0.0f ||
           (runs && (c == 0 || act[c - 1] != 0.0f || ba[c] != ba[c - 1] || bb[c] != bb[c - 1]));
  };
  const int per = (c_n + blockDim.x - 1) / blockDim.x;
  const int lo = min(c_n, static_cast<int>(threadIdx.x) * per), hi = min(c_n, lo + per);
  int mine = 0;
  for (int c = lo; c < hi; ++c) mine += is_node(c);
  int total;
  int at = block_exclusive_scan(mine, &total);
  for (int c = lo; c < hi; ++c)
    if (is_node(c)) s.node[at++] = c;
  for (int i = threadIdx.x; i < total + 2; i += blockDim.x) s.cnt[i] = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    int d = 0;
    for (int i = 0; i < total; ++i) {
      const int c = s.node[i], a = ba[c], b = bb[c];
      const int fa = s.fixed[a], fb = s.fixed[b];
      int lv = 0;
      if (!(runs && act[c] == 0.0f && fa && fb)) {
        lv = max(fa ? 0 : s.last[a], fb ? 0 : s.last[b]) + 1;
        if (!fa) s.last[a] = lv;
        if (!fb) s.last[b] = lv;
        ++s.cnt[lv];
        d = max(d, lv);
      }
      s.lvl[i] = lv;
    }
    for (int l = 1, start = 0; l <= d; ++l) {
      const int k = s.cnt[l];
      s.cnt[l] = start;
      start += k;
    }
    s.cnt[0] = 0;
    n_nodes = total;
    depth = d;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int lv = s.lvl[i];
    if (lv > 0) s.order[atomicAdd(&s.cnt[lv], 1)] = i;
  }
  s.n_nodes = n_nodes;
  s.depth = depth;
  __syncthreads();
}

// Run n_sweeps sweeps of the schedule, level by level, a barrier after
// each level; load(node) gives a node with its slot's data, apply(node)
// updates the bodies and returns false where it could not show its change
// exact. With at most one placed node a thread, each thread loads its node
// once and keeps it in registers across the sweeps; otherwise threads loop
// over a level's nodes, loading each.
template <typename Node, typename Load, typename Apply>
__device__ bool walk(const Schedule& s, int n_sweeps, Load load, Apply apply) {
  bool ok = true;
#ifdef SCAN_SERIAL_WALK
  // the ablation of devtools/probe_scan_walk.py: one thread walks the same
  // placed nodes in slot order, with no barrier
  if (threadIdx.x == 0)
    for (int it = 0; it < n_sweeps; ++it)
      for (int i = 0; i < s.n_nodes; ++i)
        if (s.lvl[i] > 0) {
          Node q = load(i);
          ok = apply(q) && ok;
        }
#else
  const int placed = s.depth > 0 ? s.cnt[s.depth] : 0, t = threadIdx.x;
  if (placed <= static_cast<int>(blockDim.x)) {
    int mine = 0;  // this thread's level
    Node q;
    if (t < placed) {
      int lo = 1, hi = s.depth;
      while (lo < hi) {
        const int mid = (lo + hi) / 2;
        if (t < s.cnt[mid]) hi = mid;
        else lo = mid + 1;
      }
      mine = lo;
      q = load(s.order[t]);
    }
    for (int it = 0; it < n_sweeps; ++it) {
      for (int l = 1; l <= s.depth; ++l) {
        if (l == mine) ok = apply(q) && ok;
        __syncthreads();
      }
    }
  } else {
    for (int it = 0; it < n_sweeps; ++it) {
      for (int l = 1; l <= s.depth; ++l) {
        for (int i = s.cnt[l - 1] + t; i < s.cnt[l]; i += blockDim.x) {
          Node q = load(s.order[i]);
          ok = apply(q) && ok;
        }
        __syncthreads();
      }
    }
  }
#endif
  return ok;
}

// ---- velocity ----

struct VelocityArgs {
  const float* v_in;
  const float* w_in;
  const float* acc_in;
  float* v;
  float* w;
  float* acc;
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
  int32_t* sched;
  int32_t* scratch;
  int n_bodies, n_contacts, n_iterations;
  int bodies_shared, sched_shared, contacts_shared;
};

// where the walk reads and writes (shared memory or global)
struct VelocityData {
  float *v, *w, *acc;
  const float *im, *inv_i;
  const int32_t *ba, *bb;
  const float *act, *nrm, *tan1, *tan2, *dsa, *dsb, *em, *fr, *tsv;
};

// one slot's data; fa, fb: its bodies are fixed (never stored)
struct VelocitySlot {
  int c, a, b;
  bool fa, fb;
  float on, tsv, fr;
  V3 nn, t1, t2, da, db, e, old;
};

__device__ __forceinline__ VelocitySlot velocity_load(const VelocityData& k, const int* fixed,
                                                      int c) {
  VelocitySlot q;
  q.c = c, q.a = k.ba[c], q.b = k.bb[c];
  q.fa = fixed && fixed[q.a], q.fb = fixed && fixed[q.b];
  q.on = k.act[c], q.tsv = k.tsv[c], q.fr = k.fr[c];
  q.nn = ld3(k.nrm + 3 * c), q.t1 = ld3(k.tan1 + 3 * c), q.t2 = ld3(k.tan2 + 3 * c);
  q.da = ld3(k.dsa + 3 * c), q.db = ld3(k.dsb + 3 * c), q.e = ld3(k.em + 3 * c);
  q.old = ld3(k.acc + 3 * c);
  return q;
}

// One slot's update; no store to a fixed body. False where the change it
// skips on a fixed body is not ±0 (dp or a lever arm's cross not finite).
__device__ __forceinline__ bool velocity_apply(const VelocityData& k, VelocitySlot& q) {
  const int a = q.a, b = q.b;
  const V3 va = ld3(k.v + 3 * a), wa = ld3(k.w + 3 * a);
  const V3 vb = ld3(k.v + 3 * b), wb = ld3(k.w + 3 * b);
  const V3 nn = q.nn, t1 = q.t1, t2 = q.t2, da = q.da, db = q.db, e = q.e, old = q.old;
  const V3 rel = vsub(vadd(va, cross(wa, da)), vadd(vb, cross(wb, db)));
  const float s0 = add(old.x, mul(-e.x, sub(dot(nn, rel), q.tsv)));
  const float s1 = add(old.y, mul(-e.y, dot(t1, rel)));
  const float s2 = add(old.z, mul(-e.z, dot(t2, rel)));
  // Coulomb clamp (solver.py:_clamp_impulses): max(t_mag, 1e-12) and a select
  const float n0 = clamp_min(s0, 0.0f);
  const float max_t = mul(q.fr, n0);
  const float t_mag = __fsqrt_rn(add(mul(s1, s1), mul(s2, s2)));
  const float scale = t_mag > max_t ? __fdiv_rn(max_t, clamp_min(t_mag, 1e-12f)) : 1.0f;
  const V3 fresh = {n0, mul(s1, scale), mul(s2, scale)};
  const float d0 = mul(sub(fresh.x, old.x), q.on);
  const float d1 = mul(sub(fresh.y, old.y), q.on);
  const float d2 = mul(sub(fresh.z, old.z), q.on);
  const V3 dp = {add(add(mul(d0, nn.x), mul(d1, t1.x)), mul(d2, t2.x)),
                 add(add(mul(d0, nn.y), mul(d1, t1.y)), mul(d2, t2.y)),
                 add(add(mul(d0, nn.z), mul(d1, t1.z)), mul(d2, t2.z))};
  const V3 ca = cross(da, dp), cb = cross(db, dp);
  const V3 va1 = vadd(va, vscale(k.im[a], dp));
  const V3 wa1 = vadd(wa, matvec(k.inv_i + 9 * a, ca));
  // a = b: b's update starts from a's
  const V3 vb1 = vadd(a == b ? va1 : vb, vscale(-k.im[b], dp));
  const V3 wb1 = vadd(a == b ? wa1 : wb, vneg(matvec(k.inv_i + 9 * b, cb)));
  if (!q.fa) {
    st3(k.v + 3 * a, va1);
    st3(k.w + 3 * a, wa1);
  }
  if (!q.fb) {
    st3(k.v + 3 * b, vb1);
    st3(k.w + 3 * b, wb1);
  }
  if (q.on != 0.0f) {
    st3(k.acc + 3 * q.c, fresh);
    q.old = fresh;
  }
  return !(q.fa || q.fb) || (fin(dp) && (!q.fa || fin(ca)) && (!q.fb || fin(cb)));
}

__global__ void __launch_bounds__(kThreads) scan_velocity_kernel(VelocityArgs g) {
  extern __shared__ float smem[];
  const int n = g.n_bodies, c_n = g.n_contacts;
  VelocityData k{g.v,         g.w,      g.acc,    g.inv_mass, g.inv_inertia, g.body_a,
                 g.body_b,    g.active, g.normal, g.tangent,  g.bitangent,   g.disp_a,
                 g.disp_b,    g.eff_mass, g.friction, g.target};
  float* next = smem;
  bool ok = take(k.im, next, g.bodies_shared, n);
  ok = take(k.inv_i, next, g.bodies_shared, 9 * n) && ok;
  if (g.bodies_shared) {
    k.v = next;
    k.w = next + 3 * n;
    next += 6 * n;
  }
  auto stage_state = [&]() {
    bool fine = stage(k.v, g.v_in, 3 * n);
    fine = stage(k.w, g.w_in, 3 * n) && fine;
    return stage(k.acc, g.acc_in, 3 * c_n) && fine;
  };
  Schedule s = carve(g.sched_shared ? reinterpret_cast<int*>(next) : g.scratch, c_n, n);
  if (g.sched_shared) next = reinterpret_cast<float*>(s.fixed + n);
  const bool cs = g.contacts_shared;
  if (cs) {
    int32_t* ids = reinterpret_cast<int32_t*>(next);
    stage_ids(ids, g.body_a, c_n);
    stage_ids(ids + c_n, g.body_b, c_n);
    k.ba = ids, k.bb = ids + c_n;
    next = reinterpret_cast<float*>(ids + 2 * c_n);
  }
  ok = take(k.act, next, cs, c_n) && ok;
  ok = take(k.fr, next, cs, c_n) && ok;
  ok = take(k.tsv, next, cs, c_n) && ok;
  ok = take(k.nrm, next, cs, 3 * c_n) && ok;
  ok = take(k.tan1, next, cs, 3 * c_n) && ok;
  ok = take(k.tan2, next, cs, 3 * c_n) && ok;
  ok = take(k.dsa, next, cs, 3 * c_n) && ok;
  ok = take(k.dsb, next, cs, 3 * c_n) && ok;
  ok = take(k.em, next, cs, 3 * c_n) && ok;
  if (cs) k.acc = next;
  ok = stage_state() && ok;
  __syncthreads();
  build_schedule(s, false, k.ba, k.bb, k.act, c_n, n, k.im, k.inv_i, nullptr);
  bool sequential = __syncthreads_or(!ok);
  if (!sequential) {
    ok = walk<VelocitySlot>(
        s, g.n_iterations, [&](int i) { return velocity_load(k, s.fixed, s.node[i]); },
        [&](VelocitySlot& q) { return velocity_apply(k, q); });
    // a non-finite body state stays non-finite under later updates
    ok = all_finite(k.v, 3 * n) && all_finite(k.w, 3 * n) && all_finite(k.acc, 3 * c_n) && ok;
    sequential = __syncthreads_or(!ok);
    if (sequential) {
      stage_state();
      __syncthreads();
    }
  }
  if (sequential && threadIdx.x == 0) {
    for (int it = 0; it < g.n_iterations; ++it) {
      for (int c = 0; c < c_n; ++c) {
        VelocitySlot q = velocity_load(k, nullptr, c);
        velocity_apply(k, q);
      }
    }
  }
  __syncthreads();
  if (g.bodies_shared) {
    stage(g.v, k.v, 3 * n);
    stage(g.w, k.w, 3 * n);
  }
  if (g.contacts_shared) stage(g.acc, k.acc, 3 * c_n);
  if (g.sched) {
    for (int c = threadIdx.x; c < c_n; c += blockDim.x) g.sched[c] = 0;
    for (int b = threadIdx.x; b < n; b += blockDim.x) g.sched[2 * c_n + 2 + b] = s.fixed[b];
    if (threadIdx.x == 0) g.sched[2 * c_n] = s.depth;
    __syncthreads();
    for (int i = threadIdx.x; i < s.n_nodes; i += blockDim.x) g.sched[s.node[i]] = s.lvl[i];
  }
}

// ---- correction ----

struct CorrectionArgs {
  const float* pos_in;
  const float* ori_in;
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
  int32_t* sched;
  int32_t* scratch;
  float factor;
  int n_bodies, n_contacts, n_iterations;
  int bodies_shared, sched_shared, contacts_shared;
};

struct CorrectionData {
  float *pos, *ori;
  const float *im, *inv_i;
  const int32_t *ba, *bb;
  const float *act, *nrm, *la, *lb;
  float factor;
};

// one node's data: an active slot (run = 0) or a run of `run` inactive
// slots on (a, b); fa, fb: its bodies are fixed (never stored)
struct CorrectionSlot {
  int c, a, b, run;
  bool fa, fb;
  float act;
  V3 nn, la, lb;
};

__device__ __forceinline__ CorrectionSlot correction_load(const CorrectionData& k,
                                                          const int* fixed, int c, int run) {
  CorrectionSlot q;
  q.c = c, q.a = k.ba[c], q.b = k.bb[c], q.run = run;
  q.fa = fixed && fixed[q.a], q.fb = fixed && fixed[q.b];
  q.act = k.act[c];
  q.nn = ld3(k.nrm + 3 * c), q.la = ld3(k.la + 3 * c), q.lb = ld3(k.lb + 3 * c);
  return q;
}

// One node's update; no store to a fixed body. A run renormalizes ori[a]
// and ori[b] (a = b: twice a slot). False as for velocity_apply.
__device__ __forceinline__ bool correction_apply(const CorrectionData& k, const CorrectionSlot& q) {
  const int a = q.a, b = q.b;
  if (q.run > 0) {
    if (a == b) {
      renormalize(k.ori + 4 * a, 2 * q.run);
    } else {
      if (!q.fa) renormalize(k.ori + 4 * a, q.run);
      if (!q.fb) renormalize(k.ori + 4 * b, q.run);
    }
    return true;
  }
  const V3 nn = q.nn;
  const V3 xa = ld3(k.pos + 3 * a), xb = ld3(k.pos + 3 * b);
  const Q4 qa = ld4(k.ori + 4 * a), qb = ld4(k.ori + 4 * b);
  const V3 pa = vadd(xa, rotate(qa, q.la));
  const V3 pb = vadd(xb, rotate(qb, q.lb));
  const float depth = dot(nn, vsub(pb, pa));
  const V3 da = vsub(pb, xa), db = vsub(pb, xb);
  // effective mass along the normal (solver.py:_effective_mass) with the
  // inverse inertia from before the correction
  const float ima = k.im[a], imb = k.im[b];
  const V3 ca = cross(da, nn), cb = cross(db, nn);
  const float denom = add(add(add(ima, imb), dot(ca, matvec(k.inv_i + 9 * a, ca))),
                          dot(cb, matvec(k.inv_i + 9 * b, cb)));
  const float e = __fdiv_rn(1.0f, clamp_min(denom, 1e-12f));
  const float do_it = mul(q.act, depth > 0.0f ? 1.0f : 0.0f);
  const float pseudo = mul(mul(mul(e, k.factor), depth), do_it);
  const V3 dp = vscale(pseudo, nn);
  const V3 xa1 = vadd(xa, vscale(ima, dp));
  const V3 xb1 = vadd(a == b ? xa1 : xb, vscale(-imb, dp));
  const V3 cda = cross(da, dp), cdb = cross(db, dp);
  const Q4 qa1 = integrate(qa, matvec(k.inv_i + 9 * a, cda));
  const Q4 qb1 = integrate(a == b ? qa1 : qb, vneg(matvec(k.inv_i + 9 * b, cdb)));
  if (!q.fa) {
    st3(k.pos + 3 * a, xa1);
    st4(k.ori + 4 * a, qa1);
  }
  if (!q.fb) {
    st3(k.pos + 3 * b, xb1);
    st4(k.ori + 4 * b, qb1);
  }
  return !(q.fa || q.fb) || (fin(dp) && (!q.fa || fin(cda)) && (!q.fb || fin(cdb)));
}

__global__ void __launch_bounds__(kThreads) scan_correction_kernel(CorrectionArgs g) {
  extern __shared__ float smem[];
  const int n = g.n_bodies, c_n = g.n_contacts;
  CorrectionData k{g.pos,    g.ori,    g.inv_mass, g.inv_inertia, g.body_a, g.body_b,
                   g.active, g.normal, g.local_a,  g.local_b,     g.factor};
  float* next = smem;
  bool ok = take(k.im, next, g.bodies_shared, n);
  ok = take(k.inv_i, next, g.bodies_shared, 9 * n) && ok;
  if (g.bodies_shared) {
    k.pos = next;
    k.ori = next + 3 * n;
    next += 7 * n;
  }
  auto stage_state = [&]() {
    const bool fine = stage(k.pos, g.pos_in, 3 * n);
    return stage(k.ori, g.ori_in, 4 * n) && fine;
  };
  Schedule s = carve(g.sched_shared ? reinterpret_cast<int*>(next) : g.scratch, c_n, n);
  if (g.sched_shared) next = reinterpret_cast<float*>(s.fixed + n);
  const bool cs = g.contacts_shared;
  if (cs) {
    int32_t* ids = reinterpret_cast<int32_t*>(next);
    stage_ids(ids, g.body_a, c_n);
    stage_ids(ids + c_n, g.body_b, c_n);
    k.ba = ids, k.bb = ids + c_n;
    next = reinterpret_cast<float*>(ids + 2 * c_n);
  }
  ok = take(k.act, next, cs, c_n) && ok;
  ok = take(k.nrm, next, cs, 3 * c_n) && ok;
  ok = take(k.la, next, cs, 3 * c_n) && ok;
  ok = take(k.lb, next, cs, 3 * c_n) && ok;
  ok = stage_state() && ok;
  __syncthreads();
  build_schedule(s, true, k.ba, k.bb, k.act, c_n, n, k.im, k.inv_i, g.ori_in);
  bool sequential = __syncthreads_or(!ok);
  if (!sequential) {
    auto load = [&](int node) {
      const int c = s.node[node];
      const int end = node + 1 < s.n_nodes ? s.node[node + 1] : c_n;
      return correction_load(k, s.fixed, c, k.act[c] != 0.0f ? 0 : end - c);
    };
    ok = walk<CorrectionSlot>(s, g.n_iterations, load,
                              [&](CorrectionSlot& q) { return correction_apply(k, q); });
    // a non-finite pose stays non-finite under later updates
    ok = all_finite(k.pos, 3 * n) && all_finite(k.ori, 4 * n) && ok;
    sequential = __syncthreads_or(!ok);
    if (sequential) {
      stage_state();
      __syncthreads();
    }
  }
  if (sequential && threadIdx.x == 0) {
    for (int it = 0; it < g.n_iterations; ++it)
      for (int c = 0; c < c_n; ++c) correction_apply(k, correction_load(k, nullptr, c, 0));
  }
  __syncthreads();
  if (g.bodies_shared) {
    stage(g.pos, k.pos, 3 * n);
    stage(g.ori, k.ori, 4 * n);
  }
  if (g.sched) {
    // every slot lies in the last node that starts at or before it
    for (int c = threadIdx.x; c < c_n; c += blockDim.x) {
      int lo = 0, hi = s.n_nodes - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (s.node[mid] <= c) lo = mid;
        else hi = mid - 1;
      }
      g.sched[c_n + c] = s.lvl[lo];
    }
    for (int b = threadIdx.x; b < n; b += blockDim.x) g.sched[2 * c_n + 2 + n + b] = s.fixed[b];
    if (threadIdx.x == 0) g.sched[2 * c_n + 1] = s.depth;
  }
}

// Which parts go to shared memory, in this order while they fit: the
// bodies, the schedule, the contacts; returns the bytes.
size_t plan(size_t body_bytes, size_t sched_bytes, size_t contact_bytes, int* bodies_shared,
            int* sched_shared, int* contacts_shared) {
  size_t used = 0;
  auto fit = [&](size_t bytes, int* shared) {
    *shared = used + bytes <= kMaxShared;
    if (*shared) used += bytes;
  };
  fit(body_bytes, bodies_shared);
  fit(sched_bytes, sched_shared);
  fit(contact_bytes, contacts_shared);
  return used;
}

size_t sched_bytes(int n_bodies, int n_contacts) {
  return sizeof(int) * (4 * static_cast<size_t>(n_contacts) + 2 + 2 * static_cast<size_t>(n_bodies));
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

// Inputs (*_in) are read, outputs (v, w, acc) written. sched (2C + 2 + 2N
// ints, or null) receives the slots' velocity levels [0, C), the velocity
// depth at 2C and the velocity's fixed flags at 2C + 2; scratch holds the
// schedule (4C + 2 + 2N ints) where shared memory does not.
extern "C" int scan_velocity_iterations(const void* v_in, const void* w_in, const void* acc_in,
                                        void* v, void* w, void* acc,
                                        const void* inv_mass, const void* inv_inertia,
                                        const void* body_a, const void* body_b,
                                        const void* active, const void* normal,
                                        const void* tangent, const void* bitangent,
                                        const void* disp_a, const void* disp_b,
                                        const void* eff_mass, const void* friction,
                                        const void* target, void* sched, void* scratch,
                                        int n_bodies, int n_contacts, int n_iterations,
                                        void* stream) {
  if (n_bodies <= 0 || n_contacts < 0 || n_iterations < 0) return cudaErrorInvalidValue;
  VelocityArgs g{static_cast<const float*>(v_in), static_cast<const float*>(w_in),
                 static_cast<const float*>(acc_in), static_cast<float*>(v),
                 static_cast<float*>(w), static_cast<float*>(acc),
                 static_cast<const float*>(inv_mass), static_cast<const float*>(inv_inertia),
                 static_cast<const int32_t*>(body_a), static_cast<const int32_t*>(body_b),
                 static_cast<const float*>(active), static_cast<const float*>(normal),
                 static_cast<const float*>(tangent), static_cast<const float*>(bitangent),
                 static_cast<const float*>(disp_a), static_cast<const float*>(disp_b),
                 static_cast<const float*>(eff_mass), static_cast<const float*>(friction),
                 static_cast<const float*>(target), static_cast<int32_t*>(sched),
                 static_cast<int32_t*>(scratch), n_bodies, n_contacts, n_iterations, 0, 0, 0};
  const size_t smem = plan(sizeof(float) * 16 * static_cast<size_t>(n_bodies),
                           sched_bytes(n_bodies, n_contacts),
                           sizeof(float) * 26 * static_cast<size_t>(n_contacts),
                           &g.bodies_shared, &g.sched_shared, &g.contacts_shared);
  return launch(scan_velocity_kernel, g, smem, stream);
}

// As scan_velocity_iterations: sched receives the correction levels at
// [C, 2C), the correction depth at 2C + 1 and the correction's fixed flags
// at 2C + 2 + N.
extern "C" int scan_position_correction(const void* pos_in, const void* ori_in, void* pos,
                                        void* ori, const void* inv_mass,
                                        const void* inv_inertia, const void* body_a,
                                        const void* body_b, const void* active,
                                        const void* normal, const void* local_a,
                                        const void* local_b, void* sched, void* scratch,
                                        float factor, int n_bodies, int n_contacts,
                                        int n_iterations, void* stream) {
  if (n_bodies <= 0 || n_contacts < 0 || n_iterations < 0) return cudaErrorInvalidValue;
  CorrectionArgs g{static_cast<const float*>(pos_in), static_cast<const float*>(ori_in),
                   static_cast<float*>(pos), static_cast<float*>(ori),
                   static_cast<const float*>(inv_mass), static_cast<const float*>(inv_inertia),
                   static_cast<const int32_t*>(body_a), static_cast<const int32_t*>(body_b),
                   static_cast<const float*>(active), static_cast<const float*>(normal),
                   static_cast<const float*>(local_a), static_cast<const float*>(local_b),
                   static_cast<int32_t*>(sched), static_cast<int32_t*>(scratch), factor,
                   n_bodies, n_contacts, n_iterations, 0, 0, 0};
  const size_t smem = plan(sizeof(float) * 17 * static_cast<size_t>(n_bodies),
                           sched_bytes(n_bodies, n_contacts),
                           sizeof(float) * 12 * static_cast<size_t>(n_contacts),
                           &g.bodies_shared, &g.sched_shared, &g.contacts_shared);
  return launch(scan_correction_kernel, g, smem, stream);
}
