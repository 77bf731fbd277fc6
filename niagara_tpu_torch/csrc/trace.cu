// The ray-traced shadows' BVH walk for Hopper: trace_any_hit<kAlpha>.
//
// The reference has no Pallas kernel here: niagara_tpu/ops/shadow.py's
// trace_any_hit (:320-486) is one jax.lax.while_loop whose body (:352-465)
// moves every ray of the batch one node a step, ~100 array ops a step for
// up to 1024 (or 2048) steps.  In eager PyTorch that is ~10^5 launches a
// frame; this kernel is one launch.  Plain torch twin:
// ops/shadow.py::trace_plain.
//
// One thread per ray, the body's whole state machine in registers: walk
// the TLAS in world space; at a TLAS leaf whose box the ray hits, enter
// the instance (origin and direction rotated by the conjugate quaternion
// and divided by the scale, so t is kept) and walk its BLAS from node 0;
// at a BLAS leaf run up to kMaxLeaf watertight triangle tests (with kAlpha
// the hit's uv must land on an opaque cell of the triangle's 8x8 mask,
// the quality-1 any-hit); walking off the BLAS resumes at the TLAS skip
// pointer saved on entry.  A ray stops at its first hit, when it walks off
// the TLAS, or after max_steps node visits.  The reference counts steps
// for the whole batch, but every unfinished ray advances exactly once a
// step, so a budget per ray gives the same flags.
//
// Every float rounds op by op as in the plain version (the library is
// built with --fmad=false; sums of three are ((a0 + a1) + a2); divisions
// are IEEE; min/max return NaN when either side is, as torch.minimum
// does), so the flags and step counts equal trace_plain's bit for bit.
//
// What bounds it: each step is a dependent 32-byte node load (two __ldg
// float4), each leaf test a 48-byte triangle row (three float4), so a ray
// is a chain of latency-bound loads; the rays of a warp diverge in path
// and length.  This first kernel keeps it simple: no ray sorting, no
// warp-cooperative traversal, no persistent threads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaf = 8;
constexpr int kBlock = 128;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float dot(V3 a, V3 b) { return (a.x * b.x + a.y * b.y) + a.z * b.z; }

// torch.minimum / torch.maximum: NaN when either operand is NaN
__device__ __forceinline__ float min_nan(float a, float b) { return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b); }
__device__ __forceinline__ float max_nan(float a, float b) { return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b); }

// 1 / where(|d| < 1e-12, 1e-12, d): a tiny negative component turns into
// +1e-12, as in the reference (shadow.py:345)
__device__ __forceinline__ float safe_inv(float d) { return 1.0f / (fabsf(d) < 1e-12f ? 1e-12f : d); }
__device__ __forceinline__ V3 safe_inv(V3 d) { return {safe_inv(d.x), safe_inv(d.y), safe_inv(d.z)}; }

// v rotated by the conjugate of q = (x, y, z, w): v + 2 cross(-q.xyz, cross(-q.xyz, v) + w v)
__device__ __forceinline__ V3 rotate_conj(V3 v, float4 q) {
  const V3 qv = {-q.x, -q.y, -q.z};
  const V3 c = cross(qv, v);
  const V3 t = {c.x + q.w * v.x, c.y + q.w * v.y, c.z + q.w * v.z};
  const V3 r = cross(qv, t);
  return {v.x + 2.0f * r.x, v.y + 2.0f * r.y, v.z + 2.0f * r.z};
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }
__device__ __forceinline__ float clampf(float v, float lo, float hi) { return fminf(fmaxf(v, lo), hi); }

// The quality-1 mask test of a hit at barycentrics (u, v) on triangle ti
// (shadow.py:403-421); the plain version is ops/shadow.py::_alpha_pass.
__device__ __forceinline__ bool alpha_pass(const float4* __restrict__ uv4, const float4* __restrict__ alpha4, int ta,
                                           float u, float v) {
  const float4 a0 = __ldg(alpha4 + 2 * ta), a1 = __ldg(alpha4 + 2 * ta + 1);
  const float idu = a1.z;
  if (idu <= 0.0f) return true;  // untextured: every hit occludes
  const float4 uv0 = __ldg(uv4 + 2 * ta), uv1 = __ldg(uv4 + 2 * ta + 1);
  const float w = (1.0f - u) - v;
  const float hu = (uv0.x * w + uv0.z * u) + uv1.x * v;
  const float hv = (uv0.y * w + uv0.w * u) + uv1.y * v;
  const float gx = clampf(floorf((hu - a1.x) * idu), 0.0f, 7.0f);
  const float gy = clampf(floorf((hv - a1.y) * a1.w), 0.0f, 7.0f);
  const int cell = (int)(gy * 8.0f + gx);
  const int q = cell >> 4;
  const float half = q == 0 ? a0.x : (q == 1 ? a0.y : (q == 2 ? a0.z : a0.w));
  return (((int)half >> (cell & 15)) & 1) != 0;
}

template <bool kAlpha>
__global__ void __launch_bounds__(kBlock)
    trace_any_hit(const float4* __restrict__ nodes, int n_nodes, int tlas_base, const float4* __restrict__ tris,
                  int n_tris, const float4* __restrict__ inst, int n_inst, const float4* __restrict__ uv4,
                  const float4* __restrict__ alpha4, int n_alpha, const float* __restrict__ origin,
                  const float* __restrict__ direction, int n_rays, float t_min, float t_max, int max_steps,
                  bool* __restrict__ occluded, int* __restrict__ steps_out) {
  const int r = blockIdx.x * kBlock + threadIdx.x;
  if (r >= n_rays) return;
  const V3 ow = {origin[3 * r], origin[3 * r + 1], origin[3 * r + 2]};
  const V3 dw = {direction[3 * r], direction[3 * r + 1], direction[3 * r + 2]};
  const V3 inv_w = safe_inv(dw);
  const int tlas_count = n_nodes - tlas_base;

  int ptr = 0, base = 0, ncount = 0, tbase = 0, resume = tlas_count;
  bool in_blas = false, hit = false;
  V3 oo = {0.0f, 0.0f, 0.0f}, dd = {0.0f, 0.0f, 0.0f};
  int step = 0;
  for (; step < max_steps; ++step) {
    if (hit || (!in_blas && ptr >= tlas_count)) break;
    const int gidx = clampi(in_blas ? base + ptr : tlas_base + min(ptr, tlas_count - 1), 0, n_nodes - 1);
    const float4 lo = __ldg(nodes + 2 * gidx), hi = __ldg(nodes + 2 * gidx + 1);  // min3 max.x | max.yz skip leaf
    const V3 o = in_blas ? oo : ow;
    const V3 inv_d = in_blas ? safe_inv(dd) : inv_w;
    const float t0x = (lo.x - o.x) * inv_d.x, t0y = (lo.y - o.y) * inv_d.y, t0z = (lo.z - o.z) * inv_d.z;
    const float t1x = (lo.w - o.x) * inv_d.x, t1y = (hi.x - o.y) * inv_d.y, t1z = (hi.y - o.z) * inv_d.z;
    const float tnear =
        max_nan(max_nan(max_nan(min_nan(t0x, t1x), min_nan(t0y, t1y)), min_nan(t0z, t1z)), t_min);
    const float tfar = min_nan(min_nan(min_nan(max_nan(t0x, t1x), max_nan(t0y, t1y)), max_nan(t0z, t1z)), t_max);
    const bool box_hit = tnear <= tfar;
    const int skip = __float_as_int(hi.z), leaf = __float_as_int(hi.w);
    const bool is_leaf = leaf >= 0;
    const int local_next = (box_hit && !is_leaf) ? ptr + 1 : skip;

    if (in_blas) {
      if (is_leaf && box_hit) {
        const int first = tbase + (leaf >> 4), count = leaf & 15;
        const V3 d = dd;
        for (int j = 0; j < count && !hit; ++j) {
          const int ti = clampi(first + j, 0, n_tris - 1);
          const float4 a = __ldg(tris + 3 * ti), b = __ldg(tris + 3 * ti + 1), c = __ldg(tris + 3 * ti + 2);
          const V3 v0 = {a.x, a.y, a.z}, e1 = {a.w, b.x, b.y}, e2 = {b.z, b.w, c.x};
          const V3 pvec = cross(d, e2);
          const float det = dot(e1, pvec);
          const float inv_det = fabsf(det) < 1e-12f ? 0.0f : 1.0f / det;
          const V3 tvec = sub(o, v0);
          const float u = dot(tvec, pvec) * inv_det;
          const V3 qvec = cross(tvec, e1);
          const float v = dot(d, qvec) * inv_det;
          const float t = dot(e2, qvec) * inv_det;
          bool ok = fabsf(det) > 1e-12f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > t_min && t < t_max;
          if (kAlpha && ok) ok = alpha_pass(uv4, alpha4, min(ti, n_alpha - 1), u, v);
          hit = ok;
        }
      }
      if (local_next >= ncount) {  // walked off the BLAS: back to the TLAS
        ptr = resume;
        in_blas = false;
      } else {
        ptr = local_next;
      }
    } else if (is_leaf && box_hit) {  // enter the instance
      const int row = clampi(leaf >> 4, 0, n_inst - 1);
      const float4 p = __ldg(inst + 3 * row), q = __ldg(inst + 3 * row + 1), m = __ldg(inst + 3 * row + 2);
      // p: position, scale; q: quaternion; m: BLAS node base, node count, triangle base
      const float s = fabsf(p.w) < 1e-12f ? 1e-12f : p.w;
      const V3 ro = rotate_conj(sub(ow, {p.x, p.y, p.z}), q), rd = rotate_conj(dw, q);
      oo = {ro.x / s, ro.y / s, ro.z / s};
      dd = {rd.x / s, rd.y / s, rd.z / s};
      base = (int)m.x;
      ncount = (int)m.y;
      tbase = (int)m.z;
      resume = skip;
      ptr = 0;
      in_blas = true;
    } else {
      ptr = local_next;
    }
  }
  const bool live = !(hit || (!in_blas && ptr >= tlas_count));
  occluded[r] = hit;
  steps_out[r] = live ? -1 : step;
}

}  // namespace

// nodes [n_nodes, 8], tris [n_tris, 12] (v0 | e1 | e2 | pad), inst [n_inst, 12],
// uv and alpha [n_alpha, 8] (read with alpha != 0), origin/direction [n_rays, 3]
// -> occluded [n_rays] (bool), steps [n_rays] (-1: out of budget)
extern "C" int trace_launch(const float* nodes, int n_nodes, int tlas_base, const float* tris, int n_tris,
                            const float* inst, int n_inst, const float* uv, const float* alpha, int n_alpha,
                            const float* origin, const float* direction, int n_rays, float t_min, float t_max,
                            int max_steps, int alpha_test, bool* occluded, int* steps, cudaStream_t stream) {
  if (n_rays <= 0 || n_nodes <= tlas_base || tlas_base < 0 || n_tris <= 0 || n_inst <= 0 || n_alpha <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n_rays + kBlock - 1) / kBlock);
  const float4 *n4 = (const float4*)nodes, *t4 = (const float4*)tris, *i4 = (const float4*)inst;
  const float4 *u4 = (const float4*)uv, *a4 = (const float4*)alpha;
  if (alpha_test)
    trace_any_hit<true><<<grid, kBlock, 0, stream>>>(n4, n_nodes, tlas_base, t4, n_tris, i4, n_inst, u4, a4, n_alpha,
                                                     origin, direction, n_rays, t_min, t_max, max_steps, occluded,
                                                     steps);
  else
    trace_any_hit<false><<<grid, kBlock, 0, stream>>>(n4, n_nodes, tlas_base, t4, n_tris, i4, n_inst, u4, a4, n_alpha,
                                                      origin, direction, n_rays, t_min, t_max, max_steps, occluded,
                                                      steps);
  return (int)cudaGetLastError();
}
