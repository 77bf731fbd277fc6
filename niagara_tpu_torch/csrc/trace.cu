// The ray-traced shadows' BVH walk for Hopper: trace_any_hit<kAlpha>.
//
// The reference has no Pallas kernel here: niagara_tpu/ops/shadow.py's
// trace_any_hit (:320-486) is one jax.lax.while_loop whose body (:352-465)
// moves every ray of the batch one node a step, ~100 array ops a step for
// up to 1024 (or 2048) steps.  In eager PyTorch that is ~10^5 launches a
// frame; this kernel is one launch.  Plain torch twin:
// ops/shadow.py::trace_plain.
//
// A ray's walk: the TLAS in world space; at a TLAS leaf whose box the ray
// hits, enter the instance (origin and direction rotated by the conjugate
// quaternion and divided by the scale, so t is kept) and walk its BLAS from
// node 0; at a BLAS leaf whose box it hits, up to kMaxLeaf watertight
// triangle tests (with kAlpha the hit's uv must land on an opaque cell of
// the triangle's 8x8 mask, the quality-1 any-hit); walking off the BLAS
// resumes at the TLAS skip pointer saved on entry.  A ray stops at its
// first hit, when it walks off the TLAS, or after max_steps node visits
// (the leaf's tests and the entry belong to the visit of their node).  The
// reference counts steps for the whole batch, but every unfinished ray
// advances exactly once a step, so a budget per ray gives the same flags.
//
// Every float rounds op by op as in the plain version (the library is
// built with --fmad=false; sums of three are ((a0 + a1) + a2); divisions
// are IEEE; min/max return NaN when either side is, as torch.minimum
// does), so the flags and step counts equal trace_plain's bit for bit.
// Which thread runs a ray, and when, changes no arithmetic of it.
//
// What bounds it.  Neither bytes nor operations: the walk's rows (~4 MB
// distinct) sit in the 50 MB L2, and a ray is a chain of ~145 dependent
// node loads (1 to 1,024).  On the H100 the kernel's time is its longest
// walks' chains: the 2% of rays over 512 steps alone take as long as the
// whole launch, and cutting the budget to 256 steps (17% of the steps)
// nearly halves it (niagara_tpu_torch/trace_sweep.py, PERF.md).  The
// first kernel (one thread per ray) also lost its warps to their longest
// ray and to lanes running TLAS steps, entries, BLAS steps and leaves of
// up to 8 serial triangle tests one after another.  This design:
//  - persistent warps that refill finished lanes (Aila & Laine, HPG 2009):
//    as many blocks as fill the card once; a warp takes rays from a
//    counter with one atomicAdd, and takes more whenever kRefill of its
//    lanes are idle, so a long ray holds one lane, not 31 others;
//  - a coherent ray order: slot s of the counter is ray order[s]
//    (shadow_pass passes the Morton order of the rays' pixels), so the
//    rays a warp takes together are neighbours in the image;
//  - phase-coherent stepping: the lanes step through nodes (TLAS and BLAS
//    in one code path) and park at an instance entry or a BLAS leaf; when
//    kBatch lanes are parked, or none walks, the warp runs the entries,
//    then every parked leaf's triangles spread one per lane
//    (warp-cooperative, the hits gathered by ballot);
//  - the tail: once the counter is spent and at most kTail lanes are
//    busy, the warp's last walks go on lane groups (walk_together), each
//    step of a long walk a read from registers where its next node lies
//    in the group's window instead of a round trip;
//  - the BLAS inverse direction is computed once at the instance entry,
//    not on every BLAS step (the same IEEE divisions of the same inputs),
//    and NaN-propagating min/max are single instructions.
// Results are written at the ray's id, so the finishing order is free.
// Shared-memory tiles, TMA and wgmma do not apply: the walk is a chain of
// dependent loads with no tile to stage or product to issue.

#include <atomic>

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaf = 8;
constexpr int kBlock = 128;
// The schedule, each value measured on the H100 (PERF.md): a warp takes
// new rays once kRefill of its lanes are idle; runs its parked lanes'
// entries and leaf tests once kBatch of them are parked, or none walks;
// and once the counter is spent and at most kTail lanes are busy, walks
// them on lane groups.  A minimum of kMinBlocks = 1 block a SM in
// __launch_bounds__ leaves the kernel its ~70 registers (7 blocks a SM);
// 8 caps them at 64, 12 at 40 with spills.
constexpr int kRefill = 8;
constexpr int kBatch = 4;
constexpr int kTail = 8;
constexpr int kMinBlocks = 1;
constexpr int kMaxDevices = 64;
constexpr unsigned kAll = 0xffffffffu;
// a lane: no ray; at a node step; parked at an instance entry; parked at a BLAS leaf
enum : int { kIdle = 0, kWalk = 1, kEnter = 2, kLeaf = 3 };

struct V3 {
  float x, y, z;
};

struct Scene {
  const float4* nodes;  // [n_nodes, 2]: min3 max.x | max.yz skip leaf
  const float4* tris;   // [n_tris, 3]: v0 e1.x | e1.yz e2.xy | e2.z pad
  const float4* inst;   // [n_inst, 3]: position scale | quaternion | BLAS base, count, triangle base
  const float4* uv4;    // [n_alpha, 2]
  const float4* alpha4; // [n_alpha, 2]
  int n_nodes, tlas_base, n_tris, n_inst, n_alpha;
};

struct Rays {
  const float* origin;     // [n, 3]
  const float* direction;  // [n, 3]
  const int* order;        // [n] ray of each counter slot, or null: slot s is ray s
  bool* occluded;          // [n]
  int* steps;              // [n]
  int* counter;            // the next slot, zeroed before the launch
  int n, max_steps;
  float t_min, t_max;
};

__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float dot(V3 a, V3 b) { return (a.x * b.x + a.y * b.y) + a.z * b.z; }

// torch.minimum / torch.maximum: NaN when either operand is NaN (one
// instruction each on sm_80+; the NaN's bits differ from torch's, but only
// the slab test's comparison reads them)
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

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

__device__ __forceinline__ V3 load3(const float* p, int i) {
  return {__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)};
}

__device__ __forceinline__ V3 shfl3(V3 v, int src) {
  return {__shfl_sync(kAll, v.x, src), __shfl_sync(kAll, v.y, src), __shfl_sync(kAll, v.z, src)};
}

// The quality-1 mask test of a hit at barycentrics (u, v) on triangle ti
// (shadow.py:403-421); the plain version is ops/shadow.py::_alpha_pass.
__device__ __forceinline__ bool alpha_pass(const Scene& s, int ta, float u, float v) {
  const float4 a0 = __ldg(s.alpha4 + 2 * ta), a1 = __ldg(s.alpha4 + 2 * ta + 1);
  const float idu = a1.z;
  if (idu <= 0.0f) return true;  // untextured: every hit occludes
  const float4 uv0 = __ldg(s.uv4 + 2 * ta), uv1 = __ldg(s.uv4 + 2 * ta + 1);
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

// The watertight any-hit test of the object-space ray (o, d) against triangle ti.
template <bool kAlpha>
__device__ __forceinline__ bool tri_hit(const Scene& s, int ti, V3 o, V3 d, float t_min, float t_max) {
  const float4 a = __ldg(s.tris + 3 * ti), b = __ldg(s.tris + 3 * ti + 1), c = __ldg(s.tris + 3 * ti + 2);
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
  if (kAlpha && ok) ok = alpha_pass(s, min(ti, s.n_alpha - 1), u, v);
  return ok;
}

// A ray's walk: world-space origin and inverse direction; the level it
// walks (node pointer and base: the TLAS's, or the entered BLAS's with its
// node count, triangle base and the TLAS pointer to resume at); that
// level's origin and inverse direction (the world's, or the instance's
// object-space ray, whose direction the leaf tests read); its steps so far
// and whether it hit.
struct Walk {
  V3 ow, inv_w, o, inv, dd;
  int ptr, base, ncount, tbase, resume, step;
  bool in_blas, hit;

  __device__ __forceinline__ void start(const Scene& s, const Rays& q, int r) {
    ow = o = load3(q.origin, r);
    inv_w = inv = safe_inv(load3(q.direction, r));
    dd = {0.0f, 0.0f, 0.0f};
    ptr = ncount = tbase = step = 0;
    base = s.tlas_base;
    resume = s.n_nodes - s.tlas_base;
    in_blas = hit = false;
  }
  // walked off the TLAS or hit; the budget is checked where the walk's loop
  // starts its next step
  __device__ __forceinline__ bool done(int tlas_count) const { return hit || (!in_blas && ptr >= tlas_count); }
  // the slab test of node (lo, hi) against the current level's ray
  __device__ __forceinline__ bool box_hit(float4 lo, float4 hi, float t_min, float t_max) const {
    const float t0x = (lo.x - o.x) * inv.x, t0y = (lo.y - o.y) * inv.y, t0z = (lo.z - o.z) * inv.z;
    const float t1x = (lo.w - o.x) * inv.x, t1y = (hi.x - o.y) * inv.y, t1z = (hi.y - o.z) * inv.z;
    const float tnear = max_nan(max_nan(max_nan(min_nan(t0x, t1x), min_nan(t0y, t1y)), min_nan(t0z, t1z)), t_min);
    const float tfar = min_nan(min_nan(min_nan(max_nan(t0x, t1x), max_nan(t0y, t1y)), max_nan(t0z, t1z)), t_max);
    return tnear <= tfar;
  }
  // move to node `next` of the current level; off the BLAS's end, back to the TLAS
  __device__ __forceinline__ void advance(int next, int tlas_base) {
    if (in_blas && next >= ncount) {
      ptr = resume;
      base = tlas_base;
      o = ow;
      inv = inv_w;
      in_blas = false;
    } else {
      ptr = next;
    }
  }
  // the entry of the instance whose rows are p (position, scale), qt (its
  // quaternion) and m (BLAS node base, node count, triangle base), for the
  // ray with world direction dw, resuming the TLAS at `skip` after it
  __device__ __forceinline__ void enter(float4 p, float4 qt, float4 m, V3 dw, int skip) {
    const float sc = fabsf(p.w) < 1e-12f ? 1e-12f : p.w;
    const V3 ro = rotate_conj(sub(ow, {p.x, p.y, p.z}), qt), rd = rotate_conj(dw, qt);
    o = {ro.x / sc, ro.y / sc, ro.z / sc};
    dd = {rd.x / sc, rd.y / sc, rd.z / sc};
    inv = safe_inv(dd);
    base = (int)m.x;
    ncount = (int)m.y;
    tbase = (int)m.z;
    resume = skip;
    ptr = 0;
    in_blas = true;
  }
  // every field from lane `src`
  __device__ __forceinline__ Walk from_lane(int src) const {
    Walk w;
    w.ow = shfl3(ow, src), w.inv_w = shfl3(inv_w, src), w.o = shfl3(o, src), w.inv = shfl3(inv, src);
    w.dd = shfl3(dd, src);
    w.ptr = __shfl_sync(kAll, ptr, src), w.base = __shfl_sync(kAll, base, src);
    w.ncount = __shfl_sync(kAll, ncount, src), w.tbase = __shfl_sync(kAll, tbase, src);
    w.resume = __shfl_sync(kAll, resume, src), w.step = __shfl_sync(kAll, step, src);
    w.in_blas = __shfl_sync(kAll, (int)in_blas, src) != 0, w.hit = __shfl_sync(kAll, (int)hit, src) != 0;
    return w;
  }
};

__device__ __forceinline__ void enter_row(Walk& w, const Scene& s, const Rays& q, int r, int leaf, int skip) {
  const int row = clampi(leaf >> 4, 0, s.n_inst - 1);
  w.enter(__ldg(s.inst + 3 * row), __ldg(s.inst + 3 * row + 1), __ldg(s.inst + 3 * row + 2), load3(q.direction, r),
          skip);
}

// The tail: the warp's last walks, each on a group of lanes.  With k
// walks left (k <= tail), each takes a group of 32 / k (rounded down to a
// power of two) lanes.  Each round the group loads that many nodes from
// its pointer on (one coalesced round trip, a slab test a lane), then the
// walk takes its steps through them from registers for as long as its
// pointer stays in the window: a node's next node is the following one (a
// descent) or its skip, which in a depth-first layout is often near.  A
// BLAS leaf's triangles are tested one a lane; an entry or a level change
// starts a new window.  Steps and flags are the walk's own, in order.
template <bool kAlpha>
__device__ __forceinline__ void walk_together(Walk& w, const Scene& s, const Rays& q, int r, int gl, int width,
                                              int gbase, unsigned gmask) {
  const int tlas_count = s.n_nodes - s.tlas_base;
  for (;;) {
    if (w.done(tlas_count) || w.step >= q.max_steps) break;
    const int start = w.ptr;
    const int gidx = clampi(w.base + start + gl, 0, s.n_nodes - 1);
    const float4 lo = __ldg(s.nodes + 2 * gidx), hi = __ldg(s.nodes + 2 * gidx + 1);
    const bool bh = w.box_hit(lo, hi, q.t_min, q.t_max);
    const int my_skip = __float_as_int(hi.z), my_leaf = __float_as_int(hi.w);
    const bool level = w.in_blas;
    for (;;) {
      const int k = gbase + w.ptr - start;
      const bool box = __shfl_sync(gmask, (int)bh, k) != 0;
      const int skip = __shfl_sync(gmask, my_skip, k), leaf = __shfl_sync(gmask, my_leaf, k);
      ++w.step;
      if (leaf >= 0 && box) {
        if (!w.in_blas) {
          enter_row(w, s, q, r, leaf, skip);
          break;
        }
        const int first = w.tbase + (leaf >> 4), cnt = min(leaf & 15, kMaxLeaf);
        bool any = false;
        for (int j = 0; j < cnt && !any; j += width) {
          const bool ok = j + gl < cnt && tri_hit<kAlpha>(s, clampi(first + j + gl, 0, s.n_tris - 1), w.o, w.dd,
                                                          q.t_min, q.t_max);
          any = (__ballot_sync(gmask, ok) & gmask) != 0;
        }
        w.hit = any;
        w.advance(skip, s.tlas_base);
      } else {
        w.advance(box ? w.ptr + 1 : skip, s.tlas_base);
      }
      if (w.in_blas != level || w.done(tlas_count) || w.step >= q.max_steps || w.ptr < start ||
          w.ptr - start >= width)
        break;
    }
  }
  if (gl == 0) {
    q.occluded[r] = w.hit;
    q.steps[r] = w.done(tlas_count) ? w.step : -1;
  }
}

template <bool kAlpha>
__global__ void __launch_bounds__(kBlock, kMinBlocks) trace_any_hit(const Scene s, const Rays q) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int tlas_count = s.n_nodes - s.tlas_base;

  // a lane's ray id, next action and walk, and the node it parked at (leaf
  // and skip words)
  int r = -1, mode = kIdle, leaf = 0, skip = 0;
  Walk w;
  w.ow = w.inv_w = w.o = w.inv = w.dd = {0.0f, 0.0f, 0.0f};
  w.ptr = w.base = w.ncount = w.tbase = w.resume = w.step = 0;
  w.in_blas = w.hit = false;
  bool drained = false;  // the counter has passed the last ray (warp-uniform)

  for (;;) {
    // refill: one atomicAdd for the warp's idle lanes, slots in lane order
    // (lanes retired below wait for the next round)
    const unsigned idle = __ballot_sync(kAll, mode == kIdle);
    if (!drained && idle != 0 && (__popc(idle) >= kRefill || idle == kAll)) {
      const int want = __popc(idle);
      int first = 0;
      if (lane == 0) first = atomicAdd(q.counter, want);
      first = __shfl_sync(kAll, first, 0);
      drained = first + want >= q.n;
      if (mode == kIdle) {
        const int slot = first + __popc(idle & below);
        r = slot < q.n ? (q.order ? __ldg(q.order + slot) : slot) : -1;
        if (r >= 0 && r < q.n) {
          w.start(s, q, r);
          mode = kWalk;
        }
      }
    }
    // retire ended walks, before a lane's next node step as the walk's
    // loop checks: an ended walk keeps its steps, a live one at its budget
    // gets -1
    if (mode == kWalk) {
      const bool done = w.done(tlas_count);
      if (done || w.step >= q.max_steps) {
        q.occluded[r] = w.hit;
        q.steps[r] = done ? w.step : -1;
        mode = kIdle;
      }
    }
    const unsigned walking = __ballot_sync(kAll, mode == kWalk), busy = __ballot_sync(kAll, mode != kIdle);
    if (busy == 0) {
      if (drained) break;
      continue;
    }
    // the tail (below) once the rays are all taken and at most `tail` lanes
    // are busy: their parked work first, then every walk on its lane group
    const bool tail = drained && __popc(busy) <= kTail;
    if (tail && busy == walking) break;

    if (walking != 0 && __popc(busy & ~walking) < kBatch && !tail) {
      // a node step, TLAS and BLAS in one path
      if (mode == kWalk) {
        const int gidx = clampi(w.base + w.ptr, 0, s.n_nodes - 1);
        const float4 lo = __ldg(s.nodes + 2 * gidx), hi = __ldg(s.nodes + 2 * gidx + 1);
        const bool box_hit = w.box_hit(lo, hi, q.t_min, q.t_max);
        skip = __float_as_int(hi.z);
        leaf = __float_as_int(hi.w);
        ++w.step;
        if (leaf < 0 || !box_hit)
          w.advance(box_hit ? w.ptr + 1 : skip, s.tlas_base);
        else
          mode = w.in_blas ? kLeaf : kEnter;  // the entry or the tests finish this step
      }
      continue;
    }

    // the parked lanes: instance entries, then the leaves' triangle tests
    if (mode == kEnter) {
      enter_row(w, s, q, r, leaf, skip);
      mode = kWalk;
    }
    if (__any_sync(kAll, mode == kLeaf)) {
      // every parked leaf's triangles in a row, lane j of round k testing
      // item 32k + j against its owner's ray
      const bool mine = mode == kLeaf;
      const int cnt = mine ? min(leaf & 15, kMaxLeaf) : 0;
      int incl = cnt;
      for (int k = 1; k < 32; k <<= 1) {
        const int v = __shfl_up_sync(kAll, incl, k);
        if (lane >= k) incl += v;
      }
      const int total = __shfl_sync(kAll, incl, 31), excl = incl - cnt, first = w.tbase + (leaf >> 4);
      bool got = false;
      for (int k = 0; k < total; k += 32) {
        const int i = k + lane;
        int owner = 0;  // the first lane whose inclusive count exceeds i
        for (int b = 16; b > 0; b >>= 1)
          if (__shfl_sync(kAll, incl, owner + b - 1) <= i) owner += b;
        const int o_first = __shfl_sync(kAll, first, owner), o_excl = __shfl_sync(kAll, excl, owner);
        const V3 oi = shfl3(w.o, owner), di = shfl3(w.dd, owner);
        const bool ok = i < total && tri_hit<kAlpha>(s, clampi(o_first + (i - o_excl), 0, s.n_tris - 1), oi, di,
                                                     q.t_min, q.t_max);
        const unsigned hits = __ballot_sync(kAll, ok);
        const int lo = max(excl - k, 0), hi = min(incl - k, 32);
        if (mine && lo < hi) got |= (hits >> lo) << (32 - (hi - lo)) != 0;
      }
      if (mine) {
        w.hit = got;
        w.advance(skip, s.tlas_base);  // a leaf's next node is its skip
        mode = kWalk;
      }
    }
  }

  // the tail: the last walks, each on a group of lanes
  const unsigned walking = __ballot_sync(kAll, mode == kWalk);
  if (walking == 0) return;
  const int k = __popc(walking);
  int width = 32;
  while (width * k > 32) width >>= 1;
  const int g = lane / width, gl = lane % width;
  const unsigned gmask = (width == 32 ? kAll : ((1u << width) - 1u)) << (g * width);
  const int src = g < k ? __fns(walking, 0, g + 1) : lane;
  w = w.from_lane(src);  // every lane the walk of its group
  r = __shfl_sync(kAll, r, src);
  if (g < k) walk_together<kAlpha>(w, s, q, r, gl, width, g * width, gmask);
}

}  // namespace

// nodes [n_nodes, 8], tris [n_tris, 12] (v0 | e1 | e2 | pad), inst [n_inst, 12],
// uv and alpha [n_alpha, 8] (read with alpha != 0), origin/direction [n_rays, 3],
// order [n_rays] (a permutation of the rays, or null), counter [1] (scratch)
// -> occluded [n_rays] (bool), steps [n_rays] (-1: out of budget).  blocks <= 0:
// as many as fill the card once.
extern "C" int trace_launch(const float* nodes, int n_nodes, int tlas_base, const float* tris, int n_tris,
                            const float* inst, int n_inst, const float* uv, const float* alpha, int n_alpha,
                            const float* origin, const float* direction, const int* order, int n_rays, float t_min,
                            float t_max, int max_steps, int alpha_test, int blocks, int* counter, bool* occluded,
                            int* steps, cudaStream_t stream) {
  if (n_rays <= 0 || n_nodes <= tlas_base || tlas_base < 0 || n_tris <= 0 || n_inst <= 0 || n_alpha <= 0)
    return (int)cudaErrorInvalidValue;
  void (*kernel)(const Scene, const Rays) = alpha_test ? trace_any_hit<true> : trace_any_hit<false>;
  if (blocks <= 0) {
    // the grid that fills the card once is fixed per device and instance:
    // asked once, then read from here
    static std::atomic<int> fill[kMaxDevices][2];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    blocks = fill[dev][alpha_test ? 1 : 0].load(std::memory_order_relaxed);
    if (blocks <= 0) {
      int sms = 0, per_sm = 0;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, 0);
      if (err != cudaSuccess) return (int)err;
      blocks = per_sm * sms;
      fill[dev][alpha_test ? 1 : 0].store(blocks, std::memory_order_relaxed);
    }
  }
  const int needed = (n_rays + kBlock - 1) / kBlock;
  if (blocks > needed) blocks = needed;
  const Scene s = {(const float4*)nodes, (const float4*)tris, (const float4*)inst, (const float4*)uv,
                   (const float4*)alpha, n_nodes, tlas_base, n_tris, n_inst, n_alpha};
  const Rays q = {origin, direction, order, occluded, steps, counter, n_rays, max_steps, t_min, t_max};
  const cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kBlock, 0, stream>>>(s, q);
  return (int)cudaGetLastError();
}
