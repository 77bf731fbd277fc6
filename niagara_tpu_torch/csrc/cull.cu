// The cull layer for Hopper: draw cull, cluster cull with ordered
// compaction, the clusters' screen-x order, and the depth pyramid.
//
// Replaces no Pallas kernel: the reference's cull (niagara_tpu/ops/cull.py
// draw_cull, cluster_cull_direct_multi; ops/raster.py order_clusters_by_x,
// transform_meta_direct) and its pyramid (ops/pyramid.py build_pyramid) are
// XLA ops.  The port ran them as chains of ~1,200 plain torch ops a frame,
// and the host's dispatch of those, not the device, set the layer's time.
// Plain twins (ops/cull.py cull_pass_plain, ops/pyramid.py
// build_pyramid_plain) follow the same f32 op order; with --fmad=false both
// round op by op, so every output agrees bit for bit.  Where a test is
// skipped here because an earlier one decided (a draw already invisible),
// the plain version computes it and drops it: the same result.
//
// Kernels, per cull pass:
//   draw_cull_kernel     one thread a draw: frustum, late occlusion, the
//                        pass's class and emission rule, new visibility,
//                        LOD; the emitted draws compacted in id order with
//                        their LOD's meshlet count and offset and the
//                        exclusive prefix of meshlet counts, by a decoupled
//                        look-back over a 64-bit status word a tile
//                        (emitted draws, meshlets); whole-draw drops against
//                        the candidate capacity; the late pass's write-back
//                        clears every 64-slot pair its draws touch.
//   cluster_cull_kernel  one thread a candidate slot: the owning draw by a
//                        binary search of the prefix; the visibility-bit
//                        skip, cone, frustum and occlusion tests; the late
//                        write-back's visible bits by atomic OR (each bit is
//                        distinct, and every clear landed in the launch
//                        before); survivors compacted draw-major in each
//                        class group by a look-back a group, with the
//                        x-order key (xq << slot_bits) | slot.  Persistent:
//                        the blocks fill the dead keys once the totals are in.
//   cluster_order_kernel after torch.sort of a group's keys: the setup
//                        metadata in x order, dead slots from candidate 0.
// and per frame:
//   pyramid_base_kernel   level 0 from the depth (3x3 min at the nearest
//                        texel, or the 2x2 min) in 32x32 tiles, with the
//                        tile's exact halvings down to 1x1 in shared memory.
//   pyramid_filter_kernel every level's 2x2 footprint min and the atlas's
//                        zero padding; block 0 first builds the levels below
//                        the tiles in shared memory.
//
// What bounds them: bytes.  The draw pass reads ~100 B a draw (mesh row,
// quaternion, scale, position, class, visibility, one LOD count and offset)
// and writes 11 B a draw and 28 B an emitted draw; the cluster pass reads
// 72 B a candidate (two rows of 32 B and one word); the pyramid reads the
// depth once and writes its [levels, ph, pw] atlas, padding included.  Every
// array is read once with consecutive threads on consecutive rows, and the
// compactions are single-pass (no count, scan and scatter kernels), so the
// layer is a few launches and a few hundred kB to tens of MB of traffic.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

constexpr int kTile = 256;  // draws or candidate slots a block (_build.CULL_TILE)
constexpr int kWarps = kTile / 32;
constexpr int kMaxGroups = 4;
constexpr int kMaxClasses = 8;
// draw status: 2 flag bits, emitted draws (26 bits), meshlets (36 bits, saturating)
constexpr unsigned long long kDrawAggregate = 1ull << 62;
constexpr unsigned long long kDrawPrefix = 2ull << 62;
constexpr int kEBits = 26;
constexpr long long kMSat = (1ll << 36) - 1;
constexpr int kPyrTile = 32;       // level-0 texels a pyramid tile side (_build.PYRAMID_TILE_LEVELS = 5 halvings)
constexpr int kPyrLevels = 16;
constexpr int kTailMax = 4096;     // texels of the largest level below the tiles (_build.PYRAMID_TAIL_MAX)

// counters (int64), the wrapper's zeroed buffer
enum { kNDraws = 0, kDrawDropped = 1, kNCand = 2, kClusterDropped = 3, kCount = 4, kFillDraw = 8, kFillMi = 9 };

}  // namespace

struct CullConsts {
  float view[12];  // rows 0-2 of the view matrix
  float p00, p11, znear, zfar;
  float frustum[4];
  float lod_target, pyramid_w, pyramid_h;
  int culling, lod, occlusion, cluster_occlusion, cluster_backface, post_pass;
};

// A pass's class groups: capacities, x-order constants, output arrays, and
// in merged mode the groups each class belongs to (a bit a group).
struct GroupSpec {
  int n;
  int cap[kMaxGroups], slot_bits[kMaxGroups];
  float half[kMaxGroups], hi[kMaxGroups];
  int* key[kMaxGroups];
  int* draw[kMaxGroups];
  int* mi[kMaxGroups];
  unsigned group_mask[kMaxClasses];
};

struct PyramidPlan {
  int levels, in_h, in_w, ph, pw, lt;  // lt: the last level the tiles build
  int h[kPyrLevels], w[kPyrLevels], two_x[kPyrLevels], ny[kPyrLevels], nx[kPyrLevels], uoff[kPyrLevels];
};

namespace {

// The compacted draw of an emitted draw (slot < draw capacity).
struct Entry {
  int draw, count, offset, visoff, cls, vis;
};

struct Atlas {
  const float* data;
  long long n;
  int h, w;
};

// torch.minimum / maximum / clamp on floats: NaN propagates
__device__ __forceinline__ float tmin(float a, float b) { return a != a ? a : (b != b ? b : fminf(a, b)); }
__device__ __forceinline__ float tmax(float a, float b) { return a != a ? a : (b != b ? b : fmaxf(a, b)); }
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clampf(float v, float lo, float hi) { return v != v ? v : fminf(fmaxf(v, lo), hi); }

// v + 2 cross(q.xyz, cross(q.xyz, v) + q.w v)  (cullmath.rotate_quat)
__device__ __forceinline__ void rot_quat(float qx, float qy, float qz, float qw, float px, float py, float pz,
                                         float& ox, float& oy, float& oz) {
  float tx = qy * pz - qz * py + qw * px;
  float ty = qz * px - qx * pz + qw * py;
  float tz = qx * py - qy * px + qw * pz;
  ox = px + 2.0f * (qy * tz - qz * ty);
  oy = py + 2.0f * (qz * tx - qx * tz);
  oz = pz + 2.0f * (qx * ty - qy * tx);
}

// cullmath.view_transform
__device__ __forceinline__ void view_xf(const CullConsts& p, float x, float y, float z, bool translate, float& ox,
                                        float& oy, float& oz) {
  ox = x * p.view[0] + y * p.view[1] + z * p.view[2];
  oy = x * p.view[4] + y * p.view[5] + z * p.view[6];
  oz = x * p.view[8] + y * p.view[9] + z * p.view[10];
  if (translate) {
    ox = ox + p.view[3];
    oy = oy + p.view[7];
    oz = oz + p.view[11];
  }
}

// cullmath.frustum_visible
__device__ __forceinline__ bool frustum_visible(float cx, float cy, float cz, float r, const CullConsts& p) {
  return cz * p.frustum[1] - fabsf(cx) * p.frustum[0] > -r && cz * p.frustum[3] - fabsf(cy) * p.frustum[2] > -r &&
         cz + r > p.znear && cz - r < p.zfar;
}

// cull._occluded: project_sphere, occlusion_mip, sample_pyramid_min
__device__ bool occluded(float cx, float cy, float cz, float r, const CullConsts& p, const Atlas& a) {
  if (!(cz >= r + p.znear)) return false;
  const float czr2 = cz * cz - r * r;
  const float vx = sqrtf(clamp_min(cx * cx + czr2, 0.0f));
  const float minx = (vx * cx - cz * r) / (vx * cz + cx * r);
  const float maxx = (vx * cx + cz * r) / (vx * cz - cx * r);
  const float vy = sqrtf(clamp_min(cy * cy + czr2, 0.0f));
  const float miny = (vy * cy - cz * r) / (vy * cz + cy * r);
  const float maxy = (vy * cy + cz * r) / (vy * cz - cy * r);
  const float a0 = minx * p.p00 * 0.5f + 0.5f;
  const float a1 = maxy * p.p11 * -0.5f + 0.5f;
  const float a2 = maxx * p.p00 * 0.5f + 0.5f;
  const float a3 = miny * p.p11 * -0.5f + 0.5f;

  const float size_x = (a2 - a0) * p.pyramid_w;
  const float size_y = (a3 - a1) * p.pyramid_h;
  float level = ceilf(log2f(clamp_min(tmax(size_x, size_y), 1e-12f)));
  const float fmip_w = p.pyramid_w * exp2f(1.0f - level);
  const float fmip_h = p.pyramid_h * exp2f(1.0f - level);
  const float fx = a0 * fmip_w;
  const float fy = a1 * fmip_h;
  const bool fits = (fx - floorf(fx)) + (a2 - a0) * fmip_w <= 2.0f && (fy - floorf(fy)) + (a3 - a1) * fmip_h <= 2.0f;
  level = clamp_min(level - (fits ? 1.0f : 0.0f), 0.0f);

  const long long lvl = (long long)level;
  const long long shift = lvl < 0 ? 0 : lvl > 62 ? 62 : lvl;
  const long long mip_w = max((long long)a.w >> shift, 1ll);
  const long long mip_h = max((long long)a.h >> shift, 1ll);
  const long long x0 = (long long)floorf((a0 + a2) * 0.5f * (float)mip_w - 0.5f);
  const long long y0 = (long long)floorf((a1 + a3) * 0.5f * (float)mip_h - 0.5f);
  const long long xc = min(max(x0, 0ll), mip_w - 1);
  const long long yc = min(max(y0, 0ll), mip_h - 1);
  const long long idx = min(max((lvl * a.h + yc) * a.w + xc, 0ll), a.n - 1);
  return p.znear / (cz - r) <= a.data[idx];
}

__device__ __forceinline__ unsigned long long pack_draw(long long e, long long m) {
  return ((unsigned long long)e << 36) | (unsigned long long)min(m, kMSat);
}

// draw_cull_kernel's look-back: exclusive (emitted, meshlets) of tile vb
__device__ void draw_look_back(const unsigned long long* status, int vb, int lane, long long& ex_e, long long& ex_m) {
  ex_e = 0;
  ex_m = 0;
  for (int j = vb - 1;;) {
    const int idx = j - lane;
    const unsigned long long s = idx >= 0 ? *(const volatile unsigned long long*)(status + idx) : kDrawPrefix;
    const unsigned flag = (unsigned)(s >> 62);
    const unsigned pmask = __ballot_sync(0xffffffffu, flag == 2u);
    const unsigned need = pmask ? (pmask & (0u - pmask)) * 2u - 1u : 0xffffffffu;
    if (__ballot_sync(0xffffffffu, flag == 0u) & need) continue;
    const bool mine = (need >> lane) & 1u;
    long long e = mine ? (long long)((s >> 36) & ((1ull << kEBits) - 1)) : 0;
    long long m = mine ? (long long)(s & (unsigned long long)kMSat) : 0;
    for (int o = 16; o > 0; o >>= 1) {
      e += __shfl_xor_sync(0xffffffffu, e, o);
      m += __shfl_xor_sync(0xffffffffu, m, o);
    }
    ex_e += e;
    ex_m = min(ex_m + m, kMSat);
    if (pmask) return;
    j -= 32;
  }
}

struct DrawIn {
  const float* mesh_row;  // [D, nr] center, radius, LOD count, LOD errors
  int nr;
  const float* orientation;  // [D,4]
  const float* scale;        // [D]
  const float* position;     // [D,3]
  const int* post_pass;      // [D]
  const int* draw_vis;       // [D]
  const int* lod_count;      // [D, nl] meshlets of each LOD
  const int* lod_offset;     // [D, nl]
  int nl;
  const int* vis_offset;  // [D]
  int D;
};

__global__ void __launch_bounds__(kTile)
    draw_cull_kernel(DrawIn in, Atlas atlas, CullConsts p, int late, int num_classes, int draw_cap,
                     long long cand_cap, int n_tiles, bool* emit_out, long long* lod_out, bool* vis_out, int* bases,
                     Entry* entries, long long* new_words, long long W, long long* cnt,
                     unsigned long long* status, unsigned* ticket) {
  __shared__ int s_vb, s_we[kWarps], s_wm[kWarps];
  __shared__ long long s_ex_e, s_ex_m, s_cand[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_vb = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int vb = s_vb;
  const int d = vb * kTile + tid;

  bool emit = false;
  int mc = 0, lodc = 0, pp = 0, dv = 0;
  if (d < in.D) {
    const float* row = in.mesh_row + (size_t)d * in.nr;
    const float* q = in.orientation + (size_t)d * 4;
    const float s = in.scale[d];
    float wx, wy, wz, cx, cy, cz;
    rot_quat(q[0], q[1], q[2], q[3], row[0], row[1], row[2], wx, wy, wz);
    wx = wx * s + in.position[(size_t)d * 3 + 0];
    wy = wy * s + in.position[(size_t)d * 3 + 1];
    wz = wz * s + in.position[(size_t)d * 3 + 2];
    view_xf(p, wx, wy, wz, true, cx, cy, cz);
    const float r = row[3] * s;
    pp = in.post_pass[d];
    dv = in.draw_vis[d];
    const bool in_pass = num_classes == 0 ? pp == p.post_pass : pp < num_classes;
    const bool pass_nonzero = num_classes == 0 ? p.post_pass != 0 : pp != 0;
    bool visible = frustum_visible(cx, cy, cz, r, p) || p.culling == 0;
    if (late && p.occlusion && visible) visible = !occluded(cx, cy, cz, r, p, atlas);
    visible = visible && in_pass;
    const bool new_vis = in_pass ? visible : dv != 0;
    emit = late ? visible && (p.cluster_occlusion == 1 || dv == 0 || pass_nonzero) : visible && dv != 0;

    // LOD from screen-space error: the highest i >= 1 with error < threshold
    const float dist = clamp_min(sqrtf(cx * cx + cy * cy + cz * cz) - r, 0.0f);
    const float threshold = dist * p.lod_target / s;
    const long long lod_count = (long long)row[4];
    long long lod = 0;
    for (int i = 1; i < in.nr - 5; ++i)
      if (row[5 + i] < threshold && i < lod_count) lod = i;
    if (!p.lod) lod = 0;
    emit_out[d] = emit;
    lod_out[d] = lod;
    vis_out[d] = new_vis;
    lodc = (int)min(max(lod, 0ll), (long long)min(in.nl - 1, 15));
    if (emit) mc = in.lod_count[(size_t)d * in.nl + lodc];
  }

  // the tile's ranks: emitted draws by ballot, meshlets by a warp scan
  const unsigned eb = __ballot_sync(0xffffffffu, emit);
  int ms = mc;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, ms, o);
    if (lane >= o) ms += t;
  }
  if (lane == 31) s_wm[warp] = ms;
  if (lane == 0) s_we[warp] = __popc(eb);
  __syncthreads();
  int e_rank = __popc(eb & ((1u << lane) - 1u)), m_excl = ms - mc, agg_e = 0;
  long long agg_m = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      e_rank += s_we[w];
      m_excl += s_wm[w];
    }
    agg_e += s_we[w];
    agg_m += s_wm[w];
  }
  if (tid == 0) *(volatile unsigned long long*)(status + vb) = (vb == 0 ? kDrawPrefix : kDrawAggregate) | pack_draw(agg_e, agg_m);
  if (warp == 0) {
    long long ex_e = 0, ex_m = 0;
    if (vb > 0) draw_look_back(status, vb, lane, ex_e, ex_m);
    if (lane == 0) {
      s_ex_e = ex_e;
      s_ex_m = ex_m;
      if (vb > 0) *(volatile unsigned long long*)(status + vb) = kDrawPrefix | pack_draw(ex_e + agg_e, ex_m + agg_m);
      if (vb == n_tiles - 1) {  // the last tile: every draw is counted
        const long long total = ex_e + agg_e;
        cnt[kNDraws] = min(total, (long long)draw_cap);
        if (total > draw_cap) atomicAdd((unsigned long long*)&cnt[kDrawDropped], (unsigned long long)(total - draw_cap));
      }
    }
  }
  __syncthreads();

  bool dropped = false;
  long long cand = 0;
  if (emit) {
    const long long e = s_ex_e + e_rank;
    if (e < draw_cap) {
      const long long base = min(s_ex_m + m_excl, kMSat);
      const bool fits = base + mc <= cand_cap;
      const int count = fits ? mc : 0;
      dropped = mc > 0 && !fits;
      cand = count;
      bases[e] = (int)min(base, (long long)INT_MAX);
      entries[e] = Entry{d, count, in.lod_offset[(size_t)d * in.nl + lodc], in.vis_offset[d], pp, dv != 0};
      if (new_words != nullptr && count > 0) {  // the late write-back's clear: both words of each touched pair
        const long long first = (long long)in.vis_offset[d] >> 6, last = ((long long)in.vis_offset[d] + count - 1) >> 6;
        for (long long pr = first; pr <= last; ++pr)
          for (long long w = 2 * pr; w < 2 * pr + 2; ++w)
            if (w < W) new_words[w] = 0;
      }
    }
  }
  const int n_dropped = __syncthreads_count(dropped);
  for (int o = 16; o > 0; o >>= 1) cand += __shfl_xor_sync(0xffffffffu, cand, o);
  if (lane == 0) s_cand[warp] = cand;
  __syncthreads();
  if (tid == 0) {
    long long c = 0;
    for (int w = 0; w < kWarps; ++w) c += s_cand[w];
    if (c) atomicAdd((unsigned long long*)&cnt[kNCand], (unsigned long long)c);
    if (n_dropped) atomicAdd((unsigned long long*)&cnt[kDrawDropped], (unsigned long long)n_dropped);
  }
}

struct ClusterIn {
  const int* bases;
  const Entry* entries;
  const int* lod_offset;  // the scene's [D, nl] table: candidate 0 with no emitted draw
  const float* cull_row;  // [M,8] center, radius, cone axis, cutoff
  int M;
  const float* xform;  // [D,8] position, scale, quaternion
  const long long* vis_words;
  long long W;
  long long* new_words;  // the late write-back's words, null without it
};

// the compacted draw owning candidate slot k: the last with base <= k
__device__ __forceinline__ int owner(const int* bases, int n, long long k) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (bases[mid] <= k)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(kTile)
    cluster_cull_kernel(ClusterIn in, Atlas atlas, CullConsts p, GroupSpec gs, int late, int multi, int cand_cap,
                        int n_tiles, long long* cnt, unsigned* status, unsigned* ticket) {
  __shared__ int s_vb, s_wc[kMaxGroups][kWarps], s_off[kMaxGroups], s_total[kMaxGroups];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_draws = (int)cnt[kNDraws];
  const long long n_cand = min(cnt[kNCand], (long long)cand_cap);
  const int n_live = (int)((n_cand + kTile - 1) / kTile);
  const unsigned all = (1u << gs.n) - 1u;
  const bool cluster_occ = p.cluster_occlusion == 1;

  for (;;) {
    if (tid == 0) s_vb = (int)atomicAdd(ticket, 1u);
    __syncthreads();
    const int vb = s_vb;
    if (vb >= n_live) break;
    const long long k = (long long)vb * kTile + tid;
    unsigned gm = 0;  // the groups this candidate survives into
    int draw = 0, mi = 0;
    float ratio = 0.0f;
    if (k < n_cand) {  // the fitting draws' slots are exactly [0, n_cand)
      const int j = owner(in.bases, n_draws, k);
      const Entry e = in.entries[j];
      const long long ordv = k - in.bases[j];
      draw = e.draw;
      mi = (int)min(max((long long)e.offset + ordv, 0ll), (long long)in.M - 1);
      const long long vis_slot = (long long)e.visoff + ordv;
      const float* row = in.cull_row + (size_t)mi * 8;
      const float* xf = in.xform + (size_t)draw * 8;
      const float s = xf[3];
      const float r = row[3] * s;
      float wx, wy, wz, cx, cy, cz;
      rot_quat(xf[4], xf[5], xf[6], xf[7], row[0], row[1], row[2], wx, wy, wz);
      view_xf(p, wx * s + xf[0], wy * s + xf[1], wz * s + xf[2], true, cx, cy, cz);

      const long long word = in.vis_words[min(max(vis_slot >> 5, 0ll), in.W - 1)];
      const long long bit = 1ll << (vis_slot & 31);
      const bool vis_bit = (word & bit) != 0;
      // the visibility skip and the cone cull gate on class 0
      const bool cls0 = multi ? e.cls == 0 : p.post_pass == 0;
      bool visible = true, skip = false;
      if (cluster_occ) {
        if (!late)
          visible = vis_bit || !cls0;
        else
          skip = cls0 && e.vis && vis_bit;
      }
      if (visible && p.cluster_backface == 1 && cls0) {
        float ax, ay, az, nx, ny, nz;
        rot_quat(xf[4], xf[5], xf[6], xf[7], row[4], row[5], row[6], ax, ay, az);
        view_xf(p, ax, ay, az, false, nx, ny, nz);
        const float dist = sqrtf(cx * cx + cy * cy + cz * cz);
        visible = !(cx * nx + cy * ny + cz * nz >= row[7] * dist + r);
      }
      visible = visible && frustum_visible(cx, cy, cz, r, p);
      if (late && cluster_occ && visible) visible = !occluded(cx, cy, cz, r, p, atlas);
      if (late && cluster_occ && visible && in.new_words != nullptr && (vis_slot >> 5) < in.W)
        atomicOr((unsigned long long*)(in.new_words + (vis_slot >> 5)), (unsigned long long)bit);
      if (visible && !skip) {
        if (!multi)
          gm = all;
        else if (e.cls >= 0 && e.cls < kMaxClasses)
          gm = gs.group_mask[e.cls];
        ratio = cx / clamp_min(cz, 1e-3f);
      }
    }

    int rank[kMaxGroups];
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      const unsigned b = __ballot_sync(0xffffffffu, (gm >> g) & 1u);
      rank[g] = __popc(b & ((1u << lane) - 1u));
      if (lane == 0) s_wc[g][warp] = __popc(b);
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (g >= gs.n) break;
      int agg = 0;
      for (int w = 0; w < kWarps; ++w) {
        rank[g] += w < warp ? s_wc[g][w] : 0;
        agg += s_wc[g][w];
      }
      unsigned* st = status + (size_t)g * n_tiles;
      if (tid == 0) *(volatile unsigned*)(st + vb) = (vb == 0 ? lookback::kPrefix : lookback::kAggregate) | (unsigned)agg;
      if (warp == g) {
        const int excl = vb == 0 ? 0 : lookback::look_back(st, vb, lane);
        if (lane == 0) {
          s_off[g] = excl;
          if (vb > 0) *(volatile unsigned*)(st + vb) = lookback::kPrefix | (unsigned)(excl + agg);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (g >= gs.n) break;
      const int slot = s_off[g] + rank[g];
      if ((gm >> g) & 1u && slot < gs.cap[g]) {
        const long long xq = (long long)clampf(ratio * 256.0f + gs.half[g], 0.0f, gs.hi[g]);
        gs.key[g][slot] = (int)((xq << gs.slot_bits[g]) | slot);
        gs.draw[g][slot] = draw;
        gs.mi[g][slot] = mi;
      }
    }
    __syncthreads();  // s_wc and s_off are free for the next tile
  }

  // the totals, then the dead keys (after every live one in the sort)
  if (tid < gs.n)
    s_total[tid] = n_live > 0 ? lookback::wait_prefix(status + (size_t)tid * n_tiles, n_live - 1) : 0;
  __syncthreads();
  const size_t stride = (size_t)gridDim.x * kTile, first = (size_t)blockIdx.x * kTile + tid;
  for (int g = 0; g < gs.n; ++g)
    for (size_t i = (size_t)min(s_total[g], gs.cap[g]) + first; i < (size_t)gs.cap[g]; i += stride) gs.key[g][i] = INT_MAX;
  if (blockIdx.x == 0 && tid == 0) {
    long long over = 0;
    for (int g = 0; g < gs.n; ++g) {
      cnt[kCount + g] = min(s_total[g], gs.cap[g]);
      over += max(s_total[g] - gs.cap[g], 0);
    }
    cnt[kClusterDropped] = over;
    // dead output slots repeat candidate 0: its draw when one fits, else
    // compacted draw 0 (draw 0 and its LOD-0 offset when none was emitted)
    const int j = n_cand > 0 ? owner(in.bases, n_draws, 0) : 0;
    const int off = n_draws > 0 ? in.entries[j].offset : in.lod_offset[0];
    cnt[kFillDraw] = n_draws > 0 ? in.entries[j].draw : 0;
    cnt[kFillMi] = min(max(off, 0), in.M - 1);
  }
}

__global__ void __launch_bounds__(kTile)
    cluster_order_kernel(const int* sorted, const int* sdraw, const int* smi, const long long* cnt, int g, int cap,
                         int slot_bits, const int* tri_count, int n_tri, const float* xform, const int* mat,
                         const int* post, long long* o_mi, int* o_tri, float* o_xform, long long* o_draw, int* o_mat,
                         int* o_post) {
  const int j = blockIdx.x * kTile + threadIdx.x;
  if (j >= cap) return;
  int draw, mi;
  if (j < cnt[kCount + g]) {
    const int s = sorted[j] & ((1 << slot_bits) - 1);
    draw = sdraw[s];
    mi = smi[s];
  } else {
    draw = (int)cnt[kFillDraw];
    mi = (int)cnt[kFillMi];
  }
  mi = min(max(mi, 0), n_tri - 1);
  o_mi[j] = mi;
  o_tri[j] = tri_count[mi];
  const float4* src = reinterpret_cast<const float4*>(xform + (size_t)draw * 8);
  float4* dst = reinterpret_cast<float4*>(o_xform + (size_t)j * 8);
  dst[0] = src[0];
  dst[1] = src[1];
  o_draw[j] = draw;
  o_mat[j] = mat[draw];
  o_post[j] = post[draw];
}

// ------------------------------------------------------------- pyramid

__device__ __forceinline__ float min4(const float* s, int w, int i, int j) {
  const float* a = s + (size_t)(2 * i) * w + 2 * j;
  return tmin(tmin(a[0], a[1]), tmin(a[w], a[w + 1]));
}

// pyramid._shift_min over rows, then over columns, read at (y, x)
__device__ __forceinline__ float min3x3(const float* s, int h, int w, int y, int x) {
  const int y1 = min(y + 1, h - 1), y2 = min(y + 2, h - 1);
  const int xs[3] = {x, min(x + 1, w - 1), min(x + 2, w - 1)};
  float r[3];
  for (int c = 0; c < 3; ++c) r[c] = tmin(s[(size_t)y * w + xs[c]], tmin(s[(size_t)y1 * w + xs[c]], s[(size_t)y2 * w + xs[c]]));
  return tmin(r[0], tmin(r[1], r[2]));
}

// one texel of a level from its source level (h, w): the 2x2 min, or the
// 3x3 min at the nearest source texel
__device__ __forceinline__ float reduce_texel(const PyramidPlan& pl, const int* index, int L, const float* src, int h,
                                              int w, int i, int j) {
  return pl.two_x[L] ? min4(src, w, i, j) : min3x3(src, h, w, index[pl.ny[L] + i], index[pl.nx[L] + j]);
}

// the footprint filter: min of the texel, its right, lower and lower-right neighbours (clamped)
__device__ __forceinline__ float footprint(const float* m, int h, int w, int i, int j) {
  const int i1 = min(i + 1, h - 1), j1 = min(j + 1, w - 1);
  return tmin(tmin(m[(size_t)i * w + j], m[(size_t)i * w + j1]), tmin(m[(size_t)i1 * w + j], m[(size_t)i1 * w + j1]));
}

__global__ void __launch_bounds__(kTile)
    pyramid_base_kernel(const float* depth, PyramidPlan pl, const int* index, float* u) {
  __shared__ float buf[2][kPyrTile * kPyrTile];
  const int ty0 = blockIdx.y * kPyrTile, tx0 = blockIdx.x * kPyrTile;
  for (int t = threadIdx.x; t < kPyrTile * kPyrTile; t += kTile) {
    const int r = t / kPyrTile, c = t % kPyrTile, i = ty0 + r, j = tx0 + c;
    if (i < pl.h[0] && j < pl.w[0]) {
      const float v = reduce_texel(pl, index, 0, depth, pl.in_h, pl.in_w, i, j);
      buf[0][t] = v;
      u[pl.uoff[0] + (size_t)i * pl.w[0] + j] = v;
    }
  }
  for (int L = 1; L <= pl.lt; ++L) {  // the tile's exact halvings
    __syncthreads();
    const int side = kPyrTile >> L;
    const float* src = buf[(L - 1) & 1];
    float* dst = buf[L & 1];
    for (int t = threadIdx.x; t < side * side; t += kTile) {
      const int r = t / side, c = t % side, i = (ty0 >> L) + r, j = (tx0 >> L) + c;
      if (i < pl.h[L] && j < pl.w[L]) {
        const float v = min4(src, 2 * side, r, c);
        dst[t] = v;
        u[pl.uoff[L] + (size_t)i * pl.w[L] + j] = v;
      }
    }
  }
}

__global__ void __launch_bounds__(kTile)
    pyramid_filter_kernel(PyramidPlan pl, const int* index, const float* u, float* atlas) {
  const int plane = pl.ph * pl.pw;
  if (blockIdx.x == 0) {  // the levels below the tiles, in shared memory
    __shared__ float tail[2][kTailMax];
    const float* src = u + pl.uoff[pl.lt];
    int h = pl.h[pl.lt], w = pl.w[pl.lt];
    for (int L = pl.lt + 1; L < pl.levels; ++L) {
      float* dst = tail[L & 1];
      const int oh = pl.h[L], ow = pl.w[L];
      for (int t = threadIdx.x; t < oh * ow; t += kTile) dst[t] = reduce_texel(pl, index, L, src, h, w, t / ow, t % ow);
      __syncthreads();
      for (int t = threadIdx.x; t < oh * ow; t += kTile)
        atlas[(size_t)L * plane + (size_t)(t / ow) * pl.pw + t % ow] = footprint(dst, oh, ow, t / ow, t % ow);
      src = dst;
      h = oh;
      w = ow;
      __syncthreads();
    }
    return;
  }
  const int t = (blockIdx.x - 1) * kTile + threadIdx.x;
  if (t >= pl.levels * plane) return;
  const int L = t / plane, rem = t - L * plane, i = rem / pl.pw, j = rem - i * pl.pw;
  float v = 0.0f;  // the padding past the level's size
  if (i < pl.h[L] && j < pl.w[L]) {
    if (L > pl.lt) return;  // block 0 writes it
    v = footprint(u + pl.uoff[L], pl.h[L], pl.w[L], i, j);
  }
  atlas[t] = v;
}

template <typename K>
int resident_blocks(K kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTile, 0);
  return sms * (per_sm > 0 ? per_sm : 1);
}

}  // namespace

// counters: the zeroed int64 [10] (n_draws, draw_dropped, n_candidates,
// cluster_dropped, 4 group counts, fill draw, fill meshlet); status: the
// zeroed tiles' words of ceil(D / kTile) tiles; ticket: a zeroed word.
// new_words: null, or the late write-back's copy of the words (W).
extern "C" int draw_cull_launch(const float* mesh_row, int nr, const float* orientation, const float* scale,
                                const float* position, const int* post_pass, const int* draw_vis,
                                const int* lod_count, const int* lod_offset, int nl, const int* vis_offset, int D,
                                const float* atlas, long long atlas_n, int atlas_h, int atlas_w, CullConsts p,
                                int late, int num_classes, int draw_cap, long long cand_cap, bool* emit,
                                long long* lod, bool* new_vis, int* bases, int* entries, long long* new_words,
                                long long W, long long* counters, unsigned long long* status, unsigned* ticket,
                                cudaStream_t stream) {
  const int n_tiles = (D + kTile - 1) / kTile;
  if (n_tiles == 0) return 0;
  DrawIn in{mesh_row, nr, orientation, scale, position, post_pass, draw_vis, lod_count, lod_offset, nl, vis_offset, D};
  draw_cull_kernel<<<n_tiles, kTile, 0, stream>>>(in, Atlas{atlas, atlas_n, atlas_h, atlas_w}, p, late, num_classes,
                                                  draw_cap, cand_cap, n_tiles, emit, lod, new_vis, bases,
                                                  reinterpret_cast<Entry*>(entries), new_words, W, counters, status,
                                                  ticket);
  return (int)cudaGetLastError();
}

// entries: draw_cull_launch's (6 ints a compacted draw); status: zeroed
// kMaxGroups * ceil(cand_cap / kTile) words; ticket: a zeroed word.
extern "C" int cluster_cull_launch(const int* bases, const int* entries, const int* lod_offset, const float* cull_row,
                                   int M, const float* xform, const long long* vis_words, long long W,
                                   long long* new_words, const float* atlas, long long atlas_n, int atlas_h,
                                   int atlas_w, CullConsts p, int late, int multi, int cand_cap, GroupSpec gs,
                                   long long* counters, unsigned* status, unsigned* ticket, cudaStream_t stream) {
  static int resident = 0;
  if (resident == 0) resident = resident_blocks(cluster_cull_kernel);
  const int n_tiles = (cand_cap + kTile - 1) / kTile;
  const int blocks = n_tiles < resident ? (n_tiles > 0 ? n_tiles : 1) : resident;
  ClusterIn in{bases, reinterpret_cast<const Entry*>(entries), lod_offset, cull_row, M, xform, vis_words, W, new_words};
  cluster_cull_kernel<<<blocks, kTile, 0, stream>>>(in, Atlas{atlas, atlas_n, atlas_h, atlas_w}, p, gs, late, multi,
                                                    cand_cap, n_tiles, counters, status, ticket);
  return (int)cudaGetLastError();
}

extern "C" int cluster_order_launch(const int* sorted, const int* sdraw, const int* smi, const long long* counters,
                                    int g, int cap, int slot_bits, const int* tri_count, int n_tri,
                                    const float* xform, const int* mat, const int* post, long long* o_mi, int* o_tri,
                                    float* o_xform, long long* o_draw, int* o_mat, int* o_post, cudaStream_t stream) {
  cluster_order_kernel<<<(cap + kTile - 1) / kTile, kTile, 0, stream>>>(sorted, sdraw, smi, counters, g, cap,
                                                                        slot_bits, tri_count, n_tri, xform, mat,
                                                                        post, o_mi, o_tri, o_xform, o_draw, o_mat,
                                                                        o_post);
  return (int)cudaGetLastError();
}

// u: the levels 0..lt the tiles build (plan.uoff); index: the nearest-texel
// tables of the levels that do not halve exactly.
extern "C" int pyramid_base_launch(const float* depth, PyramidPlan plan, const int* index, float* u,
                                   cudaStream_t stream) {
  const dim3 grid((plan.w[0] + kPyrTile - 1) / kPyrTile, (plan.h[0] + kPyrTile - 1) / kPyrTile);
  pyramid_base_kernel<<<grid, kTile, 0, stream>>>(depth, plan, index, u);
  return (int)cudaGetLastError();
}

extern "C" int pyramid_filter_launch(PyramidPlan plan, const int* index, const float* u, float* atlas,
                                     cudaStream_t stream) {
  const long long texels = (long long)plan.levels * plan.ph * plan.pw;
  pyramid_filter_kernel<<<(unsigned)(1 + (texels + kTile - 1) / kTile), kTile, 0, stream>>>(plan, index, u, atlas);
  return (int)cudaGetLastError();
}
