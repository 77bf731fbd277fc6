// Triangle transform + setup + ordered compaction for Hopper.
//
// Replaces niagara_tpu/ops/setup_fused.py::_setup_kernel, entered through
// setup_compact, in both static variants: no-alpha (_setup_kernel_noalpha)
// and alpha (_setup_kernel_alpha), the template flag kAlpha of setup_kernel.
// The alpha variant copies the triangle's opacity-mask row into record cols
// 48-55 for clusters of post class > 0 and writes exact zeros for the rest
// (a select: the mask table is read only for post clusters); the no-alpha
// instance has no mask code at all.  Plain torch twin: ops/setup.py::
// setup_plain, which follows the same op order; with --fmad=false both round
// op by op, so records agree bit for bit.
//
// One pass.  A block takes a group of kGroup whole clusters (kGroup * 96
// triangle slots, one thread each) by an atomic ticket, so every group
// before it has started:
//   1. each of the group's 64-corner meshlets is transformed once into
//      shared memory (load_corner's op order, so a corner's value does not
//      depend on the thread that computed it), and the slots read their
//      three corners from there;
//   2. each slot is evaluated once; warp ballots rank the survivors inside
//      the block, and the block publishes its count;
//   3. the survivors' records are built in shared memory at their ranks
//      while warp 0 finds the block's output offset by a decoupled
//      look-back over the earlier groups' published counts and prefixes
//      (one 32-bit status word per group: 2 flag bits, 30 value bits), so
//      the output keeps the flat slot order (cluster * 96 + triangle) and
//      fragment ids (frag_offset + compacted index) without a second pass
//      or a bare atomic cursor;
//   4. the block's records, one contiguous range of rows, go out with
//      16-byte stores; the AABB planes, tri_k/tri_t and `valid` at
//      consecutive addresses.
// The grid is persistent: its blocks loop over tickets until the live
// groups run out, then zero the rows past the final count (the contract:
// rows past `count` are zero) and write count and dropped once the last
// live group has published its prefix --
// so only those rows are written twice, never the whole capacity, and a
// late pass with one live cluster costs one group and the zeroing.
// The status words and the ticket are zeroed by the wrapper (n_groups + 1
// words).
//
// What bounds it: per live slot ~250 f32 ops of setup and per meshlet
// vertex ~60 of transform, against 224 + 20 bytes out per survivor and the
// zeroed tail; the shared-memory record stage (kGroup * 96 * 224 bytes)
// limits residency to four blocks of 192 threads an SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

constexpr int kMaxTri = 96;
constexpr int kMaxVtx = 64;
constexpr int kRec = 56;
constexpr int kGroup = 2;                   // clusters per block iteration
constexpr int kThreads = kGroup * kMaxTri;  // one thread per triangle slot
constexpr int kWarps = kThreads / 32;
using lookback::kAggregate;
using lookback::kPrefix;

}  // namespace

struct SetupParams {
  float view[12];  // rows 0-2 of the view matrix
  float p00, p11, znear, width, height;
};

namespace {

struct SetupIn {
  const long long* cluster_count;
  const long long* mi;
  const int* tri_count;
  const float* xform;  // [K,8] position, scale, quaternion xyzw
  const long long* draw_id;
  const int* mat_index;
  const int* post_pass;
  int K;
  const int* tris;      // [M,96,3]
  const float* vdata;   // [M,64,8]
  const int* vertices;  // [M,64]
  const float* alpha;   // [M,8,128] opacity-mask rows, channel-major (alpha variant only)
  SetupParams p;
};

struct Corner {
  float hx, hy, w, zw, nx, ny, nz, u, v, vid;
};

__device__ __forceinline__ void rot_quat(float qx, float qy, float qz, float qw, float px, float py,
                                         float pz, float& ox, float& oy, float& oz) {
  float txq = qy * pz - qz * py + qw * px;
  float tyq = qz * px - qx * pz + qw * py;
  float tzq = qx * py - qy * px + qw * pz;
  ox = px + 2.0f * (qy * tzq - qz * tyq);
  oy = py + 2.0f * (qz * txq - qx * tzq);
  oz = pz + 2.0f * (qx * tyq - qy * txq);
}

__device__ __forceinline__ Corner load_corner(const SetupIn& in, long long m, int li, const float* xf) {
  const float* vd = in.vdata + ((size_t)m * kMaxVtx + li) * 8;
  const SetupParams& p = in.p;
  float qx = xf[4], qy = xf[5], qz = xf[6], qw = xf[7];
  float wx, wy, wz;
  rot_quat(qx, qy, qz, qw, vd[0], vd[1], vd[2], wx, wy, wz);
  wx = wx * xf[3] + xf[0];
  wy = wy * xf[3] + xf[1];
  wz = wz * xf[3] + xf[2];
  float camx = p.view[0] * wx + p.view[1] * wy + p.view[2] * wz + p.view[3];
  float camy = p.view[4] * wx + p.view[5] * wy + p.view[6] * wz + p.view[7];
  float viewz = p.view[8] * wx + p.view[9] * wy + p.view[10] * wz + p.view[11];
  float safe_z = fabsf(viewz) < 1e-12f ? 1e-12f : viewz;
  Corner c;
  c.zw = p.znear / safe_z;
  float hx = (p.p00 * camx * 0.5f + 0.5f * viewz) * p.width;
  float hy = (0.5f * viewz - p.p11 * camy * 0.5f) * p.height;
  if (viewz > 1e-9f) {  // 1/256 subpixel snap; rintf rounds half to even like jnp.round
    hx = rintf(hx / safe_z * 256.0f) * (1.0f / 256.0f) * viewz;
    hy = rintf(hy / safe_z * 256.0f) * (1.0f / 256.0f) * viewz;
  }
  c.hx = hx;
  c.hy = hy;
  c.w = viewz;
  rot_quat(qx, qy, qz, qw, vd[3], vd[4], vd[5], c.nx, c.ny, c.nz);
  c.u = vd[6];
  c.v = vd[7];
  c.vid = (float)in.vertices[(size_t)m * kMaxVtx + li];
  return c;
}

__device__ __forceinline__ float finite_or_zero(float x) { return isfinite(x) ? x : 0.0f; }

// min/max that propagate NaN, like torch.minimum/maximum (fminf/fmaxf drop it)
__device__ __forceinline__ float nmin(float a, float b) { return isnan(a) || isnan(b) ? a + b : fminf(a, b); }
__device__ __forceinline__ float nmax(float a, float b) { return isnan(a) || isnan(b) ? a + b : fmaxf(a, b); }

// What a slot's setup yields besides its corners: edges, depth plane, box.
struct Tri {
  float e[9], z[3], box[4], sx[3], sy[3];
};

// Setup of the triangle with corners A, B, C of a cluster of post class
// `post`; returns validity (raster.compact_setup's tests) and fills `o`.
__device__ __forceinline__ bool eval_tri(const Corner& A, const Corner& B, const Corner& C, int post,
                                         const SetupParams& p, Tri& o) {
  const float W = p.width, H = p.height;
  // negated adjugate rows (Olano-Greer homogeneous edges)
  float* e = o.e;
  e[0] = A.w * B.hy - A.hy * B.w, e[1] = A.hx * B.w - A.w * B.hx, e[2] = A.hy * B.hx - A.hx * B.hy;  // eAB
  e[3] = B.w * C.hy - B.hy * C.w, e[4] = B.hx * C.w - B.w * C.hx, e[5] = B.hy * C.hx - B.hx * C.hy;  // eBC
  e[6] = C.w * A.hy - C.hy * A.w, e[7] = C.hx * A.w - C.w * A.hx, e[8] = C.hy * A.hx - C.hx * A.hy;  // eCA
  float det = A.hx * e[3] + A.hy * e[4] + A.w * e[5];
  bool front = det > 0.0f;
  float inv_det = fabsf(det) < 1e-30f ? 0.0f : 1.0f / det;
  float ka = A.zw * A.w, kb = B.zw * B.w, kc = C.zw * C.w;
  float za = (ka * e[3] + kb * e[6] + kc * e[0]) * inv_det;
  float zb = (ka * e[4] + kb * e[7] + kc * e[1]) * inv_det;
  float zc = (ka * e[5] + kb * e[8] + kc * e[2]) * inv_det;

  // post classes render double-sided with a reverse-Z depth bias
  bool flip = post > 0 && det < 0.0f;
  float sgn = flip ? -1.0f : 1.0f;
  for (int i = 0; i < 9; ++i) e[i] = e[i] * sgn;
  float zbias = post > 0 ? 1.0f + 1.9073486328125e-06f : 1.0f;  // 1 + 2^-19
  za = za * zbias;
  zb = zb * zbias;
  zc = zc * zbias;
  front = front || flip;

  bool zfin = nmax(nmax(fabsf(za), fabsf(zb)), fabsf(zc)) < 1e30f;
  if (!zfin) za = zb = zc = 0.0f;
  front = front && zfin;
  o.z[0] = za;
  o.z[1] = zb;
  o.z[2] = zc;

  const Corner* cs[3] = {&A, &B, &C};
  for (int i = 0; i < 3; ++i) {
    float w = cs[i]->w > 1e-9f ? cs[i]->w : 1e-9f;
    o.sx[i] = cs[i]->hx / w;
    o.sy[i] = cs[i]->hy / w;
  }
  bool behind_any = A.w <= 1e-9f || B.w <= 1e-9f || C.w <= 1e-9f;
  bool all_behind = A.w < p.znear && B.w < p.znear && C.w < p.znear;
  float x0f = behind_any ? 0.0f : floorf(nmin(nmin(o.sx[0], o.sx[1]), o.sx[2]));
  float y0f = behind_any ? 0.0f : floorf(nmin(nmin(o.sy[0], o.sy[1]), o.sy[2]));
  float x1f = behind_any ? W : ceilf(nmax(nmax(o.sx[0], o.sx[1]), o.sx[2]));
  float y1f = behind_any ? H : ceilf(nmax(nmax(o.sy[0], o.sy[1]), o.sy[2]));
  bool on_screen = x1f > 0.0f && y1f > 0.0f && x0f < W && y0f < H;
  o.box[0] = nmin(nmax(x0f, 0.0f), W - 1.0f);
  o.box[1] = nmin(nmax(y0f, 0.0f), H - 1.0f);
  o.box[2] = nmin(nmax(x1f, 0.0f), W);
  o.box[3] = nmin(nmax(y1f, 0.0f), H);
  return front && !all_behind && on_screen && o.box[2] > o.box[0] && o.box[3] > o.box[1];
}

template <bool kAlpha>
__global__ void __launch_bounds__(kThreads) setup_kernel(SetupIn in, int capacity, int n_groups, unsigned* status,
                                                         float* rec_out, int* aabb_out, long long* tri_k,
                                                         long long* tri_t, bool* valid_out, long long* counts) {
  __shared__ __align__(16) float stage[kThreads * kRec];  // the group's records, at their ranks
  __shared__ Corner corners[kGroup * kMaxVtx];
  __shared__ int warp_counts[kWarps];
  __shared__ int s_vb, s_offset, s_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long count = *in.cluster_count;
  const int live = (int)(count < 0 ? 0 : count < in.K ? count : in.K);
  const int n_live = (live + kGroup - 1) / kGroup;
  unsigned* ticket = status + n_groups;

  for (;;) {
    if (tid == 0) s_vb = (int)atomicAdd(ticket, 1u);
    __syncthreads();
    const int vb = s_vb;
    if (vb >= n_live) break;  // groups past the live clusters: one compare
    const int k0 = vb * kGroup;
    if (tid < kGroup * kMaxVtx) {  // each meshlet vertex of the group, once
      const int k = k0 + tid / kMaxVtx;
      if (k < live) corners[tid] = load_corner(in, in.mi[k], tid % kMaxVtx, in.xform + (size_t)k * 8);
    }
    __syncthreads();

    const int c = tid / kMaxTri, t = tid - c * kMaxTri, k = k0 + c;
    Tri o;
    int li[3] = {0, 0, 0}, post = 0;
    bool valid = false;
    if (k < live && t < in.tri_count[k]) {
      const int* tri = in.tris + ((size_t)in.mi[k] * kMaxTri + t) * 3;
      for (int i = 0; i < 3; ++i) li[i] = c * kMaxVtx + tri[i];
      post = in.post_pass[k];
      valid = eval_tri(corners[li[0]], corners[li[1]], corners[li[2]], post, in.p, o);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, valid);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int rank = __popc(ballot & ((1u << lane) - 1u)), agg = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int n = warp_counts[w];
      rank += w < warp ? n : 0;
      agg += n;
    }
    if (tid == 0) *(volatile unsigned*)(status + vb) = (vb == 0 ? kPrefix : kAggregate) | (unsigned)agg;

    float box[4];
    if (valid) {  // the record at its rank; col 13 (the compacted index) once the offset is known
      float* r = stage + rank * kRec;
      for (int i = 0; i < 9; ++i) r[i] = finite_or_zero(o.e[i]);
      for (int i = 0; i < 3; ++i) r[9 + i] = finite_or_zero(o.z[i]);
      for (int i = 0; i < 4; ++i) box[i] = finite_or_zero(o.box[i]);
      r[12] = box[0];
      r[14] = box[2];
      r[15] = box[3];
      for (int i = 0; i < 3; ++i) {
        const Corner& q = corners[li[i]];
        float* rc = r + 16 + 8 * i;
        rc[0] = finite_or_zero(o.sx[i]);
        rc[1] = finite_or_zero(o.sy[i]);
        rc[2] = finite_or_zero(q.w);
        rc[3] = finite_or_zero(q.nx);
        rc[4] = finite_or_zero(q.ny);
        rc[5] = finite_or_zero(q.nz);
        rc[6] = finite_or_zero(q.u);
        rc[7] = finite_or_zero(q.v);
        r[40 + i] = finite_or_zero(q.vid);
      }
      r[43] = finite_or_zero((float)in.draw_id[k]);
      r[44] = finite_or_zero((float)in.mat_index[k]);
      r[45] = finite_or_zero((float)post);
      r[46] = finite_or_zero((float)(k * kMaxTri + t));
      r[47] = 0.0f;
      if (kAlpha && post > 0) {  // cols 48-55: this triangle's mask row
        const float* mask = in.alpha + (size_t)in.mi[k] * 8 * 128 + t;
        for (int i = 0; i < 8; ++i) r[48 + i] = finite_or_zero(mask[i * 128]);
      } else {
        for (int i = 0; i < 8; ++i) r[48 + i] = 0.0f;
      }
    }
    if (warp == 0) {
      const int excl = vb == 0 ? 0 : lookback::look_back(status, vb, lane);
      if (lane == 0) {
        s_offset = excl;
        if (vb > 0) *(volatile unsigned*)(status + vb) = kPrefix | (unsigned)(excl + agg);
      }
    }
    __syncthreads();
    const int offset = s_offset;
    const int slot = offset + rank;
    if (valid && slot < capacity) {
      stage[rank * kRec + 13] = (float)slot;  // fragment ids = compacted index + pass offset
      for (int i = 0; i < 4; ++i) aabb_out[(size_t)i * capacity + slot] = (int)box[i];
      tri_k[slot] = k;
      tri_t[slot] = t;
      valid_out[slot] = true;
    }
    __syncthreads();
    const int n_out = max(0, min(agg, capacity - offset));
    const float4* src = reinterpret_cast<const float4*>(stage);
    float4* dst = reinterpret_cast<float4*>(rec_out + (size_t)offset * kRec);
    for (int i = tid; i < n_out * (kRec / 4); i += kThreads) dst[i] = src[i];
    __syncthreads();  // stage and corners are free for the next group
  }

  // rows past the count: zero, once the last live group has its prefix
  if (tid == 0) {
    s_total = n_live > 0 ? lookback::wait_prefix(status, n_live - 1) : 0;  // no live group: the count is 0
    if (blockIdx.x == 0) {
      counts[0] = min(s_total, capacity);       // count
      counts[1] = max(s_total - capacity, 0);  // dropped
    }
  }
  __syncthreads();
  const int lo = min(s_total, capacity);
  const size_t stride = (size_t)gridDim.x * kThreads, first = (size_t)blockIdx.x * kThreads + tid;
  float4* rz = reinterpret_cast<float4*>(rec_out + (size_t)lo * kRec);
  const size_t n4 = (size_t)(capacity - lo) * (kRec / 4);
  for (size_t i = first; i < n4; i += stride) rz[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (size_t i = first; i < (size_t)(capacity - lo); i += stride) {
    for (int j = 0; j < 4; ++j) aabb_out[(size_t)j * capacity + lo + i] = 0;
    tri_k[lo + i] = 0;
    tri_t[lo + i] = 0;
    valid_out[lo + i] = false;
  }
}

template <bool kAlpha>
int launch(const SetupIn& in, int capacity, unsigned* status, float* rec, int* aabb, long long* tri_k,
           long long* tri_t, bool* valid, long long* counts, cudaStream_t stream) {
  static int resident = 0;  // blocks of this kernel the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, setup_kernel<kAlpha>, kThreads, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int n_groups = (in.K + kGroup - 1) / kGroup;
  const int blocks = n_groups < resident ? (n_groups > 0 ? n_groups : 1) : resident;
  setup_kernel<kAlpha><<<blocks, kThreads, 0, stream>>>(in, capacity, n_groups, status, rec, aabb, tri_k, tri_t,
                                                        valid, counts);
  return (int)cudaGetLastError();
}

}  // namespace

// alpha == nullptr launches the no-alpha variant, else the alpha variant.
// status: setup_group()'s groups of K clusters + 1 zeroed words (group
// status, then the ticket).  Outputs: rec [capacity, 56], aabb [4,
// capacity], tri_k/tri_t [capacity], valid [capacity], counts = (count,
// dropped).
extern "C" int setup_launch(const long long* cluster_count, const long long* mi, const int* tri_count,
                            const float* xform, const long long* draw_id, const int* mat_index,
                            const int* post_pass, int K, const int* tris, const float* vdata,
                            const int* vertices, const float* alpha, SetupParams params, int capacity,
                            unsigned* status, float* rec, int* aabb, long long* tri_k, long long* tri_t, bool* valid,
                            long long* counts, cudaStream_t stream) {
  SetupIn in{cluster_count, mi, tri_count, xform, draw_id, mat_index, post_pass, K, tris, vdata,
             vertices, alpha, params};
  return alpha != nullptr ? launch<true>(in, capacity, status, rec, aabb, tri_k, tri_t, valid, counts, stream)
                          : launch<false>(in, capacity, status, rec, aabb, tri_k, tri_t, valid, counts, stream);
}

// Clusters per block iteration: the wrapper sizes the status array from it.
extern "C" int setup_group() { return kGroup; }
