// Triangle transform + setup + ordered compaction for Hopper.
//
// Replaces niagara_tpu/ops/setup_fused.py::_setup_kernel, entered through
// setup_compact, in both static variants: no-alpha (_setup_kernel_noalpha)
// and alpha (_setup_kernel_alpha), the template flag kAlpha of setup_scatter.
// The alpha variant copies the triangle's opacity-mask row into record cols
// 48-55 for clusters of post class > 0 and writes exact zeros for the rest
// (a select: the mask table is read only for post clusters); the no-alpha
// instance has no mask code at all.  Plain torch twin: ops/setup.py::
// setup_plain, which follows the same op order; with --fmad=false both round
// op by op, so records agree bit for bit.
//
// What bounds it here: per live triangle slot ~250 f32 ops and ~110 bytes of
// corner reads (three [64,8] f32 vertex rows per cluster, shared by its 96
// slots and L2-resident), then 224+28 bytes of record out per survivor.  At
// the headline capacity (65,536 clusters = 6.3M slots) it is latency- and
// occupancy-bound, not bandwidth-bound.  The TPU kernel's bf16 corner splits,
// one-hot MXU placement and VMEM windows have no purpose here: one thread per
// (cluster, triangle) slot reads its corners straight from f32 meshlet_vdata.
//
// Compaction must keep the reference's prefix order (fragment ids are
// frag_offset + compacted index), so it is three deterministic steps instead
// of an atomic cursor:
//   1. setup_count:   per block of 256 slots, the number of valid triangles;
//   2. setup_scan:    one block scans the block counts -> block offsets + total;
//   3. setup_scatter: recompute each slot, rank it inside its block with warp
//                     ballots, write the record at block offset + rank.
// Slots of clusters at or past the live count cost one compare.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTri = 96;
constexpr int kMaxVtx = 64;
constexpr int kRec = 56;
constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;

}  // namespace

struct SetupParams {
  float view[12];  // rows 0-2 of the view matrix
  float p00, p11, znear, width, height;
};

namespace {

struct SetupIn {
  const long long* cluster_count;
  const int* mi;
  const int* tri_count;
  const float* xform;  // [K,8] position, scale, quaternion xyzw
  const int* draw_id;
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

__device__ __forceinline__ Corner load_corner(const SetupIn& in, int m, int li, const float* xf) {
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

// Evaluates triangle slot `flat`; returns validity and, when `rec` is given,
// fills the record (col 13 still holds y0) and the integer AABB.
__device__ __forceinline__ bool eval_slot(const SetupIn& in, long long live_count, int flat, float* rec,
                                          int* box) {
  int k = flat / kMaxTri;
  int t = flat - k * kMaxTri;
  if (k >= in.K || k >= live_count || t >= in.tri_count[k]) return false;
  int m = in.mi[k];
  const float* xf = in.xform + (size_t)k * 8;
  const int* tri = in.tris + ((size_t)m * kMaxTri + t) * 3;
  Corner A = load_corner(in, m, tri[0], xf);
  Corner B = load_corner(in, m, tri[1], xf);
  Corner C = load_corner(in, m, tri[2], xf);
  const float W = in.p.width, H = in.p.height;

  // negated adjugate rows (Olano-Greer homogeneous edges)
  float e[9] = {
      A.w * B.hy - A.hy * B.w, A.hx * B.w - A.w * B.hx, A.hy * B.hx - A.hx * B.hy,  // eAB
      B.w * C.hy - B.hy * C.w, B.hx * C.w - B.w * C.hx, B.hy * C.hx - B.hx * C.hy,  // eBC
      C.w * A.hy - C.hy * A.w, C.hx * A.w - C.w * A.hx, C.hy * A.hx - C.hx * A.hy,  // eCA
  };
  float det = A.hx * e[3] + A.hy * e[4] + A.w * e[5];
  bool front = det > 0.0f;
  float inv_det = fabsf(det) < 1e-30f ? 0.0f : 1.0f / det;
  float ka = A.zw * A.w, kb = B.zw * B.w, kc = C.zw * C.w;
  float za = (ka * e[3] + kb * e[6] + kc * e[0]) * inv_det;
  float zb = (ka * e[4] + kb * e[7] + kc * e[1]) * inv_det;
  float zc = (ka * e[5] + kb * e[8] + kc * e[2]) * inv_det;

  // post classes render double-sided with a reverse-Z depth bias
  int post = in.post_pass[k];
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

  float sx[3], sy[3];
  const Corner* cs[3] = {&A, &B, &C};
  for (int i = 0; i < 3; ++i) {
    float w = cs[i]->w > 1e-9f ? cs[i]->w : 1e-9f;
    sx[i] = cs[i]->hx / w;
    sy[i] = cs[i]->hy / w;
  }
  bool behind_any = A.w <= 1e-9f || B.w <= 1e-9f || C.w <= 1e-9f;
  bool all_behind = A.w < in.p.znear && B.w < in.p.znear && C.w < in.p.znear;
  float x0f = behind_any ? 0.0f : floorf(nmin(nmin(sx[0], sx[1]), sx[2]));
  float y0f = behind_any ? 0.0f : floorf(nmin(nmin(sy[0], sy[1]), sy[2]));
  float x1f = behind_any ? W : ceilf(nmax(nmax(sx[0], sx[1]), sx[2]));
  float y1f = behind_any ? H : ceilf(nmax(nmax(sy[0], sy[1]), sy[2]));
  bool on_screen = x1f > 0.0f && y1f > 0.0f && x0f < W && y0f < H;
  float x0d = nmin(nmax(x0f, 0.0f), W - 1.0f);
  float y0d = nmin(nmax(y0f, 0.0f), H - 1.0f);
  float x1d = nmin(nmax(x1f, 0.0f), W);
  float y1d = nmin(nmax(y1f, 0.0f), H);
  bool valid = front && !all_behind && on_screen && x1d > x0d && y1d > y0d;
  if (!valid || rec == nullptr) return valid;

  for (int i = 0; i < 9; ++i) rec[i] = e[i];
  rec[9] = za;
  rec[10] = zb;
  rec[11] = zc;
  rec[12] = x0d;
  rec[13] = y0d;
  rec[14] = x1d;
  rec[15] = y1d;
  for (int i = 0; i < 3; ++i) {
    float* r = rec + 16 + 8 * i;
    r[0] = sx[i];
    r[1] = sy[i];
    r[2] = cs[i]->w;
    r[3] = cs[i]->nx;
    r[4] = cs[i]->ny;
    r[5] = cs[i]->nz;
    r[6] = cs[i]->u;
    r[7] = cs[i]->v;
  }
  rec[40] = A.vid;
  rec[41] = B.vid;
  rec[42] = C.vid;
  rec[43] = (float)in.draw_id[k];
  rec[44] = (float)in.mat_index[k];
  rec[45] = (float)post;
  rec[46] = (float)flat;
  for (int i = 0; i < 47; ++i) rec[i] = finite_or_zero(rec[i]);
  box[0] = (int)rec[12];
  box[1] = (int)rec[13];
  box[2] = (int)rec[14];
  box[3] = (int)rec[15];
  return true;
}

__global__ void setup_count(SetupIn in, int* block_counts) {
  __shared__ int warp_counts[kThreads / 32];
  long long live = *in.cluster_count;
  int first = blockIdx.x * kThreads;
  if (first / kMaxTri >= live) {  // whole block past the live clusters
    if (threadIdx.x == 0) block_counts[blockIdx.x] = 0;
    return;
  }
  bool valid = eval_slot(in, live, first + threadIdx.x, nullptr, nullptr);
  unsigned ballot = __ballot_sync(0xffffffffu, valid);
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_counts[w];
    block_counts[blockIdx.x] = s;
  }
}

// One block: exclusive scan of the per-block counts, plus the total.
__global__ void setup_scan(const int* block_counts, int n_blocks, int* block_offsets, int* total) {
  __shared__ int sums[kScanThreads];
  int tid = threadIdx.x;
  int per = (n_blocks + kScanThreads - 1) / kScanThreads;
  int lo = min(tid * per, n_blocks), hi = min(lo + per, n_blocks);
  int own = 0;
  for (int i = lo; i < hi; ++i) own += block_counts[i];
  sums[tid] = own;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {  // inclusive Hillis-Steele scan
    int add = tid >= off ? sums[tid - off] : 0;
    __syncthreads();
    sums[tid] += add;
    __syncthreads();
  }
  int run = sums[tid] - own;
  for (int i = lo; i < hi; ++i) {
    block_offsets[i] = run;
    run += block_counts[i];
  }
  if (tid == kScanThreads - 1) *total = sums[tid];
}

template <bool kAlpha>
__global__ void setup_scatter(SetupIn in, const int* block_offsets, int capacity, float* rec_out,
                              int* aabb_out, int* flat_out) {
  __shared__ int warp_counts[kThreads / 32];
  long long live = *in.cluster_count;
  int first = blockIdx.x * kThreads;
  if (first / kMaxTri >= live) return;
  int flat = first + threadIdx.x;
  float rec[kRec];
  int box[4];
  bool valid = eval_slot(in, live, flat, rec, box);
  unsigned ballot = __ballot_sync(0xffffffffu, valid);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_counts[warp] = __popc(ballot);
  __syncthreads();
  int rank = __popc(ballot & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) rank += warp_counts[w];
  int slot = block_offsets[blockIdx.x] + rank;
  if (!valid || slot >= capacity) return;
  rec[13] = (float)slot;  // fragment ids = compacted index + pass offset
  float* dst = rec_out + (size_t)slot * kRec;
  for (int i = 0; i < 47; ++i) dst[i] = rec[i];  // col 47 stays zero
  if (kAlpha && in.post_pass[flat / kMaxTri] > 0) {  // cols 48-55: this triangle's mask row
    const int k = flat / kMaxTri, t = flat - k * kMaxTri;
    const float* mask = in.alpha + (size_t)in.mi[k] * 8 * 128 + t;
    for (int i = 0; i < 8; ++i) dst[48 + i] = finite_or_zero(mask[i * 128]);
  }  // else cols 48-55 stay zero
  for (int i = 0; i < 4; ++i) aabb_out[(size_t)i * capacity + slot] = box[i];
  flat_out[slot] = flat;
}

}  // namespace

// alpha == nullptr launches the no-alpha variant, else the alpha variant.
extern "C" int setup_launch(const long long* cluster_count, const int* mi, const int* tri_count,
                            const float* xform, const int* draw_id, const int* mat_index,
                            const int* post_pass, int K, const int* tris, const float* vdata,
                            const int* vertices, const float* alpha, SetupParams params, int capacity,
                            int* block_counts, int* block_offsets, int* total, float* rec, int* aabb,
                            int* flat, cudaStream_t stream) {
  SetupIn in{cluster_count, mi, tri_count, xform, draw_id, mat_index, post_pass, K, tris, vdata,
             vertices, alpha, params};
  int n_blocks = (K * kMaxTri + kThreads - 1) / kThreads;
  setup_count<<<n_blocks, kThreads, 0, stream>>>(in, block_counts);
  setup_scan<<<1, kScanThreads, 0, stream>>>(block_counts, n_blocks, block_offsets, total);
  if (alpha != nullptr)
    setup_scatter<true><<<n_blocks, kThreads, 0, stream>>>(in, block_offsets, capacity, rec, aabb, flat);
  else
    setup_scatter<false><<<n_blocks, kThreads, 0, stream>>>(in, block_offsets, capacity, rec, aabb, flat);
  return (int)cudaGetLastError();
}
