// Tile rasterizer for Hopper: visibility buffer resolve over tile-sorted pairs.
//
// Replaces niagara_tpu/ops/raster_tile.py::_raster_kernel, entered through
// rasterize_tiles, in all its variants.  Two are static (the template flag
// kAlpha): opaque (alpha_test=False) and alpha_test (raster_tile.py:440-468),
// which the merged late stream of an alpha-classed frame and every sun-map
// raster of a scene with masks run.  The row_window variant (raster_tile.py:393,
// the sun map's dirty-band update) is the runtime argument band_row0 of both:
// the framebuffer is a band of tile rows whose first row is full-grid tile row
// band_row0, coverage is tested at full-grid pixel rows and the result stored
// at the band's own rows, so a band equals the matching rows of a full render;
// a launch on a whole framebuffer passes 0.  Plain torch twin:
// ops/raster_tile.py::raster_plain.
//
// Work follows the pixels a triangle can cover.  A record is tested only on
// the pixels of its tile inside its clip box: the bounding box of the
// triangle its three edge equations bound, each edge first moved outward by
// the most its f32 evaluation over the tile can be off (2^-21 of |a| x_max
// + |b| y_max + |c|), computed in double; where the three edges bound no
// finite triangle (their normals do not span the plane) the clip is the
// whole tile.  No pixel the edge tests can pass lies outside it, so the
// result is raster_plain's.  The setup's own box (cols 12-15, from the
// snapped corners) is not such a bound: a short edge far from the origin
// has coefficients whose f32 rounding moves its line by up to a quarter
// pixel, and where it meets a nearly parallel edge the triangle's tip moves
// by pixels -- on the headline frame 90 of 12.6M covered (pair, pixel)
// tests lie outside the setup box, up to 13 pixels from it (ROADMAP.md,
// queue C; tests/test_torch_raster_box.py).  The clip boxes of a batch are
// computed once, by one thread each.
//
// One warp takes one record, holds it in registers and spreads its clip box
// over the lanes: a box up to 32 wide as 32 / w rows of w lanes, a wider one
// row by row.  Each covered pixel folds the 64-bit key (depth bits << 32) |
// (0xFFFFFFFF - id) into the tile's key array in shared memory with
// atomicMax (after a plain read that skips the atomic when it cannot win):
// the max reverse-Z covered depth wins and ties go to the smallest fragment
// id, raster_plain's own scatter_reduce key, so the result does not depend
// on which warp got there first.  The winner merges once with the carried
// depth/vis (the early pass's output for the late pass) when the tile is
// done.
//
// Records are staged in batches of 128 with 16-byte cp.async copies of the
// record row (cols 0-15; the alpha variant adds cols 20-23, 28-31, 36-39
// and 48-55 for the corner uvs and the opacity-mask row), double-buffered
// so the next batch's gather is in flight while this one is tested.  For a
// covered pixel of a masked record (idu = col 54 > 0) the alpha variant
// interpolates uv with the Olano-Greer weights (IEEE division, the
// reference's op order), finds the 8x8 mask cell and keeps the pixel only
// if the cell's bit is set.  The mask halves are exact 16-bit
// integers, so the bit is taken with an integer shift, which equals the
// reference's f32 form floor(half * 2^-(b mod 16)) mod 2 on every input
// (tests/test_torch_alpha.py checks all of them).
//
// The grid is persistent (as many blocks as fit on the card) and takes
// tiles from a global counter in the order the wrapper gives, the tiles
// with most pairs first, so no heavy tile starts last; each tile is
// resolved and written by exactly one block.  Tried and dropped (timed on
// the headline's captured inputs, H100): warps that each pull 32 records
// into registers and broadcast them by shuffles, without block barriers
// (slower: the per-record shuffles and spills cost more than the barriers
// saved); splitting a tile across blocks through a global key scratch (no
// tile holds enough pairs to outlast the others, so nothing to gain).
// What bounds it now: issuing the ~30 instructions of each (clip pixel,
// record) test -- about 73M tests on the headline's opaque frame, at a few
// lanes idle per warp -- plus, in the alpha variant, the mask test of each
// covered pixel and the shared-memory atomics where double-sided triangles
// overlap; staging, clip boxes and the depth/vis merge are a small part.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRec = 56;
constexpr int kTileW = 128;
constexpr int kTileH = 8;
constexpr int kTilePx = kTileW * kTileH;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 128;  // records per staged batch

// Staged floats per record: 16-byte chunks of the record row.  Chunks 0-3
// are cols 0-15 (edges, depth plane, x0, id, x1, y1); the alpha variant adds
// cols 20-23, 28-31 and 36-39 (corner uvs at 22/23, 30/31, 38/39) and cols
// 48-55 (mask halves, u0, v0, idu, idv).
template <bool kAlpha>
struct Staged {
  static constexpr int kChunks = kAlpha ? 9 : 4;
  static constexpr int kFloats = kChunks * 4;
};
__device__ __forceinline__ int chunk_col(int c) { return c < 4 ? 4 * c : c < 7 ? 20 + 8 * (c - 4) : 48 + 4 * (c - 7); }
// staged positions of the alpha columns
enum { kId = 13, kUA = 18, kVA = 19, kUB = 22, kVB = 23, kUC = 26, kVC = 27,
       kM0 = 28, kM1, kM2, kM3, kU0, kV0, kIdu, kIdv };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// NaN-propagating min/max, like jnp.minimum/maximum inside jnp.clip
__device__ __forceinline__ float nmin(float a, float b) { return isnan(a) || isnan(b) ? a + b : fminf(a, b); }
__device__ __forceinline__ float nmax(float a, float b) { return isnan(a) || isnan(b) ? a + b : fmaxf(a, b); }

// Opacity-mask test of one covered pixel against a masked record k (kIdu > 0).
__device__ __forceinline__ bool mask_bit(const float* k, float e0, float e1, float e2) {
  const float wsum = e0 + e1 + e2;
  const float inv = fabsf(wsum) < 1e-20f ? 0.0f : 1.0f / wsum;
  // Olano-Greer: edge values weigh the corners e1 -> A, e2 -> B, e0 -> C
  const float u = (e1 * k[kUA] + e2 * k[kUB] + e0 * k[kUC]) * inv;
  const float v = (e1 * k[kVA] + e2 * k[kVB] + e0 * k[kVC]) * inv;
  const float gx = nmin(nmax(floorf((u - k[kU0]) * k[kIdu]), 0.0f), 7.0f);
  const float gy = nmin(nmax(floorf((v - k[kV0]) * k[kIdv]), 0.0f), 7.0f);
  const float bb = gy * 8.0f + gx;
  if (isnan(bb)) return false;  // the reference's f32 bit is NaN there, which fails > 0.5
  const float half = bb < 16.0f ? k[kM0] : bb < 32.0f ? k[kM1] : bb < 48.0f ? k[kM2] : k[kM3];
  return (((int)half >> ((int)bb & 15)) & 1) != 0;
}

// Start the cp.async copies of batch [base, base + n) of the tile's pairs.
template <bool kAlpha>
__device__ __forceinline__ void stage(float (*buf)[Staged<kAlpha>::kFloats], const long long* pair_tri,
                                      const float* rec, int base, int n) {
  for (int r = threadIdx.x; r < n; r += kThreads) {
    const float* row = rec + (size_t)pair_tri[base + r] * kRec;
#pragma unroll
    for (int c = 0; c < Staged<kAlpha>::kChunks; ++c) cp_async16(&buf[r][4 * c], row + chunk_col(c));
  }
  cp_async_commit();
}

// The pixels [x0, x1) x [y0, y1) (full-grid rows) of the tile at (tx0,
// gty0) that record k's edge tests can pass: see the header.
__device__ __forceinline__ int4 clip_box(const float* k, int tx0, int gty0) {
  const int4 tile = make_int4(tx0, tx0 + kTileW, gty0, gty0 + kTileH);
  const double xm = tx0 + kTileW, ym = gty0 + kTileH;  // bound the tile's pixel centres
  double a[3], b[3], c[3];
  for (int i = 0; i < 3; ++i) {
    a[i] = k[3 * i];
    b[i] = k[3 * i + 1];
    c[i] = k[3 * i + 2];
    c[i] += (fabs(a[i]) * xm + fabs(b[i]) * ym + fabs(c[i])) * 0x1p-21;  // outward by the f32 evaluation error
    if (!isfinite(c[i])) return tile;
  }
  double lo_x = 1e300, hi_x = -1e300, lo_y = 1e300, hi_y = -1e300;
  int sign = 0;
  for (int i = 0; i < 3; ++i) {  // vertex of edges i and j
    const int j = i == 2 ? 0 : i + 1;
    const double s = a[i] * b[j] - a[j] * b[i];
    const int si = s > 0.0 ? 1 : s < 0.0 ? -1 : 0;
    if (si == 0 || (sign != 0 && si != sign)) return tile;  // the edges bound no finite triangle
    sign = si;
    const double x = (b[i] * c[j] - b[j] * c[i]) / s, y = (c[i] * a[j] - c[j] * a[i]) / s;
    lo_x = fmin(lo_x, x), hi_x = fmax(hi_x, x), lo_y = fmin(lo_y, y), hi_y = fmax(hi_y, y);
  }
  // pixel p is tested at p + 0.5: p in [ceil(lo - 0.5), floor(hi - 0.5)]
  const auto clamp_px = [](double v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : (int)v; };
  return make_int4(clamp_px(floor(lo_x - 0.5), tile.x, tile.y), clamp_px(floor(hi_x - 0.5) + 1.0, tile.x, tile.y),
                   clamp_px(floor(lo_y - 0.5), tile.z, tile.w), clamp_px(floor(hi_y - 0.5) + 1.0, tile.z, tile.w));
}

// One warp: record k against the pixels of its clip box.
template <bool kAlpha>
__device__ __forceinline__ void raster_record(const float* k, int4 box, int tx0, int gty0, int frag_off,
                                              unsigned long long* keys, int lane) {
  const int xa = box.x, xb = box.y, ya = box.z, yb = box.w;
  if (xa >= xb || ya >= yb) return;
  // the record in registers: through shared memory, every atomic below
  // would make the compiler load it again
  float q[Staged<kAlpha>::kFloats];
#pragma unroll
  for (int i = 0; i < Staged<kAlpha>::kFloats; ++i) q[i] = k[i];
  // top-left fill rule per edge (raster_tile.py:416-419)
  const bool tl0 = q[0] > 0.0f || (q[0] == 0.0f && q[1] > 0.0f);
  const bool tl1 = q[3] > 0.0f || (q[3] == 0.0f && q[4] > 0.0f);
  const bool tl2 = q[6] > 0.0f || (q[6] == 0.0f && q[7] > 0.0f);
  const unsigned low = 0xFFFFFFFFu - (unsigned)((int)q[kId] + frag_off);
  const bool masked = kAlpha && q[kIdu] > 0.0f;
  auto test = [&](int px, int gy) {
    const float fx = (float)px + 0.5f, fy = (float)gy + 0.5f;
    const float e0 = q[0] * fx + q[1] * fy + q[2];
    const float e1 = q[3] * fx + q[4] * fy + q[5];
    const float e2 = q[6] * fx + q[7] * fy + q[8];
    const float z = q[9] * fx + q[10] * fy + q[11];
    bool cover = (e0 > 0.0f || (tl0 && e0 == 0.0f)) && (e1 > 0.0f || (tl1 && e1 == 0.0f)) &&
                 (e2 > 0.0f || (tl2 && e2 == 0.0f)) && z > 0.0f && z <= 1.0f;
    if (kAlpha && cover && masked) cover = mask_bit(q, e0, e1, e2);
    if (!cover) return;
    const unsigned long long key = ((unsigned long long)__float_as_uint(z) << 32) | low;
    unsigned long long* slot = keys + (gy - gty0) * kTileW + (px - tx0);
    if (key > *(volatile unsigned long long*)slot) atomicMax(slot, key);
  };
  const int bw = xb - xa;
  if (bw <= 32) {  // 32 / bw rows of bw lanes at a time
    const int rows = 32 / bw, r = lane / bw;
    if (r < rows)
      for (int gy = ya + r; gy < yb; gy += rows) test(xa + lane - r * bw, gy);
  } else {
    for (int gy = ya; gy < yb; ++gy)
      for (int px = xa + lane; px < xb; px += 32) test(px, gy);
  }
}

template <bool kAlpha>
__global__ void __launch_bounds__(kThreads) raster_tile(const long long* tile_start, const int* tile_order,
                                                        const long long* pair_tri, const float* rec, int frag_off,
                                                        const float* depth_in, const int* vis_in, float* depth_out,
                                                        int* vis_out, int width, int tiles_x, int n_tiles,
                                                        int band_row0, int* tile_counter) {
  constexpr int kF = Staged<kAlpha>::kFloats;
  __shared__ __align__(16) float buf[2][kBatch][kF];
  __shared__ int4 clip[kBatch];
  __shared__ unsigned long long keys[kTilePx];
  __shared__ int s_slot;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kTilePx; i += kThreads) keys[i] = 0ull;

  for (;;) {
    if (threadIdx.x == 0) s_slot = atomicAdd(tile_counter, 1);
    __syncthreads();  // s_slot published; the last tile's keys are reset
    if (s_slot >= n_tiles) break;
    const int t = tile_order[s_slot];
    const int tx0 = (t % tiles_x) * kTileW;
    const int ty0 = (t / tiles_x) * kTileH;     // band-local row: where depth/vis live
    const int gty0 = ty0 + band_row0 * kTileH;  // full-grid row: where coverage is tested
    const int start = (int)tile_start[t], end = (int)tile_start[t + 1];
    const int nb = (end - start + kBatch - 1) / kBatch;
    if (nb > 0) stage<kAlpha>(buf[0], pair_tri, rec, start, min(kBatch, end - start));
    for (int b = 0; b < nb; ++b) {
      const int base = start + b * kBatch;
      if (b + 1 < nb) {
        stage<kAlpha>(buf[(b + 1) & 1], pair_tri, rec, base + kBatch, min(kBatch, end - base - kBatch));
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int n = min(kBatch, end - base);
      for (int r = threadIdx.x; r < n; r += kThreads) clip[r] = clip_box(buf[b & 1][r], tx0, gty0);
      __syncthreads();
      for (int r = warp; r < n; r += kWarps)
        raster_record<kAlpha>(buf[b & 1][r], clip[r], tx0, gty0, frag_off, keys, lane);
      __syncthreads();
    }

    for (int i = threadIdx.x; i < kTilePx; i += kThreads) {
      const unsigned long long key = keys[i];
      keys[i] = 0ull;
      const float z = __uint_as_float((unsigned)(key >> 32));
      const int id = (int)(0xFFFFFFFFu - (unsigned)key);
      const size_t p = (size_t)(ty0 + (i >> 7)) * width + tx0 + (i & (kTileW - 1));
      const float d = depth_in[p];
      const int v = vis_in[p];
      const bool closer = z > d;
      const bool tie = z > 0.0f && z == d && id < v;
      depth_out[p] = closer ? z : d;
      vis_out[p] = (closer || tie) ? id : v;
    }
    __syncthreads();  // every thread has read s_slot before it is overwritten
  }
}

template <bool kAlpha>
int launch(const long long* tile_start, const int* tile_order, const long long* pair_tri, const float* rec,
           int frag_off, const float* depth_in, const int* vis_in, float* depth_out, int* vis_out, int width,
           int tiles_x, int n_tiles, int band_row0, int* tile_counter, cudaStream_t stream) {
  static int grid = 0;  // persistent: as many blocks as are resident at once
  if (grid == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, raster_tile<kAlpha>, kThreads, 0);
    grid = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int blocks = n_tiles < grid ? (n_tiles > 0 ? n_tiles : 1) : grid;
  raster_tile<kAlpha><<<blocks, kThreads, 0, stream>>>(tile_start, tile_order, pair_tri, rec, frag_off, depth_in,
                                                       vis_in, depth_out, vis_out, width, tiles_x, n_tiles,
                                                       band_row0, tile_counter);
  return (int)cudaGetLastError();
}

}  // namespace

// alpha_test != 0 launches the alpha_test variant, else the opaque one;
// band_row0 is the full-grid tile row of the framebuffer's first row (0 for
// a whole framebuffer).  tile_order lists the tiles in the order the grid
// takes them (the wrapper puts the ones with most pairs first);
// tile_counter is one int, zero at the launch.  `rec` must be 16-byte
// aligned.
extern "C" int raster_launch(const long long* tile_start, const int* tile_order, const long long* pair_tri,
                             const float* rec, int frag_off, const float* depth_in, const int* vis_in,
                             float* depth_out, int* vis_out, int width, int tiles_x, int n_tiles, int band_row0,
                             int alpha_test, int* tile_counter, cudaStream_t stream) {
  return alpha_test ? launch<true>(tile_start, tile_order, pair_tri, rec, frag_off, depth_in, vis_in, depth_out,
                                   vis_out, width, tiles_x, n_tiles, band_row0, tile_counter, stream)
                    : launch<false>(tile_start, tile_order, pair_tri, rec, frag_off, depth_in, vis_in, depth_out,
                                    vis_out, width, tiles_x, n_tiles, band_row0, tile_counter, stream);
}
