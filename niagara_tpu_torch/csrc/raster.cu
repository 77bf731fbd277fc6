// Tile rasterizer for Hopper: visibility buffer resolve over tile-sorted pairs.
//
// Replaces niagara_tpu/ops/raster_tile.py::_raster_kernel, entered through
// rasterize_tiles, in two static variants (the template flag kAlpha): opaque
// (alpha_test=False) and alpha_test (raster_tile.py:440-468), which the merged
// late stream of an alpha-classed frame runs.  The row_window variant (sun-map
// bands) is not ported yet.  Plain torch twin: ops/raster_tile.py::raster_plain.
//
// One block per 8x128-pixel tile, 256 threads, each owning 4 pixels of one
// column.  The block walks its tile's pair range [tile_start[t],
// tile_start[t+1]) in batches of 64 records: the batch's coefficients (record
// cols fetched by pair_tri straight from the setup records -- no per-pair
// record stream is built) are staged in shared memory, then every thread tests
// its pixels against each record in registers.  Per pixel the max reverse-Z
// covered depth wins and ties go to the smallest fragment id -- a total order,
// so the result does not depend on record order -- and the winner merges once
// with the carried depth/vis (the early pass's output for the late pass).
//
// The opaque variant stages 13 columns per record (edges, depth plane, id);
// the alpha variant 27 (adding the corner uvs, cols 22/23, 30/31, 38/39, and
// the opacity-mask row, cols 48-55), 6.9 KB a batch.  For a covered pixel of
// a record with a mask (idu = col 54 > 0) it interpolates uv with the
// Olano-Greer weights (IEEE division, the reference's op order), finds the
// 8x8 mask cell and keeps the pixel only if the cell's bit is set; records
// without a mask (opaque clusters in the merged stream) pass untouched.  The
// mask halves are exact 16-bit integers, so the bit is taken with an integer
// shift, which equals the reference's f32 form floor(half * 2^-(b mod 16))
// mod 2 on every input (tests/test_torch_alpha.py checks all of them).
//
// Cost: ~28 f32 ops per (pixel, record) test and 52 bytes of record per pair
// from L2 (108 in the alpha variant, plus ~34 ops for a covered pixel of a
// masked record).  Every record is tested on all 1024 pixels of its tile --
// the TPU kernel's x-band narrowing (a VPU-width trick) is not carried over
// and nothing clips to the triangle's box -- although at the headline a
// triangle's box holds a few dozen of those pixels: most of the tests are
// work the inputs do not need, which is why the kernel sits far above its
// bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRec = 56;
constexpr int kTileW = 128;
constexpr int kTileH = 8;
constexpr int kThreads = 256;
constexpr int kRows = kTileH * kTileW / kThreads;  // pixels per thread (one column)
constexpr int kBatch = 64;
constexpr int kNoId = 1 << 30;

// Record column of staged slot c: edges + depth plane (cols 0-11), the
// fragment id (col 13); the alpha variant adds the corner uvs (cols 22/23,
// 30/31, 38/39) and the mask row (cols 48-55).
__device__ __forceinline__ int staged_col(int c) {
  if (c < 12) return c;
  if (c == 12) return 13;
  if (c < 19) return 22 + ((c - 13) >> 1) * 8 + ((c - 13) & 1);
  return 48 + (c - 19);
}
enum { kId = 12, kUA = 13, kVA, kUB, kVB, kUC, kVC, kM0, kM1, kM2, kM3, kU0, kV0, kIdu, kIdv };

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

template <bool kAlpha>
__global__ void raster_tile(const int* tile_start, const int* pair_tri, const float* rec, int frag_off,
                            const float* depth_in, const int* vis_in, float* depth_out, int* vis_out,
                            int width, int tiles_x) {
  constexpr int kCoef = kAlpha ? 27 : 13;
  __shared__ float coef[kBatch][kCoef];
  const int t = blockIdx.x;
  const int col = threadIdx.x % kTileW;
  const int row0 = (threadIdx.x / kTileW) * kRows;
  const int px = (t % tiles_x) * kTileW + col;
  const int py0 = (t / tiles_x) * kTileH + row0;
  const float fx = (float)px + 0.5f;
  float zbest[kRows];
  int ibest[kRows];
  for (int j = 0; j < kRows; ++j) {
    zbest[j] = 0.0f;
    ibest[j] = kNoId;
  }

  const int start = tile_start[t], end = tile_start[t + 1];
  for (int base = start; base < end; base += kBatch) {
    const int n = min(kBatch, end - base);
    for (int i = threadIdx.x; i < n * kCoef; i += kThreads) {
      const int r = i / kCoef, c = i % kCoef;
      coef[r][c] = rec[(size_t)pair_tri[base + r] * kRec + staged_col(c)];
    }
    __syncthreads();
    for (int r = 0; r < n; ++r) {
      const float* k = coef[r];
      // top-left fill rule per edge (raster_tile.py:416-419)
      const bool tl0 = k[0] > 0.0f || (k[0] == 0.0f && k[1] > 0.0f);
      const bool tl1 = k[3] > 0.0f || (k[3] == 0.0f && k[4] > 0.0f);
      const bool tl2 = k[6] > 0.0f || (k[6] == 0.0f && k[7] > 0.0f);
      const int id = (int)k[kId] + frag_off;
      for (int j = 0; j < kRows; ++j) {
        const float fy = (float)(py0 + j) + 0.5f;
        const float e0 = k[0] * fx + k[1] * fy + k[2];
        const float e1 = k[3] * fx + k[4] * fy + k[5];
        const float e2 = k[6] * fx + k[7] * fy + k[8];
        const float z = k[9] * fx + k[10] * fy + k[11];
        bool cover = (e0 > 0.0f || (tl0 && e0 == 0.0f)) && (e1 > 0.0f || (tl1 && e1 == 0.0f)) &&
                     (e2 > 0.0f || (tl2 && e2 == 0.0f)) && z > 0.0f && z <= 1.0f;
        if (kAlpha && cover && k[kIdu] > 0.0f) cover = mask_bit(k, e0, e1, e2);
        if (cover && (z > zbest[j] || (z == zbest[j] && id < ibest[j]))) {
          zbest[j] = z;
          ibest[j] = id;
        }
      }
    }
    __syncthreads();
  }

  for (int j = 0; j < kRows; ++j) {
    const size_t p = (size_t)(py0 + j) * width + px;
    const float d = depth_in[p];
    const int v = vis_in[p];
    const bool closer = zbest[j] > d;
    const bool tie = zbest[j] > 0.0f && zbest[j] == d && ibest[j] < v;
    depth_out[p] = closer ? zbest[j] : d;
    vis_out[p] = (closer || tie) ? ibest[j] : v;
  }
}

}  // namespace

// alpha_test != 0 launches the alpha_test variant, else the opaque one.
extern "C" int raster_launch(const int* tile_start, const int* pair_tri, const float* rec, int frag_off,
                             const float* depth_in, const int* vis_in, float* depth_out, int* vis_out,
                             int width, int tiles_x, int n_tiles, int alpha_test, cudaStream_t stream) {
  if (alpha_test)
    raster_tile<true><<<n_tiles, kThreads, 0, stream>>>(tile_start, pair_tri, rec, frag_off, depth_in, vis_in,
                                                        depth_out, vis_out, width, tiles_x);
  else
    raster_tile<false><<<n_tiles, kThreads, 0, stream>>>(tile_start, pair_tri, rec, frag_off, depth_in, vis_in,
                                                         depth_out, vis_out, width, tiles_x);
  return (int)cudaGetLastError();
}
