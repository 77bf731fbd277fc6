// Visibility-buffer attribute resolve for Hopper.
//
// Replaces niagara_tpu/ops/raster_tile.py::_shade_kernel, entered through
// shade_tiles.  Plain torch twin: ops/raster_tile.py::shade_plain.
//
// Fragment ids are (stream frag offset + compacted record index) and the
// streams' id ranges are disjoint, so a pixel's winning record is a direct
// gather: rec_s[vis - off_s] for the stream s whose range [off_s, off_s +
// count_s) holds vis (were two to hold it, the later stream wins, as in
// shade_plain); a pixel in no range resolves to zeros.  The TPU kernel finds
// the same record with one-hot MXU matmuls over each tile's pair chunks.
// Each pixel interpolates the 13 attribute channels (nx ny nz u v viewz draw
// mat post vid0 vid1 vid2 duv) with perspective-correct Olano-Greer weights
// in the reference's op order (raster_tile.py:861-892); duv depends on the
// record alone and is computed with the reference's ops in its order, so it
// has the same bits on every pixel of the triangle.  Up to kMaxStreams
// streams a launch (the frame passes two).
//
// What bounds it: bytes.  At 1080p a frame reads the visibility buffer
// (8.3 MB) and each winning record once (~54K records, 8.5 MB), and writes
// the [H, W, 13] f32 planes (107.8 MB): ~0.037 ms at 3.35 TB/s.  The planes
// are nearly all of it, so the stores must go out whole:
//
// * A warp resolves 32 consecutive pixels of a row, a block of 4 warps one
//   128-pixel tile width (W is a multiple of 128) of kRows = 2 rows, so x
//   and y come from the block index and each thread resolves 2 pixels; the
//   ids of both rows are loaded first, so both are in flight together.  A
//   thread writes its 13 values into its warp's slice of shared memory
//   (stride 13, odd, so the 32 lanes hit 32 banks), and after __syncwarp
//   the warp copies the slice's 1,664 contiguous bytes to the planes as 104
//   16-byte stores, whole 32-byte sectors (thirteen scalar stores a thread
//   at a 52-byte stride would leave each store instruction 52 partly
//   written sectors, and set the pace).
// * A record is 224 bytes and 16-byte aligned (the wrapper checks, and
//   clones an array that is not); its used columns 0-8 and 16-45 come in as
//   eleven read-only 16-byte loads (cols 0-11 and 16-47), not 46 scalar
//   ones.  Neighbouring pixels mostly share a record (~38 pixels a winner at
//   1080p), so the repeats hit L1.
// * The streams' counts are read once per warp, lane i reading stream i's,
//   and broadcast by shuffle.
//
// Tried on the headline frame's captured inputs (H100): one pixel a thread,
// and blocks of 256 or 512 threads, ran slower; streaming stores
// (st.global.cs) gained next to nothing and are not used, since the
// G-buffer glue reads the planes right after.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRec = 56;
constexpr int kAttr = 13;
constexpr int kMaxStreams = 4;
constexpr int kTileW = 128;
constexpr int kRows = 2;             // pixel rows a block resolves: pixels a thread
constexpr int kWarps = kTileW / 32;  // one per 32 pixels of a row
constexpr int kThreads = kWarps * 32;
constexpr int kInvalid = 0x7FFFFFFF;
constexpr int kSlice = 32 * kAttr;  // floats a warp stages: 104 float4
constexpr unsigned kAll = 0xffffffffu;

}  // namespace

// Mirror of class ShadeStreams in _build.py (ctypes); passed by value.
struct ShadeStreams {
  const float* rec[kMaxStreams];        // [cap, 56] f32, 16-byte aligned
  const long long* count[kMaxStreams];  // live records of each stream
  int off[kMaxStreams];                 // fragment id of each stream's record 0
  int n;                                // streams in use, 1..kMaxStreams
};

namespace {

// The winning record of fragment id v, or nullptr: the last stream whose
// [off, off + count) holds v; count is lane i's my_count for stream i.
__device__ __forceinline__ const float* winner(const ShadeStreams& s, long long my_count, int v) {
  const float* r = nullptr;
#pragma unroll
  for (int i = 0; i < kMaxStreams; ++i) {
    if (i < s.n) {
      const long long count = __shfl_sync(kAll, my_count, i);
      const long long local = (long long)v - s.off[i];
      if (local >= 0 && local < count) r = s.rec[i] + local * kRec;
    }
  }
  return r;
}

// The 13 channels of pixel (x, y) from record r (zeros without one), in
// shade_plain's order and with its ops in its order.
__device__ __forceinline__ void resolve(const float* r, int x, int y, float* out) {
  if (r == nullptr) {
#pragma unroll
    for (int k = 0; k < kAttr; ++k) out[k] = 0.0f;
    return;
  }
  // c[k] = record column k for k in 0-11 and 16-47 (12-15 are not read)
  float c[48];
  const float4* r4 = reinterpret_cast<const float4*>(r);
#pragma unroll
  for (int q = 0; q < 12; ++q) {
    if (q == 3) continue;
    const float4 t = __ldg(r4 + q);
    c[4 * q] = t.x;
    c[4 * q + 1] = t.y;
    c[4 * q + 2] = t.z;
    c[4 * q + 3] = t.w;
  }
  const float fx = (float)x + 0.5f;
  const float fy = (float)y + 0.5f;
  const float e0 = c[0] * fx + c[1] * fy + c[2];
  const float e1 = c[3] * fx + c[4] * fy + c[5];
  const float e2 = c[6] * fx + c[7] * fy + c[8];
  const float wsum = e0 + e1 + e2;
  const float inv = fabsf(wsum) < 1e-20f ? 0.0f : 1.0f / wsum;
  // edge e1 (B,C) weighs corner A, e2 (C,A) weighs B, e0 (A,B) weighs C
  const float pw0 = e1 * inv, pw1 = e2 * inv, pw2 = e0 * inv;
  auto interp = [&](int o) { return pw0 * c[16 + o] + pw1 * c[24 + o] + pw2 * c[32 + o]; };
  const float uv_area = fabsf((c[30] - c[22]) * (c[39] - c[23]) - (c[31] - c[23]) * (c[38] - c[22]));
  const float px_area = fabsf((c[24] - c[16]) * (c[33] - c[17]) - (c[25] - c[17]) * (c[32] - c[16]));
  out[0] = interp(3);  // world normal
  out[1] = interp(4);
  out[2] = interp(5);
  out[3] = interp(6);  // uv
  out[4] = interp(7);
  out[5] = interp(2);  // viewz
  out[6] = c[43];      // draw, material, post class
  out[7] = c[44];
  out[8] = c[45];
  out[9] = c[40];      // corner vertex ids
  out[10] = c[41];
  out[11] = c[42];
  out[12] = uv_area / fmaxf(px_area, 1e-6f);  // duv
}

__global__ void __launch_bounds__(kThreads) shade_px(const int* __restrict__ vis, int width, int height,
                                                     ShadeStreams s, float* __restrict__ attr) {
  __shared__ __align__(16) float stage[kWarps * kSlice];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int x = blockIdx.x * kTileW + warp * 32 + lane;
  const int y0 = blockIdx.y * kRows;
  int v[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) v[j] = y0 + j < height ? __ldg(vis + (size_t)(y0 + j) * width + x) : kInvalid;
  long long my_count = 0;
#pragma unroll
  for (int i = 0; i < kMaxStreams; ++i)
    if (i < s.n && lane == i) my_count = __ldg(s.count[i]);

  float* slice = stage + warp * kSlice;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (y0 + j >= height) break;  // the whole block
    if (j) __syncwarp();          // the last row's copy-out has read the slice
    resolve(winner(s, my_count, v[j]), x, y0 + j, slice + lane * kAttr);
    __syncwarp();
    // the warp's 32 pixels are 1,664 contiguous bytes of the planes, 16-byte
    // aligned: their first pixel is a multiple of 32 and attr is 16-byte aligned
    const float4* src = reinterpret_cast<const float4*>(slice);
    float4* dst = reinterpret_cast<float4*>(attr + ((size_t)(y0 + j) * width + x - lane) * kAttr);
#pragma unroll
    for (int q = lane; q < kSlice / 4; q += 32) dst[q] = src[q];
  }
}

}  // namespace

extern "C" int shade_launch(const int* vis, int width, int height, ShadeStreams streams, float* attr,
                            cudaStream_t stream) {
  if (width % kTileW || height <= 0 || streams.n < 1 || streams.n > kMaxStreams) return (int)cudaErrorInvalidValue;
  const dim3 grid(width / kTileW, (height + kRows - 1) / kRows);
  shade_px<<<grid, kThreads, 0, stream>>>(vis, width, height, streams, attr);
  return (int)cudaGetLastError();
}
