// The bloom chain's three filters for Hopper.
//
// The reference has no Pallas kernel for bloom: niagara_tpu/ops/bloom.py
// expands every bilinear tap of the 13-tap Jimenez downsample and the 9-tap
// tent upsample into a fixed stencil and sums it as padded, shifted slices
// (`_down2`, `_up2`, `_bilinear_x2`), one XLA op per tap.  In eager PyTorch
// that is one multiply and one add launch per tap, ~1,500 launches a frame
// at 1080p; these kernels do each level in one launch.  Plain torch twins:
// ops/bloom.py::_down2, up2_add_plain and _bilinear_x2.
//
// Each output texel is summed with its plain version's ops in its order
// (acc starts at 0 and takes `acc + w * v` tap by tap, mul and add each
// rounded: the library is built with --fmad=false), and the reference's
// edge padding is index clamping, so every kernel equals its plain version
// bit for bit.  The weights come from the plain version's tables (the
// wrapper passes them by value); every loop over them unrolls at compile
// time, so they stay in the parameter bank.
//
// What bounds them: bytes, and at these sizes launch latency.  A 1080p
// frame's chain reads and writes ~20 MB in all (level 0 of the down chain
// reads 960x540x3 f32 = 6.2 MB), ~6 us at 3.35 TB/s, spread over 15
// launches; each tap re-read hits L1/L2.
//
// * bloom_down: one thread per output texel and channel, the 6x6 stencil
//   at stride 2 over rows and columns clamped to the source.
// * bloom_up: one thread per source texel and channel computes its 2x2
//   output quad (the four phases, 4x4 taps each from one 5x5 window it
//   loads once), adds the finer mip (`mips[i] + up`) and writes the quad
//   cropped to the finer mip's size.
// * bloom_x2: the same quad scheme for the 1:2 bilinear expansion (2x2 taps
//   a phase from a 3x3 window), all three channels in one thread, written
//   straight into the [H, W, 3] full-resolution image the composite adds:
//   each output row's two pixels as 6 contiguous floats (three 8-byte
//   stores), where one thread per channel wrote 4-byte values at a
//   12-byte stride.

#include <cuda_runtime.h>
#include <stdint.h>

// Mirrors of the ctypes structures in _build.py; passed by value.
struct DownWeights {
  float w[6][6];  // bloom._DOWN_K[j][i]
};
struct UpWeights {
  float w[2][2][4][4];  // [py][px][j][i] = bloom._UP_K[(py, px)][py + j][px + i]
};
struct X2Weights {
  float w[2][2][2][2];  // [py][px][a][b]: the tap at column px + a - 1, row py + b - 1
};

namespace {

constexpr int kBx = 32, kBy = 8;

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

__global__ void __launch_bounds__(kBx* kBy)
    bloom_down(const float* __restrict__ src, int h, int w, float* __restrict__ out, int oh, int ow, DownWeights k) {
  const int x = blockIdx.x * kBx + threadIdx.x, y = blockIdx.y * kBy + threadIdx.y, c = blockIdx.z;
  if (x >= ow || y >= oh) return;
  const float* s = src + (size_t)c * h * w;
  int col[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) col[i] = clampi(2 * x + i - 2, w - 1);
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float* row = s + (size_t)clampi(2 * y + j - 2, h - 1) * w;
#pragma unroll
    for (int i = 0; i < 6; ++i) acc = acc + k.w[j][i] * __ldg(row + col[i]);
  }
  out[((size_t)c * oh + y) * ow + x] = acc;
}

__global__ void __launch_bounds__(kBx* kBy)
    bloom_up(const float* __restrict__ src, int h, int w, const float* __restrict__ mip, float* __restrict__ out,
             int oh, int ow, UpWeights k) {
  const int x = blockIdx.x * kBx + threadIdx.x, y = blockIdx.y * kBy + threadIdx.y, c = blockIdx.z;
  if (x >= w || y >= h) return;
  const float* s = src + (size_t)c * h * w;
  float v[5][5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const float* row = s + (size_t)clampi(y + j - 2, h - 1) * w;
#pragma unroll
    for (int i = 0; i < 5; ++i) v[j][i] = __ldg(row + clampi(x + i - 2, w - 1));
  }
#pragma unroll
  for (int py = 0; py < 2; ++py) {
    const int oy = 2 * y + py;
    if (oy >= oh) break;
#pragma unroll
    for (int px = 0; px < 2; ++px) {
      const int ox = 2 * x + px;
      if (ox >= ow) break;
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc = acc + k.w[py][px][j][i] * v[py + j][px + i];
      const size_t o = ((size_t)c * oh + oy) * ow + ox;
      out[o] = __ldg(mip + o) + acc;
    }
  }
}

__global__ void __launch_bounds__(kBx* kBy)
    bloom_x2(const float* __restrict__ src, int h, int w, float* __restrict__ out, int oh, int ow, X2Weights k) {
  const int x = blockIdx.x * kBx + threadIdx.x, y = blockIdx.y * kBy + threadIdx.y;
  if (x >= w || y >= h) return;
  int row[3], col[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    row[j] = clampi(y + j - 1, h - 1) * w;
    col[j] = clampi(x + j - 1, w - 1);
  }
  // per channel the 3x3 window; per output row its two pixels' three
  // channels, 6 contiguous floats, stored as three float2 where they are
  // 8-byte aligned (an even pixel offset oy * ow; out is 256-byte aligned)
  float v[3][3][3], o[2][2][3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int i = 0; i < 3; ++i) v[c][j][i] = __ldg(src + (size_t)c * h * w + row[j] + col[i]);
#pragma unroll
  for (int py = 0; py < 2; ++py)
#pragma unroll
    for (int px = 0; px < 2; ++px)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float acc = 0.0f;
        // the plain version's loop order: columns outer, rows inner
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 2; ++b) acc = acc + k.w[py][px][a][b] * v[c][py + b][px + a];
        o[py][px][c] = acc;
      }
#pragma unroll
  for (int py = 0; py < 2; ++py) {
    const int oy = 2 * y + py;
    if (oy >= oh) break;
    float* dst = out + ((size_t)oy * ow + 2 * x) * 3;
    if (2 * x + 1 < ow && !(((size_t)oy * ow) & 1)) {
      float2* d2 = reinterpret_cast<float2*>(dst);
      d2[0] = make_float2(o[py][0][0], o[py][0][1]);
      d2[1] = make_float2(o[py][0][2], o[py][1][0]);
      d2[2] = make_float2(o[py][1][1], o[py][1][2]);
    } else {
#pragma unroll
      for (int px = 0; px < 2; ++px)
        if (2 * x + px < ow)
#pragma unroll
          for (int c = 0; c < 3; ++c) dst[3 * px + c] = o[py][px][c];
    }
  }
}

dim3 grid_of(int w, int h, int c) { return dim3((w + kBx - 1) / kBx, (h + kBy - 1) / kBy, c); }

}  // namespace

// src [c, h, w] -> out [c, (h+1)/2, (w+1)/2]
extern "C" int bloom_down_launch(const float* src, int c, int h, int w, float* out, DownWeights k,
                                 cudaStream_t stream) {
  if (c <= 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const int oh = (h + 1) / 2, ow = (w + 1) / 2;
  bloom_down<<<grid_of(ow, oh, c), dim3(kBx, kBy), 0, stream>>>(src, h, w, out, oh, ow, k);
  return (int)cudaGetLastError();
}

// src [c, h, w], mip and out [c, oh, ow] with oh <= 2h, ow <= 2w: out = mip + up2(src)
extern "C" int bloom_up_launch(const float* src, int c, int h, int w, const float* mip, float* out, int oh, int ow,
                               UpWeights k, cudaStream_t stream) {
  if (c <= 0 || h <= 0 || w <= 0 || oh <= 0 || ow <= 0 || oh > 2 * h || ow > 2 * w) return (int)cudaErrorInvalidValue;
  bloom_up<<<grid_of(w, h, c), dim3(kBx, kBy), 0, stream>>>(src, h, w, mip, out, oh, ow, k);
  return (int)cudaGetLastError();
}

// src [c, h, w] -> out [oh, ow, c] with oh <= 2h, ow <= 2w
extern "C" int bloom_x2_launch(const float* src, int c, int h, int w, float* out, int oh, int ow, X2Weights k,
                               cudaStream_t stream) {
  if (c != 3 || h <= 0 || w <= 0 || oh <= 0 || ow <= 0 || oh > 2 * h || ow > 2 * w) return (int)cudaErrorInvalidValue;
  bloom_x2<<<grid_of(w, h, 1), dim3(kBx, kBy), 0, stream>>>(src, h, w, out, oh, ow, k);
  return (int)cudaGetLastError();
}
