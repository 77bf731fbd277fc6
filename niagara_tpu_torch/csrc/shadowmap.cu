// Sun-map shadow resolve for Hopper: shadow_map_pass in one launch.
//
// Replaces no Pallas kernel: the reference's shadow_map_pass
// (niagara_tpu/ops/sunmap.py:498) and its blur (niagara_tpu/ops/shadow.py
// shadow_blur) are XLA ops, fused by XLA.  Their port ran as ~680 eager
// torch ops a frame over half-resolution tensors (the blur alone 84
// torch.roll and their arithmetic), each a launch paced by the host.
// Plain torch twin: ops/sunmap.py::shadow_map_plain; this kernel computes
// its output bit for bit, with its ops in its order (no contraction:
// --fmad=false; IEEE division; exp2f as torch's exp2 calls it).
//
// What it computes, per texel of the 1/scale grid [sh, sw]: the camera
// depth d at (y * scale, x * scale), the world position through the
// inverse view-projection, the sun-map coordinates, one 16-byte row of
// the packed 2x2 PCF table (pack_sun_map) compared against the biased
// receiver depth and weighted, 1 where d <= 0 (nothing drawn); with the
// blur, the separable depth-aware bilateral filter of shadow_blur
// (kTaps taps a side, horizontal then vertical, neighbours wrapping at
// the grid's edges as torch.roll wraps); then each texel stored to its
// scale x scale pixels.
//
// One block a tile of kTX x kTY texels.  With the blur the block first
// resolves the tile and a halo of kTaps texels on every side into shared
// memory (linear depth and term; the halo repeats neighbouring blocks'
// resolve, ~3.7x the texels at 32 x 16), runs the horizontal pass over
// every row of that region, then the vertical pass over the tile's rows.
// The block counts the texels it tested against the map (d > 0) and adds
// them to one word with one atomic.
//
// What bounds it: bytes, and barely.  At 1920x1080, scale 2: the depth
// texels (2.1 MB needed), a 16-byte PCF row a texel (8.3 MB) and the
// 8.3 MB output, ~19 MB, ~6 us at 3.35 TB/s; ~0.5 GFLOP and ~34M exp2f
// with the halo's repeats.  Either is microseconds, against the
// milliseconds the host spent launching the torch ops.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 10;  // ops/shadow.py SHADOW_BLUR_KERNEL
constexpr int kTX = 32;    // a warp: 32 texels of a row
constexpr int kTY = 16;    // rows a tile
constexpr int kRX = kTX + 2 * kTaps;
constexpr int kRY = kTY + 2 * kTaps;

}  // namespace

// Mirror of class ShadowResolveArgs in _build.py (ctypes); passed by value.
struct ShadowResolveArgs {
  const float* depth;    // [height, width] f32, reverse-Z
  const float* packed;   // [map_h * map_w, 4] f32 (pack_sun_map)
  const float* rows;     // [3, 3] f32: world -> sun basis
  const float* lo;       // [3] f32
  const float* hi;       // [3] f32
  float* out;            // [sh * scale, sw * scale] f32
  unsigned int* count;   // one word: texels tested against the map
  float ivp[16];         // inverse view-projection, row-major
  float tap_w[kTaps];    // float32(exp2(-i * i / 50)), i = 1..kTaps
  float bias_scale;      // float32(0.998 * bias_texels)
  float znear;
  int width, height, scale, sw, sh, map_w, map_h;
};

namespace {

// torch.maximum on floats: a NaN operand propagates
__device__ __forceinline__ float maximum(float a, float b) { return a != a ? a : (b != b ? b : fmaxf(a, b)); }

__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// The sun frame's constants as sunmap._sun_coords computes them
struct Sun {
  float r[9], lo[3], ext[3], bias;
};

__device__ __forceinline__ Sun load_sun(const ShadowResolveArgs& a) {
  Sun s;
#pragma unroll
  for (int k = 0; k < 9; ++k) s.r[k] = __ldg(a.rows + k);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.lo[k] = __ldg(a.lo + k);
    s.ext[k] = __ldg(a.hi + k) - s.lo[k];
  }
  s.bias = a.bias_scale * maximum(s.ext[0] / (float)a.map_w, s.ext[1] / (float)a.map_h) / s.ext[2];
  return s;
}

__device__ __forceinline__ float depth_at(const ShadowResolveArgs& a, int x, int y) {
  return __ldg(a.depth + (size_t)y * a.scale * a.width + (size_t)x * a.scale);
}

// ops/sunmap.py shadow_map_plain's term at texel (x, y) of depth d:
// shadow.world_positions, sample_shadow_packed, the valid select
__device__ float resolve(const ShadowResolveArgs& a, const Sun& s, int x, int y, float d) {
  if (!(d > 0.0f)) return 1.0f;
  const float ndc_x = ((float)x + 0.5f) / (float)a.sw * 2.0f - 1.0f;
  const float ndc_y = 1.0f - ((float)y + 0.5f) / (float)a.sh * 2.0f;
  float h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = ndc_x * a.ivp[4 * i] + ndc_y * a.ivp[4 * i + 1] + d * a.ivp[4 * i + 2] + a.ivp[4 * i + 3];
  const float wdiv = fabsf(h[3]) < 1e-20f ? 1e-20f : h[3];
  const float p0 = h[0] / wdiv, p1 = h[1] / wdiv, p2 = h[2] / wdiv;
  float sc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) sc[i] = p0 * s.r[3 * i] + p1 * s.r[3 * i + 1] + p2 * s.r[3 * i + 2];
  const float px = (sc[0] - s.lo[0]) / s.ext[0] * (float)a.map_w - 0.5f;
  const float py = (sc[1] - s.lo[1]) / s.ext[1] * (float)a.map_h - 0.5f;
  const float z_here = 1.0f - 0.998f * ((sc[2] - s.lo[2]) / s.ext[2]);
  const float zb = z_here + s.bias;
  const long long x0 = (long long)floorf(px), y0 = (long long)floorf(py);
  const float fx = x0 < 0 ? 0.0f : px - (float)x0;
  const float fy = y0 < 0 ? 0.0f : py - (float)y0;
  const long long row = min(max(y0, 0ll), (long long)a.map_h - 1) * a.map_w + min(max(x0, 0ll), (long long)a.map_w - 1);
  const float4 q = __ldg(reinterpret_cast<const float4*>(a.packed) + row);
  const float l0 = q.x <= zb ? 1.0f : 0.0f, l1 = q.y <= zb ? 1.0f : 0.0f;
  const float l2 = q.z <= zb ? 1.0f : 0.0f, l3 = q.w <= zb ? 1.0f : 0.0f;
  return l0 * (1.0f - fx) * (1.0f - fy) + l1 * fx * (1.0f - fy) + l2 * (1.0f - fx) * fy + l3 * fx * fy;
}

// shadow_blur's linear depth: znear / d, d guarded at 1e-20
__device__ __forceinline__ float linear(const ShadowResolveArgs& a, float d) {
  return a.znear / (fabsf(d) < 1e-20f ? 1e-20f : d);
}

// One output texel of a shadow_blur pass: `sv` / `dv` the term and the
// linear depth at the texel, their neighbours along the pass `sv_stride` /
// `dv_stride` apart in shared memory
__device__ __forceinline__ float blur_tap(const ShadowResolveArgs& a, const float* sv, int sv_stride, const float* dv,
                                          int dv_stride) {
  const float lin = dv[0];
  float acc = sv[0], accw = 1.0f;
#pragma unroll
  for (int sign = -1; sign <= 1; sign += 2) {
    const float dnext = dv[sign * dv_stride];
    const float dgrad = fabsf(lin - dnext) < 0.1f ? dnext - lin : 0.0f;
#pragma unroll
    for (int i = 1; i <= kTaps; ++i) {
      const float fw = a.tap_w[i - 1] * exp2f(-fabsf(dv[sign * i * dv_stride] - (lin + dgrad * (float)i)) * 100.0f);
      acc = acc + sv[sign * i * sv_stride] * fw;
      accw = accw + fw;
    }
  }
  return acc / accw;
}

__device__ __forceinline__ void store(const ShadowResolveArgs& a, int x, int y, float v) {
  const size_t ow = (size_t)a.sw * a.scale;
  if (a.scale == 2) {
    const float2 v2 = make_float2(v, v);
    float2* o = reinterpret_cast<float2*>(a.out + (size_t)y * 2 * ow + (size_t)x * 2);
    o[0] = v2;
    o[ow / 2] = v2;
    return;
  }
  for (int dy = 0; dy < a.scale; ++dy)
    for (int dx = 0; dx < a.scale; ++dx) a.out[((size_t)y * a.scale + dy) * ow + (size_t)x * a.scale + dx] = v;
}

// the block's tested texels into the count: one atomic a block
__device__ __forceinline__ void count_tested(const ShadowResolveArgs& a, bool tested) {
  const int n = __syncthreads_count(tested);
  if (threadIdx.x == 0 && threadIdx.y == 0 && n) atomicAdd(a.count, (unsigned)n);
}

__global__ void __launch_bounds__(kTX* kTY) resolve_px(ShadowResolveArgs a) {
  const int x = blockIdx.x * kTX + threadIdx.x;
  const int y = blockIdx.y * kTY + threadIdx.y;
  const bool inside = x < a.sw && y < a.sh;
  const Sun s = load_sun(a);
  const float d = inside ? depth_at(a, x, y) : 0.0f;
  if (inside) store(a, x, y, resolve(a, s, x, y, d));
  count_tested(a, inside && d > 0.0f);
}

__global__ void __launch_bounds__(kTX* kTY) resolve_blur(ShadowResolveArgs a) {
  __shared__ float s_lin[kRY][kRX];
  __shared__ float s_term[kRY][kRX];
  __shared__ float s_h[kRY][kTX];  // the horizontal pass over every row of the region
  const int tid = threadIdx.y * kTX + threadIdx.x;
  const int x0 = blockIdx.x * kTX - kTaps, y0 = blockIdx.y * kTY - kTaps;
  const Sun s = load_sun(a);
  for (int i = tid; i < kRY * kRX; i += kTX * kTY) {
    const int ry = i / kRX, rx = i - ry * kRX;
    const int gx = wrap(x0 + rx, a.sw), gy = wrap(y0 + ry, a.sh);
    const float d = depth_at(a, gx, gy);
    s_lin[ry][rx] = linear(a, d);
    s_term[ry][rx] = resolve(a, s, gx, gy, d);
  }
  __syncthreads();
  for (int i = tid; i < kRY * kTX; i += kTX * kTY) {
    const int ry = i / kTX, lx = i - ry * kTX;
    s_h[ry][lx] = blur_tap(a, &s_term[ry][lx + kTaps], 1, &s_lin[ry][lx + kTaps], 1);
  }
  __syncthreads();
  const int x = blockIdx.x * kTX + threadIdx.x;
  const int y = blockIdx.y * kTY + threadIdx.y;
  const bool inside = x < a.sw && y < a.sh;
  const int ry = threadIdx.y + kTaps;
  if (inside) store(a, x, y, blur_tap(a, &s_h[ry][threadIdx.x], kTX, &s_lin[ry][threadIdx.x + kTaps], kRX));
  count_tested(a, inside && depth_at(a, x, y) > 0.0f);
}

}  // namespace

// blur: the bilateral filter on; the count is zeroed here, before the launch
extern "C" int shadow_resolve_launch(ShadowResolveArgs args, int blur, cudaStream_t stream) {
  if (args.sw <= 0 || args.sh <= 0 || args.scale <= 0 || args.map_w <= 0 || args.map_h <= 0 ||
      args.width < args.sw * args.scale || args.height < args.sh * args.scale)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(args.count, 0, sizeof(unsigned int), stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((args.sw + kTX - 1) / kTX, (args.sh + kTY - 1) / kTY);
  if (blur)
    resolve_blur<<<grid, dim3(kTX, kTY), 0, stream>>>(args);
  else
    resolve_px<<<grid, dim3(kTX, kTY), 0, stream>>>(args);
  return (int)cudaGetLastError();
}
