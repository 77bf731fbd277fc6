// G-buffer encode for Hopper: gbuffer_from_attrs in one launch.
//
// Replaces no Pallas kernel: the reference's gbuffer_from_attrs
// (niagara_tpu/ops/shade.py:260) is XLA ops, fused by XLA.  Its port ran
// as ~250 eager torch ops over whole-frame tensors, each a launch paced by
// the host and a full-frame write.  Plain torch twin:
// ops/shade.py::gbuffer_plain; this kernel computes its outputs bit for
// bit, with its ops in its order (no contraction: --fmad=false; IEEE
// division and square root; powf and log2f as torch's pow and log2 call
// them).
//
// One thread a pixel, blocks of kBX x kBY pixels.  A valid pixel gathers
// its material row (row 0 when the table has one material), picks the mip
// from its duv and the albedo's texel area, samples each slot the scene
// textures (a 16-byte quad load where the table has quads, four wrapped
// texel loads where it does not; slot 0 through the row's mip metadata
// where the scene has it, the others through mip_rows), bends its normal
// through the screen-space tangent frame (the world positions and uvs of
// the pixel and its right-hand and lower-row neighbours, or the ones
// before at the last column and row, as ddx/ddy repeat their last
// difference), applies the post-pass alpha discard, and encodes g0 and
// g1.  An invalid pixel writes zeros and samples nothing.  The block sums
// the pixels it shaded into one word.
//
// What bounds it: bytes.  At 1080p it reads the attribute planes of the
// valid pixels (52 B each, the channels it uses share their sectors), the
// valid mask and, with a normal map, the depth (5 B a pixel), a 16-byte
// quad a sampled slot, and writes g0 and g1 (32 B) and valid (1 B) a
// pixel: ~0.2-0.3 GB, ~0.1 ms at 3.35 TB/s.  The neighbours' planes and
// depth are read again from L1 (the block's other rows and columns) and
// the material table and texels mostly from L1 and L2.
//
// Specialised at compile time on what changes the kernel's shape: whether
// it samples textures, whether a normal map applies (a normal-mapped slot,
// depth and the inverse view-projection given), and whether the table has
// quads.  The sampled slots, slot 0's metadata path and the one-material
// broadcast are launch constants: every thread takes the same branch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBX = 32;  // a warp: 32 pixels of a row
constexpr int kBY = 8;   // rows a block
constexpr int kAttr = 13;
constexpr int kMaxMips = 14;  // render/textures.py MAX_MIPS

}  // namespace

// Mirror of class GBufferArgs in _build.py (ctypes); passed by value.
struct GBufferArgs {
  const float* attrs;           // [H, W, 13] f32
  const unsigned char* valid;   // [H, W] bool
  const float* depth;           // [H, W] f32 (read with a normal map)
  const float* mat_row;         // [nm, row_len] f32
  const unsigned char* texels;  // [N, 4] u8
  const unsigned char* quads;   // [N, 16] u8 (read with kQuad)
  const int* mip_rows;          // [n_tex * 14, 4] i32: offset, w, h, 0
  float* g0;                    // [H, W, 4] f32
  float* g1;                    // [H, W, 4] f32
  unsigned char* valid_out;     // [H, W] bool
  unsigned long long* count;    // one zeroed word: the pixels shaded
  float ivp[16];                // inverse view-projection, row-major
  int width, height, nm, row_len, n_tex;
  int slots;                    // bit i: slot i is sampled
  int meta;                     // slot 0 addresses its mips from row columns 16-19
};

namespace {

// torch's clamp_min and maximum on floats: a NaN operand propagates
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__device__ __forceinline__ float maximum(float a, float b) { return a != a ? a : (b != b ? b : fmaxf(a, b)); }
// torch.remainder on integers: the sign of the divisor
__device__ __forceinline__ int remainder(int a, int b) {
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
__device__ __forceinline__ float dot3(const float* a, const float* b) { return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]; }
__device__ __forceinline__ float unorm(unsigned v) { return (float)v / 255.0f; }
__device__ __forceinline__ float from_srgb(float c) { return powf(clamp_min(c, 0.0f), 2.2f); }
__device__ __forceinline__ float to_srgb(float c) { return powf(clamp_min(c, 0.0f), (float)(1.0 / 2.2)); }

// a / |a| guarded at 1e-20, in place
__device__ __forceinline__ void normalize(float* a) {
  const float len = clamp_min(sqrtf(dot3(a, a)), 1e-20f);
  a[0] = a[0] / len;
  a[1] = a[1] / len;
  a[2] = a[2] / len;
}

// render/textures.py select_mip_from_area
__device__ __forceinline__ int select_mip(float duv, float area) {
  const float m = 0.5f * log2f(clamp_min(duv * area, 1.0f));
  return (int)(m != m ? m : fminf(fmaxf(m, 0.0f), (float)(kMaxMips - 1)));
}

__device__ __forceinline__ void unorm4(uint32_t w, float* out) {
  out[0] = unorm(w & 255u);
  out[1] = unorm((w >> 8) & 255u);
  out[2] = unorm((w >> 16) & 255u);
  out[3] = unorm(w >> 24);
}

// render/textures.py sample (bilinear): texture `tex_id` at uv, mip
// `mip`; with `use_meta` (slot 0) its mips addressed from `meta`, the
// row's mip-0 offset, width, height and mip count
template <bool kQuad>
__device__ __forceinline__ void sample(const GBufferArgs& g, int tex_id, float u_in, float v_in, int mip,
                                       bool use_meta, float4 meta, float* out) {
  const int tid = min(max(tex_id, 0), g.n_tex - 1);
  int m = min(max(mip, 0), kMaxMips - 1);
  int off, w, h;
  if (use_meta) {
    const int off0 = (int)meta.x, w0 = (int)meta.y, h0 = (int)meta.z, cnt = (int)meta.w;
    m = min(m, max(cnt - 1, 0));
    w = max(w0 >> m, 1);
    h = max(h0 >> m, 1);
    off = off0;
    for (int k = 0; k < m; ++k) off += max(w0 >> k, 1) * max(h0 >> k, 1);
  } else {
    const int4 r = __ldg(reinterpret_cast<const int4*>(g.mip_rows) + (tid * kMaxMips + m));
    off = r.x;
    w = r.y;
    h = r.z;
  }
  const float wf = (float)w, hf = (float)h;
  const float u = u_in - floorf(u_in);
  const float v = v_in - floorf(v_in);
  const float x = u * wf - 0.5f;
  const float y = v * hf - 0.5f;
  const int x0 = (int)floorf(x);
  const int y0 = (int)floorf(y);
  const float fx = x - (float)x0;
  const float fy = y - (float)y0;
  float p[4][4];  // p(x0, y0), p(x0 + 1, y0), p(x0, y0 + 1), p(x0 + 1, y0 + 1)
  if (kQuad) {
    const int i = off + remainder(y0, h) * w + remainder(x0, w);
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(g.quads) + (size_t)(long long)i);
    unorm4(q.x, p[0]);
    unorm4(q.y, p[1]);
    unorm4(q.z, p[2]);
    unorm4(q.w, p[3]);
  } else {
    const uint32_t* t = reinterpret_cast<const uint32_t*>(g.texels);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = off + remainder(y0 + (k >> 1), h) * w + remainder(x0 + (k & 1), w);
      unorm4(__ldg(t + (size_t)(long long)i), p[k]);
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float top = p[0][c] * (1.0f - fx) + p[1][c] * fx;
    const float bot = p[2][c] * (1.0f - fx) + p[3][c] * fx;
    out[c] = top * (1.0f - fy) + bot * fy;
  }
}

// ops/shade.py _world_position of pixel (x, y)
__device__ __forceinline__ void world_position(const GBufferArgs& g, int x, int y, float* out) {
  const float ndc_x = ((float)x + 0.5f) / (float)g.width * 2.0f - 1.0f;
  const float ndc_y = 1.0f - ((float)y + 0.5f) / (float)g.height * 2.0f;
  const float d = __ldg(g.depth + (size_t)y * g.width + x);
  float h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = ndc_x * g.ivp[4 * i] + ndc_y * g.ivp[4 * i + 1] + d * g.ivp[4 * i + 2] + g.ivp[4 * i + 3];
  const float wdiv = fabsf(h[3]) < 1e-20f ? 1e-20f : h[3];
  out[0] = h[0] / wdiv;
  out[1] = h[1] / wdiv;
  out[2] = h[2] / wdiv;
}

__device__ __forceinline__ float2 uv_at(const GBufferArgs& g, int x, int y) {
  const float* a = g.attrs + ((size_t)y * g.width + x) * kAttr;
  return make_float2(__ldg(a + 3), __ldg(a + 4));
}

__device__ __forceinline__ void cross(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// ops/shade.py _screen_space_tbn at pixel (x, y), then the mapped normal
// nmap.x * t + nmap.y * b + nmap.z * nrm, normalized, into nrm
__device__ void bend_normal(const GBufferArgs& g, int x, int y, const float* nmap, float* nrm) {
  const int xa = min(x, g.width - 2), ya = min(y, g.height - 2);
  float pa[3], pb[3], dp1[3], dp2[3];
  world_position(g, xa + 1, y, pb);
  world_position(g, xa, y, pa);
  const float2 ua = uv_at(g, xa, y), ub = uv_at(g, xa + 1, y);
#pragma unroll
  for (int i = 0; i < 3; ++i) dp1[i] = pb[i] - pa[i];
  const float du1 = ub.x - ua.x, dv1 = ub.y - ua.y;
  world_position(g, x, ya, pa);
  world_position(g, x, ya + 1, pb);
  const float2 uc = uv_at(g, x, ya), ud = uv_at(g, x, ya + 1);
#pragma unroll
  for (int i = 0; i < 3; ++i) dp2[i] = pa[i] - pb[i];
  const float du2 = uc.x - ud.x, dv2 = uc.y - ud.y;
  float dp2perp[3], dp1perp[3], t[3], b[3];
  cross(dp2, nrm, dp2perp);
  cross(nrm, dp1, dp1perp);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    t[i] = dp2perp[i] * du1 + dp1perp[i] * du2;
    b[i] = dp2perp[i] * dv1 + dp1perp[i] * dv2;
  }
  const float inv = 1.0f / sqrtf(clamp_min(maximum(dot3(t, t), dot3(b, b)), 1e-20f));
  float mapped[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) mapped[i] = nmap[0] * (t[i] * inv) + nmap[1] * (b[i] * inv) + nmap[2] * nrm[i];
  normalize(mapped);
#pragma unroll
  for (int i = 0; i < 3; ++i) nrm[i] = mapped[i];
}

// cullmath.oct_encode
__device__ __forceinline__ void oct_encode(const float* v, float* e) {
  const float denom = fabsf(v[0]) + fabsf(v[1]) + fabsf(v[2]);
  const float d = clamp_min(denom, 1e-20f);
  const float p0 = v[0] / d, p1 = v[1] / d;
  if (v[2] <= 0.0f) {
    e[0] = (1.0f - fabsf(p1)) * (v[0] >= 0.0f ? 1.0f : -1.0f);
    e[1] = (1.0f - fabsf(p0)) * (v[1] >= 0.0f ? 1.0f : -1.0f);
  } else {
    e[0] = p0;
    e[1] = p1;
  }
}

template <bool kTex, bool kNmap, bool kQuad>
__global__ void __launch_bounds__(kBX* kBY) gbuffer_px(GBufferArgs g) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  const bool inside = x < g.width && y < g.height;
  const size_t p = inside ? (size_t)y * g.width + x : 0;
  bool v = inside && __ldg(g.valid + p) != 0;
  float4 o0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), o1 = o0;
  if (v) {
    const float* a = g.attrs + p * kAttr;
    float nrm[3] = {__ldg(a), __ldg(a + 1), __ldg(a + 2)};
    normalize(nrm);
    // every id is in range (uncovered pixels carry 0); the clamp keeps a
    // wrong one inside the table
    const long long mat = g.nm == 1 ? 0 : min(max((long long)__ldg(a + 7), 0ll), (long long)g.nm - 1);
    const float* row = g.mat_row + mat * g.row_len;
    float alb[4], spec[4], emis[3];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      alb[c] = __ldg(row + c);
      spec[c] = __ldg(row + 4 + c);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) emis[c] = __ldg(row + 8 + c);
    if (kTex) {
      int tid[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) tid[s] = (int)__ldg(row + 11 + s);
      const float u = __ldg(a + 3), w = __ldg(a + 4);
      const int mip = select_mip(__ldg(a + 12), clamp_min(__ldg(row + 15), 1.0f));
      float t[4];
      const float4 none = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if ((g.slots & 1) && tid[0] > 0) {
        const float4 meta = g.meta ? make_float4(__ldg(row + 16), __ldg(row + 17), __ldg(row + 18), __ldg(row + 19))
                                   : none;
        sample<kQuad>(g, tid[0], u, w, mip, g.meta != 0, meta, t);
#pragma unroll
        for (int c = 0; c < 3; ++c) alb[c] = alb[c] * from_srgb(t[c]);
        alb[3] = alb[3] * t[3];
      }
      if (kNmap && tid[1] > 0) {
        sample<kQuad>(g, tid[1], u, w, mip, false, none, t);
        const float nmap[3] = {t[0] * 2.0f - 1.0f, t[1] * 2.0f - 1.0f, t[2] * 2.0f - 1.0f};
        bend_normal(g, x, y, nmap, nrm);
      }
      if ((g.slots & 4) && tid[2] > 0) {
        sample<kQuad>(g, tid[2], u, w, mip, false, none, t);
#pragma unroll
        for (int c = 0; c < 4; ++c) spec[c] = spec[c] * from_srgb(t[c]);
      }
      if ((g.slots & 8) && tid[3] > 0) {
        sample<kQuad>(g, tid[3], u, w, mip, false, none, t);
#pragma unroll
        for (int c = 0; c < 3; ++c) emis[c] = emis[c] * from_srgb(t[c]);
      }
      v = !((int)__ldg(a + 8) > 0 && alb[3] < 0.5f);
    }
    if (v) {
      const float lum[3] = {0.3f, 0.6f, 0.1f};
      const float emissivef = dot3(emis, lum) / (dot3(alb, lum) + 1e-3f);
      o0 = make_float4(to_srgb(alb[0]), to_srgb(alb[1]), to_srgb(alb[2]), log2f(1.0f + emissivef) / 5.0f);
      float e[2];
      oct_encode(nrm, e);
      o1 = make_float4(e[0] * 0.5f + 0.5f, e[1] * 0.5f + 0.5f, spec[3], 0.0f);
    }
  }
  if (inside) {
    reinterpret_cast<float4*>(g.g0)[p] = o0;
    reinterpret_cast<float4*>(g.g1)[p] = o1;
    g.valid_out[p] = v ? 1 : 0;
  }
  const int shaded = __syncthreads_count(v);
  if (threadIdx.x == 0 && threadIdx.y == 0 && shaded) atomicAdd(g.count, (unsigned long long)shaded);
}

template <bool kTex, bool kNmap>
cudaError_t launch_quad(const GBufferArgs& g, bool quad, dim3 grid, cudaStream_t stream) {
  if (quad)
    gbuffer_px<kTex, kNmap, true><<<grid, dim3(kBX, kBY), 0, stream>>>(g);
  else
    gbuffer_px<kTex, kNmap, false><<<grid, dim3(kBX, kBY), 0, stream>>>(g);
  return cudaGetLastError();
}

}  // namespace

// textured: sample the slots; nmap: bend normals (needs depth, textured);
// quad: the table has texels_quad
extern "C" int gbuffer_launch(GBufferArgs args, int textured, int nmap, int quad, cudaStream_t stream) {
  if (args.width <= 0 || args.height <= 0 || args.nm < 1 || (nmap && (!textured || args.width < 2 || args.height < 2)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((args.width + kBX - 1) / kBX, (args.height + kBY - 1) / kBY);
  if (!textured) return (int)launch_quad<false, false>(args, false, grid, stream);
  if (nmap) return (int)launch_quad<true, true>(args, quad != 0, grid, stream);
  return (int)launch_quad<true, false>(args, quad != 0, grid, stream);
}
