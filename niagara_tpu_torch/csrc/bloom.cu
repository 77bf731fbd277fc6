// The bloom chain's filters for Hopper.
//
// The reference has no Pallas kernel for bloom: niagara_tpu/ops/bloom.py
// expands every bilinear tap of the 13-tap Jimenez downsample and the 9-tap
// tent upsample into a fixed stencil and sums it as padded, shifted slices
// (`_down2`, `_up2`, `_bilinear_x2`), one XLA op per tap.  In eager PyTorch
// that is one multiply and one add launch per tap, ~1,500 launches a frame
// at 1080p; these kernels do the chain in 10 launches (4 downs, the tail, 4
// ups, the expansion).  Plain torch twins: ops/bloom.py::_down2,
// up2_add_plain, tail_plain and _bilinear_x2.
//
// Each output texel is summed with its plain version's ops in its order
// (acc starts at 0 and takes `acc + w * v` tap by tap, mul and add each
// rounded: the library is built with --fmad=false), and the reference's
// edge padding is index clamping, so every kernel equals its plain version
// bit for bit.  The weights come from the plain version's tables (the
// wrapper passes them by value); every loop over them unrolls at compile
// time, so they stay in the parameter bank.
//
// What bounds them: bytes on the large levels, launches on the small ones.
// A 1080p frame's down and up chain moves ~29 MB (level 0 of the down
// chain reads 960x540x3 f32 = 6.2 MB), ~8.7 us at 3.35 TB/s; levels 4-7
// move under 0.1 MB over what were 6 launches of ~2.5 us each.  On the H100
// the chain takes ~52 us (PERF.md §6): the tail runs on one SM (~12 us)
// and ~1.3 us pass between launches even when they are dependent.
//
// * bloom_down (the large levels): one block per 32x8 output tile with
//   all three channels.  It stages the tile's source and halo (20 rows of
//   72 columns a channel, clamped at the edges; fewer on a small level) in
//   shared memory once, with coalesced asynchronous copies (cp.async, 16
//   bytes where the row is 16-byte aligned, all in flight at once), so
//   each source texel comes from device memory once a block instead of up
//   to 36 times through L1; each thread then sums a 2x2 quad of outputs a
//   channel from an 8x8 window (16 shared loads an output, not 36) and
//   writes each output row's pair as one float2.
// * bloom_up (the large levels): one block per 32x4 source texels, all
//   three channels; the source and its 2-texel halo staged the same way;
//   each thread reads the finer mip under its 2x2 output quad once (two
//   float2 a channel, coalesced), computes the four phases (4x4 taps each
//   from one 5x5 window) and writes `mips[i] + up` a row pair at a time,
//   cropped to the finer mip's size.
// * bloom_tail (the small levels): from the first level whose mips down to
//   the chain's last fit in 48 KB of shared memory (ops/bloom.py
//   tail_start: mip 4 at 1080p, mip 1 at 256x128; it holds up to 227 KB),
//   every remaining down and then every up back to that level, in one
//   launch on one block of 512 threads, __syncthreads() between levels.
//   The mips stay in dynamic shared memory; each up level overwrites its
//   mip in place (an output reads only its own texel of the finer mip),
//   and every level computed is also written to device memory (the gate
//   holds each to the plain chain's).  A cluster of 4-16 blocks, each
//   owning a band of rows and reading its halo through distributed shared
//   memory, was measured slower at every start (PERF.md §6).
// * Dependent launches: the chain's kernels go out through
//   cudaLaunchKernelEx with programmatic stream serialization, so a launch
//   can start while the previous kernel drains.  Before
//   griddepcontrol.wait a kernel only computes indices: it reads and
//   writes no device memory (the caching allocator may hand it an output
//   block that the previous kernel still reads), and every block waits, so
//   each kernel completes after all earlier ones.  Once its last loads are
//   issued a block lets the next launch start (launch_dependents).
// * bloom_x2: the same quad scheme for the 1:2 bilinear expansion (2x2 taps
//   a phase from a 3x3 window), all three channels in one thread, written
//   straight into the [H, W, 3] full-resolution image the composite adds:
//   each output row's two pixels as 6 contiguous floats (three 8-byte
//   stores), where one thread per channel wrote 4-byte values at a
//   12-byte stride.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

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
// The tail's levels: level 0 is its source, level k is h[k] x w[k] (each
// half the one above, rounded up).  In `out` (floats) level k's down output
// starts at down_off[k] (k = 1..n-1) and its up output at up_off[k]
// (k = 0..n-2); soff (level k's offset in shared memory) is filled here.
struct TailLevels {
  int n;
  int h[8], w[8];
  int down_off[8], up_off[8];
  int soff[8];
};

namespace {

constexpr int kBx = 32, kBy = 8;  // bloom_x2's block
// bloom_down: 16x4 threads a channel (threadIdx.z), each a 2x2 output quad,
// so a 32x8 output tile, reading source rows 2*oy0-2.. (20) and columns
// 2*ox0-4.. (72: from a 16-byte boundary when the source's width is a
// multiple of 4)
constexpr int kDownTx = 16, kDownTy = 4;
constexpr int kDownOw = 2 * kDownTx, kDownOh = 2 * kDownTy;
constexpr int kDownSh = 2 * kDownOh + 4, kDownSw = 2 * kDownOw + 8;
// bloom_up: 32x4 threads a channel (threadIdx.z), one source texel each (its
// 2x2 output quad), the source staged from row y0-2 (8 rows) and column
// x0-4 (40 columns)
constexpr int kUpTx = 32, kUpTy = 4;
constexpr int kUpSh = kUpTy + 4, kUpSw = kUpTx + 8;
// bloom_tail: one block of 512 threads (up to 128 registers a thread: a
// texel's taps load at once, not one latency each);
// the most dynamic shared memory a block of the H100 may hold (227 KB)
constexpr int kTailThreads = 512;
constexpr int kTailMaxSmem = 232448;

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// Programmatic dependent launch: wait for the previous kernel on the stream
// to complete (its writes visible); let the next one start launching.
__device__ __forceinline__ void wait_previous_grid() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void launch_next_grid() { asm volatile("griddepcontrol.launch_dependents;" ::: "memory"); }

// Stage rows [y0, y0 + rows) x columns [x0, x0 + 4 * quads) of the three
// channel planes of src (h x w, indices clamped at the edges) into s,
// layout [3][kRows][4 * kQuads], with asynchronous copies (cp.async: every
// copy in flight at once, no registers); the caller waits for them.  x0 is a
// multiple of 4, so where w is too (and src 16-byte aligned) every
// in-bounds quad is one 16-byte copy.
template <int kRows, int kQuads>
__device__ __forceinline__ void stage_tile(const float* __restrict__ src, int h, int w, int y0, int x0, int rows,
                                           int quads, float4* s) {
  const bool vec = (w & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  const int nt = blockDim.x * blockDim.y * blockDim.z;
  for (int q = (threadIdx.z * blockDim.y + threadIdx.y) * blockDim.x + threadIdx.x; q < rows * quads; q += nt) {
    const int r = q / quads, k = q % quads, x = x0 + 4 * k;
    const float* row = src + (size_t)clampi(y0 + r, h - 1) * w;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* p = row + (size_t)c * h * w;
      float* d = reinterpret_cast<float*>(s + (c * kRows + r) * kQuads + k);
      if (vec && x >= 0 && x + 3 < w) {
        __pipeline_memcpy_async(d, p + x, 16);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) __pipeline_memcpy_async(d + e, p + clampi(x + e, w - 1), 4);
      }
    }
  }
  __pipeline_commit();
}

// out[c][oy][ox..ox+1] = (a, b), cropped at ow; one float2 where aligned
__device__ __forceinline__ void store_pair(float* d, bool pair, int ox, int ow, float a, float b) {
  if (pair && ox + 1 < ow) {
    *reinterpret_cast<float2*>(d) = make_float2(a, b);
  } else {
    d[0] = a;
    if (ox + 1 < ow) d[1] = b;
  }
}

__global__ void __launch_bounds__(kDownTx* kDownTy * 3)
    bloom_down(const float* __restrict__ src, int h, int w, float* __restrict__ out, int oh, int ow, DownWeights k) {
  __shared__ float4 tile4[3 * kDownSh * kDownSw / 4];
  const float* tile = reinterpret_cast<const float*>(tile4);
  const int ox0 = blockIdx.x * kDownOw, oy0 = blockIdx.y * kDownOh;
  const int oy = oy0 + 2 * threadIdx.y, ox = ox0 + 2 * threadIdx.x;
  const bool pair = (ow & 1) == 0 && (reinterpret_cast<uintptr_t>(out) & 7) == 0;
  wait_previous_grid();
  // only the rows and columns the tile's live outputs read (a small level
  // has fewer than a tile's): qy threads' quads down read 4 * qy + 4 rows,
  // qx across 4 * qx + 6 columns (qx + 2 groups of 4)
  const int qy = (min(oh - oy0, kDownOh) + 1) / 2, qx = (min(ow - ox0, kDownOw) + 1) / 2;
  stage_tile<kDownSh, kDownSw / 4>(src, h, w, 2 * oy0 - 2, 2 * ox0 - 4, 4 * qy + 4, qx + 2, tile4);
  launch_next_grid();
  __pipeline_wait_prior(0);
  __syncthreads();
  if (oy >= oh || ox >= ow) return;
  {
    const int c = threadIdx.z;
    // source row 2*oy+j-2 is tile row 4*ty + 2a + j for output row oy + a;
    // source column 2*ox+i-2 is tile column 4*tx + 2 + 2b + i for column ox + b
    const float* s = tile + (c * kDownSh + 4 * threadIdx.y) * kDownSw + 4 * threadIdx.x + 2;
    float acc[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float v[8];
      const float2* p = reinterpret_cast<const float2*>(s + r * kDownSw);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float2 t = p[m];
        v[2 * m] = t.x;
        v[2 * m + 1] = t.y;
      }
      // rows in increasing j, columns in increasing i for each output: the
      // plain version's order
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int j = r - 2 * a;
        if (j < 0 || j >= 6) continue;
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int i = 0; i < 6; ++i) acc[a][b] = acc[a][b] + k.w[j][i] * v[2 * b + i];
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
      if (oy + a < oh) store_pair(out + ((size_t)c * oh + oy + a) * ow + ox, pair, ox, ow, acc[a][0], acc[a][1]);
  }
}

__global__ void __launch_bounds__(kUpTx* kUpTy * 3)
    bloom_up(const float* __restrict__ src, int h, int w, const float* __restrict__ mip, float* __restrict__ out,
             int oh, int ow, UpWeights k) {
  __shared__ float4 tile4[3 * kUpSh * kUpSw / 4];
  const float* tile = reinterpret_cast<const float*>(tile4);
  const int x0 = blockIdx.x * kUpTx, y0 = blockIdx.y * kUpTy;
  const int x = x0 + threadIdx.x, y = y0 + threadIdx.y, ox = 2 * x;
  const bool live = x < w && y < h;
  const bool pair = (ow & 1) == 0 && ((reinterpret_cast<uintptr_t>(mip) | reinterpret_cast<uintptr_t>(out)) & 7) == 0;
  wait_previous_grid();
  // only the rows and columns the tile's live texels read
  const int ny = min(h - y0, kUpTy), nx = min(w - x0, kUpTx);
  stage_tile<kUpSh, kUpSw / 4>(src, h, w, y0 - 2, x0 - 4, ny + 4, (nx + 9) / 4, tile4);
  // the finer mip under this thread's quad in its channel, read once
  const int c = threadIdx.z;
  float m[2][2];
#pragma unroll
  for (int py = 0; py < 2; ++py) {
    const int oy = 2 * y + py;
    m[py][0] = m[py][1] = 0.0f;
    if (!live || oy >= oh) continue;
    const float* p = mip + ((size_t)c * oh + oy) * ow + ox;
    if (pair && ox + 1 < ow) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(p));
      m[py][0] = t.x;
      m[py][1] = t.y;
    } else {
      m[py][0] = __ldg(p);
      if (ox + 1 < ow) m[py][1] = __ldg(p + 1);
    }
  }
  launch_next_grid();
  __pipeline_wait_prior(0);
  __syncthreads();
  if (!live) return;
  {
    // source (y + j - 2, x + i - 2) is tile (ty + j, tx + 2 + i)
    const float* s = tile + (c * kUpSh + threadIdx.y) * kUpSw + threadIdx.x + 2;
    float v[5][5];
#pragma unroll
    for (int j = 0; j < 5; ++j)
#pragma unroll
      for (int i = 0; i < 5; ++i) v[j][i] = s[j * kUpSw + i];
#pragma unroll
    for (int py = 0; py < 2; ++py) {
      const int oy = 2 * y + py;
      if (oy >= oh) break;
      float o[2];
#pragma unroll
      for (int px = 0; px < 2; ++px) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc = acc + k.w[py][px][j][i] * v[py + j][px + i];
        o[px] = m[py][px] + acc;
      }
      store_pair(out + ((size_t)c * oh + oy) * ow + ox, pair, ox, ow, o[0], o[1]);
    }
  }
}

// The tail's threads over a level's columns: thread tid takes column tx of
// rows ty, ty + sy, ... (sy rows at a time when the level is at most
// kTailThreads wide, else columns tx, tx + sx, ... of every row), so the
// loops over a level divide nothing per texel.  The three channels' rows
// are one run of rows: row r of n a channel is channel c = channel(r, n)'s
// row r - c * n (two compares, not a division per row).
struct Spread {
  int tx, ty, sx, sy;
};
__device__ __forceinline__ int channel(int r, int n) { return r >= 2 * n ? 2 : (r >= n ? 1 : 0); }
__device__ __forceinline__ Spread spread(int w) {
  const int tid = threadIdx.x;
  if (w > kTailThreads) return {tid, 0, kTailThreads, 1};
  const int sy = kTailThreads / w;
  return {tid % w, tid < sy * w ? tid / w : 1 << 30, w, sy};
}

// The tail: one block, every level's three planes in shared memory at
// TailLevels::soff.
__global__ void __launch_bounds__(kTailThreads, 1)
    bloom_tail(const float* __restrict__ src, float* __restrict__ out, TailLevels L, DownWeights dk, UpWeights uk) {
  extern __shared__ float4 tail4[];
  float* const sm = reinterpret_cast<float*>(tail4);
  wait_previous_grid();
  {  // level 0 from device memory
    const int h = L.h[0], w = L.w[0];
    const bool vec = (w & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
    const int cw = vec ? w / 4 : w;  // copies a row, of 16 or 4 bytes
    const Spread t = spread(cw);
    for (int r = t.ty; r < 3 * h; r += t.sy) {
      const int i = r * w;
      for (int x = t.tx; x < cw; x += t.sx) {
        if (vec) {
          __pipeline_memcpy_async(sm + i + 4 * x, src + i + 4 * x, 16);
        } else {
          __pipeline_memcpy_async(sm + i + x, src + i + x, 4);
        }
      }
    }
    __pipeline_commit();
  }
  launch_next_grid();
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int k = 0; k + 1 < L.n; ++k) {  // down: level k -> level k + 1
    const int h = L.h[k], w = L.w[k], oh = L.h[k + 1], ow = L.w[k + 1];
    const Spread t = spread(ow);
    for (int x = t.tx; x < ow; x += t.sx) {
      int col[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) col[i] = clampi(2 * x + i - 2, w - 1);
      for (int r = t.ty; r < 3 * oh; r += t.sy) {
        const int c = channel(r, oh), y = r - c * oh;
        const float* p = sm + L.soff[k] + c * h * w;
        float* d = sm + L.soff[k + 1] + c * oh * ow;
        float* o = out + L.down_off[k + 1] + c * oh * ow;
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float* row = p + clampi(2 * y + j - 2, h - 1) * w;
#pragma unroll
          for (int i = 0; i < 6; ++i) acc = acc + dk.w[j][i] * row[col[i]];
        }
        d[y * ow + x] = acc;
        o[y * ow + x] = acc;
      }
    }
    __syncthreads();
  }
  for (int k = L.n - 2; k >= 0; --k) {  // up: level k + 1 (accumulated) -> level k, plus mip k
    const int h = L.h[k + 1], w = L.w[k + 1], oh = L.h[k], ow = L.w[k];
    const Spread t = spread(w);
    for (int x = t.tx; x < w; x += t.sx) {
      int col[5];
#pragma unroll
      for (int i = 0; i < 5; ++i) col[i] = clampi(x + i - 2, w - 1);
      for (int r = t.ty; r < 3 * h; r += t.sy) {
        const int c = channel(r, h), y = r - c * h;
        const float* p = sm + L.soff[k + 1] + c * h * w;
        float* d = sm + L.soff[k] + c * oh * ow;
        float* o = out + L.up_off[k] + c * oh * ow;
        float v[5][5];
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          const float* row = p + clampi(y + j - 2, h - 1) * w;
#pragma unroll
          for (int i = 0; i < 5; ++i) v[j][i] = row[col[i]];
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
              for (int i = 0; i < 4; ++i) acc = acc + uk.w[py][px][j][i] * v[py + j][px + i];
            const float sum = d[oy * ow + ox] + acc;
            d[oy * ow + ox] = sum;
            o[oy * ow + ox] = sum;
          }
        }
      }
    }
    __syncthreads();
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

// cudaLaunchKernelEx with programmatic stream serialization; the launch's
// error, the last error cleared either way
template <typename... Params, typename... Args>
int launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
                     Args&&... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace

// src [3, h, w] -> out [3, (h+1)/2, (w+1)/2]
extern "C" int bloom_down_launch(const float* src, int c, int h, int w, float* out, DownWeights k,
                                 cudaStream_t stream) {
  if (c != 3 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  const int oh = (h + 1) / 2, ow = (w + 1) / 2;
  return launch_dependent(bloom_down, dim3((ow + kDownOw - 1) / kDownOw, (oh + kDownOh - 1) / kDownOh),
                          dim3(kDownTx, kDownTy, 3), 0, stream, src, h, w, out, oh, ow, k);
}

// src [3, h, w], mip and out [3, oh, ow] with oh <= 2h, ow <= 2w: out = mip + up2(src)
extern "C" int bloom_up_launch(const float* src, int c, int h, int w, const float* mip, float* out, int oh, int ow,
                               UpWeights k, cudaStream_t stream) {
  if (c != 3 || h <= 0 || w <= 0 || oh <= 0 || ow <= 0 || oh > 2 * h || ow > 2 * w) return (int)cudaErrorInvalidValue;
  return launch_dependent(bloom_up, dim3((w + kUpTx - 1) / kUpTx, (h + kUpTy - 1) / kUpTy), dim3(kUpTx, kUpTy, 3), 0,
                          stream, src, h, w, mip, out, oh, ow, k);
}

// src [3, h[0], w[0]] -> out: every level of the tail's down and up (see
// TailLevels), on one block
extern "C" int bloom_tail_launch(const float* src, float* out, TailLevels L, DownWeights dk, UpWeights uk,
                                 cudaStream_t stream) {
  if (L.n < 2 || L.n > 8 || L.h[0] <= 0 || L.w[0] <= 0) return (int)cudaErrorInvalidValue;
  size_t floats = 0;
  for (int k = 0; k < L.n; ++k) {
    if (k > 0 && (L.h[k] != (L.h[k - 1] + 1) / 2 || L.w[k] != (L.w[k - 1] + 1) / 2)) return (int)cudaErrorInvalidValue;
    if ((k > 0 && L.down_off[k] < 0) || (k + 1 < L.n && L.up_off[k] < 0)) return (int)cudaErrorInvalidValue;
    L.soff[k] = (int)floats;
    floats += ((size_t)3 * L.h[k] * L.w[k] + 3) & ~(size_t)3;  // each level 16-byte aligned
  }
  const size_t smem = floats * sizeof(float);
  if (smem > (size_t)kTailMaxSmem) return (int)cudaErrorInvalidValue;
  static const cudaError_t configured =
      cudaFuncSetAttribute(bloom_tail, cudaFuncAttributeMaxDynamicSharedMemorySize, kTailMaxSmem);
  if (configured != cudaSuccess) return (int)configured;
  return launch_dependent(bloom_tail, dim3(1), dim3(kTailThreads), smem, stream, src, out, L, dk, uk);
}

// src [c, h, w] -> out [oh, ow, c] with oh <= 2h, ow <= 2w
extern "C" int bloom_x2_launch(const float* src, int c, int h, int w, float* out, int oh, int ow, X2Weights k,
                               cudaStream_t stream) {
  if (c != 3 || h <= 0 || w <= 0 || oh <= 0 || ow <= 0 || oh > 2 * h || ow > 2 * w) return (int)cudaErrorInvalidValue;
  bloom_x2<<<dim3((w + kBx - 1) / kBx, (h + kBy - 1) / kBy, 1), dim3(kBx, kBy), 0, stream>>>(src, h, w, out, oh, ow, k);
  return (int)cudaGetLastError();
}
