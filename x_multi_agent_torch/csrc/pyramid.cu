// One level of the tracker's image pyramids: the next level of two images
// and the Scharr gradients of the first, from one read of the level.
//
// Replaces no Pallas kernel: the JAX package builds its pyramids in XLA
// (x_multi_agent_tpu/vision/image.py: build_pyramid, scharr_gradients). It
// was added because the port's plain chain (vision/image.py: every tap a
// full-frame multiply and add over edge-padded copies, 144 torch kernels a
// tracker frame) ran some 35x over its byte bound, on the critical path of
// the image fleet's device-bound frame.
// Semantics equal image.build_pyramid and image.scharr_gradients bit for bit:
//   * each stencil is separable: the vertical taps first, then the
//     horizontal ones, each pass summed left to right from tap 0, each
//     product and each sum rounded on its own (__fmul_rn, __fadd_rn: nvcc
//     would contract a*k + b into an FMA, which rounds once), zero taps
//     skipped (Scharr's derivative is -v[c-1] + v[c+1]);
//   * edges replicate: indices are clamped into the image, as _pad_edge's
//     concatenation pads;
//   * the next level is the [1 4 6 4 1]/16 blur at even rows and columns
//     from 0 only: ceil(H/2) x ceil(W/2);
//   * the taps (1/16, 4/16, 6/16, 3/32, 10/32, +-1) are exact in float32.
// What bounds it on the card: bytes, at some 18 operations a written pixel.
// A tracker frame of 64 agents at 480x640 needs the two base images read
// once, levels 1 and 2 of both pyramids and dx, dy of the previous image's
// three levels written once: 413 MB, 0.123 ms at 3.35 TB/s.
// Design: one launch per level for both images (the grid: tiles x agents x
// images; the previous image's blocks also write its gradients), so each
// level is read from memory once and level 1, written by the launch before,
// may still sit in L2. A block stages its 16x64 tile and the halo (2 rows
// above, 2 below, one 4-float chunk left and right) in shared memory with
// 16-byte cp.async copies (4-byte copies at the image's left and right edge
// or where rows are not 16-byte aligned). Each thread takes 4 neighbouring
// pixels of a row: the vertical passes at their 6 columns in registers, the
// horizontal ones from those, dx and dy written with 16-byte stores. The
// blur's vertical pass runs at the kept rows only, into shared memory, and
// its horizontal pass at the kept columns only, one output a thread.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 64;  // tile width, level pixels
constexpr int TY = 16;  // tile height
constexpr int THREADS = 256;
constexpr int SX0 = 4;                // staged columns start one chunk left of the tile
constexpr int SY0 = 2;                // staged rows start 2 rows above it
constexpr int SW = TX + 2 * SX0;      // 72 staged columns: 18 chunks of 4 floats
constexpr int CHUNKS = SW / 4;
constexpr int SH = TY + 3;            // staged rows y0-2 .. y0+TY
constexpr int NY = TY / 2;            // kept rows of a tile
constexpr int NX = TX / 2;            // kept columns of a tile
constexpr int BN = TX + 3;            // vertical blur at columns x0-2 .. x0+TX
constexpr int BW = BN + 1;

constexpr float B0 = 1.f / 16, B1 = 4.f / 16, B2 = 6.f / 16;  // the blur's taps
constexpr float G0 = 3.f / 32, G1 = 10.f / 32;                // Scharr's smoothing taps

static_assert(THREADS == TY * (TX / 4), "one thread per 4 gradient pixels");
static_assert(THREADS == NY * NX, "one thread per kept pixel");

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// (a + b), (a * b) rounded each on its own
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

__global__ void __launch_bounds__(THREADS)
pyramid_level_kernel(const float* __restrict__ prev, const float* __restrict__ cur,
                     float* __restrict__ prev_next, float* __restrict__ cur_next,
                     float* __restrict__ dx, float* __restrict__ dy, int h, int w,
                     int tiles_x, int next, int vec) {
  __shared__ __align__(16) float s_in[SH * SW];
  __shared__ float s_blur[NY * BW];
  const int t = threadIdx.x;
  const int ty = blockIdx.x / tiles_x;
  const int y0 = ty * TY, x0 = (blockIdx.x - ty * tiles_x) * TX;
  const bool grads = blockIdx.z == 0;  // the previous image's blocks
  const size_t plane = (size_t)h * w;
  const float* img = (grads ? prev : cur) + blockIdx.y * plane;

  // ---- stage rows y0-2 .. y0+TY, columns x0-4 .. x0+TX+3, clamped ------
  for (int i = t; i < SH * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, q = i - r * CHUNKS;
    const float* row = img + (size_t)clampi(y0 - SY0 + r, 0, h - 1) * w;
    const int gx = x0 - SX0 + 4 * q;
    float* d = s_in + r * SW + 4 * q;
    if (vec && gx >= 0 && gx + 4 <= w) {
      cp_async16(d, row + gx);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) cp_async4(d + k, row + clampi(gx + k, 0, w - 1));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // ---- dx, dy of 4 pixels a thread: row y0 + t / 16, columns c .. c+3 ----
  if (grads) {
    const int ry = t / (TX / 4), cx = (t % (TX / 4)) * 4;
    const int y = y0 + ry, x = x0 + cx;
    float v[3][6];  // staged rows y-1 .. y+1 at columns x-1 .. x+4
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float* s = s_in + (ry + SY0 - 1 + i) * SW + cx + SX0;
      const float4 m = *reinterpret_cast<const float4*>(s);
      v[i][0] = s[-1];
      v[i][1] = m.x;
      v[i][2] = m.y;
      v[i][3] = m.z;
      v[i][4] = m.w;
      v[i][5] = s[4];
    }
    float vg[6], u[6];  // Scharr's vertical passes at columns x-1 .. x+4
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      vg[j] = add(add(mul(v[0][j], G0), mul(v[1][j], G1)), mul(v[2][j], G0));
      u[j] = add(-v[0][j], v[2][j]);
    }
    float ox[4], oy[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ox[k] = add(-vg[k], vg[k + 2]);
      oy[k] = add(add(mul(u[k], G0), mul(u[k + 1], G1)), mul(u[k + 2], G0));
    }
    if (y < h) {
      const size_t o = blockIdx.y * plane + (size_t)y * w + x;
      if (vec && x + 4 <= w) {
        *reinterpret_cast<float4*>(dx + o) = make_float4(ox[0], ox[1], ox[2], ox[3]);
        *reinterpret_cast<float4*>(dy + o) = make_float4(oy[0], oy[1], oy[2], oy[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (x + k < w) {
            dx[o + k] = ox[k];
            dy[o + k] = oy[k];
          }
        }
      }
    }
  }
  if (!next) return;

  // ---- the blur's vertical pass at the kept rows y0, y0+2, .. ----------
  for (int i = t; i < NY * BN; i += THREADS) {
    const int r = i / BN, j = i - r * BN;
    const float* s = s_in + 2 * r * SW + j + SX0 - 2;
    float v = mul(s[0], B0);
    v = add(v, mul(s[SW], B1));
    v = add(v, mul(s[2 * SW], B2));
    v = add(v, mul(s[3 * SW], B1));
    s_blur[r * BW + j] = add(v, mul(s[4 * SW], B0));
  }
  __syncthreads();

  // ---- its horizontal pass at the kept columns: one output a thread ------
  const int r = t / NX, jj = t % NX;
  const int hn = (h + 1) / 2, wn = (w + 1) / 2;
  const int yn = y0 / 2 + r, xn = x0 / 2 + jj;
  if (yn < hn && xn < wn) {
    const float* s = s_blur + r * BW + 2 * jj;
    float v = mul(s[0], B0);
    v = add(v, mul(s[1], B1));
    v = add(v, mul(s[2], B2));
    v = add(v, mul(s[3], B1));
    v = add(v, mul(s[4], B0));
    (grads ? prev_next : cur_next)[blockIdx.y * (size_t)hn * wn + (size_t)yn * wn + xn] = v;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// One pyramid level of a images (a, h, w): prev's dx and dy, and with
// `next` the next level of prev and of cur, (a, ceil(h/2), ceil(w/2)).
// Without `next`, cur and the next levels' pointers are not read and may be
// null.
extern "C" int xmat_pyramid_level(const void* prev, const void* cur, void* prev_next,
                                  void* cur_next, void* dx, void* dy, int a, int h, int w,
                                  int next, void* stream) {
  if (a <= 0 || h <= 0 || w <= 0) return 0;
  const int tiles_x = (w + TX - 1) / TX, tiles_y = (h + TY - 1) / TY;
  const int vec = w % 4 == 0 && aligned16(prev) && (!next || aligned16(cur)) &&
                  aligned16(dx) && aligned16(dy);
  const dim3 grid(tiles_x * tiles_y, a, next ? 2 : 1);
  pyramid_level_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)prev, (const float*)cur, (float*)prev_next, (float*)cur_next, (float*)dx,
      (float*)dy, h, w, tiles_x, next, vec);
  return (int)cudaGetLastError();
}
