// K1: fused FAST-9/16 corner score + threshold + 3-px border + 3x3 NMS.
//
// Replaces the Pallas TPU kernels x_multi_agent_tpu/vision/pallas_fast.py
// (fast_score_nms_batch / _fast_kernel_batch / _score_strip, and the
// single-image fast_score_nms, which is this kernel with A = 1).
// Semantics equal fast.nms3(fast.fast_score(img, thr)) exactly:
//   * diffs are circle pixel minus centre over the 16 Bresenham taps;
//   * score = max over the 16 contiguous 9-arcs of the arc minimum, for both
//     polarities (the dark polarity's arc minimum of -d is -(arc max of d));
//   * score > thr else 0; 0 in the 3-px border;
//   * NMS keeps score >= max of the in-image 3x3 neighbourhood (out-of-image
//     neighbours are -inf, as reduce_window pads).
// Only subtract, min, max and compare: bit-exact against the plain version.
//
// What bounds it on the card: bytes. It reads each pixel once and writes one
// score (8 bytes/pixel): 49 MB at the slice's detection shapes (16x480x640 +
// 16x240x320), ~15 us at 3.35 TB/s, while its operations, with the rejection
// test below, come to ~25 per pixel (~5 us at 33.5 T fp32 ops/s). In
// practice the instructions around them (indices, bounds, shared-memory
// traffic, the list, the barriers) set the pace (PERF.md has the measured
// split).
// Design:
//   * compass-tap rejection, exact: every 9-arc holds two cyclically adjacent
//     taps of {0, 4, 8, 12}, so score > thr needs such a pair with d > thr
//     (bright) or -d > thr (dark); any other pixel scores 0, whatever thr.
//     The pixels that pass are compacted into a shared list (warp ballot)
//     and scored by all threads together, so no warp idles on a few lanes'
//     full scores; tiles off the image's border skip the bounds tests;
//   * a listed pixel is scored only in the polarities whose pair passed (the
//     other's score is <= thr, so it cannot win), with the TPU kernel's
//     log-depth arc tree (16x4 mins instead of 16x8); min and max are exact,
//     so the order changes no bit;
//   * 64x32 output tiles: the staged 72x40 tile is 1.4x the output and the
//     scored 66x34 region 1.1x; NMS keeps each thread on 8 rows of one
//     column, with the rows' 3-wide maxima in registers;
//   * a persistent grid walks the tiles; each block prefetches its next tile
//     with 4-byte cp.async copies (zero-filled off the image via src-size 0,
//     the zero halo) while it scores the current one.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TX = 64;
constexpr int TY = 32;
constexpr int HALO = 4;            // 3 for the circle, 1 for NMS
constexpr int SW = TX + 2 * HALO;  // staged image tile
constexpr int SH = TY + 2 * HALO;
constexpr int RW = TX + 2;  // scored region (+1 ring for NMS)
constexpr int RH = TY + 2;
constexpr int THREADS = 256;
constexpr int NMS_ROWS = TY / (THREADS / TX);  // rows per thread in NMS

// staged-tile offset of circle tap k (clockwise from 12 o'clock)
__host__ __device__ constexpr int tap(int k) {
  constexpr int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  constexpr int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  return dy[k] * SW + dx[k];
}

__device__ __forceinline__ void cp_async4_zfill(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}

struct Tile {
  int a, x0, y0;
};

__device__ __forceinline__ Tile tile_at(int t, int tiles_x, int tiles_y) {
  const int per_img = tiles_x * tiles_y;
  Tile r;
  r.a = t / per_img;
  const int rem = t - r.a * per_img;
  const int ty = rem / tiles_x;
  r.y0 = ty * TY;
  r.x0 = (rem - ty * tiles_x) * TX;
  return r;
}

// Issue the copies of tile t's staged image (one commit group).
__device__ __forceinline__ void stage_tile(float* dst, const float* __restrict__ imgs,
                                           const Tile& tl, int h, int w) {
  const float* img = imgs + (size_t)tl.a * h * w;
  int ly = threadIdx.x / SW, lx = threadIdx.x % SW;
  for (int i = threadIdx.x; i < SH * SW; i += THREADS) {
    const int gy = tl.y0 - HALO + ly, gx = tl.x0 - HALO + lx;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    cp_async4_zfill(dst + i, in ? img + (size_t)gy * w + gx : img, in);
    ly += THREADS / SW;
    lx += THREADS % SW;
    if (lx >= SW) {
      lx -= SW;
      ++ly;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// FAST score of one polarity of the pixel at staged offset ci: the maximum
// over the 16 9-arcs of the arc minimum of sign * (tap - centre), by
// minima over arcs of 2, 4, 8, then 9 taps. sign is +-1 (exact).
__device__ __forceinline__ float arc_score(const float* s, int ci, float sign) {
  const float c = s[ci];
  float v[16], m2[16], m4[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = sign * (s[ci + tap(k)] - c);
#pragma unroll
  for (int k = 0; k < 16; ++k) m2[k] = fminf(v[k], v[(k + 1) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) m4[k] = fminf(m2[k], m2[(k + 2) & 15]);
  float best = -INFINITY;
#pragma unroll
  for (int k = 0; k < 16; ++k)
    best = fmaxf(best, fminf(fminf(m4[k], m4[(k + 4) & 15]), v[(k + 8) & 15]));
  return best;
}

__global__ void __launch_bounds__(THREADS)
fast_score_nms_kernel(const float* __restrict__ imgs, float* __restrict__ out, int n_img,
                      int h, int w, float thr, int nms, int tiles_x, int tiles_y) {
  __shared__ float s_img[2][SH * SW];
  __shared__ float s_score[RH * RW];
  __shared__ unsigned short s_list[RH * RW];
  __shared__ int s_count;
  const int n_tiles = n_img * tiles_x * tiles_y;
  const int lane = threadIdx.x & 31;
  int t = blockIdx.x;
  if (t >= n_tiles) return;
  stage_tile(s_img[0], imgs, tile_at(t, tiles_x, tiles_y), h, w);
  for (int buf = 0; t < n_tiles; t += gridDim.x, buf ^= 1) {
    const Tile tl = tile_at(t, tiles_x, tiles_y);
    const int next = t + gridDim.x;
    if (next < n_tiles) {
      stage_tile(s_img[buf ^ 1], imgs, tile_at(next, tiles_x, tiles_y), h, w);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this tile has arrived
    if (threadIdx.x == 0) s_count = 0;
    __syncthreads();
    const float* s = s_img[buf];

    // ---- A: out-of-image -inf, border and rejected pixels 0; list the rest
    // with the polarities whose compass pair passed (bit 12 bright, 13 dark)
    const bool inner = tl.x0 >= 4 && tl.x0 + TX + 4 <= w && tl.y0 >= 4 && tl.y0 + TY + 4 <= h;
    for (int i0 = 0; i0 < RH * RW; i0 += THREADS) {
      const int i = i0 + threadIdx.x;
      unsigned pol = 0;
      if (i < RH * RW) {
        const int ly = i / RW, lx = i - (i / RW) * RW;
        const int gy = tl.y0 - 1 + ly, gx = tl.x0 - 1 + lx;
        float v = 0.f;
        bool interior = inner;
        if (!inner) {
          if (gy < 0 || gy >= h || gx < 0 || gx >= w) v = -INFINITY;
          interior = gy >= 3 && gy < h - 3 && gx >= 3 && gx < w - 3;
        }
        if (interior) {
          const int ci = (ly + HALO - 1) * SW + lx + HALO - 1;
          const float c = s[ci];
          const float d0 = s[ci + tap(0)] - c, d4 = s[ci + tap(4)] - c;
          const float d8 = s[ci + tap(8)] - c, d12 = s[ci + tap(12)] - c;
          // the adjacent pairs (0,4), (4,8), (8,12), (12,0); -d > thr is d < -thr
          pol = ((d0 > thr || d8 > thr) && (d4 > thr || d12 > thr)) ? 1u : 0u;
          pol |= ((d0 < -thr || d8 < -thr) && (d4 < -thr || d12 < -thr)) ? 2u : 0u;
        }
        s_score[i] = v;
      }
      const unsigned m = __ballot_sync(0xffffffffu, pol != 0);
      if (m) {
        int base = 0;
        if (lane == 0) base = atomicAdd(&s_count, __popc(m));
        base = __shfl_sync(0xffffffffu, base, 0);
        if (pol) s_list[base + __popc(m & ((1u << lane) - 1u))] = (unsigned short)(i | pol << 12);
      }
    }
    __syncthreads();

    // ---- B: the listed pixels' scores in the polarities that passed (the
    // other polarity's score is <= thr there, so it cannot win) ------------
    const int n_cand = s_count;
    for (int q = threadIdx.x; q < n_cand; q += THREADS) {
      const unsigned e = s_list[q];
      const int i = e & 4095;
      const int ci = (i / RW + HALO - 1) * SW + i % RW + HALO - 1;
      float v = arc_score(s, ci, (e & (1u << 12)) ? 1.f : -1.f);
      if ((e >> 12) == 3u) v = fmaxf(v, arc_score(s, ci, -1.f));
      s_score[i] = v > thr ? v : 0.f;
    }
    __syncthreads();

    // ---- C: NMS (or copy) and write the tile -----------------------------
    const int col = threadIdx.x % TX, r0 = (threadIdx.x / TX) * NMS_ROWS;
    const int gx = tl.x0 + col;
    float* o = out + (size_t)tl.a * h * w;
    if (nms) {
      auto hmax = [&](int row) {  // 3-wide maximum in scored-region row `row`
        const float* r = s_score + row * RW + col;
        return fmaxf(fmaxf(r[0], r[1]), r[2]);
      };
      float h0 = hmax(r0), h1 = hmax(r0 + 1);
#pragma unroll
      for (int r = 0; r < NMS_ROWS; ++r) {
        const float h2 = hmax(r0 + r + 2);
        const float c = s_score[(r0 + r + 1) * RW + col + 1];
        const int gy = tl.y0 + r0 + r;
        if (gx < w && gy < h) o[(size_t)gy * w + gx] = c >= fmaxf(fmaxf(h0, h1), h2) ? c : 0.f;
        h0 = h1;
        h1 = h2;
      }
    } else {
#pragma unroll
      for (int r = 0; r < NMS_ROWS; ++r) {
        const int gy = tl.y0 + r0 + r;
        if (gx < w && gy < h) o[(size_t)gy * w + gx] = s_score[(r0 + r + 1) * RW + col + 1];
      }
    }
    __syncthreads();  // s_img[buf] and s_score are reused by the next tile
  }
}

}  // namespace

extern "C" int xmat_fast_score_nms(const void* imgs, void* out, int a, int h, int w,
                                   int nms, float thr, void* stream) {
  if (a <= 0 || h <= 0 || w <= 0) return 0;
  const int tiles_x = (w + TX - 1) / TX, tiles_y = (h + TY - 1) / TY;
  const long long n_tiles = (long long)a * tiles_x * tiles_y;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fast_score_nms_kernel, THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  const int grid = (int)(n_tiles < (long long)n_sm * per_sm ? n_tiles : (long long)n_sm * per_sm);
  fast_score_nms_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)imgs, (float*)out, a, h, w, thr, nms, tiles_x, tiles_y);
  return (int)cudaGetLastError();
}
