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
// What bounds it on the card: it is a gather stencil, 16 taps + 3x3, with
// ~2x16x8 min/max per pixel. The input is read once and the output written
// once (8 bytes/pixel), so at 16x480x640 it moves ~40 MB: memory time is
// ~12 us at 3.35 TB/s, while the ~290 min/max/sub per pixel (~1.4 G ops)
// make it compute-bound on the SM ALUs.
// Design: grid (tiles_x, tiles_y, A); each block stages its 32x8 tile plus a
// 4-pixel halo (3 for the circle, 1 for NMS) in shared memory once, scores
// the tile plus a 1-pixel ring into shared memory, then thresholds, masks
// and suppresses from shared memory and writes only its output tile. No
// intermediate touches device memory.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int HALO = 4;
constexpr int SW = TX + 2 * HALO;  // staged image tile width
constexpr int SH = TY + 2 * HALO;
constexpr int RW = TX + 2;  // scored tile (+1 ring for NMS)
constexpr int RH = TY + 2;

__constant__ int c_dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int c_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__global__ void fast_score_nms_kernel(const float* __restrict__ imgs,
                                      float* __restrict__ out, int h, int w,
                                      float thr, int nms) {
  __shared__ float s_img[SH][SW];
  __shared__ float s_score[RH][RW];
  const int a = blockIdx.z;
  const float* img = imgs + (size_t)a * h * w;
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const int nthreads = TX * TY;

  for (int i = tid; i < SH * SW; i += nthreads) {
    const int ly = i / SW, lx = i % SW;
    const int gy = y0 - HALO + ly, gx = x0 - HALO + lx;
    s_img[ly][lx] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? img[(size_t)gy * w + gx] : 0.f;
  }
  __syncthreads();

  for (int i = tid; i < RH * RW; i += nthreads) {
    const int ly = i / RW, lx = i % RW;
    const int gy = y0 - 1 + ly, gx = x0 - 1 + lx;
    float s;
    if (gy < 0 || gy >= h || gx < 0 || gx >= w) {
      s = -INFINITY;
    } else if (gy < 3 || gy >= h - 3 || gx < 3 || gx >= w - 3) {
      s = 0.f;
    } else {
      // staged row of image row gy is gy - (y0 - HALO) = ly + HALO - 1
      const int cy = ly + HALO - 1, cx = lx + HALO - 1;
      const float c = s_img[cy][cx];
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) d[k] = s_img[cy + c_dy[k]][cx + c_dx[k]] - c;
      float bright = -INFINITY, dark = -INFINITY;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        float mn = d[k], mx = d[k];
#pragma unroll
        for (int j = 1; j < 9; ++j) {
          mn = fminf(mn, d[(k + j) & 15]);
          mx = fmaxf(mx, d[(k + j) & 15]);
        }
        bright = fmaxf(bright, mn);
        dark = fmaxf(dark, -mx);
      }
      s = fmaxf(bright, dark);
      s = (s > thr) ? s : 0.f;
    }
    s_score[ly][lx] = s;
  }
  __syncthreads();

  const int gx = x0 + threadIdx.x, gy = y0 + threadIdx.y;
  if (gx >= w || gy >= h) return;
  float c = s_score[threadIdx.y + 1][threadIdx.x + 1];
  if (nms) {
    float neigh = c;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        neigh = fmaxf(neigh, s_score[threadIdx.y + dy][threadIdx.x + dx]);
    c = (c >= neigh) ? c : 0.f;
  }
  out[(size_t)a * h * w + (size_t)gy * w + gx] = c;
}

}  // namespace

extern "C" int xmat_fast_score_nms(const void* imgs, void* out, int a, int h,
                                   int w, int nms, float thr, void* stream) {
  if (a <= 0 || h <= 0 || w <= 0) return 0;
  dim3 block(TX, TY);
  dim3 grid((w + TX - 1) / TX, (h + TY - 1) / TY, a);
  fast_score_nms_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)imgs, (float*)out, h, w, thr, nms);
  return (int)cudaGetLastError();
}
