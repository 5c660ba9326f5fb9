// K2: one Bouguet Lucas-Kanade pyramid level for K features of A agents.
//
// Replaces the Pallas TPU kernels x_multi_agent_tpu/vision/pallas_lk2.py
// (track_level / _lk2_kernel, the lane-packed default) and
// x_multi_agent_tpu/vision/pallas_lk.py (track_level / _lk_kernel, the
// per-feature layout used for half_win > 14): the window size is a launch
// parameter here, so one kernel serves every half_win.
// Semantics follow the plain version lk._track_level:
//   * the (2h+2)^2 slab based at floor(pt - h) of the EDGE-PADDED image,
//     with the slab base clamped to clip(by, 0, hp - p) exactly as the
//     reference's dynamic_slice does. The padded image is never built: a
//     padded index r maps to clamp(r - pad, 0, H - 1) of the unpadded one;
//   * constant-fraction bilinear -> (2h+1)^2 windows of prev, gx and gy;
//   * G = [[sum ix^2, sum ix iy], [., sum iy^2]], ok = min_eig(G)/(2h+1)^2
//     > min_eig_thr, det guarded at 1e-12;
//   * n_iters Gauss-Newton steps against the current image, each feature
//     stopping once |dnu|^2 <= eps^2 (applied step included, OpenCV-style).
//
// What bounds it on the card: latency, not bandwidth or FLOPs. Per feature
// and level it reads 3 windows once plus <= n_iters current windows (~1-2 KB
// each, mostly from L1/L2), and does ~30 flops per window pixel per
// iteration; but every iteration ends in a block-wide reduction whose result
// decides the next gather, a chain of up to n_iters dependent steps.
// Design: one block per (feature, agent), grid (K, A). The block stages the
// previous-frame windows (image, gx, gy) once in shared memory (size set from
// half_win at launch) and reduces G with one block reduction; each iteration
// gathers the current-frame slab straight from device memory (4 clamped taps
// per window pixel, cached), reduces b with one more block reduction and
// exits early as a block (the exit test is uniform: every thread evaluates
// it on the same reduced values). No padded image copies, no TPU lane
// packing.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Sum N per-thread values over the block; every thread gets the totals.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* scratch) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[n] += __shfl_down_sync(0xffffffffu, v[n], off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0)
#pragma unroll
    for (int n = 0; n < N; ++n) scratch[warp * N + n] = v[n];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      float t = lane < WARPS ? scratch[lane * N + n] : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(0xffffffffu, t, off);
      if (lane == 0) scratch[WARPS * N + n] = t;
    }
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = scratch[WARPS * N + n];
  __syncthreads();  // scratch is reused by the next reduction
}

struct Slab {
  int by, bx;  // clamped padded-image slab base
  float fx, fy;
};

// base(pt) of the reference: floor(pt - h) in padded coordinates, clamped
// as dynamic_slice clamps, plus the constant bilinear fractions.
__device__ __forceinline__ Slab slab_base(float x, float y, int half_win, int pad,
                                          int hp, int wp, int p) {
  const float sx = x - (float)half_win, sy = y - (float)half_win;
  const float bxf = floorf(sx), byf = floorf(sy);
  Slab s;
  s.fx = sx - bxf;
  s.fy = sy - byf;
  s.bx = clampi((int)bxf + pad, 0, wp - p);
  s.by = clampi((int)byf + pad, 0, hp - p);
  return s;
}

// bilinear window value (i, j) of an image through a slab
__device__ __forceinline__ float interp(const float* __restrict__ img, const Slab& s,
                                        int i, int j, int pad, int h, int w) {
  const int r0 = clampi(s.by + i - pad, 0, h - 1), r1 = clampi(s.by + i + 1 - pad, 0, h - 1);
  const int c0 = clampi(s.bx + j - pad, 0, w - 1), c1 = clampi(s.bx + j + 1 - pad, 0, w - 1);
  const float v00 = __ldg(img + (size_t)r0 * w + c0), v01 = __ldg(img + (size_t)r0 * w + c1);
  const float v10 = __ldg(img + (size_t)r1 * w + c0), v11 = __ldg(img + (size_t)r1 * w + c1);
  return v00 * (1.f - s.fx) * (1.f - s.fy) + v01 * s.fx * (1.f - s.fy) +
         v10 * (1.f - s.fx) * s.fy + v11 * s.fx * s.fy;
}

__global__ void __launch_bounds__(THREADS)
lk_level_kernel(const float* __restrict__ prev, const float* __restrict__ cur,
                const float* __restrict__ gx, const float* __restrict__ gy,
                const float* __restrict__ pts, const float* __restrict__ guess,
                float* __restrict__ flow, bool* __restrict__ ok_out, int h, int w,
                int k, int half_win, int n_iters, float min_eig_thr, float eps2) {
  extern __shared__ float smem[];
  const int win = 2 * half_win + 1, n = win * win;
  float* s_prev = smem;
  float* s_ix = smem + n;
  float* s_iy = smem + 2 * n;
  float* scratch = smem + 3 * n;  // (WARPS + 1) * 3 floats

  const int f = blockIdx.x, a = blockIdx.y;
  const size_t img_off = (size_t)a * h * w;
  prev += img_off; cur += img_off; gx += img_off; gy += img_off;
  const size_t fi = (size_t)a * k + f;
  const float px = pts[2 * fi], py = pts[2 * fi + 1];

  const int pad = half_win + 1, p = win + 1;
  const int hp = h + 2 * pad, wp = w + 2 * pad;

  // ---- previous-frame windows, staged once; structure tensor G ----------
  const Slab s0 = slab_base(px, py, half_win, pad, hp, wp, p);
  float g[3] = {0.f, 0.f, 0.f};
  for (int e = threadIdx.x; e < n; e += THREADS) {
    const int i = e / win, j = e % win;
    const float vp = interp(prev, s0, i, j, pad, h, w);
    const float vx = interp(gx, s0, i, j, pad, h, w);
    const float vy = interp(gy, s0, i, j, pad, h, w);
    s_prev[e] = vp;
    s_ix[e] = vx;
    s_iy[e] = vy;
    g[0] += vx * vx;
    g[1] += vx * vy;
    g[2] += vy * vy;
  }
  block_sum<3>(g, scratch);
  const float gxx = g[0], gxy = g[1], gyy = g[2];
  const float det = gxx * gyy - gxy * gxy;
  const float tr = gxx + gyy;
  const float min_eig = (tr - sqrtf(fmaxf(tr * tr - 4.f * det, 0.f))) * 0.5f;
  const bool ok = min_eig / (float)n > min_eig_thr;
  const float det_safe = fabsf(det) > 1e-12f ? det : 1.f;

  // ---- Gauss-Newton iterations against the current frame ---------------
  float nu_x = guess[2 * fi], nu_y = guess[2 * fi + 1];
  for (int it = 0; it < n_iters; ++it) {
    const Slab sc = slab_base(px + nu_x, py + nu_y, half_win, pad, hp, wp, p);
    float b[2] = {0.f, 0.f};
    for (int e = threadIdx.x; e < n; e += THREADS) {
      const int i = e / win, j = e % win;
      const float di = s_prev[e] - interp(cur, sc, i, j, pad, h, w);
      b[0] += di * s_ix[e];
      b[1] += di * s_iy[e];
    }
    block_sum<2>(b, scratch);
    const float dnu_x = (gyy * b[0] - gxy * b[1]) / det_safe;
    const float dnu_y = (gxx * b[1] - gxy * b[0]) / det_safe;
    nu_x += dnu_x;
    nu_y += dnu_y;
    const float d2 = dnu_x * dnu_x + dnu_y * dnu_y;
    if (!(d2 > eps2)) break;  // uniform across the block
  }
  if (threadIdx.x == 0) {
    flow[2 * fi] = nu_x;
    flow[2 * fi + 1] = nu_y;
    ok_out[fi] = ok;
  }
}

}  // namespace

extern "C" int xmat_lk_level(const void* prev, const void* cur, const void* gx,
                             const void* gy, const void* pts, const void* guess,
                             void* flow, void* ok, int a, int h, int w, int k,
                             int half_win, int n_iters, float min_eig_thr,
                             float eps2, void* stream) {
  if (a <= 0 || k <= 0) return 0;
  const int win = 2 * half_win + 1;
  const size_t smem = (size_t)(3 * win * win + 3 * (WARPS + 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lk_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(k, a);
  lk_level_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)prev, (const float*)cur, (const float*)gx, (const float*)gy,
      (const float*)pts, (const float*)guess, (float*)flow, (bool*)ok, h, w, k,
      half_win, n_iters, min_eig_thr, eps2);
  return (int)cudaGetLastError();
}
