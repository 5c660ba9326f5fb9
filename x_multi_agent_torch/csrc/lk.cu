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
// What bounds it on the card: bytes, in principle. A feature needs its four
// slabs (prev, gx, gy once, the current image's around each step: ~7.7 KB
// at h = 10), ~39 flops per window pixel for the windows and G and ~16 per
// pixel and step; at 16 agents x 200 features the bytes take ~2-4 us per
// level at 3.35 TB/s and the flops less. In practice the instructions
// around them (about four shared-memory reads and ten other instructions
// per window pixel and pass) and the chain of dependent steps set the
// pace: each step's gather depends on the last step's result, so a feature
// is a chain of up to n_iters rounds, and the level waits for its slowest
// feature (PERF.md has the measured split).
// Design: one warp per (agent, feature), and one warp per block, so the
// block scheduler hands an SM slot to the next feature as soon as a feature
// is done (no block waits for its slowest warp). The warp copies its three
// previous-frame slabs and a region of the current image MARGIN pixels
// wider on each side than the slab at the first guess, all at once, into
// its shared memory with 4-byte cp.async copies, lanes along a row (one
// round trip; indices clamped as above). It builds its lanes' window pixels
// of prev, ix and iy into registers (for half_win <= 15, compiled per
// half_win; in shared memory above) and reduces G with a shfl_xor
// butterfly, which leaves the same totals in every lane. A step whose slab
// base stays within MARGIN of the region's reads the region where it is;
// only a step that leaves it copies a new region (the test is uniform in
// the warp). Each step accumulates b and reduces it by butterfly; the exit
// test is uniform and each warp leaves on its own. No __syncthreads.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block may opt into
constexpr int FEATURES_PER_BLOCK = 1;  // one warp each

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Slab {
  int by, bx;                  // clamped padded-image slab base
  float w00, w01, w10, w11;    // bilinear weights of the constant fractions
};

// base(pt) of the reference: floor(pt - h) in padded coordinates, clamped
// as dynamic_slice clamps, plus the bilinear weights of its fractions.
__device__ __forceinline__ Slab slab_base(float x, float y, int half_win, int pad,
                                          int hp, int wp, int p) {
  const float sx = x - (float)half_win, sy = y - (float)half_win;
  const float bxf = floorf(sx), byf = floorf(sy);
  const float fx = sx - bxf, fy = sy - byf;
  Slab s;
  s.w00 = (1.f - fx) * (1.f - fy);
  s.w01 = fx * (1.f - fy);
  s.w10 = (1.f - fx) * fy;
  s.w11 = fx * fy;
  s.bx = clampi((int)bxf + pad, 0, wp - p);
  s.by = clampi((int)byf + pad, 0, hp - p);
  return s;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// The n x n blocks of the padded images imgs[0..M) at padded origin (by, bx)
// into dst + m * n * n (row-major, stride n): lanes along a row, one clamped
// column per lane, each row's clamped offset shared by the M images.
template <int N, int M>
__device__ __forceinline__ void stage(float* dst, const float* const (&imgs)[M], int by,
                                      int bx, int n_rt, int pad, int h, int w, int lane) {
  const int n = N > 0 ? N : n_rt;  // unrolled where compiled in
  for (int c = lane; c < n; c += 32) {
    const int col = clampi(bx + c - pad, 0, w - 1);
#pragma unroll
    for (int r = 0; r < n; ++r) {
      const size_t off = (size_t)clampi(by + r - pad, 0, h - 1) * w + col;
#pragma unroll
      for (int m = 0; m < M; ++m) cp_async4(dst + m * n * n + r * n + c, imgs[m] + off);
    }
  }
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
}

// bilinear window value at slab offset o (window pixel (i, j): o = i*p + j)
__device__ __forceinline__ float interp(const float* sl, int o, int p, const Slab& s) {
  return fmaf(sl[o + p + 1], s.w11,
              fmaf(sl[o + p], s.w10, fmaf(sl[o + 1], s.w01, sl[o] * s.w00)));
}

// One lane's window pixels e = lane + 32 t: NPL of them in registers, or
// (NPL = 0) any number in the warp's shared memory.
template <int NPL>
struct Window {
  float pv[NPL], ix[NPL], iy[NPL];
  __device__ Window(float*, int) {}
  __device__ float& prev(int t) { return pv[t]; }
  __device__ float& gx(int t) { return ix[t]; }
  __device__ float& gy(int t) { return iy[t]; }
};

template <>
struct Window<0> {
  float* base;
  int n;
  __device__ Window(float* b, int n_) : base(b), n(n_) {}
  __device__ float& prev(int t) { return base[32 * t + (threadIdx.x & 31)]; }
  __device__ float& gx(int t) { return base[n + 32 * t + (threadIdx.x & 31)]; }
  __device__ float& gy(int t) { return base[2 * n + 32 * t + (threadIdx.x & 31)]; }
};

constexpr int MARGIN = 1;  // pixels the staged current region extends past the slab

// HW > 0: half_win compiled in, windows in registers; HW = 0: any half_win
// (the argument), windows in shared memory.
template <int HW>
struct Shape {
  static constexpr int WIN = 2 * HW + 1, P = HW > 0 ? WIN + 1 : 0;
  static constexpr int PM = HW > 0 ? P + 2 * MARGIN : 0;  // staged current region
  static constexpr int NPL = HW > 0 ? (WIN * WIN + 31) / 32 : 0;
};

// Walks one lane's window pixels e = lane + 32 t, t = 0, 1, ...: (i, j) =
// (e / win, e % win) and the offset i * stride + j, without a division.
struct Walk {
  int j, o, dj, dov, wrap, win;
  __device__ Walk(int lane, int win_, int stride, int base)
      : j(lane % win_), o(base + (lane / win_) * stride + lane % win_), dj(32 % win_),
        dov((32 / win_) * stride + 32 % win_), wrap(stride - win_), win(win_) {}
  __device__ void next() {
    j += dj;
    o += dov;
    if (j >= win) {
      j -= win;
      o += wrap;
    }
  }
};

// shared floats one feature needs
__host__ __device__ inline int feature_floats(bool windows_in_smem, int p, int n) {
  const int pm = p + 2 * MARGIN;
  return 3 * p * p + pm * pm + (windows_in_smem ? 3 * ((n + 31) / 32) * 32 : 0);
}

template <int HW>
__global__ void __launch_bounds__(32 * FEATURES_PER_BLOCK)
lk_level_kernel(const float* __restrict__ prev, const float* __restrict__ cur,
                const float* __restrict__ gx, const float* __restrict__ gy,
                const float* __restrict__ pts, const float* __restrict__ guess,
                float* __restrict__ flow, bool* __restrict__ ok_out, int h, int w,
                int k, int n_feat, int half_win_rt, int n_iters, float min_eig_thr,
                float eps2) {
  using S = Shape<HW>;
  extern __shared__ float smem[];
  const int half_win = HW > 0 ? HW : half_win_rt;
  const int win = 2 * half_win + 1, n = win * win, p = win + 1, pad = half_win + 1;
  const int pm = p + 2 * MARGIN;
  const int hp = h + 2 * pad, wp = w + 2 * pad, pp = p * p;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int fi = blockIdx.x * FEATURES_PER_BLOCK + warp;  // a * k + feature
  if (fi >= n_feat) return;
  // this warp's slabs prev, gx, gy; current region; windows when NPL = 0
  float* sl = smem + (size_t)warp * feature_floats(HW == 0, p, n);
  float* region = sl + 3 * pp;
  const size_t img_off = (size_t)(fi / k) * h * w;
  prev += img_off; cur += img_off; gx += img_off; gy += img_off;
  const float px = pts[2 * fi], py = pts[2 * fi + 1];
  float nu_x = guess[2 * fi], nu_y = guess[2 * fi + 1];
  const int n_t = S::NPL > 0 ? S::NPL : (n + 31) / 32;  // window pixels per lane

  // ---- one round trip: prev, gx, gy slabs and the current region ---------
  const Slab s0 = slab_base(px, py, half_win, pad, hp, wp, p);
  Slab sc = slab_base(px + nu_x, py + nu_y, half_win, pad, hp, wp, p);
  int rby = sc.by, rbx = sc.bx;  // slab base the region is centred on
  const float* const slabs[3] = {prev, gx, gy};
  const float* const current[1] = {cur};
  stage<S::P>(sl, slabs, s0.by, s0.bx, p, pad, h, w, lane);
  stage<S::PM>(region, current, rby - MARGIN, rbx - MARGIN, pm, pad, h, w, lane);
  wait_copies();

  // ---- previous-frame windows; structure tensor G -------------------------
  Window<S::NPL> win_px(region + pm * pm, n);
  float gxx = 0.f, gxy = 0.f, gyy = 0.f;
  {
    Walk wk(lane, win, p, 0);
#pragma unroll
    for (int t = 0; t < n_t; ++t, wk.next()) {
      if (lane + 32 * t < n) {
        const float vx = interp(sl + pp, wk.o, p, s0);
        const float vy = interp(sl + 2 * pp, wk.o, p, s0);
        win_px.prev(t) = interp(sl, wk.o, p, s0);
        win_px.gx(t) = vx;
        win_px.gy(t) = vy;
        gxx += vx * vx;
        gxy += vx * vy;
        gyy += vy * vy;
      }
    }
  }
  gxx = warp_sum(gxx);
  gxy = warp_sum(gxy);
  gyy = warp_sum(gyy);
  const float det = gxx * gyy - gxy * gxy;
  const float tr = gxx + gyy;
  const float min_eig = (tr - sqrtf(fmaxf(tr * tr - 4.f * det, 0.f))) * 0.5f;
  const bool ok = min_eig / (float)n > min_eig_thr;
  const float inv_det = 1.f / (fabsf(det) > 1e-12f ? det : 1.f);

  // ---- Gauss-Newton steps against the current frame -----------------------
  for (int it = 0; it < n_iters; ++it) {
    if (it > 0) sc = slab_base(px + nu_x, py + nu_y, half_win, pad, hp, wp, p);
    if (abs(sc.by - rby) > MARGIN || abs(sc.bx - rbx) > MARGIN) {  // left the region
      __syncwarp();  // every lane is done reading it
      rby = sc.by;
      rbx = sc.bx;
      stage<S::PM>(region, current, rby - MARGIN, rbx - MARGIN, pm, pad, h, w, lane);
      wait_copies();
    }
    float b0 = 0.f, b1 = 0.f;
    Walk wk(lane, win, pm, (sc.by - rby + MARGIN) * pm + sc.bx - rbx + MARGIN);
#pragma unroll
    for (int t = 0; t < n_t; ++t, wk.next()) {
      if (lane + 32 * t < n) {
        const float d = win_px.prev(t) - interp(region, wk.o, pm, sc);
        b0 = fmaf(d, win_px.gx(t), b0);
        b1 = fmaf(d, win_px.gy(t), b1);
      }
    }
    b0 = warp_sum(b0);
    b1 = warp_sum(b1);
    const float dnu_x = (gyy * b0 - gxy * b1) * inv_det;
    const float dnu_y = (gxx * b1 - gxy * b0) * inv_det;
    nu_x += dnu_x;
    nu_y += dnu_y;
    const float d2 = dnu_x * dnu_x + dnu_y * dnu_y;
    if (!(d2 > eps2)) break;  // uniform across the warp
  }
  if (lane == 0) {
    flow[2 * fi] = nu_x;
    flow[2 * fi + 1] = nu_y;
    ok_out[fi] = ok;
  }
}

template <int HW>
int launch(const void* prev, const void* cur, const void* gx, const void* gy,
           const void* pts, const void* guess, void* flow, void* ok, int a, int h, int w,
           int k, int half_win, int n_iters, float min_eig_thr, float eps2,
           cudaStream_t stream) {
  const int win = 2 * half_win + 1;
  const size_t smem =
      (size_t)FEATURES_PER_BLOCK * feature_floats(HW == 0, win + 1, win * win) * sizeof(float);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lk_level_kernel<HW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int n_feat = a * k;
  lk_level_kernel<HW><<<(n_feat + FEATURES_PER_BLOCK - 1) / FEATURES_PER_BLOCK,
                        32 * FEATURES_PER_BLOCK, smem, stream>>>(
      (const float*)prev, (const float*)cur, (const float*)gx, (const float*)gy,
      (const float*)pts, (const float*)guess, (float*)flow, (bool*)ok, h, w, k, n_feat,
      half_win, n_iters, min_eig_thr, eps2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int xmat_lk_level(const void* prev, const void* cur, const void* gx,
                             const void* gy, const void* pts, const void* guess,
                             void* flow, void* ok, int a, int h, int w, int k,
                             int half_win, int n_iters, float min_eig_thr,
                             float eps2, void* stream) {
  if (a <= 0 || k <= 0) return 0;
  if (half_win < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define XMAT_LK_CASE(HW)                                                               \
  case HW:                                                                             \
    return launch<HW>(prev, cur, gx, gy, pts, guess, flow, ok, a, h, w, k, half_win, \
                      n_iters, min_eig_thr, eps2, s);
  switch (half_win) {
    XMAT_LK_CASE(1) XMAT_LK_CASE(2) XMAT_LK_CASE(3) XMAT_LK_CASE(4) XMAT_LK_CASE(5)
    XMAT_LK_CASE(6) XMAT_LK_CASE(7) XMAT_LK_CASE(8) XMAT_LK_CASE(9) XMAT_LK_CASE(10)
    XMAT_LK_CASE(11) XMAT_LK_CASE(12) XMAT_LK_CASE(13) XMAT_LK_CASE(14) XMAT_LK_CASE(15)
    default:
      return launch<0>(prev, cur, gx, gy, pts, guess, flow, ok, a, h, w, k, half_win,
                       n_iters, min_eig_thr, eps2, s);
  }
#undef XMAT_LK_CASE
}
