// Track rows: the filter's MSCKF, MSCKF-SLAM and SLAM update rows, each
// track projected and gated against its agent's covariance in one block.
//
// Replaces no Pallas kernel: the JAX package's filter has none (XLA fuses
// its dense chain). The port's plain chain (vio/updates/track_rows.py:
// _window_plain, _slam_plain) scatters each track's 2x3 observation blocks
// into a dense (2M, D) Jacobian, applies three Householder reflections to it
// whole, and broadcasts the agent's D x D covariance to every track for a
// dense S = H0 P H0^T + I: about 840 torch ops a frame and a per-track copy
// of P (1.38 GB at 512 agents). Only the 6M pose columns of a window track's
// rows are non-zero, and a reflection acts on rows, so a column that starts
// at zero stays zero: the same mathematics needs P's pose block alone.
//
// One block per (agent, track):
//   * window tracks (MSCKF, MSCKF-SLAM; mode 0; 4 <= M <= 16): stage the
//     pose columns of the 2M rows, apply the three reflections (found on the
//     feature Jacobian, and applied to the residuals, by track_reflect_kernel
//     below with linalg.householder_qt's rounding), whiten by 1/sigma, form
//     S = Hw P Hw^T + I over P's pose block (6M x 6M; its lower half, fp32
//     or fp64 FMAs, no TF32, no tensor cores), gamma = rw^T S^-1 rw, the
//     chi-square gate at dof 2 n_obs - 3, and write the dense rows once
//     (zeros outside the pose columns and where the gate rejects) and, for
//     MSCKF-SLAM, h1 unmasked;
//   * SLAM features (mode 1, one warp): the 2 rows on the current pose, the
//     anchor pose and the feature's own columns (at most 15, summed where
//     they coincide, in the plain chain's order), P's block over them, S
//     (2 x 2), the plain chain's closed-form gamma, the gate at dof 2 length.
// A failed factorisation (a pivot not positive), a non-finite gamma, or a
// non-finite entry anywhere in the agent's P (p_ok: the plain chain's dense
// product multiplies every entry of P, so 0 x NaN makes its S NaN) rejects
// the track, as the plain chain's NaN does. A track the builder rejected
// itself (its ok flag: too few observations, non-finite Jacobians, an
// inactive feature) keeps no row whatever its gamma, so it skips the gate:
// its block writes zeros (and MSCKF-SLAM's unmasked rows).
//
// The rows round as the plain chain's do. The filter's update compresses
// the stacked rows through a Cholesky of their Gram matrix with a 1e-6
// ridge, and the observability-constrained rows leave that matrix singular
// but for the ridge: a rounding of the rows can decide whether it factors,
// and so whether an agent is updated at all. So each reflection is applied
// as the plain chain computes it on the card: v^T a as an FMA chain over
// the rows in order (cuBLAS's gemv at these batch sizes), then v (v^T a),
// beta times it and a minus it, each rounded on its own (torch's
// elementwise kernels; never contracted). The reflections themselves come
// from track_reflect_kernel, four launches a builder between the wrapper's
// three v^T hf products (torch.einsum: cuBLAS's order for three columns
// changes with the batch), its sums torch.sum's 32-lane halving tree. The
// gate's own arithmetic (S, its factorisation) only decides, and may round
// otherwise.
//
// What bounds it on the card: writing the rows. At 512 agents and M = 15 the
// three builders write 272 MB of rows (0.08 ms at 3.35 TB/s); the gates of
// the tracks the builders keep add up to 505 kFLOP each (7.8 GFLOP if every
// track were kept: 0.12 ms at 67 TFLOP/s fp32). A gated track's steps are
// short and dependent, so its block's latency sets the pace as much: P's
// pose block is copied with 16-byte cp.async at the start and lands while the
// reflections run; every thread applies the three reflections to a pose
// column held in registers; the products keep 8 x 3 tiles of Hw P and 4 x 4
// tiles of S in registers, read with 16-byte loads (Hw's rows broadcast
// across the warp); warp 0 eliminates [S rw; rw^T 0] a row a lane in
// registers (the square-root-free Cholesky: no square root, no separate
// solve, the corner left is -gamma); every write is coalesced. Before it,
// cov_finite_kernel (one block an agent, its own entry point) reads each P
// once for the finiteness flag.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MODE_WINDOW = 0;
constexpr int CORE = 15;      // error-state columns before the pose columns
constexpr int ROWS = 8;       // Hw P register tile: 8 rows (two 4-wide loads) ...
constexpr int COLS = 3;       // ... by 3 columns of P
constexpr int SQ = 4;         // S register tile: 4 x 4
constexpr int MAX_M = 16;     // 2M rows and the 2M - 2 of [S rw; rw^T 0] fit a warp
constexpr int MAX_SLAM = 15;  // SLAM columns: current pose, anchor pose, feature
constexpr int SLAM_THREADS = 32;

template <typename T>
struct Args {
  const T* res;       // window (A, K, 2M) reflected by the wrapper; SLAM (A, K, 2)
  const T* j_pos;     // window (A, K, M, 2, 3); SLAM (A, K, 2, 3)
  const T* j_att;
  const T* hf;        // SLAM only (window tracks' hf is reflected by the wrapper)
  const T* j_apos;    // anchor-pose blocks (MSCKF-SLAM, SLAM) or null
  const T* j_aatt;
  const int* anchor;  // (A, K) anchor window index, or null
  const T* cov;       // (A, D, D)
  const bool* p_ok;   // (A,) every entry of the agent's P finite (cov_finite_kernel)
  const long long* count;  // (A, K) n_obs (window) or track length (SLAM)
  const bool* ok;     // (A, K) the builder's own validity
  const T* table;     // (max_dof + 1,) chi-square quantiles
  T* rows;            // (A, K, r, D)
  T* res_out;         // (A, K, r)
  bool* keep;         // (A, K)
  bool* valid;        // (A, K) ok and gamma finite (window), or null
  T* h1;              // (A, K, 3, D) or null
  const T* v;         // window: (3, A, K, 2M) the reflections' vectors
  const T* beta;      // window: (A, K, 3) their factors
  int k, m, d, max_dof, cur;
  T inv_sigma;
};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Four consecutive values from 16-byte-aligned shared memory.
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}

__device__ __forceinline__ void load4(const double* p, double (&o)[4]) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  const double2 y = *reinterpret_cast<const double2*>(p + 2);
  o[0] = x.x;
  o[1] = x.y;
  o[2] = y.x;
  o[3] = y.y;
}

// (i, k) of entry e of the lower triangle k <= i, row by row.
__device__ __forceinline__ void lower_index(int e, int& i, int& k) {
  i = (int)((sqrtf(8.0f * e + 1.0f) - 1.0f) * 0.5f);
  while (i * (i + 1) / 2 > e) --i;
  while ((i + 1) * (i + 2) / 2 <= e) ++i;
  k = e - i * (i + 1) / 2;
}

// Shared-memory layout of a window track (in elements of T; every region
// starts on 16 bytes).
struct WindowLayout {
  int R, C, r, RP, TS, WS, PS, ES;
  int sys, pb, hwt, tpt, el, v, bet, col, total;
  __host__ __device__ static int up4(int x) { return (x + 3) & ~3; }
  __host__ __device__ WindowLayout(int m, int vec) {
    R = 2 * m;
    C = 6 * m;
    r = R - 3;
    RP = (r + ROWS - 1) / ROWS * ROWS;  // the projected rows, padded to whole tiles
    TS = RP + 4;  // the transposed arrays' stride: 16-byte rows, 4-way bank conflicts at most
    WS = C | 1;   // odd: rows read down a column hit distinct banks
    PS = (C + 2 * vec - 1) / vec * vec;  // a row of P's block from its 16-byte-aligned start
    ES = (r + 1) | 1;
    sys = 0;
    pb = up4(sys + R * WS);
    hwt = up4(pb + C * PS);
    v = up4(hwt + C * TS);  // the three reflections' vectors, 32 each
    bet = v + 3 * 32;
    col = up4(bet + 3);     // a column of the elimination
    total = col + 32;
    // once Hw P is formed P's block is read no more: (Hw P)^T, then the lower
    // half of [S rw; rw^T 0], take its place
    tpt = pb;
    el = up4(tpt + C * TS);
  }
};

template <typename T>
__device__ void write_zero_rows(const Args<T>& g, long long track, int r) {
  T* rows = g.rows + track * r * g.d;
  for (int i = threadIdx.x; i < r * g.d; i += blockDim.x) rows[i] = T(0);
  for (int i = threadIdx.x; i < r; i += blockDim.x) g.res_out[track * r + i] = T(0);
  if (threadIdx.x == 0) {
    g.keep[track] = false;
    if (g.valid) g.valid[track] = false;
  }
}

// The plain chain's arithmetic, rounded as it rounds: a * b and a - b on
// their own (torch's elementwise kernels), a * b + c fused (cuBLAS's).
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename T>
__device__ void window_track(const Args<T>& g, int a, int t, T* sm) {
  constexpr int VEC = 16 / sizeof(T);
  const WindowLayout L(g.m, VEC);
  const int m = g.m, R = L.R, C = L.C, r = L.r, RP = L.RP, TS = L.TS;
  const int WS = L.WS, PS = L.PS, ES = L.ES, d = g.d;
  T* sys = sm + L.sys;  // the pose columns of the 2M rows
  T* pb = sm + L.pb;    // P's pose block, row j from pb + j * PS + its offset
  T* hwt = sm + L.hwt;  // Hw^T (C x RP, stride TS), rows past r zero
  T* tpt = sm + L.tpt;  // (Hw P)^T (C x RP, stride TS)
  T* el = sm + L.el;    // [S rw; rw^T 0], lower half
  T* v = sm + L.v;
  T* bet = sm + L.bet;
  T* colj = sm + L.col;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nth >> 5;
  const long long track = (long long)a * g.k + t;
  // a track the builder rejected (too few observations, non-finite
  // Jacobians) keeps no row whatever its gamma: it skips the gate, and only
  // MSCKF-SLAM's column-space rows are formed for it
  const bool ok = g.ok[track];
  if (!ok && !g.h1) {
    write_zero_rows(g, track, r);
    return;
  }

  // 1. P's pose block in 16-byte copies, in flight while the system is
  //    staged and reflected; the gate's count, threshold and P flag
  const long long p0 = (long long)a * d * d + (long long)CORE * d + CORE;
  const int off0 = (int)(p0 & (VEC - 1)), doff = d & (VEC - 1);
  if (ok) {
    for (int row = warp; row < C; row += nwarps) {
      const long long s = p0 + (long long)row * d;
      const long long s0 = s & ~(long long)(VEC - 1);
      const int n = (int)(s - s0 + C + VEC - 1) / VEC;
      for (int q = lane; q < n; q += 32) cp_async<16>(pb + row * PS + q * VEC, g.cov + s0 + q * VEC);
    }
  }
  long long dof = 0;
  T thr = T(0);
  bool p_ok = false;
  if (tid == 0 && ok) {
    dof = 2 * g.count[track] - 3;
    thr = g.table[dof < 0 ? 0 : (dof > g.max_dof ? g.max_dof : dof)];
    p_ok = g.p_ok[a];
  }

  // 2. the pose columns: each observation's own pose blocks, then the
  //    anchor-pose blocks added; the reflections' vectors and factors
  for (int i = tid; i < R * WS; i += nth) sys[i] = T(0);
  const long long n_tracks = (long long)gridDim.x;  // one block a track
  for (int i = tid; i < 3 * 32; i += nth)
    v[i] = i % 32 < R ? g.v[((i / 32) * n_tracks + track) * R + i % 32] : T(0);
  if (tid < 3) bet[tid] = g.beta[track * 3 + tid];
  __syncthreads();
  const long long base = track * R;  // (A, K, M, 2) flattened
  for (int it = tid; it < 2 * R; it += nth) {
    const int rho = it >> 1, f = it & 1, j = rho >> 1;
    const T* src = (f == 0 ? g.j_pos : g.j_att) + (base + rho) * 3;
    T* s = sys + rho * WS + (f == 0 ? 3 * j : 3 * m + 3 * j);
#pragma unroll
    for (int b = 0; b < 3; ++b) s[b] = src[b];
  }
  const int anc = g.j_apos ? g.anchor[track] : -1;
  if (anc >= 0 && anc < m) {
    __syncthreads();
    for (int it = tid; it < 2 * R; it += nth) {
      const int rho = it >> 1, f = it & 1;
      const T* src = (f == 0 ? g.j_apos : g.j_aatt) + (base + rho) * 3;
      T* s = sys + rho * WS + (f == 0 ? 3 * anc : 3 * m + 3 * anc);
#pragma unroll
      for (int b = 0; b < 3; ++b) s[b] += src[b];
    }
  }
  __syncthreads();

  // 3. the three Householder reflections (found on the hf columns by the
  //    wrapper, linalg.householder_qt's own operations), each thread
  //    applying all three in turn to a pose column held in registers, as
  //    the plain chain rounds: v^T a an FMA chain over the rows in order,
  //    a - beta (v (v^T a)) one rounding a step
  for (int c = tid; c < C; c += nth) {
    T x[32];
#pragma unroll
    for (int rho = 0; rho < 32; ++rho) x[rho] = rho < R ? sys[rho * WS + c] : T(0);
#pragma unroll
    for (int kk = 0; kk < 3; ++kk) {
      const T* vk = v + kk * 32;
      const T beta = bet[kk];
      T va = T(0);
#pragma unroll
      for (int rho = 0; rho < 32; ++rho)
        if (rho < R) va = fma_rn(vk[rho], x[rho], va);
#pragma unroll
      for (int rho = 0; rho < 32; ++rho)
        if (rho < R) x[rho] = sub_rn(x[rho], mul_rn(beta, mul_rn(vk[rho], va)));
    }
#pragma unroll
    for (int rho = 0; rho < 32; ++rho)
      if (rho < R) sys[rho * WS + c] = x[rho];
  }
  __syncthreads();

  if (ok) {
    // 4. whiten the projected rows (rows 3..), transposed; P's block lands
    for (int c = warp; c < C; c += nwarps)
      for (int row = lane; row < RP; row += 32)
        hwt[c * TS + row] = row < r ? sys[(3 + row) * WS + c] * g.inv_sigma : T(0);
    cp_async_wait_all();
    __syncthreads();

    // 5. Hw P: each thread an 8 x 3 tile in registers, Hw's 8 rows in two
    //    4-wide loads (broadcast: a warp's threads share them), then the
    //    tile stored transposed where P's block was
    const int cg = C / COLS;  // C = 6M: whole tiles
    const bool tiled = tid < (RP / ROWS) * cg;
    const int i0 = (tid / cg) * ROWS, c0 = (tid % cg) * COLS;
    T acc[ROWS][COLS] = {};
    if (tiled) {
#pragma unroll 4
      for (int j = 0; j < C; ++j) {
        T ha[4], hb[4];
        load4(hwt + j * TS + i0, ha);
        load4(hwt + j * TS + i0 + 4, hb);
        const T* p = pb + j * PS + ((off0 + j * doff) & (VEC - 1)) + c0;
        const T pa = p[0], pv = p[1], pc = p[2];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[u][0] += ha[u] * pa;
          acc[u][1] += ha[u] * pv;
          acc[u][2] += ha[u] * pc;
          acc[u + 4][0] += hb[u] * pa;
          acc[u + 4][1] += hb[u] * pv;
          acc[u + 4][2] += hb[u] * pc;
        }
      }
    }
    __syncthreads();
    if (tiled) {
#pragma unroll
      for (int w = 0; w < COLS; ++w)
#pragma unroll
        for (int u = 0; u < ROWS; ++u) tpt[(c0 + w) * TS + i0 + u] = acc[u][w];
    }
    __syncthreads();

    // 6. [S rw; rw^T 0] (lower half): S = (Hw P) Hw^T + I in 4 x 4 tiles,
    //    rw the whitened residuals, the corner 0
    const int nb = RP / SQ, n_tiles = nb * (nb + 1) / 2;
    for (int e = tid; e < n_tiles + r + 1; e += nth) {
      if (e >= n_tiles) {
        const int k = e - n_tiles;
        el[r * ES + k] = k < r ? g.res[base + 3 + k] * g.inv_sigma : T(0);
        continue;
      }
      int ib, kb;
      lower_index(e, ib, kb);
      T sq[SQ][SQ] = {};
#pragma unroll 4
      for (int c = 0; c < C; ++c) {
        T x[4], y[4];
        load4(tpt + c * TS + SQ * ib, x);
        load4(hwt + c * TS + SQ * kb, y);
#pragma unroll
        for (int u = 0; u < SQ; ++u)
#pragma unroll
          for (int w = 0; w < SQ; ++w) sq[u][w] += x[u] * y[w];
      }
#pragma unroll
      for (int u = 0; u < SQ; ++u)
#pragma unroll
        for (int w = 0; w < SQ; ++w) {
          const int i = SQ * ib + u, k = SQ * kb + w;
          if (k <= i && i < r) el[i * ES + k] = sq[u][w] + (i == k ? T(1) : T(0));
        }
    }
    __syncthreads();

    // 7. warp 0 eliminates [S rw; rw^T 0] symmetrically (the square-root-free
    //    Cholesky, LDL^T), a row a lane in registers: a pivot that is not
    //    positive (or NaN) fails as cholesky_ex's info does; after the r
    //    pivots of S the corner holds -rw^T S^-1 rw = -gamma. Then the gate.
    if (warp == 0) {
      T row[32];
#pragma unroll
      for (int k = 0; k < 32; ++k)
        row[k] = lane <= r && k <= r ? (k <= lane ? el[lane * ES + k] : el[k * ES + lane]) : T(0);
      bool fail = false;
#pragma unroll
      for (int j = 0; j < 31; ++j) {
        if (j < r && !fail) {  // uniform: every lane holds the same pivot
          const T piv = __shfl_sync(0xffffffffu, row[j], j);
          fail = !(piv > T(0));
          if (!fail) {
            const T inv = T(1) / piv, cj = row[j];
            colj[lane] = cj;  // column j: A[k][j] = A[j][k]
            __syncwarp();
#pragma unroll
            for (int k = j + 1; k < 32; ++k)
              if (lane > j) row[k] -= (cj * colj[k]) * inv;  // symmetric to the bit
            __syncwarp();
          }
        }
      }
      T corner = T(0);
#pragma unroll
      for (int k = 0; k < 32; ++k)
        if (k == r) corner = row[k];
      corner = __shfl_sync(0xffffffffu, corner, r);
      if (lane == 0) {
        const T gamma = fail || !p_ok ? (T)NAN : -corner;
        const bool valid = isfinite(gamma);
        const bool keep = valid && dof > 0 && gamma < thr;
        g.keep[track] = keep;
        if (g.valid) g.valid[track] = valid;
        bet[0] = keep ? T(1) : T(0);
      }
    }
  } else if (tid == 0) {
    g.keep[track] = false;
    if (g.valid) g.valid[track] = false;
    bet[0] = T(0);
  }
  __syncthreads();

  // 8. the dense rows once: zeros outside the pose columns and where the
  //    gate rejects; MSCKF-SLAM's column-space rows unmasked
  const bool keep = bet[0] != T(0);
  T* rows = g.rows + track * r * d;
  for (int row = warp; row < r; row += nwarps) {
    T* o = rows + (long long)row * d;
    for (int col = lane; col < d; col += 32) {
      const int pc = col - CORE;
      o[col] = keep && pc >= 0 && pc < C ? sys[(3 + row) * WS + pc] : T(0);
    }
  }
  for (int i = tid; i < r; i += nth) g.res_out[track * r + i] = keep ? g.res[base + 3 + i] : T(0);
  if (g.h1) {
    for (int row = warp; row < 3; row += nwarps) {
      T* o = g.h1 + (track * 3 + row) * d;
      for (int col = lane; col < d; col += 32) {
        const int pc = col - CORE;
        o[col] = pc >= 0 && pc < C ? sys[row * WS + pc] : T(0);
      }
    }
  }
}

template <typename T>
__device__ void slam_feature(const Args<T>& g, int a, int t, T* sm) {
  T* blk = sm;                       // [32]: the five 2 x 3 blocks, then res
  T* hv = blk + 32;                  // [2][MAX_SLAM] row values
  T* ps = hv + 2 * MAX_SLAM;         // [MAX_SLAM][MAX_SLAM] P over the columns
  T* tq = ps + MAX_SLAM * MAX_SLAM;  // [2][MAX_SLAM] Hw P
  int* cols = reinterpret_cast<int*>(tq + 2 * MAX_SLAM);
  int* n_cols = cols + MAX_SLAM;
  const int lane = threadIdx.x, m = g.m, d = g.d;
  const long long track = (long long)a * g.k + t;
  if (!g.ok[track]) {  // rejected by the builder: no row whatever its gamma
    write_zero_rows(g, track, 2);
    return;
  }
  const int anc = g.anchor[track];

  // 1. the blocks, one value a lane: current pose (position, attitude),
  //    anchor pose (position, attitude), feature; the residual
  if (lane < 30) {
    const int f = lane / 6;
    const T* src = f == 0 ? g.j_pos : f == 1 ? g.j_att : f == 2 ? g.j_apos
                 : f == 3 ? g.j_aatt : g.hf;
    blk[lane] = src[track * 6 + lane - 6 * f];
  } else {
    blk[lane] = g.res[track * 2 + lane - 30];
  }
  __syncwarp();

  // 2. the two rows' columns, summed where they coincide, in the plain
  //    chain's scatter order
  if (lane == 0) {
    int n = 0;
    auto add = [&](int base, const T* b6, bool eye) {
      for (int b = 0; b < 3; ++b) {
        const int col = base + b;
        const T v0 = eye ? (b == 0 ? T(1) : T(0)) : b6[b];
        const T v1 = eye ? (b == 1 ? T(1) : T(0)) : b6[3 + b];
        int q = 0;
        while (q < n && cols[q] != col) ++q;
        if (q == n) {
          cols[n] = col;
          hv[n] = v0;
          hv[MAX_SLAM + n] = v1;
          ++n;
        } else {
          hv[q] += v0;
          hv[MAX_SLAM + q] += v1;
        }
      }
    };
    const int feat = CORE + 6 * m + 3 * t;
    if (anc == g.cur) {
      add(feat, nullptr, true);
    } else {
      add(CORE + 3 * g.cur, blk, false);
      add(CORE + 3 * m + 3 * g.cur, blk + 6, false);
      add(CORE + 3 * anc, blk + 12, false);
      add(CORE + 3 * m + 3 * anc, blk + 18, false);
      add(feat, blk + 24, false);
    }
    *n_cols = n;
  }
  __syncwarp();
  const int n = *n_cols;
  const T* cov = g.cov + (long long)a * d * d;
#pragma unroll 4
  for (int i = lane; i < n * n; i += SLAM_THREADS) {
    const int p = i / n, q = i - p * n;
    ps[p * MAX_SLAM + q] = cov[(long long)cols[p] * d + cols[q]];
  }
  __syncwarp();

  // 3. S = Hw P Hw^T + I (2 x 2, both off-diagonals as the plain product)
  const T is = g.inv_sigma;
  if (lane < n) {
    T t0 = T(0), t1 = T(0);
    for (int p = 0; p < n; ++p) {
      const T pv = ps[p * MAX_SLAM + lane];
      t0 += (hv[p] * is) * pv;
      t1 += (hv[MAX_SLAM + p] * is) * pv;
    }
    tq[lane] = t0;
    tq[MAX_SLAM + lane] = t1;
  }
  __syncwarp();
  if (lane == 0) {
    T s00 = T(0), s01 = T(0), s10 = T(0), s11 = T(0);
    for (int q = 0; q < n; ++q) {
      const T w0 = hv[q] * is, w1 = hv[MAX_SLAM + q] * is;
      s00 += tq[q] * w0;
      s01 += tq[q] * w1;
      s10 += tq[MAX_SLAM + q] * w0;
      s11 += tq[MAX_SLAM + q] * w1;
    }
    s00 += T(1);
    s11 += T(1);
    const T r0 = blk[30] * is, r1 = blk[31] * is;
    T det = s00 * s11 - s01 * s10;
    det = fabs(det) > T(1e-30) ? det : T(1);
    T gamma = (r0 * (s11 * r0 - s01 * r1) + r1 * (s00 * r1 - s10 * r0)) / det;
    if (!g.p_ok[a]) gamma = (T)NAN;
    const long long dof = 2 * g.count[track];
    const long long di = dof < 0 ? 0 : (dof > g.max_dof ? g.max_dof : dof);
    const bool keep = dof > 0 && gamma < g.table[di];
    g.keep[track] = keep;
    *n_cols = keep ? n : -1;
  }
  __syncwarp();

  // 4. the two rows, dense, once
  const int nk = *n_cols;
  T* rows = g.rows + track * 2 * d;
  for (int i = lane; i < 2 * d; i += SLAM_THREADS) {
    const int row = i >= d, col = i - row * d;
    T val = T(0);
    for (int q = 0; q < nk; ++q)
      if (cols[q] == col) val = hv[row * MAX_SLAM + q];
    rows[i] = val;
  }
  if (lane < 2) g.res_out[track * 2 + lane] = nk >= 0 ? blk[30 + lane] : T(0);
}

// The three reflections of linalg.householder_qt(hf, res) for the window
// tracks, rounded as its torch operations round on the card, between the
// wrapper's three v^T hf products (torch.einsum: cuBLAS, whose order for 3
// columns varies with the batch). One warp a track, a row a lane (2M <= 32).
// Stage s applies reflection s - 1 (s >= 1: hf and res from its vector,
// factor and va = v^T hf) and finds reflection s (s <= 2: its vector and
// factor from hf's column s). torch.sum over the rows is a 32-lane halving
// tree (lane 0's value); every product and difference is rounded on its own.
template <typename T>
__device__ __forceinline__ T lane0_sum(T x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = x + __shfl_xor_sync(0xffffffffu, x, o);
  return __shfl_sync(0xffffffffu, x, 0);
}

__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float rcp_rn(float a) { return __frcp_rn(a); }
__device__ __forceinline__ double rcp_rn(double a) { return __drcp_rn(a); }

template <typename T>
__global__ void track_reflect_kernel(T* hf, T* res, const T* va, T* v, T* beta, int n, int R,
                                     int stage) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= n) return;
  const bool row = lane < R;
  T* a = hf + (b * R + lane) * 3;  // this lane's row of hf
  T h[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) h[c] = row ? a[c] : T(0);
  T r = row ? res[b * R + lane] : T(0);
  if (stage > 0) {  // a - beta (v va) and res - beta (v (v^T res)), as householder_qt
    const int k = stage - 1;
    const T vk = row ? v[((long long)k * n + b) * R + lane] : T(0);
    const T bk = beta[b * 3 + k];
#pragma unroll
    for (int c = 0; c < 3; ++c) h[c] = sub_rn(h[c], mul_rn(bk, mul_rn(vk, va[b * 3 + c])));
    const T vm = lane0_sum(mul_rn(vk, r));
    r = sub_rn(r, mul_rn(bk, mul_rn(vk, vm)));
    if (row) {
#pragma unroll
      for (int c = 0; c < 3; ++c) a[c] = h[c];
      res[b * R + lane] = r;
    }
  }
  if (stage < 3) {  // reflection `stage` from hf's column `stage`
    const int k = stage;
    const T x = lane >= k ? h[k] : T(0);
    const T norm = sqrt_rn(lane0_sum(mul_rn(x, x)));
    const T xk = __shfl_sync(0xffffffffu, h[k], k);
    const T sign = xk >= T(0) ? T(1) : T(-1);
    const T alpha = mul_rn(-sign, norm);
    const T vv = sub_rn(x, mul_rn(alpha, lane == k ? T(1) : T(0)));
    const T vn2 = lane0_sum(mul_rn(vv, vv));
    if (row) v[((long long)k * n + b) * R + lane] = vv;
    if (lane == 0) beta[b * 3 + k] = vn2 > T(1e-24) ? mul_rn(rcp_rn(vn2), T(2)) : T(0);
  }
}

// p_ok[a]: every entry of agent a's P finite (one block an agent).
template <typename T>
__global__ void cov_finite_kernel(const T* cov, long long n, bool* p_ok) {
  const T* p = cov + blockIdx.x * n;
  int bad = 0;
#pragma unroll 8
  for (long long i = threadIdx.x; i < n; i += blockDim.x) bad |= !isfinite(p[i]);
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) p_ok[blockIdx.x] = !bad;
}

template <typename T>
__global__ void track_rows_kernel(Args<T> g, int mode) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int a = blockIdx.x / g.k, t = blockIdx.x - a * g.k;
  if (mode == MODE_WINDOW) {
    window_track<T>(g, a, t, sm);
  } else {
    slam_feature<T>(g, a, t, sm);
  }
}

template <typename T>
size_t smem_bytes(int mode, int m) {
  if (mode == MODE_WINDOW) return (size_t)WindowLayout(m, 16 / sizeof(T)).total * sizeof(T);
  return (32 + 2 * MAX_SLAM + MAX_SLAM * MAX_SLAM + 2 * MAX_SLAM) * sizeof(T) +
         (MAX_SLAM + 1) * sizeof(int);
}

template <typename T>
int launch(void* const* p, int mode, int a, int k, int m, int d, int max_dof, int cur,
           double sigma, cudaStream_t stream) {
  Args<T> g;
  g.res = (const T*)p[0];
  g.j_pos = (const T*)p[1];
  g.j_att = (const T*)p[2];
  g.hf = (const T*)p[3];
  g.j_apos = (const T*)p[4];
  g.j_aatt = (const T*)p[5];
  g.anchor = (const int*)p[6];
  g.cov = (const T*)p[7];
  g.p_ok = (const bool*)p[8];
  g.count = (const long long*)p[9];
  g.ok = (const bool*)p[10];
  g.table = (const T*)p[11];
  g.rows = (T*)p[12];
  g.res_out = (T*)p[13];
  g.keep = (bool*)p[14];
  g.valid = (bool*)p[15];
  g.h1 = (T*)p[16];
  g.v = (const T*)p[17];
  g.beta = (const T*)p[18];
  g.k = k;
  g.m = m;
  g.d = d;
  g.max_dof = max_dof;
  g.cur = cur;
  g.inv_sigma = T(1) / (T)sigma;  // as the plain chain's h / sigma on the card
  const size_t bytes = smem_bytes<T>(mode, m);
  cudaError_t e = cudaFuncSetAttribute(track_rows_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  int threads = SLAM_THREADS;
  if (mode == MODE_WINDOW) {
    // one Hw P tile and one reflected column a thread; warp 0 holds a row
    // of the system and of [S rw; rw^T 0] a lane: 4 <= M <= 16
    if (m < 4 || m > MAX_M) return (int)cudaErrorInvalidValue;
    const WindowLayout L(m, 16 / sizeof(T));
    const int tiles = (L.RP / ROWS) * (L.C / COLS);
    const int need = tiles > L.C ? tiles : L.C;
    threads = (need + 31) / 32 * 32;
    threads = threads < 128 ? 128 : threads;
  }
  track_rows_kernel<T><<<(unsigned)((long long)a * k), threads, bytes, stream>>>(g, mode);
  return (int)cudaGetLastError();
}

}  // namespace

// Pointers, in order: res, j_pos, j_att, hf, j_apos, j_aatt, anchor, cov,
// p_ok (A bools, from xmat_cov_finite), count, ok, table, rows, res_out, keep, valid,
// h1, v, beta (the optional ones null). mode 0: window tracks (2M rows each, M >= 4); mode
// 1: SLAM features (2 rows each). dbl selects double over float.
extern "C" int xmat_track_rows(void* res, void* j_pos, void* j_att, void* hf, void* j_apos,
                               void* j_aatt, void* anchor, void* cov, void* p_ok, void* count,
                               void* ok, void* table, void* rows, void* res_out, void* keep,
                               void* valid, void* h1, void* v, void* beta, int mode, int dbl,
                               int a, int k, int m, int d, int max_dof, int cur, double sigma,
                               void* stream) {
  if (a <= 0 || k <= 0) return 0;
  void* const p[19] = {res, j_pos, j_att, hf, j_apos, j_aatt, anchor, cov, p_ok, count,
                       ok, table, rows, res_out, keep, valid, h1, v, beta};
  return dbl ? launch<double>(p, mode, a, k, m, d, max_dof, cur, sigma, (cudaStream_t)stream)
             : launch<float>(p, mode, a, k, m, d, max_dof, cur, sigma, (cudaStream_t)stream);
}

// p_ok (A,) = every entry of the agent's P (A, D, D) finite: the flag
// xmat_track_rows reads, launched just before it on the same stream.
extern "C" int xmat_cov_finite(void* cov, void* p_ok, int dbl, int a, int d, void* stream) {
  if (a <= 0) return 0;
  const long long n = (long long)d * d;
  if (dbl)
    cov_finite_kernel<double><<<a, 256, 0, (cudaStream_t)stream>>>((const double*)cov, n,
                                                                    (bool*)p_ok);
  else
    cov_finite_kernel<float><<<a, 256, 0, (cudaStream_t)stream>>>((const float*)cov, n,
                                                                  (bool*)p_ok);
  return (int)cudaGetLastError();
}

// One stage of the window tracks' reflections (track_reflect_kernel) over n
// tracks of R = 2M rows: hf (n, R, 3) and res (n, R) updated in place, va
// (n, 3) the previous reflection's v^T hf, v (3, n, R), beta (n, 3).
extern "C" int xmat_track_reflect(void* hf, void* res, void* va, void* v, void* beta, int stage,
                                  int dbl, int n, int r, void* stream) {
  if (n <= 0) return 0;
  if (r > 32) return (int)cudaErrorInvalidValue;
  constexpr int WARPS = 8;
  const unsigned grid = (unsigned)((n + WARPS - 1) / WARPS);
  if (dbl)
    track_reflect_kernel<double><<<grid, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        (double*)hf, (double*)res, (const double*)va, (double*)v, (double*)beta, n, r, stage);
  else
    track_reflect_kernel<float><<<grid, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        (float*)hf, (float*)res, (const float*)va, (float*)v, (float*)beta, n, r, stage);
  return (int)cudaGetLastError();
}
