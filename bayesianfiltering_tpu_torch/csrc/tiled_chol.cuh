// The blocked Cholesky of an augmented matrix in one launch, shared by the
// tiled EKF update (K1t, ekf_tiled.cu), the tiled UT update (K8t,
// ut_tiled.cu) and, on a W of height n, the tiled sigma points (K6t, K7t:
// sigma_tiled.cu).
//
// The updates factor
//
//   W = [S; X; vᵀ; I]   ((2dy + dx + 1) × dy, row-major; K1t)
//   W = [S; X; vᵀ]      ((dy + dx + 1) × dy; K8t)
//
// with S the innovation covariance (its lower part), X the transposed
// cross-covariance (dx × dy: (H P)ᵀ for K1t, Cᵀ for K8t) and v the
// innovation. Below L (S = L Lᵀ) the same panel steps carry the rows of X,
// vᵀ and I, so they come out as (L⁻¹ Xᵀ)ᵀ = Zᵀ, (L⁻¹ v)ᵀ = zᵀ and L⁻ᵀ: the
// forward substitutions are tiled products inside the factorisation, and
// K1t's gain is one more product, K = Zᵀ L⁻¹ (factor_and_gain). K8t needs
// no gain: its covariance is sym(P) − ZᵀZ and μ = m + Zᵀz, so its W has no
// I rows (factor_update).
//
// What bounds it on an H100. At config 5 the factor is 45 MFLOP (K6t, n =
// 512) or ~60 MFLOP (K1t, a 1,025 × 256 W): microseconds at the card's
// rate. The time goes to the panels' serial dependence: a launch a step
// costs ~5 µs of latency, and the 32 × 32 diagonal factor is a chain of 32
// dependent columns. So the whole factor is one cooperative launch, a
// persistent grid of one block an SM (fewer where no phase has that many
// tasks), with a grid barrier between the steps (~1.1 µs on an H100,
// whatever the grid's size); the working W stays in L2 (a few MB at
// config 5), and each step's tiles are handed to the blocks in turn. (A
// single thread-block cluster of 8 or 16 blocks, with its hardware
// barrier, measured 1.5–1.7× slower at n = 512: the early steps' ~100
// trailing tiles need the whole card.)
//
// - Tiles of kNb × kNb, in panels of kNb columns; the tile (I, J) holds
//   rows kNb·I.., columns kNb·J.. of W, and only tiles with I ≥ J are
//   touched.
// - The first phase factors the first diagonal tile (one block an
//   element); step k (k = 0 … panels − 2) then runs every trailing tile
//   (I, J), k < J ≤ I, as one task: its block forms the two panel tiles
//   L(I, k) = W(I, k)·L_kk⁻ᵀ and L(J, k) itself (a product with the
//   panel's stored inverse; two blocks may form the same one, so that no
//   step waits for another), and takes W(I, J) −= L(I, k)·L(J, k)ᵀ. The
//   task with J = k + 1 also stores L(I, k). Look-ahead: the task on the
//   next diagonal tile (k + 1, k + 1), handed out first, goes on to factor
//   it in one warp's registers (warp_cholesky_inverse: the Cholesky of the
//   tile with an identity below it, so that its inverse comes out of the
//   same 32 column steps) while the other blocks finish step k; one
//   barrier a step. A last phase forms the rows under the last panel.
//   Per step on the critical path (n = 512, float32): the barrier, the
//   diagonal task's loads (~0.45 µs), its two 32³ products (~1.5 µs; on
//   the float64 tensor cores in float64) and the factor (~3.7 µs).
// - The preparation is folded into the first touch of each tile: S =
//   lower(s_src) (+ sym(R)) (+ jitter + 1e-6·max|diag|, the relative
//   floor) as step 0 reads it, X from x_src, vᵀ from the innovation, I
//   generated; sym(R) goes to the caller's slot in the first phase.
// - An epilogue after the last barrier: the gain's log N(v | 0, S) and
//   μ = m + Zᵀ z (= m + K v), or K6t's or K7t's points (sigma_tiled.cu).
// - Two problems side by side (K7t: P over the batch and the shared C,
//   each square, of their own sizes): every phase hands out both
//   problems' tasks, the look-ahead's diagonal tiles of both first; a
//   problem whose chain has ended adds none. At dx = dn = 512 step 0 has
//   2 × 120 tasks, so steps 0–3 take two rounds of the blocks, but the
//   two chains of 16 steps run at once instead of one after the other.
// - A diagonal tile with a non-positive, infinite or NaN pivot is set to
//   NaN throughout, with its inverse, which every later step carries into
//   all outputs: a non-PD S gives NaN, as the plain versions' cholesky
//   does. The element's flag records it for the points. Nothing raises.
// - The per-element scratch holds W, its factor L (separate: a task still
//   reads W(I, k) while another stores L(I, k)), the diagonal tiles'
//   inverses transposed, the floor and the flag, at the offsets of an
//   AugLayout; the caller's own slots follow them (AugLayout::end), and
//   AugLayout::total is the element stride.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "tiled.cuh"

namespace bft {

constexpr int kNb = 32;        // tile and panel width: one warp's lanes
constexpr int kThreads = 256;  // the element-wise kernels' and the factor's
// a tile's row stride in shared memory: 16-byte rows, so that a thread
// reads its four consecutive entries as one vector (conflict-free: a
// warp's reads are 4 rows × 32 consecutive entries)
constexpr int kTilePad = kNb + 4;

__host__ __device__ inline int tiles_of(long long n) {
  return int((n + kNb - 1) / kNb);
}

struct AugLayout {
  int dx, dy;
  long long height;     // rows of W: 2dy + dx + 1, dy + dx + 1 or dy
  long long w, l, li;   // W, its factor L, the diagonal tiles' L⁻ᵀ
  long long misc;       // the floor, then the failed-pivot flag
  long long end;        // the first element after them
  long long total;      // the per-element stride of the scratch (≥ end)
  AugLayout() : AugLayout(0, 0, 0) {}
  AugLayout(int dx_, int dy_) : AugLayout(dx_, dy_, 2LL * dy_ + dx_ + 1) {}
  // W of `height` rows: dy + dx + 1 for no I rows, dy for the factor of S
  // alone (no X, vᵀ or I)
  AugLayout(int dx_, int dy_, long long height_)
      : dx(dx_), dy(dy_), height(height_) {
    w = 0;
    l = w + height * dy;
    li = l + height * dy;
    misc = li + 1LL * tiles_of(dy) * kNb * kNb;
    end = misc + 4;
    total = end;
  }
  // offsets of the rows of X (then Zᵀ), vᵀ (then zᵀ) and I (then L⁻ᵀ)
  __host__ __device__ long long xrow() const { return 1LL * dy * dy; }
  __host__ __device__ long long vrow() const {
    return (long long)(dy + dx) * dy;
  }
  __host__ __device__ long long erow() const {
    return (long long)(dy + dx + 1) * dy;
  }
  // the last phase's first tile row: the last diagonal tile's where rows
  // of X lie in it (dy not a multiple of kNb), else the one below it
  __host__ __device__ int last_from() const {
    return tiles_of(dy) - (dy % kNb != 0 && height > dy ? 1 : 0);
  }
};

// Step k's trailing tiles (I, J), k < J ≤ I, of one element: none once
// its chain of panels has ended.
__host__ __device__ inline long long step_tasks(const AugLayout& sc, int k) {
  const int ntc = tiles_of(sc.dy), ntr = tiles_of(sc.height);
  long long per = 0;
  for (int J = k + 1; J < ntc; ++J) per += ntr - J;
  return per;
}

inline int grid_1d(long long B) { return B < 65535 ? int(B) : 65535; }

// Element-wise grids: enough blocks for `work` elements, at most 256 (a
// few per SM) per batch row.
inline dim3 elementwise_grid(long long work, int B) {
  const long long blocks = (work + kThreads - 1) / kThreads;
  return dim3(unsigned(blocks < 256 ? (blocks > 0 ? blocks : 1) : 256),
              unsigned(grid_1d(B)));
}

// The Cholesky factor and its inverse of an n × n block (n ≤ kWarp) held
// a row a lane: lane i holds row i of the block's lower part in a (zeros
// elsewhere, and everywhere on lanes ≥ n) and row i of the identity in e
// on entry, row i of L in a and row i of L⁻ᵀ in e on exit. It is the
// right-looking factor of [A; I]: the identity's rows are eliminated with
// the same l_cj as the block's own, so the inverse adds FMAs but no step
// to the chain of 32 columns. Each column is broadcast through shared
// memory (col: 2·kWarp entries, 16-byte aligned, the columns in turns):
// one store a lane, a __syncwarp and 16-byte reads of the same words by
// every lane; a shuffle a column entry had cost ~23 cycles each, in
// series (5.6–6.9 µs for the block on an H100). Each lane keeps its
// diagonal entry apart, updated with its own l_ij, so that the chain from
// pivot to pivot is one shuffle and a reciprocal square root. Constant
// trip counts, as warp_cholesky; columns past n act as the identity's.
// Returns whether some pivot was not positive or not finite (a NaN pivot
// fails too), the same on every lane. The whole warp calls it.
template <typename T>
__device__ bool warp_cholesky_inverse(T (&a)[kWarp], T (&e)[kWarp], int n,
                                      T* col) {
  const unsigned full = 0xffffffffu;
  const int i = threadIdx.x % kWarp;
  bool bad = false;
  T dg = T(0);
#pragma unroll
  for (int c = 0; c < kWarp; ++c)
    if (c == i) dg = a[c];
#pragma unroll
  for (int j = 0; j < kWarp; ++j) {
    T d = __shfl_sync(full, dg, j);
    if (j >= n) d = T(1);
    bad = bad || !(d > T(0)) || isinf(d);
    const T r = drsqrt(d);
    const T lij = i == j ? d * r : (i > j ? a[j] * r : T(0));
    a[j] = lij;
    dg -= i > j ? lij * lij : T(0);
    const T eij = e[j] * r;
    e[j] = eij;
    T* cb = col + (j & 1) * kWarp;
    cb[i] = lij;
    __syncwarp();
#pragma unroll
    for (int v = (j + 1) / 4; v < kWarp / 4; ++v) {
      T w[4];
      lds4(w, cb + 4 * v);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = 4 * v + q;
        if (c > j) {
          if (c < i) a[c] -= lij * w[q];
          e[c] -= eij * w[q];
        }
      }
    }
  }
  return bad;
}

template <typename T>
struct FactorArgs {
  T* ws;             // the scratch; element b's at ws + b·st
  long long st;
  AugLayout sc;
  int B;
  // the first touch of W: S = lower(s_src) (+ sym(R)) (+ the floor)
  const T* s_src;
  long long s_ld, s_batch;
  const T* R;        // dy × dy, batch stride r_batch; nullptr for none
  long long r_batch;
  int add_floor;
  T jitter;
  const T* x_src;    // X (dx × dy, leading dimension dy), batch x_batch
  long long x_batch;
  const T* inn;      // v (B × dy)
  long long rs;      // sym(R) to this offset of the element's scratch; < 0
  const T* m;        // the gain epilogue: ll, mean = m + Zᵀ z (B × dx)
  T* ll;
  T* mean;
};

// The block's shared tiles.
template <typename T>
struct FactorSmem {
  __align__(16) T a[kNb][kTilePad];   // W(I, k), then L(I, k)
  __align__(16) T b[kNb][kTilePad];   // W(J, k), then L(J, k)ᵀ; the
                                      // diagonal tile to factor
  __align__(16) T li[kNb][kTilePad];  // L_kk⁻ᵀ
  __align__(16) T d[kNb][kTilePad];   // a float64 product's result
  __align__(16) T col[2][kWarp];      // the diagonal factor's columns
  T red[kThreads / kWarp];
};

// Entry (i, j) of element b's W at its first touch (i < height, j < dy;
// S's entry only for j ≤ i), assembled from the sources.
template <typename T>
__device__ T first_touch(const FactorArgs<T>& a, long long b, int i, int j) {
  const int dy = a.sc.dy, dx = a.sc.dx;
  if (i < dy) {
    T v = a.s_src[b * a.s_batch + (long long)i * a.s_ld + j];
    if (a.R != nullptr) {
      const T* R = a.R + b * a.r_batch;
      v += T(0.5) * (R[i * dy + j] + R[j * dy + i]);
    }
    if (a.add_floor && i == j) v += a.ws[b * a.st + a.sc.misc];
    return v;
  }
  if (i < dy + dx)
    return a.x_src[b * a.x_batch + (long long)(i - dy) * dy + j];
  if (i == dy + dx) return a.inn[b * dy + j];
  return i - dy - dx - 1 == j ? T(1) : T(0);
}

// Thread t's four entries of a tile: row t / 8, columns 4(t % 8)…
__device__ inline int tile_row() { return threadIdx.x / 8; }
__device__ inline int tile_col() { return (threadIdx.x % 8) * 4; }

// The thread's four entries of W's tile (I, J) (zeros outside W and, where
// lower, above the diagonal).
template <typename T>
__device__ void fetch_tile(const FactorArgs<T>& a, long long b, int I, int J,
                           bool first, bool lower, T (&v)[4]) {
  const int i = I * kNb + tile_row(), c0 = J * kNb + tile_col();
  if (!first) {  // W itself: four plain loads, issued together
    const T* W = a.ws + b * a.st + a.sc.w + (long long)i * a.sc.dy + c0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = c0 + q;
      const bool in = i < a.sc.height && j < a.sc.dy && (!lower || j <= i);
      v[q] = in ? W[q] : T(0);
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = c0 + q;
    const bool in = i < a.sc.height && j < a.sc.dy && (!lower || j <= i);
    v[q] = in ? first_touch(a, b, i, j) : T(0);
  }
}

// The thread's four entries of L_kk⁻ᵀ.
template <typename T>
__device__ void fetch_inverse(const FactorArgs<T>& a, long long b, int k,
                              T (&v)[4]) {
  const T* li = a.ws + b * a.st + a.sc.li + (long long)k * kNb * kNb +
                tile_row() * kNb + tile_col();
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = li[q];
}

template <typename T>
__device__ void put(T (*s)[kTilePad], const T (&v)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) s[tile_row()][tile_col() + q] = v[q];
}

// out ∓= Σ_m x[r][m]·y[m][c0..c0+3] over the thread's four entries (row r,
// columns c0…). Float32 on the CUDA cores: eight m at a time, their shared
// loads issued together (16-byte vectors), into two sets of accumulators.
// The whole block calls it; d is unused.
template <bool kSub>
__device__ void tile_product(float (*x)[kTilePad], float (*y)[kTilePad],
                             float (&out)[4], float (*)[kTilePad]) {
  const int r = tile_row(), c0 = tile_col();
  float acc[2][4] = {};
#pragma unroll
  for (int m0 = 0; m0 < kNb; m0 += 8) {
    float v[8], w[8][4];
    lds4(*reinterpret_cast<float(*)[4]>(&v[0]), &x[r][m0]);
    lds4(*reinterpret_cast<float(*)[4]>(&v[4]), &x[r][m0 + 4]);
#pragma unroll
    for (int mm = 0; mm < 8; ++mm) lds4(w[mm], &y[m0 + mm][c0]);
#pragma unroll
    for (int mm = 0; mm < 8; ++mm)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mm & 1][q] += v[mm] * w[mm][q];
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float sum = acc[0][q] + acc[1][q];
    out[q] = kSub ? out[q] - sum : sum;
  }
}

// The same in float64 on the tensor cores (tiled.cuh's dmma, full
// float64): warp w forms the 8 × 8 output tiles (w/2, 2(w%2)) and
// (w/2, 2(w%2) + 1) in 8 steps of k = 4 (the A fragment shared), stages
// them in d, and each thread reads its four entries back. On the CUDA
// cores a 32³ product took ~1.4 µs of a block in float64 on an H100
// (~0.4 µs here), on the critical path of every step.
template <bool kSub>
__device__ void tile_product(double (*x)[kTilePad], double (*y)[kTilePad],
                             double (&out)[4], double (*d)[kTilePad]) {
  static_assert(kThreads / kWarp * 2 == (kNb / 8) * (kNb / 8),
                "two 8 x 8 output tiles a warp");
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  const int g = lane / 4, t = lane % 4, ti = w / 2, tj = (w % 2) * 2;
  double acc[2][2] = {};
#pragma unroll
  for (int ks = 0; ks < kNb / 4; ++ks) {
    const double a = x[8 * ti + g][4 * ks + t];
#pragma unroll
    for (int u = 0; u < 2; ++u)
      dmma(acc[u], a, y[4 * ks + t][8 * (tj + u) + g]);
  }
  __syncthreads();  // earlier readers of d are done
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      d[8 * ti + g][8 * (tj + u) + 2 * t + i] = acc[u][i];
  __syncthreads();
  const int r = tile_row(), c0 = tile_col();
#pragma unroll
  for (int q = 0; q < 4; ++q)
    out[q] = kSub ? out[q] - d[r][c0 + q] : d[r][c0 + q];
}

// The thread's four entries of L's tile (I, J) from v, in rows ≥ row_lo.
template <typename T>
__device__ void store_l(const FactorArgs<T>& a, long long b, int I, int J,
                        const T (&v)[4], int row_lo = 0) {
  const int r = tile_row(), c0 = tile_col();
  const int i = I * kNb + r;
  if (i >= a.sc.height || i < row_lo) return;
  T* L = a.ws + b * a.st + a.sc.l + (long long)i * a.sc.dy;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = J * kNb + c0 + q;
    if (j < a.sc.dy) L[j] = v[q];
  }
}

// Factor the lower diagonal tile (K, K) staged in s (row stride kNb + 1:
// lane i reads and writes its row free of bank conflicts) into L's tile
// (zeros above the diagonal), its L⁻ᵀ and the element's flag. Warp 0 works
// in registers and leaves L's tile in s and L⁻ᵀ in t (the same stride);
// then the whole block stores both, a row of 4 consecutive entries a
// thread (a lane a row had stored 64 rows' worth of scattered sectors).
// The whole block calls it.
template <typename T>
__device__ void factor_diag(const FactorArgs<T>& a, long long b, int K,
                            T (*s)[kNb + 1], T (*t)[kNb + 1], T* col,
                            bool first) {
  const int dy = a.sc.dy;
  const int n = dy - K * kNb < kNb ? dy - K * kNb : kNb;
  T* ws = a.ws + b * a.st;
  if (threadIdx.x < kWarp) {
    const int i = threadIdx.x;
    T x[kWarp], e[kWarp];
#pragma unroll
    for (int c = 0; c < kWarp; ++c) {
      x[c] = i < n && c <= i ? s[i][c] : T(0);
      e[c] = c == i ? T(1) : T(0);
    }
    const bool bad = warp_cholesky_inverse(x, e, n, col);
#pragma unroll
    for (int c = 0; c < kWarp; ++c) {
      s[i][c] = bad ? qnan<T>() : (c <= i ? x[c] : T(0));
      t[i][c] = bad ? qnan<T>() : e[c];
    }
    if (i == 0) {
      T* flag = ws + a.sc.misc + 1;
      *flag = (bad || (!first && *flag != T(0))) ? T(1) : T(0);
    }
  }
  __syncthreads();
  const int r = tile_row(), c0 = tile_col();
  T* li = ws + a.sc.li + (long long)K * kNb * kNb + r * kNb + c0;
  T* L = ws + a.sc.l + (long long)(K * kNb + r) * dy + K * kNb + c0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    li[q] = t[r][c0 + q];
    if (r < n && c0 + q < n) L[q] = s[r][c0 + q];
  }
}

// The diagonal tile's staging buffers (stride kNb + 1) in the block's
// tiles: the tile in b's storage, L⁻ᵀ in li's (free once a task's products
// are done).
template <typename T>
__device__ T (*stage_a(FactorSmem<T>& sm))[kNb + 1] {
  return reinterpret_cast<T(*)[kNb + 1]>(&sm.b[0][0]);
}
template <typename T>
__device__ T (*stage_b(FactorSmem<T>& sm))[kNb + 1] {
  return reinterpret_cast<T(*)[kNb + 1]>(&sm.li[0][0]);
}
static_assert(kTilePad >= kNb + 1, "a tile buffer holds a staging tile");

// The first phase for element b: the floor, then the first diagonal tile.
template <typename T>
__device__ void first_diag(const FactorArgs<T>& a, long long b,
                           FactorSmem<T>& sm) {
  const int dy = a.sc.dy;
  if (a.add_floor) {
    T mx = T(0);
    for (int i = threadIdx.x; i < dy; i += blockDim.x) {
      T d = a.s_src[b * a.s_batch + (long long)i * a.s_ld + i];
      if (a.R != nullptr) d += a.R[b * a.r_batch + i * dy + i];
      mx = dabs(d) > mx ? dabs(d) : mx;
    }
    for (int o = kWarp / 2; o > 0; o >>= 1) {
      const T other = __shfl_xor_sync(0xffffffffu, mx, o);
      mx = other > mx ? other : mx;
    }
    if (threadIdx.x % kWarp == 0) sm.red[threadIdx.x / kWarp] = mx;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kThreads / kWarp; ++w)
        mx = sm.red[w] > mx ? sm.red[w] : mx;
      a.ws[b * a.st + a.sc.misc] = a.jitter + T(kRelJitter) * mx;
    }
    __syncthreads();
  }
  T v[4];
  fetch_tile(a, b, 0, 0, true, true, v);
#pragma unroll
  for (int q = 0; q < 4; ++q) stage_a(sm)[tile_row()][tile_col() + q] = v[q];
  __syncthreads();
  factor_diag(a, b, 0, stage_a(sm), stage_b(sm), &sm.col[0][0], true);
  __syncthreads();
}

// Step k's task on the trailing tile (I, J) of element b (see the header).
// Every global load is issued before the first shared store.
template <typename T>
__device__ void trailing_task(const FactorArgs<T>& a, long long b, int I,
                              int J, int k, FactorSmem<T>& sm) {
  const bool first = k == 0, same = I == J;
  const int r = tile_row(), c0 = tile_col();
  T ta[4], tb[4], tl[4], c[4];
  fetch_tile(a, b, I, k, first, false, ta);
  if (!same) fetch_tile(a, b, J, k, first, false, tb);
  fetch_inverse(a, b, k, tl);
  fetch_tile(a, b, I, J, first, same, c);  // W(I, J)
  put(sm.a, ta);
  if (!same) put(sm.b, tb);
  put(sm.li, tl);
  __syncthreads();
  T pi[4], pj[4];
  tile_product<false>(sm.a, sm.li, pi, sm.d);
  if (!same) tile_product<false>(sm.b, sm.li, pj, sm.d);
  __syncthreads();
  // L(I, k) by rows into a, L(J, k)ᵀ into b
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    sm.a[r][c0 + q] = pi[q];
    sm.b[c0 + q][r] = same ? pi[q] : pj[q];
  }
  __syncthreads();
  tile_product<true>(sm.a, sm.b, c, sm.d);
  if (J == k + 1) store_l(a, b, I, k, pi);
  T* W = a.ws + b * a.st + a.sc.w;
  const int i = I * kNb + r;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = J * kNb + c0 + q;
    if (i < a.sc.height && j < a.sc.dy && (!same || j <= i))
      W[(long long)i * a.sc.dy + j] = c[q];
  }
  if (same && I == k + 1) {  // look-ahead: factor the next diagonal tile
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q)
      stage_a(sm)[r][c0 + q] = c0 + q <= r ? c[q] : T(0);
    __syncthreads();
    factor_diag(a, b, k + 1, stage_a(sm), stage_b(sm), &sm.col[0][0], false);
  }
  __syncthreads();
}

// The last phase's task: L(I, last) = W(I, last)·L_last⁻ᵀ in the rows
// under S (on the last diagonal tile, only those: its rows of S are the
// diagonal factor's).
template <typename T>
__device__ void last_panel_task(const FactorArgs<T>& a, long long b, int I,
                                int last, FactorSmem<T>& sm) {
  T ta[4], tl[4];
  fetch_tile(a, b, I, last, last == 0, false, ta);
  fetch_inverse(a, b, last, tl);
  put(sm.a, ta);
  put(sm.li, tl);
  __syncthreads();
  T p[4];
  tile_product<false>(sm.a, sm.li, p, sm.d);
  store_l(a, b, I, last, p, a.sc.dy);
  __syncthreads();
}

// Block g's share of `total` tasks in turns over the G blocks, the order
// reversed every other round (so that the first tasks, the look-ahead's
// diagonal tiles, are not the ones whose blocks take a second task).
template <typename F>
__device__ void for_tasks(long long total, F f) {
  const int G = gridDim.x, g = blockIdx.x;
  for (long long round = 0; round * G < total; ++round) {
    const long long p = round * G + ((round & 1) ? G - 1 - g : g);
    if (p < total) f(p);
  }
}

// The gain's epilogue: ll = log N(v | 0, S) from diag L and z, and
// μ = m + Zᵀ z, a warp a row (row dx of an element: ll).
struct GainEpilogue {
  template <typename T>
  __device__ void operator()(const FactorArgs<T>& a, FactorSmem<T>&) const {
    const int dx = a.sc.dx, dy = a.sc.dy, lane = threadIdx.x % kWarp;
    const long long warps = (long long)gridDim.x * (kThreads / kWarp);
    const long long rows = (long long)a.B * (dx + 1);
    for (long long w = blockIdx.x * (kThreads / kWarp) + threadIdx.x / kWarp;
         w < rows; w += warps) {
      const long long b = w / (dx + 1);
      const int i = int(w % (dx + 1));
      const T* L = a.ws + b * a.st + a.sc.l;
      const T* z = L + a.sc.vrow();
      T s = T(0), t = T(0);
      if (i < dx) {
        const T* zt = L + a.sc.xrow() + (long long)i * dy;
        for (int c = lane; c < dy; c += kWarp) s += zt[c] * z[c];
      } else {
        for (int c = lane; c < dy; c += kWarp) {
          s += dlog(L[(long long)c * dy + c]);
          t += z[c] * z[c];
        }
      }
      for (int o = kWarp / 2; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        t += __shfl_xor_sync(0xffffffffu, t, o);
      }
      if (lane == 0) {
        if (i < dx)
          a.mean[b * dx + i] = a.m[b * dx + i] + s;
        else
          a.ll[b] = T(-0.5) * (T(dy * kLog2Pi) + T(2) * s + t);
      }
    }
  }
  static constexpr bool kAny = true;
};

// Step k's task p of one problem, whose elements have `per` trailing
// tiles each: the look-ahead's diagonal tiles (k + 1, k + 1) of its
// elements are the tasks p < B, the other tiles follow element by
// element, column by column.
template <typename T>
__device__ void step_task(const FactorArgs<T>& a, long long p, long long per,
                          int k, FactorSmem<T>& sm) {
  const int ntr = tiles_of(a.sc.height);
  long long b;
  int I, J = k + 1;
  if (p < a.B) {
    b = p;
    I = J;
  } else {
    const long long q = p - a.B;
    b = q / (per - 1);
    long long o = q % (per - 1) + 1;  // past (k + 1, k + 1)
    while (o >= ntr - J) {
      o -= ntr - J;
      ++J;
    }
    I = J + int(o);
  }
  trailing_task(a, b, I, J, k, sm);
}

// The one-launch factor (see the header) of one problem a, or of two side
// by side (kProblems = 2: K7t's P over the batch and its shared C, each
// square, height = dy, so that neither has a last phase). Launched
// cooperatively: every block is resident, and grid.sync() separates the
// phases. Two problems share each phase: the first phase factors both
// first diagonal tiles; step k hands out the look-ahead's diagonal tiles
// of both first, then both problems' other trailing tiles; a problem
// whose chain has ended adds no tasks. The epilogue gets both. A task
// reaches its problem through a reference to the parameter
// (__grid_constant__), so that each task's code is inlined once, not
// once a problem (with four inlined copies of the step, K7t took 0.166 ms
// against 0.145 in float32, 0.284 against 0.204 in float64, at
// dx = dn = 512 on an H100, in separate runs).
template <typename T, typename Epi, int kProblems>
__global__ void __launch_bounds__(kThreads) tiled_factor_kernel(
    const __grid_constant__ FactorArgs<T> a,
    const __grid_constant__ FactorArgs<T> c, const Epi epi) {
  namespace cg = cooperative_groups;
  cg::grid_group grid = cg::this_grid();
  __shared__ FactorSmem<T> sm;
  const AugLayout& sc = a.sc;
  const int dy = sc.dy, ntr = tiles_of(sc.height);
  const long long B = a.B, Bc = kProblems == 2 ? c.B : 0;
  const int ntc = tiles_of(dy), ntc_c = Bc > 0 ? tiles_of(c.sc.dy) : 0;

  // the first phase: the first diagonal tiles, sym(R)
  for_tasks(B + Bc, [&](long long p) {
    const bool in_c = kProblems == 2 && p >= B;
    first_diag(in_c ? c : a, in_c ? p - B : p, sm);
  });
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (a.rs >= 0)
    for (long long idx = first; idx < B * dy * dy; idx += stride) {
      const long long b = idx / (1LL * dy * dy);
      const int e = int(idx % (1LL * dy * dy)), i = e / dy, j = e % dy;
      const T* R = a.R + b * a.r_batch;
      a.ws[b * a.st + a.rs + e] = T(0.5) * (R[i * dy + j] + R[j * dy + i]);
    }
  grid.sync();

  // the steps
  const int steps = (ntc > ntc_c ? ntc : ntc_c) - 1;
  for (int k = 0; k < steps; ++k) {
    const long long per = step_tasks(sc, k);  // trailing tiles of an element
    if constexpr (kProblems == 1) {
      for_tasks(B * per, [&](long long p) { step_task(a, p, per, k, sm); });
    } else {
      const long long per_c = Bc > 0 ? step_tasks(c.sc, k) : 0;
      const long long da = per > 0 ? B : 0, dc = per_c > 0 ? Bc : 0;
      const long long ra = B * per - da;  // a's tiles past its diagonal ones
      for_tasks(B * per + Bc * per_c, [&](long long p) {
        // a's diagonal tiles, c's, a's others, c's others
        const bool in_c = (p >= da && p < da + dc) || p >= da + dc + ra;
        const long long q = p < da             ? p
                            : p < da + dc      ? p - da
                            : p < da + dc + ra ? p - dc
                                               : p - da - ra;
        step_task(in_c ? c : a, q, in_c ? per_c : per, k, sm);
      });
    }
    grid.sync();
  }

  // the rows under the last panel (the first problem's only)
  const int from = sc.last_from();
  if (ntr > from) {
    const long long per = ntr - from;
    for_tasks(B * per, [&](long long p) {
      last_panel_task(a, p / per, from + int(p % per), ntc - 1, sm);
    });
    if (Epi::kAny) grid.sync();
  }
  if constexpr (kProblems == 1)
    epi(a, sm);
  else
    epi(a, c, sm);
}

// The most tasks of any phase of the factor of B elements of one problem
// and, side by side, B2 of a second square one (K7t's C; B2 = 0 for none).
inline long long factor_tasks(const AugLayout& sc, int B,
                              const AugLayout& sc2 = AugLayout(),
                              int B2 = 0) {
  const int ntc = tiles_of(sc.dy), ntc2 = B2 > 0 ? tiles_of(sc2.dy) : 0;
  long long most = 1LL * (tiles_of(sc.height) - sc.last_from()) * B;
  if (B + B2 > most) most = B + B2;  // the first phase
  for (int k = 0; k + 1 < (ntc > ntc2 ? ntc : ntc2); ++k) {
    const long long t =
        B * step_tasks(sc, k) + (B2 > 0 ? B2 * step_tasks(sc2, k) : 0);
    if (t > most) most = t;
  }
  return most > 1 ? most : 1;
}

// Launch the factor of one problem, or of two side by side (kProblems = 2,
// the second c), over `tasks` (the most that any phase has) on at most one
// block an SM (fewer blocks, a shorter barrier); returns the launch's
// error.
template <int kProblems = 1, typename T, typename Epi>
int launch_factor(const FactorArgs<T>& a, const Epi& epi, long long tasks,
                  cudaStream_t stream,
                  const FactorArgs<T>& c = FactorArgs<T>{}) {
  auto kernel = tiled_factor_kernel<T, Epi, kProblems>;
  long long blocks = sm_count();
  if (tasks < blocks) blocks = tasks;
  if (blocks < 1) blocks = 1;
  void* args[] = {const_cast<FactorArgs<T>*>(&a),
                  const_cast<FactorArgs<T>*>(&c), const_cast<Epi*>(&epi)};
  return int(cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                         dim3(unsigned(blocks)),
                                         dim3(kThreads), args, 0, stream));
}

// Factor the augmented W of every element (its G, the lower part of S
// before sym(R) and the floor, in W's top square; X at x_src) and finish
// the update's common part: sym(R) into the slot at rs (≥ 0), ll and
// μ = m + Zᵀ z. One launch; returns its error.
template <typename T>
int factor_update(T* ws, const AugLayout& sc, int B, const T* R,
                  long long r_batch, T jitter, const T* x_src,
                  long long x_batch, const T* inn, long long rs, const T* m,
                  T* ll, T* mean, cudaStream_t stream) {
  const int dx = sc.dx, dy = sc.dy;
  const long long st = sc.total;
  FactorArgs<T> a{};
  a.ws = ws; a.st = st; a.sc = sc; a.B = B;
  a.s_src = ws + sc.w; a.s_ld = dy; a.s_batch = st;
  a.R = R; a.r_batch = r_batch; a.add_floor = 1; a.jitter = jitter;
  a.x_src = x_src; a.x_batch = x_batch; a.inn = inn; a.rs = rs;
  a.m = m; a.ll = ll; a.mean = mean;
  const long long rows = 1LL * B * (dx + 1);  // the epilogue's warps
  long long tasks = factor_tasks(sc, B);
  const long long epi_blocks =
      (rows + kThreads / kWarp - 1) / (kThreads / kWarp);
  if (epi_blocks > tasks) tasks = epi_blocks;
  return launch_factor(a, GainEpilogue{}, tasks, stream);
}

// factor_update on W = [S; X; vᵀ; I], then the gain K = Zᵀ L⁻¹ (dx × dy,
// leading dimension dy, batch stride k_batch). Two launches. Returns the
// first error.
template <typename T>
int factor_and_gain(T* ws, const AugLayout& sc, int B, const T* R,
                    long long r_batch, T jitter, const T* x_src,
                    long long x_batch, const T* inn, long long rs, T* K,
                    long long k_batch, const T* m, T* ll, T* mean,
                    cudaStream_t stream) {
  const int dx = sc.dx, dy = sc.dy;
  const long long st = sc.total;
  const int err = factor_update(ws, sc, B, R, r_batch, jitter, x_src,
                                x_batch, inn, rs, m, ll, mean, stream);
  // K = Zᵀ L⁻¹ = Zᵀ (L⁻ᵀ)ᵀ
  const int e = gemm(gemm_of<T>(dx, dy, dy, B,
                                {ws + sc.l + sc.xrow(), dy, st, 0},
                                {ws + sc.l + sc.erow(), dy, st, 1}, K, dy,
                                k_batch),
                     stream);
  return err ? err : e;
}

}  // namespace bft
