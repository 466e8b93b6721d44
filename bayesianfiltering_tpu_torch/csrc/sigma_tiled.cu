// Tiled multi-block sigma points (K6t) and augmented sigma points (K7t):
// the variants of K6 and K7 (fused_ut.cu) for factors whose workspace
// does not fit in one SM's shared memory.
//
// Replace the same TPU kernels as K6 and K7:
// bayesianfiltering_tpu/ops/fused_ut.py `_sigma_kernel` (K6t) and
// `_sigma_aug_kernel` (K7t). ops/fused_ut.py picks K6/K7 or K6t/K7t by
// shape alone: the per-element kernels where their workspace fits in a
// block's shared memory (the batched Lorenz-96 UKF at n = 64, the
// UGSF/UAGSF banks), these otherwise (config 5's n = 512, path N's 2,048),
// at any width whose operands and scratch fit in the device's memory: the
// element-wise passes index in 64 bits (n² passes an int at n = 46,341).
//
// What bounds them on an H100. At config 5 (B = 1, n = 512) the Cholesky
// is 45 MFLOP and the points 2 MB in float32: ~1 µs at the card's rates.
// The time goes to the factor's serial panels. Here:
// - Cholesky: one cooperative launch (tiled_chol.cuh's tiled_factor_kernel
//   on a W of height n: no rows below S): its first touch of each tile
//   reads lower(P) straight from P (no copy), its steps factor the panels
//   with a grid barrier between them, and its epilogue writes the points
//   from the factor, still in L2. No jitter: P is factored as
//   torch.linalg.cholesky_ex factors it.
// - Newton–Schulz: a trace pass (Y = sym(P)/s, Z = I, s = tr P + 1e-30),
//   14 rounds of three tiled products (T = 1.5·I − 0.5·Z Y is one product
//   with 1.5 on the diagonal; Y ← Y T; Z ← T Z), a pass for sym(Y·√s),
//   with fused_ut.cu's constants, and the points pass. K7t runs P's and
//   C's rounds together: one trace pass and one root pass for both, and
//   each of the 42 products as one grouped launch of P's and C's (gemm2,
//   a batch per product): 45 launches, not 89.
// - Points: 32 × 32 tiles staged through padded shared memory, so that the
//   factor's columns are read and the points' rows written coalesced; both
//   halves at once. A Cholesky factor's entries above the diagonal are
//   never written by the factor, so they are taken as 0 and never read.
//   The factor NaNs only a failing diagonal tile and what later steps
//   compute from it, so every tile that touches a Cholesky block writes
//   NaN throughout it unless every pivot is finite and positive (the plain
//   versions' cholesky_ex info), from the factor's flag. The Newton–Schulz
//   routes write their points in a pass of their own.
// - K7t's Cholesky is one cooperative launch too: the factor of P over
//   the batch and of the shared C (B = 1) side by side in the same phases
//   (tiled_chol.cuh's two-problem mode: chol(blkdiag(P, C)) =
//   blkdiag(chol P, chol C), and the two chains of panels, 16 steps each
//   at dx = dn = 512, run at once instead of one after the other), and
//   the four blocks of the (2na, na) augmented points as its epilogue
//   (SigmaAugEpilogue); a non-PD P NaNs that element's state block (its
//   flag in P's problem), a non-PD C the noise block (C's flag), as in
//   the plain points_blockdiag.
//
// Each entry point enqueues its launches on the caller's stream and
// returns the first CUDA error; the wrapper supplies the scratch (a few MB
// at n = 512, resident in L2). Nothing here raises.
#include "tiled_chol.cuh"

namespace {

using namespace bft;

constexpr int kNsIters = 14;  // utils/linalg.py sqrtm_psd_ns
constexpr int kSqrtm = 1;     // ops/fused_ut.py _METHODS
constexpr int kTile = kNb;    // the points' tiles
constexpr int kTileRows = kThreads / kTile;

// Per-element scratch of one factor: a square AugLayout (W, L, the
// diagonal tiles' inverses, the flag) for the Cholesky; Y, Z, T and a
// spare n × n for Newton–Schulz (ns_stride), whose traces (one per
// element) follow the batch.
__host__ __device__ inline long long ns_stride(int n) { return 4LL * n * n; }

long long factor_stride(int n, int method) {
  return method == kSqrtm ? ns_stride(n) : AugLayout(0, n, n).total;
}

long long factor_elems(int B, int n, int method) {
  return B * factor_stride(n, method) + (method == kSqrtm ? B : 0);
}

// The Cholesky of P (B × n × n, row-major) into ws: S is lower(P) as read.
template <typename T>
FactorArgs<T> square_factor(const T* P, T* ws, int B, int n) {
  FactorArgs<T> a{};
  a.sc = AugLayout(0, n, n);
  a.ws = ws;
  a.st = a.sc.total;
  a.B = B;
  a.s_src = P;
  a.s_ld = n;
  a.s_batch = 1LL * n * n;
  a.rs = -1;
  return a;
}

// One Newton–Schulz problem: B matrices P (n × n, row-major) and their
// scratch (Y, Z, T and a spare, factor_stride apart; the traces after
// the batch).
template <typename T>
struct NsProblem {
  const T* P;
  T* ws;
  int B, n;
};

// Row y of a grid over a's elements, then c's: that element's P, scratch
// and trace slot, and its n.
template <typename T>
__device__ __forceinline__ void ns_element(const NsProblem<T>& a,
                                           const NsProblem<T>& c, long long y,
                                           const T** P, T** ws, T** s,
                                           int* n) {
  const bool in_a = y < a.B;
  const long long b = in_a ? y : y - a.B;
  const int m = in_a ? a.n : c.n;
  const long long st = ns_stride(m);
  T* base = in_a ? a.ws : c.ws;
  *n = m;
  *P = (in_a ? a.P : c.P) + b * m * m;
  *ws = base + b * st;
  *s = base + (in_a ? a.B : c.B) * st + b;
}

// Newton–Schulz's start for every element of a and c (c.B = 0 for none):
// s = tr P + 1e-30 (into the trace slot from the first block of each
// element), Y = sym(P)/s, Z = I. Every block finds s itself (n reads).
// Grid (blocks, a.B + c.B), a block a row in turns (rows_grid).
template <typename T>
__global__ void __launch_bounds__(kThreads) sigma_tiled_trace_kernel(
    const NsProblem<T> a, const NsProblem<T> c) {
  __shared__ T s_sum;
  for (long long y = blockIdx.y; y < a.B + c.B; y += gridDim.y) {
    const T* P;
    T *Y, *s_out;
    int n;
    ns_element(a, c, y, &P, &Y, &s_out, &n);
    if (threadIdx.x < kWarp) {
      T s = T(0);
      for (int i = threadIdx.x; i < n; i += kWarp) s += P[at64(i, i, n)];
      for (int o = kWarp / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (threadIdx.x == 0) s_sum = s + T(1e-30);
    }
    __syncthreads();
    const T s = s_sum;
    if (blockIdx.x == 0 && threadIdx.x == 0) *s_out = s;
    T* Z = Y + 1LL * n * n;
    for (int i = blockIdx.x; i < n; i += gridDim.x)
      for (int j = threadIdx.x; j < n; j += blockDim.x) {
        Y[at64(i, j, n)] =
            (T(0.5) * (P[at64(i, j, n)] + P[at64(j, i, n)])) / s;
        Z[at64(i, j, n)] = i == j ? T(1) : T(0);
      }
    __syncthreads();
  }
}

// Newton–Schulz's end for every element of a and c: root = sym(Y·√s)
// from the Y at slot y into slot out of the element's scratch (slots in
// units of n²). Grid (blocks, a.B + c.B), a block a row in turns.
template <typename T>
__global__ void __launch_bounds__(kThreads) sigma_tiled_root_kernel(
    const NsProblem<T> a, const NsProblem<T> c, int y, int out) {
  for (long long e = blockIdx.y; e < a.B + c.B; e += gridDim.y) {
    const T* P;
    T *ws, *s;
    int n;
    ns_element(a, c, e, &P, &ws, &s, &n);
    const T* Y = ws + 1LL * y * n * n;
    T* R = ws + 1LL * out * n * n;
    const T rs = dsqrt(*s);
    for (int i = blockIdx.x; i < n; i += gridDim.x)
      for (int j = threadIdx.x; j < n; j += blockDim.x)
        R[at64(i, j, n)] =
            T(0.5) * (Y[at64(i, j, n)] * rs + Y[at64(j, i, n)] * rs);
  }
}

// One round's product of problem q over its batch: slot out = alpha·(slot
// x)·(slot y) + diag·I, slots in units of n² of each element's scratch.
template <typename T>
Gemm<T> ns_product(const NsProblem<T>& q, int x, int y, int out, T alpha,
                   T diag) {
  const long long n2 = 1LL * q.n * q.n, st = factor_stride(q.n, kSqrtm);
  Gemm<T> g = gemm_of<T>(q.n, q.n, q.n, q.B, {q.ws + x * n2, q.n, st, 0},
                         {q.ws + y * n2, q.n, st, 0}, q.ws + out * n2, q.n,
                         st, alpha);
  g.diag = diag;
  return g;
}

// Newton–Schulz's root of a's matrices and, where c.B > 0, of c's, their
// rounds side by side: each product one launch for a alone, or one
// grouped launch of a's and c's (gemm2). The roots land in slot *F of
// each element's scratch. Returns the first CUDA error.
template <typename T>
int ns_factor(const NsProblem<T>& a, const NsProblem<T>& c, int* F,
              cudaStream_t stream) {
  int err = 0;
  auto keep = [&](int e) {
    if (err == 0) err = e;
  };
  auto product = [&](int x, int y, int out, T alpha, T diag) {
    const Gemm<T> ga = ns_product(a, x, y, out, alpha, diag);
    return c.B > 0 ? gemm2(ga, ns_product(c, x, y, out, alpha, diag), stream)
                   : gemm(ga, stream);
  };
  const int n = a.n > c.n ? a.n : c.n;
  const dim3 grid = rows_grid(n, a.B + c.B);
  int y = 0, z = 1, t = 2, w = 3;  // the slots of Y, Z, T and the spare
  sigma_tiled_trace_kernel<T><<<grid, kThreads, 0, stream>>>(a, c);
  keep(int(cudaGetLastError()));
  for (int it = 0; it < kNsIters; ++it) {
    keep(product(z, y, t, T(-0.5), T(1.5)));  // T = 1.5·I − 0.5·Z Y
    keep(product(y, t, w, T(1), T(0)));        // Y ← Y T
    int swap = y; y = w; w = swap;
    keep(product(t, z, w, T(1), T(0)));        // Z ← T Z
    swap = z; z = w; w = swap;
  }
  sigma_tiled_root_kernel<T><<<grid, kThreads, 0, stream>>>(a, c, y, t);
  keep(int(cudaGetLastError()));
  *F = t;
  return err;
}

// The points pass's operands: the state factor per element (dx × dx,
// batch stride fx_batch) and, where dn > 0, the shared noise factor
// (dn × dn) with its bias; `lower` for Cholesky factors.
template <typename T>
struct PointsArgs {
  const T* m;
  const T* Fx;
  long long fx_batch;
  int dx;
  const T* bias;
  const T* Fc;
  int dn;
  T scale;
  int lower;
};

// One kTile × kTile tile (output rows r0.., columns c0..) of both halves
// of element b's (2na, na) points, na = dx + dn: row r, column c of the
// first half is mA[c] + scale·F[c][r], of the second mA[c] − scale·F[c][r],
// with mA = [m; bias] and F = blkdiag(F_x, F_c); NaN on the state block
// where bad_x, on the noise block where bad_c. The whole block calls it,
// kTile × kTileRows threads; ends synchronised.
template <typename T>
__device__ void points_tile(const PointsArgs<T>& a, long long b, int r0,
                            int c0, bool bad_x, bool bad_c, T* pts_all,
                            T (*tile)[kTile + 1]) {
  const int dx = a.dx, dn = a.dn, na = dx + dn;
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  const T* Fx = a.Fx + b * a.fx_batch;
  // F[i][k] for output row k = r0 + tx, column i: read along k;
  // tile[r][c] = scale·F[c][r]
  const int k = r0 + tx;
  for (int s = ty; s < kTile; s += kTileRows) {
    const int i = c0 + s;
    T v = T(0);
    if (k < dx && i < dx) {
      if (!(a.lower && i < k)) v = a.scale * Fx[(long long)i * dx + k];
    } else if (k >= dx && i >= dx && k < na && i < na) {
      if (!(a.lower && i < k))
        v = a.scale * a.Fc[(long long)(i - dx) * dn + (k - dx)];
    }
    tile[tx][s] = v;
  }
  __syncthreads();
  T* pts = pts_all + b * 2LL * na * na;
  const int c = c0 + tx;
  if (c < na) {
    const T mc = c < dx ? a.m[b * dx + c] : a.bias[c - dx];
    for (int s = ty; s < kTile; s += kTileRows) {
      const int r = r0 + s;
      if (r >= na) break;
      const bool nan = (r < dx && c < dx && bad_x) ||
                       (r >= dx && c >= dx && bad_c);
      const T o = nan ? qnan<T>() : tile[s][tx];
      pts[(long long)r * na + c] = mc + o;
      pts[(long long)(na + r) * na + c] = mc - o;
    }
  }
  __syncthreads();
}

// The points of every element from its Newton–Schulz roots (nothing to
// flag): grid (column tiles, row tiles, batch), kThreads threads.
template <typename T>
__global__ void __launch_bounds__(kThreads) sigma_tiled_points_kernel(
    PointsArgs<T> a, T* pts_all, int B) {
  __shared__ T tile[kTile][kTile + 1];
  const int c0 = blockIdx.x * kTile, r0 = blockIdx.y * kTile;
  for (long long b = blockIdx.z; b < B; b += gridDim.z)
    points_tile(a, b, r0, c0, false, false, pts_all, tile);
}

template <typename T>
int launch_points(const PointsArgs<T>& a, T* pts, int B,
                  cudaStream_t stream) {
  const int tiles = (a.dx + a.dn + kTile - 1) / kTile;
  sigma_tiled_points_kernel<T><<<dim3(tiles, tiles, grid_1d(B)), kThreads,
                                 0, stream>>>(a, pts, B);
  return int(cudaGetLastError());
}

// The factor's epilogues: the points from the factor, the tiles of every
// element in turns over the factor's blocks, in the factor's first tile
// buffer (read with points_tile's stride). The flags of the factor say
// whether a pivot failed: K6t's PointsEpilogue reads P's; K7t's
// SigmaAugEpilogue reads P's for the element's state block and C's (its
// one element) for every noise block.
static_assert(kNb * kTilePad >= kTile * (kTile + 1),
              "the factor's tile buffer holds a points tile");

template <typename T>
__device__ bool factor_failed(const FactorArgs<T>& a, long long b) {
  return a.ws[b * a.st + a.sc.misc + 1] != T(0);
}

template <typename T>
__device__ void epilogue_points(const PointsArgs<T>& p, T* pts,
                                const FactorArgs<T>& a, bool bad_c,
                                FactorSmem<T>& sm) {
  const int tiles = tiles_of(p.dx + p.dn);
  const long long per = 1LL * tiles * tiles;
  for_tasks(a.B * per, [&](long long q) {
    const long long b = q / per;
    const int t = int(q % per);
    points_tile(p, b, (t / tiles) * kTile, (t % tiles) * kTile,
                factor_failed(a, b), bad_c, pts,
                reinterpret_cast<T(*)[kTile + 1]>(&sm.a[0][0]));
  });
}

template <typename T>
struct PointsEpilogue {
  PointsArgs<T> p;
  T* pts;
  static constexpr bool kAny = true;
  __device__ void operator()(const FactorArgs<T>& a,
                             FactorSmem<T>& sm) const {
    epilogue_points(p, pts, a, false, sm);
  }
};

template <typename T>
struct SigmaAugEpilogue {
  PointsArgs<T> p;
  T* pts;
  static constexpr bool kAny = true;
  __device__ void operator()(const FactorArgs<T>& a, const FactorArgs<T>& c,
                             FactorSmem<T>& sm) const {
    epilogue_points(p, pts, a, c.B > 0 && factor_failed(c, 0), sm);
  }
};

// The points' tiles of B elements at na = dx + dn, as tasks.
inline long long points_tasks(int B, int na) {
  return 1LL * B * tiles_of(na) * tiles_of(na);
}

template <typename T>
int launch_sigma_tiled(const void* m, const void* P, void* pts,
                       void* scratch, int B, int n, double scale, int method,
                       cudaStream_t stream) {
  T* ws = static_cast<T*>(scratch);
  if (method != kSqrtm) {  // one launch
    const FactorArgs<T> a = square_factor(static_cast<const T*>(P), ws, B, n);
    const PointsEpilogue<T> epi{
        {static_cast<const T*>(m), ws + a.sc.l, a.st, n, nullptr, nullptr, 0,
         T(scale), 1},
        static_cast<T*>(pts)};
    long long tasks = factor_tasks(a.sc, B);
    if (points_tasks(B, n) > tasks) tasks = points_tasks(B, n);
    return launch_factor(a, epi, tasks, stream);
  }
  int F = 0;
  const int err = ns_factor<T>({static_cast<const T*>(P), ws, B, n},
                               {nullptr, nullptr, 0, 0}, &F, stream);
  const PointsArgs<T> a{static_cast<const T*>(m), ws + 1LL * F * n * n,
                        factor_stride(n, method), n, nullptr, nullptr, 0,
                        T(scale), 0};
  const int e = launch_points<T>(a, static_cast<T*>(pts), B, stream);
  return err ? err : e;
}

// K7t: P's per-element factors and C's shared one in the scratch's two
// parts (factor_elems(B, dx, method), then factor_elems(1, dn, method)).
template <typename T>
int launch_sigma_aug_tiled(const void* m, const void* P, const void* bias,
                           const void* C, void* pts, void* scratch, int B,
                           int dx, int dn, double scale, int method,
                           cudaStream_t stream) {
  T* ws = static_cast<T*>(scratch);
  T* wc = ws + factor_elems(B, dx, method);
  const int bc = dn > 0 ? 1 : 0;
  if (method != kSqrtm) {  // one launch: both factors, then the points
    const FactorArgs<T> a = square_factor(static_cast<const T*>(P), ws, B, dx);
    const FactorArgs<T> c = square_factor(static_cast<const T*>(C), wc, bc, dn);
    const SigmaAugEpilogue<T> epi{
        {static_cast<const T*>(m), ws + a.sc.l, a.st, dx,
         static_cast<const T*>(bias), wc + c.sc.l, dn, T(scale), 1},
        static_cast<T*>(pts)};
    long long tasks = factor_tasks(a.sc, B, c.sc, bc);
    if (points_tasks(B, dx + dn) > tasks) tasks = points_tasks(B, dx + dn);
    return launch_factor<2>(a, epi, tasks, stream, c);
  }
  int F = 0;
  const int err = ns_factor<T>({static_cast<const T*>(P), ws, B, dx},
                               {static_cast<const T*>(C), wc, bc, dn}, &F,
                               stream);
  const PointsArgs<T> a{static_cast<const T*>(m), ws + 1LL * F * dx * dx,
                        factor_stride(dx, method), dx,
                        static_cast<const T*>(bias), wc + 1LL * F * dn * dn,
                        dn, T(scale), 0};
  const int e = launch_points<T>(a, static_cast<T*>(pts), B, stream);
  return err ? err : e;
}

}  // namespace

extern "C" {

long long bft_ut_sigma_tiled_scratch_elems(int B, int n, int method) {
  return factor_elems(B, n, method);
}

long long bft_ut_sigma_aug_tiled_scratch_elems(int B, int dx, int dn,
                                               int method) {
  return factor_elems(B, dx, method) + factor_elems(1, dn, method);
}

int bft_ut_sigma_tiled_f32(const void* m, const void* P, void* pts,
                           void* scratch, int B, int n, double scale,
                           int method, void* stream) {
  return launch_sigma_tiled<float>(m, P, pts, scratch, B, n, scale, method,
                                   cudaStream_t(stream));
}

int bft_ut_sigma_tiled_f64(const void* m, const void* P, void* pts,
                           void* scratch, int B, int n, double scale,
                           int method, void* stream) {
  return launch_sigma_tiled<double>(m, P, pts, scratch, B, n, scale, method,
                                    cudaStream_t(stream));
}

int bft_ut_sigma_aug_tiled_f32(const void* m, const void* P,
                               const void* bias, const void* C, void* pts,
                               void* scratch, int B, int dx, int dn,
                               double scale, int method, void* stream) {
  return launch_sigma_aug_tiled<float>(m, P, bias, C, pts, scratch, B, dx,
                                       dn, scale, method,
                                       cudaStream_t(stream));
}

int bft_ut_sigma_aug_tiled_f64(const void* m, const void* P,
                               const void* bias, const void* C, void* pts,
                               void* scratch, int B, int dx, int dn,
                               double scale, int method, void* stream) {
  return launch_sigma_aug_tiled<double>(m, P, bias, C, pts, scratch, B, dx,
                                        dn, scale, method,
                                        cudaStream_t(stream));
}

}  // extern "C"
