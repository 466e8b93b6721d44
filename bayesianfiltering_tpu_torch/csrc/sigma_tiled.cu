// Tiled multi-block sigma points (K6t) and augmented sigma points (K7t):
// the variants of K6 and K7 (fused_ut.cu) for factors whose workspace
// does not fit in one SM's shared memory.
//
// Replace the same TPU kernels as K6 and K7:
// bayesianfiltering_tpu/ops/fused_ut.py `_sigma_kernel` (K6t) and
// `_sigma_aug_kernel` (K7t). ops/fused_ut.py picks K6/K7 or K6t/K7t by
// shape alone: the per-element kernels where their workspace fits in a
// block's shared memory (the batched Lorenz-96 UKF at n = 64, the
// UGSF/UAGSF banks), these otherwise (config 5's n = 512, the band's
// edges at 1,024).
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
//   with fused_ut.cu's constants, and the points pass.
// - Points: 32 × 32 tiles staged through padded shared memory, so that the
//   factor's columns are read and the points' rows written coalesced; both
//   halves at once. A Cholesky factor's entries above the diagonal are
//   never written by the factor, so they are taken as 0 and never read.
//   The factor NaNs only a failing diagonal tile and what later steps
//   compute from it, so every tile that touches a Cholesky block writes
//   NaN throughout it unless every pivot is finite and positive (the plain
//   versions' cholesky_ex info): in K6t's epilogue from the factor's flag,
//   in the points kernel from the block's pivots.
// - K7t is a composition: the factor of P over the batch and of the shared
//   C (B = 1), one launch each, and one points pass that writes the four
//   blocks of the (2na, na) augmented points; a non-PD P NaNs that
//   element's state block, a non-PD C the noise block, as in the plain
//   points_blockdiag.
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
// spare n × n for Newton–Schulz, whose traces (one per element) follow
// the batch.
long long factor_stride(int n, int method) {
  return method == kSqrtm ? 4LL * n * n : AugLayout(0, n, n).total;
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

// Newton–Schulz's start: s = tr P + 1e-30 (into s_all from the first block
// of each element), Y = sym(P)/s, Z = I. Every block finds s itself (n
// reads). Grid (blocks, batch).
template <typename T>
__global__ void __launch_bounds__(kThreads) sigma_tiled_trace_kernel(
    const T* __restrict__ P_all, T* scratch, long long st, T* s_all, int n,
    int B) {
  __shared__ T s_sum;
  const int stride = gridDim.x * blockDim.x;
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const T* P = P_all + b * n * n;
    if (threadIdx.x < kWarp) {
      T s = T(0);
      for (int i = threadIdx.x; i < n; i += kWarp) s += P[i * n + i];
      for (int o = kWarp / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (threadIdx.x == 0) s_sum = s + T(1e-30);
    }
    __syncthreads();
    const T s = s_sum;
    if (blockIdx.x == 0 && threadIdx.x == 0) s_all[b] = s;
    T* Y = scratch + b * st;
    T* Z = Y + n * n;
    for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n * n;
         idx += stride) {
      const int i = idx / n, j = idx % n;
      Y[idx] = (T(0.5) * (P[idx] + P[j * n + i])) / s;
      Z[idx] = i == j ? T(1) : T(0);
    }
    __syncthreads();
  }
}

// Newton–Schulz's end: root = sym(Y·√s) from the Y at offset y into the
// slot at offset out. Grid (blocks, batch).
template <typename T>
__global__ void __launch_bounds__(kThreads) sigma_tiled_root_kernel(
    T* scratch, long long st, long long y, long long out,
    const T* __restrict__ s_all, int n, int B) {
  const int stride = gridDim.x * blockDim.x;
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const T* Y = scratch + b * st + y;
    T* R = scratch + b * st + out;
    const T rs = dsqrt(s_all[b]);
    for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n * n;
         idx += stride) {
      const int i = idx / n, j = idx % n;
      R[idx] = T(0.5) * (Y[idx] * rs + Y[j * n + i] * rs);
    }
  }
}

// Newton–Schulz's root of P (B × n × n, row-major) in ws
// (factor_elems(B, n, kSqrtm) elements): *F is element 0's root, element
// b's at *F + b·factor_stride. Returns the first CUDA error.
template <typename T>
int ns_factor(const T* P, T* ws, int B, int n, const T** F,
              cudaStream_t stream) {
  int err = 0;
  auto keep = [&](int e) {
    if (err == 0) err = e;
  };
  const long long st = factor_stride(n, kSqrtm);
  const dim3 grid = elementwise_grid(1LL * n * n, B);
  const long long n2 = 1LL * n * n;
  long long y = 0, z = n2, t = 2 * n2, w = 3 * n2;
  T* s_all = ws + B * st;
  sigma_tiled_trace_kernel<T><<<grid, kThreads, 0, stream>>>(P, ws, st,
                                                              s_all, n, B);
  keep(int(cudaGetLastError()));
  for (int it = 0; it < kNsIters; ++it) {
    // T = 1.5·I − 0.5·Z Y
    Gemm<T> g = gemm_of<T>(n, n, n, B, {ws + z, n, st, 0}, {ws + y, n, st, 0},
                           ws + t, n, st, T(-0.5));
    g.diag = T(1.5);
    keep(gemm(g, stream));
    // Y ← Y T, Z ← T Z
    keep(gemm(gemm_of<T>(n, n, n, B, {ws + y, n, st, 0}, {ws + t, n, st, 0},
                         ws + w, n, st),
              stream));
    long long swap = y; y = w; w = swap;
    keep(gemm(gemm_of<T>(n, n, n, B, {ws + t, n, st, 0}, {ws + z, n, st, 0},
                         ws + w, n, st),
              stream));
    swap = z; z = w; w = swap;
  }
  sigma_tiled_root_kernel<T><<<grid, kThreads, 0, stream>>>(ws, st, y, t,
                                                            s_all, n, B);
  keep(int(cudaGetLastError()));
  *F = ws + t;
  return err;
}

// The Cholesky of P (B × n × n) into ws (factor_elems(B, n, 0) elements),
// one launch; *F as ns_factor's (the lower L, its strict upper part never
// written).
template <typename T>
int chol_factor(const T* P, T* ws, int B, int n, const T** F,
                cudaStream_t stream) {
  const FactorArgs<T> a = square_factor(P, ws, B, n);
  *F = ws + a.sc.l;
  return launch_factor(a, NoEpilogue{}, factor_tasks(a.sc, B), stream);
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

// Whether some pivot of the n × n factor L is not finite and positive;
// the whole block calls it.
template <typename T>
__device__ bool pivots_bad(const T* L, int n) {
  bool bad = false;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const T d = L[(long long)i * n + i];
    bad = bad || !(d > T(0)) || isinf(d);
  }
  return __syncthreads_or(bad) != 0;
}

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

// The points of every element from their factors: grid (column tiles, row
// tiles, batch), kThreads threads.
template <typename T>
__global__ void __launch_bounds__(kThreads) sigma_tiled_points_kernel(
    PointsArgs<T> a, T* pts_all, int B) {
  __shared__ T tile[kTile][kTile + 1];
  const int dx = a.dx, dn = a.dn;
  const int c0 = blockIdx.x * kTile, r0 = blockIdx.y * kTile;
  const bool on_x = a.lower && r0 < dx && c0 < dx;
  const bool on_c = a.lower && dn > 0 && r0 + kTile > dx && c0 + kTile > dx;
  for (long long b = blockIdx.z; b < B; b += gridDim.z) {
    const bool bad_x = on_x && pivots_bad(a.Fx + b * a.fx_batch, dx);
    const bool bad_c = on_c && pivots_bad(a.Fc, dn);
    points_tile(a, b, r0, c0, bad_x, bad_c, pts_all, tile);
  }
}

template <typename T>
int launch_points(const PointsArgs<T>& a, T* pts, int B,
                  cudaStream_t stream) {
  const int tiles = (a.dx + a.dn + kTile - 1) / kTile;
  sigma_tiled_points_kernel<T><<<dim3(tiles, tiles, grid_1d(B)), kThreads,
                                 0, stream>>>(a, pts, B);
  return int(cudaGetLastError());
}

// K6t's Cholesky epilogue: the points from the factor, the tiles of every
// element in turns over the factor's blocks; the factor's flag says
// whether a pivot failed.
static_assert(kNb * kTilePad >= kTile * (kTile + 1),
              "the factor's tile buffer holds a points tile");

template <typename T>
struct PointsEpilogue {
  PointsArgs<T> p;
  T* pts;
  static constexpr bool kAny = true;
  __device__ void operator()(const FactorArgs<T>& a,
                             FactorSmem<T>& sm) const {
    const int tiles = tiles_of(a.sc.dy);
    const long long per = 1LL * tiles * tiles;
    for_tasks(a.B * per, [&](long long q) {
      const long long b = q / per;
      const int t = int(q % per);
      const bool bad = a.ws[b * a.st + a.sc.misc + 1] != T(0);
      // the factor's first tile buffer, read with points_tile's stride
      points_tile(p, b, (t / tiles) * kTile, (t % tiles) * kTile, bad, false,
                  pts, reinterpret_cast<T(*)[kTile + 1]>(&sm.a[0][0]));
    });
  }
};

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
    const int tiles = tiles_of(n);
    long long tasks = factor_tasks(a.sc, B);
    if (1LL * B * tiles * tiles > tasks) tasks = 1LL * B * tiles * tiles;
    return launch_factor(a, epi, tasks, stream);
  }
  const T* F = nullptr;
  int err = ns_factor<T>(static_cast<const T*>(P), ws, B, n, &F, stream);
  const PointsArgs<T> a{static_cast<const T*>(m), F,
                        factor_stride(n, method), n, nullptr, nullptr, 0,
                        T(scale), 0};
  const int e = launch_points<T>(a, static_cast<T*>(pts), B, stream);
  return err ? err : e;
}

template <typename T>
int launch_sigma_aug_tiled(const void* m, const void* P, const void* bias,
                           const void* C, void* pts, void* scratch, int B,
                           int dx, int dn, double scale, int method,
                           cudaStream_t stream) {
  T* ws = static_cast<T*>(scratch);
  T* wc = ws + factor_elems(B, dx, method);
  const T* Fx = nullptr;
  const T* Fc = nullptr;
  const bool chol = method != kSqrtm;
  int err = chol ? chol_factor<T>(static_cast<const T*>(P), ws, B, dx, &Fx,
                                  stream)
                 : ns_factor<T>(static_cast<const T*>(P), ws, B, dx, &Fx,
                                stream);
  const int e = chol ? chol_factor<T>(static_cast<const T*>(C), wc, 1, dn,
                                      &Fc, stream)
                     : ns_factor<T>(static_cast<const T*>(C), wc, 1, dn, &Fc,
                                    stream);
  if (err == 0) err = e;
  const PointsArgs<T> a{static_cast<const T*>(m), Fx,
                        factor_stride(dx, method), dx,
                        static_cast<const T*>(bias), Fc, dn, T(scale),
                        int(chol)};
  const int e2 = launch_points<T>(a, static_cast<T*>(pts), B, stream);
  return err ? err : e2;
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
