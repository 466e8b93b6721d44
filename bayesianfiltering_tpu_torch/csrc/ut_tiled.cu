// Tiled multi-block UT measurement update (K8t) and UT predict moments
// (K9t): the variants of K8 and K9 (fused_ut.cu) for elements whose
// workspace does not fit in one SM's shared memory.
//
// Replace the same TPU kernels as K8 and K9:
// bayesianfiltering_tpu/ops/fused_ut.py `_ut_update_kernel` (K8t) and
// `_ut_predict_kernel` (K9t). ops/fused_ut.py picks K8/K9 or K8t/K9t by
// shape alone: the per-element kernels where their workspace fits in a
// block's shared memory (the batched Lorenz-96 UKF at dx = 64, the
// UGSF/UAGSF banks), these otherwise (Lorenz-96 at dx = 512, the band's
// edges at 1,024).
//
// What bounds them on an H100. At dx = 512, dy = 256 and 1,024 sigma
// points the update is ~0.6 GFLOP of moment and gain products around a
// dy = 256 Cholesky, the predict ~0.3 GFLOP of one moment product; the
// per-element kernels ran each on one SM with the workspace in global
// scratch, one dependent load-and-FMA chain per output. Here every product
// is a tiled product over the whole card (tiled.cuh), and the update's
// Cholesky is K1t's one-launch blocked factor (tiled_chol.cuh):
//
// - Each entry point enqueues its launches on the caller's stream and
//   returns the first CUDA error. The scratch comes from the wrapper (a
//   few MB at dx = 512, resident in L2).
// - The sigma points are centred once, by an element-wise pass into the
//   scratch, so that the moments are plain products: S = w_side·Ycᵀ Yc +
//   w0c·d0 d0ᵀ is one two-term product (the center's outer product is a
//   product of inner dimension 1), Cᵀ = w_side·Xcᵀ Yc another.
// - K8t factors W = [S; Cᵀ; innovᵀ; I] as K1t factors [S; (H P)ᵀ; innovᵀ;
//   I]: the rows below S become Zᵀ = (L⁻¹ C)ᵀ, zᵀ and L⁻ᵀ, the gain is
//   K = Zᵀ L⁻¹, and log N and μ are K1t's, in the factor's launch. The
//   factorisation overwrites W's Cᵀ rows, so Cᵀ is kept in a slot of its
//   own, from which the factor's first touch reads it.
// - The covariance keeps the plain version's grouping, P − KC − (KC)ᵀ +
//   (KL)(KL)ᵀ: K C and K L are products, lower((KL)(KL)ᵀ) mirrored a third,
//   and one element-wise pass adds the symmetrised rest. The factor zeroes
//   L's strict upper part, which it otherwise never writes, so that K L
//   can read L as a full square.
//
// Math and constants follow ops/fused_ut.py's plain versions: S is
// symmetrised before the relative floor 1e-6·max|diag S| (no jitter); the
// wrapper supplies μy and the innovation (so a model's residual function
// applies); a non-PD S gives NaN in every output. Nothing here raises.
#include "tiled_chol.cuh"

namespace {

using namespace bft;

// Per-element scratch of K8t: W, L, the diagonal tiles' inverses, the
// floor and flag (AugLayout), then Cᵀ, K, K C, K L, the centred images Yc
// and points Xc, and d0 = center − μy.
struct UtUpdateScratch {
  AugLayout f;
  long long ct, k, kc, kl, yc, xc, d0;
  UtUpdateScratch(int rows, int dx, int dy) : f(dx, dy) {
    ct = f.end;
    k = ct + 1LL * dx * dy;
    kc = k + 1LL * dx * dy;
    kl = kc + 1LL * dx * dx;
    yc = kl + 1LL * dx * dy;
    xc = yc + 1LL * rows * dy;
    d0 = xc + 1LL * rows * dx;
    f.total = d0 + dy;
  }
};

// Yc = hpts − μy (rows × dy), Xc = pts[:, :dx] − m (rows × dx, points of
// leading dimension ld) and d0 = center − μy. Grid (blocks, batch).
template <typename T>
__global__ void __launch_bounds__(kThreads) ut_tiled_centre_kernel(
    const T* __restrict__ pts_all, const T* __restrict__ hpts_all,
    const T* __restrict__ center_all, const T* __restrict__ mu_all,
    const T* __restrict__ m_all, T* scratch, UtUpdateScratch sc, int B,
    int rows, int ld) {
  const int dx = sc.f.dx, dy = sc.f.dy;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    T* ws = scratch + b * sc.f.total;
    const T* mu = mu_all + b * dy;
    const T* m = m_all + b * dx;
    const T* hp = hpts_all + b * rows * dy;
    const T* pts = pts_all + b * rows * ld;
    for (int idx = first; idx < rows * dy; idx += stride)
      ws[sc.yc + idx] = hp[idx] - mu[idx % dy];
    for (int idx = first; idx < rows * dx; idx += stride) {
      const int r = idx / dx, j = idx % dx;
      ws[sc.xc + idx] = pts[(long long)r * ld + j] - m[j];
    }
    for (int i = first; i < dy; i += stride)
      ws[sc.d0 + i] = center_all[b * dy + i] - mu[i];
  }
}

// Σ = ½(P + Pᵀ) − (KC + KCᵀ) + Σ, over the whole square: Σ holds the
// mirrored (KL)(KL)ᵀ on entry; each entry is a symmetric function of the
// pair (i, j), so the result is exactly symmetric. Grid (blocks, batch).
template <typename T>
__global__ void __launch_bounds__(kThreads) ut_tiled_cov_kernel(
    const T* __restrict__ P_all, const T* scratch, T* cov_all,
    UtUpdateScratch sc, int B) {
  const int dx = sc.f.dx;
  const int stride = gridDim.x * blockDim.x;
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const T* P = P_all + b * dx * dx;
    const T* KC = scratch + b * sc.f.total + sc.kc;
    T* cov = cov_all + b * dx * dx;
    for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < dx * dx;
         idx += stride) {
      const int i = idx / dx, j = idx % dx;
      const int t = j * dx + i;
      const T p = T(0.5) * (P[idx] + P[t]);
      cov[idx] = (p - (KC[idx] + KC[t])) + cov[idx];
    }
  }
}

// K9t's first pass: μ = w_side·Σ_r fpts[r] + w0m·center into mu, and
// d0 = center − μ. Block: 32 columns, 8 row groups summed in shared
// memory. Grid (column blocks, batch).
template <typename T>
__global__ void __launch_bounds__(kThreads) ut_tiled_mean_kernel(
    const T* __restrict__ fpts_all, const T* __restrict__ center_all,
    T* mu_all, T* d0_all, long long d0_batch, int B, int rows, int dx,
    T w_side, T w0m) {
  constexpr int kCols = 32, kGroups = kThreads / kCols;
  __shared__ T part[kGroups][kCols + 1];
  const int tx = threadIdx.x % kCols, ty = threadIdx.x / kCols;
  const int j = blockIdx.x * kCols + tx;
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const T* fp = fpts_all + b * rows * dx;
    T s = T(0);
    if (j < dx)
      for (int r = ty; r < rows; r += kGroups) s += fp[(long long)r * dx + j];
    part[ty][tx] = s;
    __syncthreads();
    if (ty == 0 && j < dx) {
      T total = T(0);
      for (int g = 0; g < kGroups; ++g) total += part[g][tx];
      const T c = center_all[b * dx + j];
      const T u = w_side * total + w0m * c;
      mu_all[b * dx + j] = u;
      d0_all[b * d0_batch + j] = c - u;
    }
    __syncthreads();
  }
}

// K9t's second pass: Xc = fpts − μ (rows × dx) per element and, from the
// first batch row of blocks, sym(Q) (dx × dx, shared) when Q is given.
// Grid (blocks, batch).
template <typename T>
__global__ void __launch_bounds__(kThreads) ut_tiled_centre_rows_kernel(
    const T* __restrict__ fpts_all, const T* __restrict__ mu_all,
    const T* __restrict__ Q, T* Xc_all, long long xc_batch, T* Qs, int B,
    int rows, int dx) {
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  if (Q != nullptr && blockIdx.y == 0)
    for (int idx = first; idx < dx * dx; idx += stride) {
      const int i = idx / dx, j = idx % dx;
      Qs[idx] = T(0.5) * (Q[idx] + Q[j * dx + i]);
    }
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const T* fp = fpts_all + b * rows * dx;
    const T* mu = mu_all + b * dx;
    T* Xc = Xc_all + b * xc_batch;
    for (int idx = first; idx < rows * dx; idx += stride)
      Xc[idx] = fp[idx] - mu[idx % dx];
  }
}

template <typename T>
int launch_update_tiled(const void* pts_, const void* hpts_,
                        const void* center_, const void* mu_, const void* m_,
                        const void* P_, const void* R_, const void* inn_,
                        void* ll_, void* mean_, void* cov_, void* scratch_,
                        int B, int rows, int ld, int dx, int dy,
                        double w_side, double w0c, cudaStream_t stream) {
  const T* P = static_cast<const T*>(P_);
  const T* inn = static_cast<const T*>(inn_);
  T* cov = static_cast<T*>(cov_);
  T* ws = static_cast<T*>(scratch_);
  const UtUpdateScratch sc(rows, dx, dy);
  const long long st = sc.f.total, xx = 1LL * dx * dx;
  int err = 0;
  auto keep = [&](int e) {
    if (err == 0) err = e;
  };

  // 1. centre
  ut_tiled_centre_kernel<T><<<elementwise_grid(1LL * rows * (dx + dy), B),
                              kThreads, 0, stream>>>(
      static_cast<const T*>(pts_), static_cast<const T*>(hpts_),
      static_cast<const T*>(center_), static_cast<const T*>(mu_),
      static_cast<const T*>(m_), ws, sc, B, rows, ld);
  keep(int(cudaGetLastError()));
  // 2. G = lower(w_side·Ycᵀ Yc + w0c·d0 d0ᵀ) into W's top square
  {
    Gemm<T> g = gemm_of<T>(dy, dy, rows, B, {ws + sc.yc, dy, st, 1},
                           {ws + sc.yc, dy, st, 0}, ws + sc.f.w, dy, st,
                           T(w_side));
    g.K[1] = 1;
    g.A[1] = {ws + sc.d0, 1, st, 0};
    g.B[1] = {ws + sc.d0, dy, st, 0};
    g.alpha[1] = T(w0c);
    g.tri = kLower;
    keep(gemm(g, stream));
  }
  // 3. Cᵀ = w_side·Xcᵀ Yc (dx × dy) into its own slot
  keep(gemm(gemm_of<T>(dx, dy, rows, B, {ws + sc.xc, dx, st, 1},
                       {ws + sc.yc, dy, st, 0}, ws + sc.ct, dy, st,
                       T(w_side)),
            stream));
  // 4–6. the factorisation of W = [S; Cᵀ; innovᵀ; I], S = G (+ sym(R),
  //      shared) + floor and Cᵀ read at its first touch, with ll and μ;
  //      then K = Zᵀ L⁻¹. L's top square is read whole below: its strict
  //      upper part is zeroed.
  keep(factor_and_gain<T>(ws, sc.f, B, static_cast<const T*>(R_), 0, T(0),
                          ws + sc.ct, st, inn, -1, 1, ws + sc.k, st,
                          static_cast<const T*>(m_), static_cast<T*>(ll_),
                          static_cast<T*>(mean_), stream));
  // 7. K C (C = (Cᵀ)ᵀ), K L, then lower((KL)(KL)ᵀ) mirrored into Σ and the
  //    element-wise rest
  keep(gemm(gemm_of<T>(dx, dx, dy, B, {ws + sc.k, dy, st, 0},
                       {ws + sc.ct, dy, st, 1}, ws + sc.kc, dx, st),
            stream));
  keep(gemm(gemm_of<T>(dx, dy, dy, B, {ws + sc.k, dy, st, 0},
                       {ws + sc.f.l, dy, st, 0}, ws + sc.kl, dy, st),
            stream));
  {
    Gemm<T> g = gemm_of<T>(dx, dx, dy, B, {ws + sc.kl, dy, st, 0},
                           {ws + sc.kl, dy, st, 1}, cov, dx, xx);
    g.tri = kLowerMirror;
    keep(gemm(g, stream));
  }
  ut_tiled_cov_kernel<T><<<elementwise_grid(xx, B), kThreads, 0, stream>>>(
      P, ws, cov, sc, B);
  keep(int(cudaGetLastError()));
  return err;
}

// K9t's scratch: sym(Q) (dx × dx, shared), then per element Xc (rows × dx)
// and d0 (dx).
long long predict_scratch_elems(int B, int rows, int dx) {
  return 1LL * dx * dx + 1LL * B * (1LL * rows * dx + dx);
}

template <typename T>
int launch_predict_tiled(const void* fpts_, const void* center_,
                         const void* Q_, void* mu_, void* cov_,
                         void* scratch_, int B, int rows, int dx,
                         double w_side, double w0m, double w0c,
                         cudaStream_t stream) {
  const T* fpts = static_cast<const T*>(fpts_);
  const T* Q = static_cast<const T*>(Q_);
  T* mu = static_cast<T*>(mu_);
  T* Qs = static_cast<T*>(scratch_);
  T* Xc = Qs + 1LL * dx * dx;
  const long long st = 1LL * rows * dx + dx;  // per element: Xc, d0
  T* d0 = Xc + 1LL * rows * dx;
  int err = 0;
  auto keep = [&](int e) {
    if (err == 0) err = e;
  };
  ut_tiled_mean_kernel<T><<<dim3(unsigned((dx + 31) / 32),
                                 unsigned(grid_1d(B))),
                            kThreads, 0, stream>>>(
      fpts, static_cast<const T*>(center_), mu, d0, st, B, rows, dx,
      T(w_side), T(w0m));
  keep(int(cudaGetLastError()));
  ut_tiled_centre_rows_kernel<T><<<elementwise_grid(1LL * rows * dx, B),
                                   kThreads, 0, stream>>>(
      fpts, mu, Q, Xc, st, Qs, B, rows, dx);
  keep(int(cudaGetLastError()));
  // Σ = lower(w_side·Xcᵀ Xc + w0c·d0 d0ᵀ) (+ sym(Q)), mirrored
  Gemm<T> g = gemm_of<T>(dx, dx, rows, B, {Xc, dx, st, 1}, {Xc, dx, st, 0},
                         static_cast<T*>(cov_), dx, 1LL * dx * dx,
                         T(w_side));
  g.K[1] = 1;
  g.A[1] = {d0, 1, st, 0};
  g.B[1] = {d0, dx, st, 0};
  g.alpha[1] = T(w0c);
  if (Q != nullptr) {
    g.Cin = Qs; g.ldcin = dx; g.bcin = 0; g.beta = T(1);
  }
  g.tri = kLowerMirror;
  keep(gemm(g, stream));
  return err;
}

}  // namespace

extern "C" {

long long bft_ut_update_tiled_scratch_elems(int rows, int dx, int dy) {
  return UtUpdateScratch(rows, dx, dy).f.total;
}

long long bft_ut_predict_tiled_scratch_elems(int B, int rows, int dx) {
  return predict_scratch_elems(B, rows, dx);
}

int bft_ut_update_tiled_f32(const void* pts, const void* hpts,
                            const void* center, const void* mu, const void* m,
                            const void* P, const void* R, const void* inn,
                            void* ll, void* mean, void* cov, void* scratch,
                            int B, int rows, int ld, int dx, int dy,
                            double w_side, double w0c, void* stream) {
  return launch_update_tiled<float>(pts, hpts, center, mu, m, P, R, inn, ll,
                                    mean, cov, scratch, B, rows, ld, dx, dy,
                                    w_side, w0c, cudaStream_t(stream));
}

int bft_ut_update_tiled_f64(const void* pts, const void* hpts,
                            const void* center, const void* mu, const void* m,
                            const void* P, const void* R, const void* inn,
                            void* ll, void* mean, void* cov, void* scratch,
                            int B, int rows, int ld, int dx, int dy,
                            double w_side, double w0c, void* stream) {
  return launch_update_tiled<double>(pts, hpts, center, mu, m, P, R, inn, ll,
                                     mean, cov, scratch, B, rows, ld, dx, dy,
                                     w_side, w0c, cudaStream_t(stream));
}

int bft_ut_predict_tiled_f32(const void* fpts, const void* center,
                             const void* Q, void* mu, void* cov,
                             void* scratch, int B, int rows, int dx,
                             double w_side, double w0m, double w0c,
                             void* stream) {
  return launch_predict_tiled<float>(fpts, center, Q, mu, cov, scratch, B,
                                     rows, dx, w_side, w0m, w0c,
                                     cudaStream_t(stream));
}

int bft_ut_predict_tiled_f64(const void* fpts, const void* center,
                             const void* Q, void* mu, void* cov,
                             void* scratch, int B, int rows, int dx,
                             double w_side, double w0m, double w0c,
                             void* stream) {
  return launch_predict_tiled<double>(fpts, center, Q, mu, cov, scratch, B,
                                      rows, dx, w_side, w0m, w0c,
                                      cudaStream_t(stream));
}

}  // extern "C"
