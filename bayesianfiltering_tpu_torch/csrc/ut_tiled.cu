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
// points the update is ~0.44 GFLOP, nearly all of it the moments [S; Cᵀ]
// (0.40 GFLOP) around a dy = 256 Cholesky, the predict ~0.3 GFLOP of one
// moment product; the per-element kernels ran each on one SM with the
// workspace in global scratch, one dependent load-and-FMA chain per
// output. Here every product is a tiled product over the whole card
// (tiled.cuh), and the update's Cholesky is K1t's one-launch blocked
// factor (tiled_chol.cuh):
//
// - Each entry point enqueues its launches on the caller's stream and
//   returns the first CUDA error. The scratch comes from the wrapper (a
//   few MB at dx = 512, resident in L2).
// - K8t is four launches. The sigma points are centred once, by an
//   element-wise pass into the scratch, side by side: V = [Yc | Xc]
//   (rows × (dy + dx)) and [d0; 0], so that the moments are one two-term
//   product, [S; Cᵀ] = lower(w_side·Vᵀ Yc + w0c·[d0; 0] d0ᵀ) (the center's
//   outer product is a product of inner dimension 1), written straight
//   into W's rows 0 … dy + dx (the lower mode skips only the top square's
//   upper tiles).
// - The factor of W = [S; Cᵀ; innovᵀ] (K1t's, without its I rows) turns
//   the rows below S into Zᵀ = (L⁻¹ C)ᵀ and zᵀ, with log N and
//   μ = m + Zᵀ z in its epilogue. Since K = Cᵀ S⁻¹ = Zᵀ L⁻¹, the grouped
//   Joseph form P − KC − (KC)ᵀ + (KL)(KL)ᵀ is sym(P) − ZᵀZ, as K8 computes
//   it: one product over L's rows of Zᵀ, lower(Zᵀ Z) mirrored, whose
//   epilogue adds ½(P + Pᵀ), so that each entry is a symmetric function of
//   (i, j) and Σ is exactly symmetric. No gain, no L⁻ᵀ.
//
// Math and constants follow ops/fused_ut.py's plain versions: S is
// symmetrised before the relative floor 1e-6·max|diag S| (no jitter); the
// wrapper supplies μy and the innovation (so a model's residual function
// applies); a non-PD S gives NaN in every output (the failed panel's Zᵀ
// columns are NaN, and every entry of ZᵀZ sums over them). Nothing here
// raises.
#include "tiled_chol.cuh"

namespace {

using namespace bft;

// Per-element scratch of K8t: W = [S; Cᵀ; innovᵀ], L, the diagonal
// tiles' inverses, the floor and flag (AugLayout, no I rows), then the
// centred points V = [Yc | Xc] (rows × (dy + dx)) and [d0; 0] (dy + dx).
struct UtUpdateScratch {
  AugLayout f;
  long long v, d0;
  UtUpdateScratch(int rows, int dx, int dy)
      : f(dx, dy, 1LL * dy + dx + 1) {
    v = f.end;
    d0 = v + 1LL * rows * (dy + dx);
    f.total = d0 + dy + dx;
  }
};

// V = [hpts − μy | pts[:, :dx] − m] (rows × (dy + dx); points of leading
// dimension ld) and [center − μy; 0]. Grid (blocks, batch).
template <typename T>
__global__ void __launch_bounds__(kThreads) ut_tiled_centre_kernel(
    const T* __restrict__ pts_all, const T* __restrict__ hpts_all,
    const T* __restrict__ center_all, const T* __restrict__ mu_all,
    const T* __restrict__ m_all, T* scratch, UtUpdateScratch sc, int B,
    int rows, int ld) {
  const int dx = sc.f.dx, dy = sc.f.dy, w = dy + dx;
  const int stride = gridDim.x * blockDim.x;
  const int first = blockIdx.x * blockDim.x + threadIdx.x;
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    T* ws = scratch + b * sc.f.total;
    const T* mu = mu_all + b * dy;
    const T* m = m_all + b * dx;
    const T* hp = hpts_all + b * rows * dy;
    const T* pts = pts_all + b * rows * ld;
    for (int idx = first; idx < rows * w; idx += stride) {
      const int r = idx / w, j = idx % w;
      ws[sc.v + idx] = j < dy ? hp[r * dy + j] - mu[j]
                              : pts[(long long)r * ld + j - dy] - m[j - dy];
    }
    for (int i = first; i < w; i += stride)
      ws[sc.d0 + i] = i < dy ? center_all[b * dy + i] - mu[i] : T(0);
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
  T* ws = static_cast<T*>(scratch_);
  const UtUpdateScratch sc(rows, dx, dy);
  const long long st = sc.f.total, xx = 1LL * dx * dx;
  const int w = dy + dx;
  int err = 0;
  auto keep = [&](int e) {
    if (err == 0) err = e;
  };

  // 1. centre: V = [Yc | Xc] and [d0; 0]
  ut_tiled_centre_kernel<T><<<elementwise_grid(1LL * rows * w, B), kThreads,
                              0, stream>>>(
      static_cast<const T*>(pts_), static_cast<const T*>(hpts_),
      static_cast<const T*>(center_), static_cast<const T*>(mu_),
      static_cast<const T*>(m_), ws, sc, B, rows, ld);
  keep(int(cudaGetLastError()));
  // 2. [G; Cᵀ] = lower(w_side·Vᵀ Yc + w0c·[d0; 0] d0ᵀ) into W's rows
  //    0 … dy + dx
  {
    Gemm<T> g = gemm_of<T>(w, dy, rows, B, {ws + sc.v, w, st, 1},
                           {ws + sc.v, w, st, 0}, ws + sc.f.w, dy, st,
                           T(w_side));
    g.K[1] = 1;
    g.A[1] = {ws + sc.d0, 1, st, 0};
    g.B[1] = {ws + sc.d0, w, st, 0};
    g.alpha[1] = T(w0c);
    g.tri = kLower;
    keep(gemm(g, stream));
  }
  // 3. the factorisation of W = [S; Cᵀ; innovᵀ], S = G (+ sym(R), shared)
  //    + floor as its first touch reads it, with ll and μ = m + Zᵀ z
  keep(factor_update<T>(ws, sc.f, B, static_cast<const T*>(R_), 0, T(0),
                        ws + sc.f.w + sc.f.xrow(), st,
                        static_cast<const T*>(inn_), -1,
                        static_cast<const T*>(m_), static_cast<T*>(ll_),
                        static_cast<T*>(mean_), stream));
  // 4. Σ = sym(P) − lower(Zᵀ Z), mirrored; Zᵀ is L's rows dy … dy + dx
  {
    const T* Zt = ws + sc.f.l + sc.f.xrow();
    Gemm<T> g = gemm_of<T>(dx, dx, dy, B, {Zt, dy, st, 0}, {Zt, dy, st, 1},
                           static_cast<T*>(cov_), dx, xx, T(-1));
    g.Cin = static_cast<const T*>(P_);
    g.ldcin = dx;
    g.bcin = xx;
    g.beta = T(1);
    g.sym_cin = 1;
    g.tri = kLowerMirror;
    keep(gemm(g, stream));
  }
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
