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
// - K9t is two launches. One pass over the card (a block a 32-byte strip
//   of columns over all the rows: 64 blocks in float32, 128 in float64 at
//   dx = 512) sums μ in a fixed order and writes Xc = fpts − μ and d0;
//   then Σ = lower(w_side·Xcᵀ Xc + w0c·d0 d0ᵀ) + sym(Q), mirrored, is one
//   two-term product by tiled.cuh's gemm rule (at config 5 its 64 × 32
//   lower tiles with the rows split over a cluster of 2), with sym(Q)
//   taken in its epilogue (Gemm::sym_cin).
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

// K9t's first pass, spread over the card: a block owns a strip of S =
// strip_cols columns (32 bytes: 8 float32 or 4 float64, one sector a row)
// over all the rows. Thread (tx, ty) sums column tx of the rows ty,
// ty + G, … (G = kThreads / S row groups) in order, the block adds the groups'
// sums in a fixed tree (so that a run repeats bit for bit: no atomics),
// and writes μ = w_side·Σ_r fpts[r] + w0m·center into mu, then Xc =
// fpts − μ (the strip of every row, read again from L1) and d0 =
// center − μ into the element's scratch (Xc: rows × dx, then d0). Grid
// (strips, batch).
template <typename T>
__host__ __device__ constexpr int strip_cols() {
  return 32 / int(sizeof(T));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ut_tiled_mean_centre_kernel(
    const T* __restrict__ fpts_all, const T* __restrict__ center_all,
    T* mu_all, T* xc_all, long long st, int B, int rows, int dx, T w_side,
    T w0m) {
  constexpr int S = strip_cols<T>(), G = kThreads / S;
  __shared__ T part[G][S];
  __shared__ T mu_s[S];
  const int tx = threadIdx.x % S, ty = threadIdx.x / S;
  const int j = blockIdx.x * S + tx;
  const bool in = j < dx;
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const T* fp = fpts_all + b * rows * dx + j;
    T* xc = xc_all + b * st + j;
    T s = T(0);
    if (in)
#pragma unroll 8
      for (int r = ty; r < rows; r += G) s += fp[(long long)r * dx];
    part[ty][tx] = s;
    __syncthreads();
#pragma unroll
    for (int h = G / 2; h > 0; h >>= 1) {
      if (ty < h) part[ty][tx] += part[ty + h][tx];
      __syncthreads();
    }
    if (ty == 0 && in) {
      const T c = center_all[b * dx + j];
      const T u = w_side * part[0][tx] + w0m * c;
      mu_all[b * dx + j] = u;
      xc[(long long)rows * dx] = c - u;  // d0
      mu_s[tx] = u;
    }
    __syncthreads();
    if (in) {
      const T u = mu_s[tx];
#pragma unroll 8
      for (int r = ty; r < rows; r += G)
        xc[(long long)r * dx] = fp[(long long)r * dx] - u;
    }
    __syncthreads();
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

// K9t's scratch: per element Xc (rows × dx) and d0 (dx).
long long predict_scratch_elems(int B, int rows, int dx) {
  return 1LL * B * (1LL * rows * dx + dx);
}

template <typename T>
int launch_predict_tiled(const void* fpts_, const void* center_,
                         const void* Q_, void* mu_, void* cov_,
                         void* scratch_, int B, int rows, int dx,
                         double w_side, double w0m, double w0c,
                         cudaStream_t stream) {
  const T* Q = static_cast<const T*>(Q_);
  T* Xc = static_cast<T*>(scratch_);
  T* d0 = Xc + 1LL * rows * dx;
  const long long st = 1LL * rows * dx + dx;  // per element: Xc, d0
  ut_tiled_mean_centre_kernel<T><<<dim3(unsigned((dx + strip_cols<T>() - 1) /
                                                 strip_cols<T>()),
                                        unsigned(grid_1d(B))),
                                   kThreads, 0, stream>>>(
      static_cast<const T*>(fpts_), static_cast<const T*>(center_),
      static_cast<T*>(mu_), Xc, st, B, rows, dx, T(w_side), T(w0m));
  const int err = int(cudaGetLastError());
  // Σ = lower(w_side·Xcᵀ Xc + w0c·d0 d0ᵀ) + sym(Q), mirrored
  Gemm<T> g = gemm_of<T>(dx, dx, rows, B, {Xc, dx, st, 1}, {Xc, dx, st, 0},
                         static_cast<T*>(cov_), dx, 1LL * dx * dx,
                         T(w_side));
  g.K[1] = 1;
  g.A[1] = {d0, 1, st, 0};
  g.B[1] = {d0, dx, st, 0};
  g.alpha[1] = T(w0c);
  if (Q != nullptr) {
    g.Cin = Q; g.ldcin = dx; g.bcin = 0; g.beta = T(1); g.sym_cin = 1;
  }
  g.tri = kLowerMirror;
  const int e = gemm(g, stream);
  return err ? err : e;
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
