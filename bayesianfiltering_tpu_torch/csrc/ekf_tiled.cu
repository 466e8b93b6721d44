// Tiled multi-block EKF measurement update (K1t) and covariance predict
// (K2t): the variants of K1 and K2 (fused_ekf.cu) for elements whose
// workspace does not fit in one SM's shared memory.
//
// Replace the same TPU kernels as K1 and K2:
// bayesianfiltering_tpu/ops/fused_ekf.py `_update_kernel` (K1t) and
// `_predict_kernel` (K2t). ops/fused_ekf.py picks K1/K2 or K1t/K2t by shape
// alone: the per-element kernels where their workspace fits in a block's
// shared memory (the batched Lorenz-96 filter at dx = 64), these otherwise
// (Lorenz-96 at dx = 512, the chunked update, the bands' edges).
//
// What bounds them on an H100. At dx = 512, dy = 256 one update is ~0.9
// GFLOP of dense products (A P alone is 2dx³) and a dy = 256 Cholesky; the
// per-element kernels ran it on one SM with the workspace in global
// scratch, one dependent load-and-FMA chain per output, at ~10 GFLOP/s.
// Here every product is a tiled product over the whole card (tiled.cuh:
// 4 × 4 register tiles, the inner dimension split over a cluster where the
// output tiles alone leave SMs idle), and the factorisation is one
// launch (tiled_chol.cuh):
//
// - Each entry point enqueues its launches on the caller's stream and
//   returns the first CUDA error. The per-element scratch comes from the
//   wrapper (a few MB at dx = 512, resident in L2).
// - The Cholesky (tiled_chol.cuh, shared with K8t) factors the augmented
//   matrix W = [S; (H P)ᵀ; innovᵀ; I] ((2dy + dx + 1) × dy) in one
//   cooperative launch, panels of 32 with a grid barrier between them, so
//   that the rows below S come out as (L⁻¹ H P)ᵀ = Zᵀ, (L⁻¹ innov)ᵀ = zᵀ
//   and L⁻ᵀ; S's preparation (sym(R), the floor), log N and μ = m + Zᵀ z
//   are folded into that launch, and the gain is one more product,
//   K = Zᵀ L⁻¹ = (S⁻¹ H P)ᵀ.
// - The Joseph covariance is A P, then lower(A P Aᵀ + (K Rs) Kᵀ) mirrored,
//   two products of one pass.
// - K1t is eight launches at any dy: (H P)ᵀ, G, the factor, K, A, K Rs,
//   A P and Σ.
// - K2t is two launches: F_x P and F_q Q, which do not depend on each
//   other, as one grouped launch (at B = 1 and dx = dq = 512 their 2 × 128
//   tiles of 64 × 32 fill the card's 132 SMs without a k-split, where each
//   product alone took a cluster split of 2), then lower(F_x P F_xᵀ +
//   F_q Q F_qᵀ) mirrored, one two-term product.
//
// Math and constants follow ops/ekf.py chol_update_precomputed and
// predict_cov_precomputed: S is symmetrised before the relative floor
// (jitter + 1e-6·max|diag S|) is added, the covariance is the symmetrised
// Joseph form, the log-det comes from diag L, and a non-PD S gives NaN: a
// diagonal tile with a non-positive (or NaN) pivot is set to NaN, which
// every later step carries into all outputs. Nothing here raises.
#include "tiled_chol.cuh"

namespace {

using namespace bft;

// Per-element scratch of K1t: W, L, the diagonal tiles' inverses, the
// floor and flag (AugLayout), then sym(Rt), A = I − K H, K Rs, A P.
struct UpdateScratch {
  AugLayout f;
  long long rs, a, kr, ap;
  UpdateScratch(int dx, int dy) : f(dx, dy) {
    rs = f.end;
    a = rs + 1LL * dy * dy;
    kr = a + 1LL * dx * dx;
    ap = kr + 1LL * dx * dy;
    f.total = ap + 1LL * dx * dx;
  }
};

template <typename T>
int launch_update_tiled(const void* m_, const void* P_, const void* H_,
                        const void* R_, const void* inn_, void* ll_,
                        void* mean_, void* cov_, void* K_, void* scratch_,
                        int B, int dx, int dy, double jitter, void* stream_) {
  const T* P = static_cast<const T*>(P_);
  const T* H = static_cast<const T*>(H_);
  T* K = static_cast<T*>(K_);
  const T* inn = static_cast<const T*>(inn_);
  T* ws = static_cast<T*>(scratch_);
  const cudaStream_t stream = cudaStream_t(stream_);
  const UpdateScratch sc(dx, dy);
  const long long st = sc.f.total, xx = 1LL * dx * dx, yx = 1LL * dy * dx;
  int err = 0;
  auto keep = [&](int e) {
    if (err == 0) err = e;
  };
  auto run = [&](const Gemm<T>& g) { keep(gemm(g, stream)); };

  // (H P)ᵀ = Pᵀ Hᵀ into W's rows dy..dy+dx; G = lower((H P) Hᵀ) into W's
  // top square
  T* HPt = ws + sc.f.w + sc.f.xrow();
  run(gemm_of<T>(dx, dy, dx, B, {P, dx, xx, 1}, {H, dx, yx, 1}, HPt, dy,
                 st));
  {
    Gemm<T> g = gemm_of<T>(dy, dy, dx, B, {HPt, dy, st, 1}, {H, dx, yx, 1},
                           ws + sc.f.w, dy, st);
    g.tri = kLower;
    run(g);
  }
  // S = G + sym(Rt) + floor as the factor reads it (sym(Rt) into Rs), the
  // factorisation, ll and μ; then K
  keep(factor_and_gain<T>(ws, sc.f, B, static_cast<const T*>(R_),
                          1LL * dy * dy, T(jitter), HPt, st, inn, sc.rs, K,
                          1LL * dx * dy, static_cast<const T*>(m_),
                          static_cast<T*>(ll_), static_cast<T*>(mean_),
                          stream));
  // A = I − K H, K Rs, A P
  {
    Gemm<T> g = gemm_of<T>(dx, dx, dy, B, {K, dy, yx, 0}, {H, dx, yx, 0},
                           ws + sc.a, dx, st, T(-1));
    g.diag = T(1);
    run(g);
  }
  run(gemm_of<T>(dx, dy, dy, B, {K, dy, yx, 0}, {ws + sc.rs, dy, st, 0},
                 ws + sc.kr, dy, st));
  run(gemm_of<T>(dx, dx, dx, B, {ws + sc.a, dx, st, 0}, {P, dx, xx, 0},
                 ws + sc.ap, dx, st));
  // Σ = lower((A P) Aᵀ + (K Rs) Kᵀ), mirrored
  {
    Gemm<T> g = gemm_of<T>(dx, dx, dx, B, {ws + sc.ap, dx, st, 0},
                           {ws + sc.a, dx, st, 1}, static_cast<T*>(cov_), dx,
                           xx);
    g.K[1] = dy;
    g.A[1] = {ws + sc.kr, dy, st, 0};
    g.B[1] = {K, dy, yx, 1};
    g.alpha[1] = T(1);
    g.tri = kLowerMirror;
    run(g);
  }
  return err;
}

// K2t's per-element scratch: F_x P (dx × dx), then F_q Q (dx × dq).
long long predict_scratch(int dx, int dq) {
  return 1LL * dx * dx + 1LL * dx * dq;
}

template <typename T>
int launch_predict_tiled(const void* Fx_, const void* P_, const void* Fq_,
                         const void* Q_, void* cov_, void* scratch_, int B,
                         int dx, int dq, void* stream_) {
  const T* Fx = static_cast<const T*>(Fx_);
  const T* Fq = static_cast<const T*>(Fq_);
  T* FP = static_cast<T*>(scratch_);
  T* FQ = FP + 1LL * dx * dx;
  const cudaStream_t stream = cudaStream_t(stream_);
  const long long st = predict_scratch(dx, dq);
  const long long xx = 1LL * dx * dx, xq = 1LL * dx * dq;
  // F_x P and F_q Q in one launch (Q is shared by the batch: batch
  // stride 0)
  const int err = gemm2(
      gemm_of<T>(dx, dx, dx, B, {Fx, dx, xx, 0},
                 {static_cast<const T*>(P_), dx, xx, 0}, FP, dx, st),
      gemm_of<T>(dx, dq, dq, B, {Fq, dq, xq, 0},
                 {static_cast<const T*>(Q_), dq, 0, 0}, FQ, dq, st),
      stream);
  Gemm<T> g = gemm_of<T>(dx, dx, dx, B, {FP, dx, st, 0}, {Fx, dx, xx, 1},
                         static_cast<T*>(cov_), dx, xx);
  g.K[1] = dq;
  g.A[1] = {FQ, dq, st, 0};
  g.B[1] = {Fq, dq, xq, 1};
  g.alpha[1] = T(1);
  g.tri = kLowerMirror;
  const int e3 = gemm(g, stream);
  return err != 0 ? err : e3;
}

}  // namespace

extern "C" {

long long bft_ekf_update_tiled_scratch_elems(int dx, int dy) {
  return UpdateScratch(dx, dy).f.total;
}

long long bft_ekf_predict_cov_tiled_scratch_elems(int dx, int dq) {
  return predict_scratch(dx, dq);
}

int bft_ekf_update_tiled_f32(const void* m, const void* P, const void* H,
                             const void* R, const void* inn, void* ll,
                             void* mean, void* cov, void* gain, void* scratch,
                             int B, int dx, int dy, double jitter,
                             void* stream) {
  return launch_update_tiled<float>(m, P, H, R, inn, ll, mean, cov, gain,
                                    scratch, B, dx, dy, jitter, stream);
}

int bft_ekf_update_tiled_f64(const void* m, const void* P, const void* H,
                             const void* R, const void* inn, void* ll,
                             void* mean, void* cov, void* gain, void* scratch,
                             int B, int dx, int dy, double jitter,
                             void* stream) {
  return launch_update_tiled<double>(m, P, H, R, inn, ll, mean, cov, gain,
                                     scratch, B, dx, dy, jitter, stream);
}

int bft_ekf_predict_cov_tiled_f32(const void* Fx, const void* P,
                                  const void* Fq, const void* Q, void* cov,
                                  void* scratch, int B, int dx, int dq,
                                  void* stream) {
  return launch_predict_tiled<float>(Fx, P, Fq, Q, cov, scratch, B, dx, dq,
                                     stream);
}

int bft_ekf_predict_cov_tiled_f64(const void* Fx, const void* P,
                                  const void* Fq, const void* Q, void* cov,
                                  void* scratch, int B, int dx, int dq,
                                  void* stream) {
  return launch_predict_tiled<double>(Fx, P, Fq, Q, cov, scratch, B, dx, dq,
                                      stream);
}

}  // extern "C"
