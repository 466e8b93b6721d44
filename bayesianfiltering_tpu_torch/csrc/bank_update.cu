// EKF measurement update (K3) and covariance predict (K4) over a bank of M
// small Gaussians, d ≤ 8.
//
// Replaces the TPU kernels bayesianfiltering_tpu/ops/bank_update.py
// `_bank_update_kernel` (K3) and `_bank_predict_kernel` (K4). On the TPU
// the bank index lies along the 128 vector lanes and each scalar of the
// d×d lattice is one M-wide statement; the bank-major (d·e, M) layout and
// its 128-lane padding exist for that. Here the tensors stay (M, d, d)
// row-major and each component is a lane over a group of MX threads
// (csrc/lane_group.cuh: MX = 4 where every dimension is ≤ 4, else 8),
// thread i holding row i of each of the component's matrices.
//
// What bounds them on an H100: the matrices are tiny (the bearings-only
// update is dx = 4, dy = 1, ~250 flops and ~40 values a component) and the
// main paths' banks hold 16 to 200 components, so a launch moves a few KB
// and is bound by one component's dependent chain and by the launch. The
// first design ran that chain in one thread, padded to MX in every
// dimension (a 4-pivot factor and nine 4 × 4 products at dy = 1) on 2 of
// the 132 SMs at M = 200. What this design does about it:
// - the products are one row a thread (MX multiply-adds a step in
//   parallel over the group, the right operand's rows read from the board);
// - in the groups of 4 threads the factor sweeps only the dy real pivots
//   of S, and the solves and the products whose inner dimension is dy
//   (dq in K4) take only dy rows (row_mul's bound): one pivot and one row
//   at the bearings-only widths. The groups of 8 sweep all 8, the padded
//   pivots unit: there the bounds' branches cost more than they skip;
// - the triangular solves need no exchange: thread i applies L⁻¹ and then
//   L⁻ᵀ to its own right-hand side, column i of H P, with L's rows read
//   from the board, and gets row i of K, the row it needs next;
// - 64-thread blocks: 13 blocks on 13 SMs at M = 200.
//
// K3, row i on thread i (P's row, H's and Rt's for i < dy, entries i of m
// and of the innovation), five exchanges:
//   1. P, H, Rt and the innovation to the board; H P row i, then
//      X = Rt + (H P) Hᵀ row i;
//   2. H P and X to the board; S = ½(X + Xᵀ) from X's column i; the
//      relative diagonal floor jitter + 1e-6·max|S_jj| over the dy real
//      pivots (the max by shuffles: the same bits on every thread), padded
//      rows the identity's; L = chol(S) by group_chol (over dy pivots at
//      MX = 4); a failed pivot sets L to NaN, which reaches every output
//      of the lane (cholesky_nan's contract); thread i reads column i of
//      H P;
//   3. L and its pivots' reciprocals to the board; every thread solves
//      L [y | z] = [(H P)_{:,i} | innov] forward and Lᵀ k = y back: k is
//      row i of K = (S⁻¹ H P)ᵀ (L⁻¹ never formed); A = I − K H row i;
//   4. A and K to the board; C = (A P) Aᵀ + (K Rt) Kᵀ row i;
//   5. C to the board; Σ = ½(C + Cᵀ) from C's column i. μ_i = m_i + k·innov
//      and ll = −½(dy log 2π + 2 Σ log L_jj + ‖z‖²).
// K4, thread i holding row i of Fx, P and Fq (and of the shared Q for
// i < dq, read from global memory by every group: staging Q once a block
// costs a block barrier and was slower at the main paths' banks), two
// exchanges:
//   1. P, Q, Fx and Fq to the board; C = (Fx P) Fxᵀ + (Fq Q) Fqᵀ row i;
//   2. C to the board; Σ⁺ = ½(C + Cᵀ) from C's column i.
//
// Math and constants follow ops/ekf.py chol_update_precomputed (bank form:
// ops/bank_update.py `_update_xla`) and `_predict_cov_xla`, with Q shared
// across the bank.
#include "common.cuh"
#include "lane_group.cuh"

namespace {

using namespace bft;

constexpr int kUpdateSlots = 6;   // slots of a group's board in K3
constexpr int kPredictSlots = 5;  // in K4

template <typename T, int MX>
__global__ void __launch_bounds__(kGroupThreads) bank_update_kernel(
    const T* __restrict__ m_all, const T* __restrict__ P_all,
    const T* __restrict__ H_all, const T* __restrict__ R_all,
    const T* __restrict__ inn_all, T* __restrict__ ll_all,
    T* __restrict__ mean_all, T* __restrict__ cov_all,
    T* __restrict__ gain_all, int M, int dx, int dy, T jitter, int vx,
    int vy) {
  using Lane = GroupLane<T, MX, kUpdateSlots>;
  __shared__ __align__(16) T boards[Lane::kBoards];
  if (warp_idle<MX>(M)) return;
  const Lane g(boards, M);
  const int i = g.i;
  const size_t c = g.m;
  T* SP = g.slot(0);  // P
  T* SH = g.slot(1);  // H
  T* SR = g.slot(2);  // Rt | innov
  T* SA = g.slot(3);  // H P, then A
  T* SK = g.slot(4);  // X, then K
  T* SL = g.slot(5);  // L | 1/diag(L), then C

  T p[MX], h[MX], r[MX];
  load_row(p, P_all + c * dx * dx, i, dx, vx);
  load_row(h, H_all + c * dy * dx, i, dy, dx, vx);
  load_row(r, R_all + c * dy * dy, i, dy, dy, vy);
  const T mi = load_entry(m_all + c * dx, i, dx);
  // the bound of the factor, the solves and the products over dy: dy in
  // the groups of 4 threads, MX (every pivot, the padded ones unit) in
  // those of 8, where the branches cost more than they skip
  const int ny = MX == 4 ? dy : MX;
  put_row(SP, p, i);
  put_row(SH, h, i);
  put_row(SR, r, i);
  put_entry<T, MX>(SR, load_entry(inn_all + c * dy, i, dy), i);
  __syncwarp();

  // H P and X = Rt + (H P) Hᵀ, row i (zero past dy)
  T hp[MX], x[MX];
  row_mul(hp, h, SP);
  row_mul_t(x, hp, SH, ny);
#pragma unroll
  for (int k = 0; k < MX; ++k) x[k] = r[k] + x[k];
  put_row(SA, hp, i);
  put_row(SK, x, i);
  __syncwarp();

  // S = sym(X) + the floor on the real diagonal, the identity past dy;
  // L = chol(S)
  T s[MX], hpc[MX];
  get_col(s, SK, i);
  get_col(hpc, SA, i);  // column i of H P
#pragma unroll
  for (int k = 0; k < MX; ++k) s[k] = T(0.5) * (x[k] + s[k]);
  const T smax = group_max<T, MX>(i < dy ? dabs(entry(s, i)) : T(0));
  const T s_floor = jitter + T(kRelJitter) * smax;
#pragma unroll
  for (int k = 0; k < MX; ++k)
    if (k == i) s[k] = i < dy ? s[k] + s_floor : T(1);
  T rinv = T(1);
  if (!group_chol(s, i, rinv, ny)) {
#pragma unroll
    for (int k = 0; k < MX; ++k) s[k] = qnan<T>();
    rinv = qnan<T>();
  }
  put_row(SL, s, i);
  put_entry<T, MX>(SL, rinv, i);
  __syncwarp();

  // L [y | z] = [(H P)_{:,i} | innov], then Lᵀ k = y: k = row i of K
  T rl[MX], inn[MX], y[MX], z[MX];
  get_vec(rl, SL);
  get_vec(inn, SR);
  T logdet = T(0);
#pragma unroll
  for (int j = 0; j < MX; ++j) {
    y[j] = T(0);
    z[j] = T(0);
    if (j < ny) {
      T lj[MX];
      get_row(lj, SL, j);
      T a = hpc[j], b = inn[j];
#pragma unroll
      for (int k = 0; k < j; ++k) {
        a -= lj[k] * y[k];
        b -= lj[k] * z[k];
      }
      y[j] = a * rl[j];
      z[j] = b * rl[j];
      logdet += dlog(lj[j]);
    }
  }
#pragma unroll
  for (int j = MX - 1; j >= 0; --j) {
    if (j < ny) {
      T lj[MX];
      get_row(lj, SL, j);
      y[j] *= rl[j];
#pragma unroll
      for (int k = 0; k < j; ++k) y[k] -= lj[k] * y[j];
    }
  }

  // A = I − K H, row i
  T a[MX];
  row_mul(a, y, SH, ny);
#pragma unroll
  for (int k = 0; k < MX; ++k) a[k] = (k == i ? T(1) : T(0)) - a[k];
  put_row(SA, a, i);
  put_row(SK, y, i);
  __syncwarp();

  // C = (A P) Aᵀ + (K Rt) Kᵀ, row i
  T cr[MX];
  {
    T ap[MX], kr[MX], apa[MX];
    row_mul(ap, a, SP);
    row_mul(kr, y, SR, ny);
    row_mul_t(apa, ap, SA);
    row_mul_t(cr, kr, SK);
#pragma unroll
    for (int k = 0; k < MX; ++k) cr[k] = apa[k] + cr[k];
  }
  put_row(SL, cr, i);
  __syncwarp();

  if (g.live) {
    T cc[MX];
    get_col(cc, SL, i);
#pragma unroll
    for (int k = 0; k < MX; ++k) cc[k] = T(0.5) * (cr[k] + cc[k]);
    store_row(cov_all + c * dx * dx, cc, i, dx, vx);
    store_row(gain_all + c * dx * dy, y, i, dx, dy, vy);
    if (i < dx) mean_all[c * dx + i] = mi + dot(y, inn);
    if (i == 0) {
      T zsq = T(0);
#pragma unroll
      for (int j = 0; j < MX; ++j) zsq += z[j] * z[j];
      ll_all[c] = T(-0.5) * (T(dy * kLog2Pi) + T(2) * logdet + zsq);
    }
  }
}

template <typename T, int MX>
__global__ void __launch_bounds__(kGroupThreads) bank_predict_cov_kernel(
    const T* __restrict__ Fx_all, const T* __restrict__ P_all,
    const T* __restrict__ Fq_all, const T* __restrict__ Q,
    T* __restrict__ cov_all, int M, int dx, int dq, int vx, int vq) {
  using Lane = GroupLane<T, MX, kPredictSlots>;
  __shared__ __align__(16) T boards[Lane::kBoards];
  if (warp_idle<MX>(M)) return;
  const Lane g(boards, M);
  const int i = g.i;
  const size_t c = g.m;
  T* SP = g.slot(0);
  T* SQ = g.slot(1);
  T* SF = g.slot(2);
  T* SG = g.slot(3);
  T* SC = g.slot(4);

  T fx[MX], fq[MX];
  {
    T p[MX], q[MX];
    load_row(fx, Fx_all + c * dx * dx, i, dx, vx);
    load_row(p, P_all + c * dx * dx, i, dx, vx);
    load_row(fq, Fq_all + c * dx * dq, i, dx, dq, vq);
    load_row(q, Q, i, dq, dq, vq);
    put_row(SP, p, i);
    put_row(SQ, q, i);
    put_row(SF, fx, i);
    put_row(SG, fq, i);
  }
  __syncwarp();

  // C = (Fx P) Fxᵀ + (Fq Q) Fqᵀ, row i
  T cr[MX];
  {
    T fp[MX], fqq[MX], t[MX];
    row_mul(fp, fx, SP);
    row_mul(fqq, fq, SQ, MX == 4 ? dq : MX);
    row_mul_t(cr, fp, SF);
    row_mul_t(t, fqq, SG);
#pragma unroll
    for (int k = 0; k < MX; ++k) cr[k] = cr[k] + t[k];
  }
  put_row(SC, cr, i);
  __syncwarp();

  if (g.live) {
    T cc[MX];
    get_col(cc, SC, i);
#pragma unroll
    for (int k = 0; k < MX; ++k) cc[k] = T(0.5) * (cr[k] + cc[k]);
    store_row(cov_all + c * dx * dx, cc, i, dx, vx);
  }
}

template <typename T>
int launch_bank_update(const void* m, const void* P, const void* H,
                       const void* R, const void* inn, void* ll, void* mean,
                       void* cov, void* gain, int M, int dx, int dy,
                       double jitter, void* stream) {
  const int mx = (dx <= 4 && dy <= 4) ? 4 : 8;
  auto kernel = mx == 4 ? bank_update_kernel<T, 4> : bank_update_kernel<T, 8>;
  kernel<<<group_blocks(M, mx), kGroupThreads, 0, cudaStream_t(stream)>>>(
      static_cast<const T*>(m), static_cast<const T*>(P),
      static_cast<const T*>(H), static_cast<const T*>(R),
      static_cast<const T*>(inn), static_cast<T*>(ll), static_cast<T*>(mean),
      static_cast<T*>(cov), static_cast<T*>(gain), M, dx, dy, T(jitter),
      rows_vec<T>(dx, {P, H, cov}), rows_vec<T>(dy, {R, gain}));
  return int(cudaGetLastError());
}

template <typename T>
int launch_bank_predict(const void* Fx, const void* P, const void* Fq,
                        const void* Q, void* cov, int M, int dx, int dq,
                        void* stream) {
  const int mx = (dx <= 4 && dq <= 4) ? 4 : 8;
  auto kernel = mx == 4 ? bank_predict_cov_kernel<T, 4>
                        : bank_predict_cov_kernel<T, 8>;
  kernel<<<group_blocks(M, mx), kGroupThreads, 0, cudaStream_t(stream)>>>(
      static_cast<const T*>(Fx), static_cast<const T*>(P),
      static_cast<const T*>(Fq), static_cast<const T*>(Q),
      static_cast<T*>(cov), M, dx, dq, rows_vec<T>(dx, {Fx, P, cov}),
      rows_vec<T>(dq, {Fq, Q}));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

int bft_bank_update_f32(const void* m, const void* P, const void* H,
                        const void* R, const void* inn, void* ll, void* mean,
                        void* cov, void* gain, int M, int dx, int dy,
                        double jitter, void* stream) {
  return launch_bank_update<float>(m, P, H, R, inn, ll, mean, cov, gain, M,
                                   dx, dy, jitter, stream);
}

int bft_bank_update_f64(const void* m, const void* P, const void* H,
                        const void* R, const void* inn, void* ll, void* mean,
                        void* cov, void* gain, int M, int dx, int dy,
                        double jitter, void* stream) {
  return launch_bank_update<double>(m, P, H, R, inn, ll, mean, cov, gain, M,
                                    dx, dy, jitter, stream);
}

int bft_bank_predict_cov_f32(const void* Fx, const void* P, const void* Fq,
                             const void* Q, void* cov, int M, int dx, int dq,
                             void* stream) {
  return launch_bank_predict<float>(Fx, P, Fq, Q, cov, M, dx, dq, stream);
}

int bft_bank_predict_cov_f64(const void* Fx, const void* P, const void* Fq,
                             const void* Q, void* cov, int M, int dx, int dq,
                             void* stream) {
  return launch_bank_predict<double>(Fx, P, Fq, Q, cov, M, dx, dq, stream);
}

}  // extern "C"
