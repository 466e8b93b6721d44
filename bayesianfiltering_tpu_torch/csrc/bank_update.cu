// EKF measurement update (K3) and covariance predict (K4) over a bank of M
// small Gaussians, d ≤ 8.
//
// Replaces the TPU kernels bayesianfiltering_tpu/ops/bank_update.py
// `_bank_update_kernel` (K3) and `_bank_predict_kernel` (K4). On the TPU
// the bank index lies along the 128 vector lanes and each scalar of the
// d×d lattice is one M-wide statement; the bank-major (d·e, M) layout and
// its 128-lane padding exist for that. Here one thread owns one component
// and keeps its whole d×d lattice in registers: the tensors stay (M, d, d)
// row-major, and the ragged edge is a bounds check on the component index.
//
// What bounds them on an H100: the matrices are tiny (the BOT AGSF update
// is dx=4, dy=1, about 300 flops per component) so a launch is bound by
// latency — the dependent chain through Cholesky, L⁻¹, gain and Joseph
// form in one thread — and, at banks of a few hundred components, by how
// few threads there are to hide it. What the simple design does about it:
// no shared memory and no barriers, the lattice is padded to a static
// bound (4 or 8) so every loop unrolls and every index is a compile-time
// register slot; padded rows carry zeros and padded pivots carry one, so
// they change nothing. Each thread reads its component's contiguous
// (d, d) blocks; at these sizes the loads are served from L1/L2.
//
// Math and constants follow ops/ekf.py chol_update_precomputed (bank form:
// ops/bank_update.py `_update_xla`) and `_predict_cov_xla`, with Q shared
// across the bank.
#include "common.cuh"

namespace {

using namespace bft;

constexpr int kBankThreads = 128;

template <typename T, int MX>
__global__ void __launch_bounds__(kBankThreads) bank_update_kernel(
    const T* __restrict__ m_all, const T* __restrict__ P_all,
    const T* __restrict__ H_all, const T* __restrict__ R_all,
    const T* __restrict__ inn_all, T* __restrict__ ll_all,
    T* __restrict__ mean_all, T* __restrict__ cov_all,
    T* __restrict__ gain_all, int M, int dx, int dy, T jitter) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= M) return;
  const T* Pc = P_all + size_t(c) * dx * dx;
  const T* Hc = H_all + size_t(c) * dy * dx;
  const T* Rc = R_all + size_t(c) * dy * dy;
  const T* mc = m_all + size_t(c) * dx;
  const T* ic = inn_all + size_t(c) * dy;

  // Padded lattice: zeros outside (dx, dy), Rt = I on the padded diagonal so
  // the padded block of S factors to I and drops out of every product.
  T P[MX][MX], H[MX][MX], R[MX][MX], inn[MX];
#pragma unroll
  for (int i = 0; i < MX; ++i) {
    inn[i] = i < dy ? ic[i] : T(0);
#pragma unroll
    for (int j = 0; j < MX; ++j) {
      P[i][j] = (i < dx && j < dx) ? Pc[i * dx + j] : T(0);
      H[i][j] = (i < dy && j < dx) ? Hc[i * dx + j] : T(0);
      R[i][j] = (i < dy && j < dy) ? Rc[i * dy + j] : T(i == j ? 1 : 0);
    }
  }

  // H P and S = sym(Rt + H P Hᵀ)
  T hp[MX][MX], G[MX][MX], S[MX][MX];
#pragma unroll
  for (int i = 0; i < MX; ++i)
#pragma unroll
    for (int k = 0; k < MX; ++k) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < MX; ++j) acc += H[i][j] * P[j][k];
      hp[i][k] = acc;
    }
#pragma unroll
  for (int i = 0; i < MX; ++i)
#pragma unroll
    for (int j = 0; j < MX; ++j) {
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < MX; ++k) acc += hp[i][k] * H[j][k];
      G[i][j] = acc;
    }
#pragma unroll
  for (int i = 0; i < MX; ++i)
#pragma unroll
    for (int j = 0; j < MX; ++j)
      S[i][j] = T(0.5) * ((R[i][j] + G[i][j]) + (R[j][i] + G[j][i]));

  // relative diagonal floor over the real block only
  T mx = T(0);
#pragma unroll
  for (int i = 0; i < MX; ++i)
    if (i < dy) {
      const T a = dabs(S[i][i]);
      mx = a > mx ? a : mx;
    }
  const T s_floor = jitter + T(kRelJitter) * mx;
#pragma unroll
  for (int i = 0; i < MX; ++i)
    if (i < dy) S[i][i] += s_floor;

  // Cholesky–Crout and L⁻¹ by forward substitution
  T L[MX][MX], Li[MX][MX];
#pragma unroll
  for (int i = 0; i < MX; ++i)
#pragma unroll
    for (int j = 0; j < MX; ++j) L[i][j] = Li[i][j] = T(0);
#pragma unroll
  for (int j = 0; j < MX; ++j) {
    T d = S[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) d -= L[j][k] * L[j][k];
    L[j][j] = dsqrt(d);
#pragma unroll
    for (int i = j + 1; i < MX; ++i) {
      T s = S[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s -= L[i][k] * L[j][k];
      L[i][j] = s / L[j][j];
    }
  }
#pragma unroll
  for (int j = 0; j < MX; ++j) {
    Li[j][j] = T(1) / L[j][j];
#pragma unroll
    for (int i = j + 1; i < MX; ++i) {
      T acc = T(0);
#pragma unroll
      for (int k = j; k < i; ++k) acc += L[i][k] * Li[k][j];
      Li[i][j] = -acc / L[i][i];
    }
  }

  // Z = L⁻¹ H P, K = (L⁻ᵀ Z)ᵀ = (S⁻¹ H P)ᵀ  (dx × dy)
  T Z[MX][MX], K[MX][MX];
#pragma unroll
  for (int i = 0; i < MX; ++i)
#pragma unroll
    for (int c2 = 0; c2 < MX; ++c2) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j <= i; ++j) acc += Li[i][j] * hp[j][c2];
      Z[i][c2] = acc;
    }
#pragma unroll
  for (int i = 0; i < MX; ++i)
#pragma unroll
    for (int c2 = 0; c2 < MX; ++c2) {
      T acc = T(0);
#pragma unroll
      for (int j = i; j < MX; ++j) acc += Li[j][i] * Z[j][c2];
      K[c2][i] = acc;
    }

  // A = I − K H, A P, K Rt, then the symmetrised Joseph form
  T A[MX][MX], AP[MX][MX], KR[MX][MX], C[MX][MX];
#pragma unroll
  for (int i = 0; i < MX; ++i)
#pragma unroll
    for (int j = 0; j < MX; ++j) {
      T acc = T(0);
#pragma unroll
      for (int l = 0; l < MX; ++l) acc += K[i][l] * H[l][j];
      A[i][j] = (i == j ? T(1) : T(0)) - acc;
    }
#pragma unroll
  for (int i = 0; i < MX; ++i)
#pragma unroll
    for (int j = 0; j < MX; ++j) {
      T ap = T(0), kr = T(0);
#pragma unroll
      for (int k = 0; k < MX; ++k) {
        ap += A[i][k] * P[k][j];
        kr += K[i][k] * R[k][j];
      }
      AP[i][j] = ap;
      KR[i][j] = kr;
    }
#pragma unroll
  for (int i = 0; i < MX; ++i)
#pragma unroll
    for (int j = 0; j < MX; ++j) {
      T apa = T(0), krk = T(0);
#pragma unroll
      for (int k = 0; k < MX; ++k) {
        apa += AP[i][k] * A[j][k];
        krk += KR[i][k] * K[j][k];
      }
      C[i][j] = apa + krk;
    }

  T* cov = cov_all + size_t(c) * dx * dx;
  T* gain = gain_all + size_t(c) * dx * dy;
#pragma unroll
  for (int i = 0; i < MX; ++i)
#pragma unroll
    for (int j = 0; j < MX; ++j) {
      if (i < dx && j < dx) cov[i * dx + j] = T(0.5) * (C[i][j] + C[j][i]);
      if (i < dx && j < dy) gain[i * dy + j] = K[i][j];
    }

  // μ = m + K innov; log N(innov | 0, S) from diag L and z = L⁻¹ innov
#pragma unroll
  for (int i = 0; i < MX; ++i)
    if (i < dx) {
      T acc = T(0);
#pragma unroll
      for (int l = 0; l < MX; ++l) acc += K[i][l] * inn[l];
      mean_all[size_t(c) * dx + i] = mc[i] + acc;
    }
  T logdet = T(0), zsq = T(0);
#pragma unroll
  for (int i = 0; i < MX; ++i)
    if (i < dy) {
      T z = T(0);
#pragma unroll
      for (int j = 0; j <= i; ++j) z += Li[i][j] * inn[j];
      logdet += dlog(L[i][i]);
      zsq += z * z;
    }
  ll_all[c] = T(-0.5) * (T(dy * kLog2Pi) + T(2) * logdet + zsq);
}

template <typename T, int MX>
__global__ void __launch_bounds__(kBankThreads) bank_predict_cov_kernel(
    const T* __restrict__ Fx_all, const T* __restrict__ P_all,
    const T* __restrict__ Fq_all, const T* __restrict__ Q,
    T* __restrict__ cov_all, int M, int dx, int dq) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= M) return;
  const T* Fxc = Fx_all + size_t(c) * dx * dx;
  const T* Pc = P_all + size_t(c) * dx * dx;
  const T* Fqc = Fq_all + size_t(c) * dx * dq;

  T Fx[MX][MX], P[MX][MX], Fq[MX][MX], Qm[MX][MX];
#pragma unroll
  for (int i = 0; i < MX; ++i)
#pragma unroll
    for (int j = 0; j < MX; ++j) {
      Fx[i][j] = (i < dx && j < dx) ? Fxc[i * dx + j] : T(0);
      P[i][j] = (i < dx && j < dx) ? Pc[i * dx + j] : T(0);
      Fq[i][j] = (i < dx && j < dq) ? Fqc[i * dq + j] : T(0);
      Qm[i][j] = (i < dq && j < dq) ? Q[i * dq + j] : T(0);
    }

  T FP[MX][MX], FQ[MX][MX], C[MX][MX];
#pragma unroll
  for (int i = 0; i < MX; ++i)
#pragma unroll
    for (int j = 0; j < MX; ++j) {
      T fp = T(0), fq = T(0);
#pragma unroll
      for (int k = 0; k < MX; ++k) {
        fp += Fx[i][k] * P[k][j];
        fq += Fq[i][k] * Qm[k][j];
      }
      FP[i][j] = fp;
      FQ[i][j] = fq;
    }
#pragma unroll
  for (int i = 0; i < MX; ++i)
#pragma unroll
    for (int j = 0; j < MX; ++j) {
      T fpf = T(0), fqf = T(0);
#pragma unroll
      for (int k = 0; k < MX; ++k) {
        fpf += FP[i][k] * Fx[j][k];
        fqf += FQ[i][k] * Fq[j][k];
      }
      C[i][j] = fpf + fqf;
    }
  T* cov = cov_all + size_t(c) * dx * dx;
#pragma unroll
  for (int i = 0; i < MX; ++i)
#pragma unroll
    for (int j = 0; j < MX; ++j)
      if (i < dx && j < dx) cov[i * dx + j] = T(0.5) * (C[i][j] + C[j][i]);
}

int blocks_for(int M) { return (M + kBankThreads - 1) / kBankThreads; }

template <typename T>
int launch_bank_update(const void* m, const void* P, const void* H,
                       const void* R, const void* inn, void* ll, void* mean,
                       void* cov, void* gain, int M, int dx, int dy,
                       double jitter, void* stream) {
  auto kernel = (dx <= 4 && dy <= 4) ? bank_update_kernel<T, 4>
                                     : bank_update_kernel<T, 8>;
  kernel<<<blocks_for(M), kBankThreads, 0, cudaStream_t(stream)>>>(
      static_cast<const T*>(m), static_cast<const T*>(P),
      static_cast<const T*>(H), static_cast<const T*>(R),
      static_cast<const T*>(inn), static_cast<T*>(ll), static_cast<T*>(mean),
      static_cast<T*>(cov), static_cast<T*>(gain), M, dx, dy, T(jitter));
  return int(cudaGetLastError());
}

template <typename T>
int launch_bank_predict(const void* Fx, const void* P, const void* Fq,
                        const void* Q, void* cov, int M, int dx, int dq,
                        void* stream) {
  auto kernel = (dx <= 4 && dq <= 4) ? bank_predict_cov_kernel<T, 4>
                                     : bank_predict_cov_kernel<T, 8>;
  kernel<<<blocks_for(M), kBankThreads, 0, cudaStream_t(stream)>>>(
      static_cast<const T*>(Fx), static_cast<const T*>(P),
      static_cast<const T*>(Fq), static_cast<const T*>(Q),
      static_cast<T*>(cov), M, dx, dq);
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
