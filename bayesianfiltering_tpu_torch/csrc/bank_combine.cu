// The associative Kalman filtering combine (K10), the RTS smoothing
// elements (K11) and the smoothing combine (K12), each over a bank of M
// lanes with state dimension dx ≤ 8.
//
// Replaces the TPU kernels bayesianfiltering_tpu/ops/bank_combine.py
// `_combine_kernel` (K10, body `_combine_lattice`) and
// bayesianfiltering_tpu/ops/bank_smoother.py `_elements_kernel` (K11) and
// `_smoother_combine_kernel` (K12). On the TPU the bank index lies along the
// 128 vector lanes and each scalar of the dx×dx lattice is one M-wide
// statement; the bank-major layout and its padding exist for that. Here one
// thread owns one lane and keeps its lattice in registers, the pattern of
// csrc/bank_update.cu (K3/K4): tensors stay (M, dx, dx) row-major, the
// lattice is padded to a static bound (4 or 8) so every loop unrolls,
// padded entries are zero and the padded diagonal of every matrix that is
// factored is one, so the padding changes nothing in the real block.
//
// Broadcast operands: the chunked scan combines (1, G, ...) with
// (chunk, G, ...). A side with Ml < M lanes is read at lane m % Ml, so the
// broadcast is never materialised. K11's transition F is shared by every
// lane (f_banked = 0) or given per lane.
//
// What bounds them on an H100: K11 and K12 are bytes-bound (K11 at the 1M
// main path moves 92 values per lane against ~300 flops); K10 does ~1,400
// flops per lane at dx=4 against 112 values moved, still below the card's
// ratio of flops to bytes in float32, so all three are bytes-bound at full
// width and latency-bound at the narrow widths of the scan's upper levels.
// What the simple design does about it: adjacent threads take adjacent
// lanes, so a warp reads one contiguous stretch of each operand and every
// 128-byte line it brings in is used by the warp's next loads from L1; no
// shared memory, no barriers.
//
// Math follows the port's plain versions (ops/associative.py `_combine`
// with `_minv_woodbury`, ops/bank_smoother.py `_elements_plain`,
// `_smoother_combine`):
//   K10  ε = 1e-7·tr(C1)/dx + 1e-30,  U = chol(C1 + εI),
//        inner = I + sym(Uᵀ J2 U),  M⁻¹ = I − U inner⁻¹ (J2 U)ᵀ,
//        A = A2 M⁻¹ A1,  b = A2 M⁻¹ (b1 + C1 η2) + b2,
//        C = sym(A2 M⁻¹ C1 A2ᵀ + C2),  η = A1ᵀ M⁻ᵀ (η2 − J2 b1) + η1,
//        J = sym(A1ᵀ M⁻ᵀ J2 A1 + J1).
//        Guard: U is zeroed unless every pivot of chol(C1 + εI) is positive
//        (then M⁻¹ = I), as utils/linalg.py `cholesky_guarded` zeroes the
//        factor that `cholesky_nan` NaNs when cholesky_ex reports failure.
//   K11  G = (Pp⁻¹ F Pf)ᵀ by chol(Pp) and L⁻¹, g = mf − G mp,
//        L = sym(Pf) − sym((G Lp)(G Lp)ᵀ); a non-positive-definite Pp NaNs
//        the lane, as psd_solve does. No diagonal floor (the TPU kernel's
//        1e-30 kept its zero-padded lanes factorable; padding here has unit
//        pivots).
//   K12  E = E1 E2,  g = E1 g2 + g1,  L = sym(E1 L2 E1ᵀ + L1).
#include "common.cuh"

namespace {

using namespace bft;

constexpr int kLaneThreads = 128;

template <typename T, int MX>
__device__ __forceinline__ void load_mat(T (&X)[MX][MX], const T* g, int d) {
#pragma unroll
  for (int i = 0; i < MX; ++i)
#pragma unroll
    for (int j = 0; j < MX; ++j)
      X[i][j] = (i < d && j < d) ? g[i * d + j] : T(0);
}

template <typename T, int MX>
__device__ __forceinline__ void load_vec(T (&v)[MX], const T* g, int d) {
#pragma unroll
  for (int i = 0; i < MX; ++i) v[i] = i < d ? g[i] : T(0);
}

template <typename T, int MX>
__device__ __forceinline__ void store_mat(T* g, const T (&X)[MX][MX], int d) {
#pragma unroll
  for (int i = 0; i < MX; ++i)
#pragma unroll
    for (int j = 0; j < MX; ++j)
      if (i < d && j < d) g[i * d + j] = X[i][j];
}

template <typename T, int MX>
__device__ __forceinline__ void store_vec(T* g, const T (&v)[MX], int d) {
#pragma unroll
  for (int i = 0; i < MX; ++i)
    if (i < d) g[i] = v[i];
}

// C = A B
template <typename T, int MX>
__device__ __forceinline__ void mm(T (&C)[MX][MX], const T (&A)[MX][MX],
                                   const T (&B)[MX][MX]) {
#pragma unroll
  for (int i = 0; i < MX; ++i)
#pragma unroll
    for (int j = 0; j < MX; ++j) {
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < MX; ++k) acc += A[i][k] * B[k][j];
      C[i][j] = acc;
    }
}

// C = A Bᵀ
template <typename T, int MX>
__device__ __forceinline__ void mmt(T (&C)[MX][MX], const T (&A)[MX][MX],
                                    const T (&B)[MX][MX]) {
#pragma unroll
  for (int i = 0; i < MX; ++i)
#pragma unroll
    for (int j = 0; j < MX; ++j) {
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < MX; ++k) acc += A[i][k] * B[j][k];
      C[i][j] = acc;
    }
}

// C = Aᵀ B
template <typename T, int MX>
__device__ __forceinline__ void mtm(T (&C)[MX][MX], const T (&A)[MX][MX],
                                    const T (&B)[MX][MX]) {
#pragma unroll
  for (int i = 0; i < MX; ++i)
#pragma unroll
    for (int j = 0; j < MX; ++j) {
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < MX; ++k) acc += A[k][i] * B[k][j];
      C[i][j] = acc;
    }
}

// Lower Cholesky–Crout of S (lower triangle read) into L, strict upper part
// zero. Returns whether every pivot was positive (NaN and ≤ 0 fail), the
// info contract of torch.linalg.cholesky_ex.
template <typename T, int MX>
__device__ __forceinline__ bool reg_chol(T (&L)[MX][MX],
                                         const T (&S)[MX][MX]) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < MX; ++i)
#pragma unroll
    for (int j = 0; j < MX; ++j) L[i][j] = T(0);
#pragma unroll
  for (int j = 0; j < MX; ++j) {
    T d = S[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) d -= L[j][k] * L[j][k];
    ok = ok && (d > T(0));
    L[j][j] = dsqrt(d);
#pragma unroll
    for (int i = j + 1; i < MX; ++i) {
      T s = S[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s -= L[i][k] * L[j][k];
      L[i][j] = s / L[j][j];
    }
  }
  return ok;
}

// L⁻¹ of a lower-triangular L by forward substitution (strict upper zero).
template <typename T, int MX>
__device__ __forceinline__ void reg_tri_inv(T (&Li)[MX][MX],
                                            const T (&L)[MX][MX]) {
#pragma unroll
  for (int i = 0; i < MX; ++i)
#pragma unroll
    for (int j = 0; j < MX; ++j) Li[i][j] = T(0);
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
}

// X ← the dx×dx block of X plus one on the padded diagonal.
template <typename T, int MX>
__device__ __forceinline__ void unit_pad(T (&X)[MX][MX], int d) {
#pragma unroll
  for (int i = 0; i < MX; ++i)
    if (i >= d) X[i][i] = T(1);
}

template <typename T, int MX>
__global__ void __launch_bounds__(kLaneThreads) bank_combine_kernel(
    const T* __restrict__ A1g, const T* __restrict__ b1g,
    const T* __restrict__ C1g, const T* __restrict__ J1g,
    const T* __restrict__ e1g, const T* __restrict__ A2g,
    const T* __restrict__ b2g, const T* __restrict__ C2g,
    const T* __restrict__ J2g, const T* __restrict__ e2g, T* __restrict__ Ag,
    T* __restrict__ bg, T* __restrict__ Cg, T* __restrict__ Jg,
    T* __restrict__ eg, int M, int Ml, int Mr, int dx) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const size_t l = Ml == M ? m : m % Ml;  // lane of the left operand
  const size_t r = Mr == M ? m : m % Mr;  // lane of the right operand
  const size_t dd = size_t(dx) * dx;

  // U = chol(C1 + εI), zeroed unless every pivot is positive
  T C1[MX][MX], S[MX][MX], U[MX][MX];
  load_mat(C1, C1g + l * dd, dx);
  T tr = T(0);
#pragma unroll
  for (int i = 0; i < MX; ++i)
    if (i < dx) tr += C1[i][i];
  const T eps = T(1e-7) * tr / T(dx) + T(1e-30);
#pragma unroll
  for (int i = 0; i < MX; ++i)
#pragma unroll
    for (int j = 0; j < MX; ++j)
      S[i][j] = C1[i][j] + (i == j && i < dx ? eps : T(0));
  unit_pad(S, dx);
  if (!reg_chol(U, S)) {
#pragma unroll
    for (int i = 0; i < MX; ++i)
#pragma unroll
      for (int j = 0; j < MX; ++j) U[i][j] = T(0);
  }

  // inner = I + sym(Uᵀ J2 U); its inverse Li⁻ᵀ Li⁻¹ from chol and L⁻¹
  T J2[MX][MX], J2U[MX][MX], W[MX][MX], Lin[MX][MX], Li[MX][MX];
  load_mat(J2, J2g + r * dd, dx);
  mm(J2U, J2, U);
  mtm(W, U, J2U);
#pragma unroll
  for (int i = 0; i < MX; ++i)
#pragma unroll
    for (int j = 0; j < MX; ++j)
      S[i][j] = T(0.5) * (W[i][j] + W[j][i]) + (i == j ? T(1) : T(0));
  reg_chol(Lin, S);
  reg_tri_inv(Li, Lin);
  T inv[MX][MX];
  mtm(inv, Li, Li);

  // M⁻¹ = I − U inner⁻¹ (J2 U)ᵀ
  T V[MX][MX], Minv[MX][MX];
  mmt(V, inv, J2U);
  mm(W, U, V);
#pragma unroll
  for (int i = 0; i < MX; ++i)
#pragma unroll
    for (int j = 0; j < MX; ++j)
      Minv[i][j] = (i == j ? T(1) : T(0)) - W[i][j];

  // A = (A2 M⁻¹) A1
  T A1[MX][MX], A2[MX][MX], A2M[MX][MX], X[MX][MX];
  load_mat(A1, A1g + l * dd, dx);
  load_mat(A2, A2g + r * dd, dx);
  mm(A2M, A2, Minv);
  mm(X, A2M, A1);
  store_mat(Ag + size_t(m) * dd, X, dx);

  // b = A2M (b1 + C1 η2) + b2
  T b1[MX], e2[MX], v[MX];
  load_vec(b1, b1g + l * dx, dx);
  load_vec(e2, e2g + r * dx, dx);
#pragma unroll
  for (int i = 0; i < MX; ++i) {
    T acc = b1[i];
#pragma unroll
    for (int k = 0; k < MX; ++k) acc += C1[i][k] * e2[k];
    v[i] = acc;
  }
  {
    T b2[MX], bo[MX];
    load_vec(b2, b2g + r * dx, dx);
#pragma unroll
    for (int i = 0; i < MX; ++i) {
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < MX; ++k) acc += A2M[i][k] * v[k];
      bo[i] = acc + b2[i];
    }
    store_vec(bg + size_t(m) * dx, bo, dx);
  }

  // C = sym(A2M C1 A2ᵀ + C2)
  {
    T C2[MX][MX];
    mm(X, A2M, C1);
    mmt(W, X, A2);
    load_mat(C2, C2g + r * dd, dx);
#pragma unroll
    for (int i = 0; i < MX; ++i)
#pragma unroll
      for (int j = 0; j < MX; ++j)
        X[i][j] = T(0.5) * ((W[i][j] + W[j][i]) + (C2[i][j] + C2[j][i]));
    store_mat(Cg + size_t(m) * dd, X, dx);
  }

  // η = A1ᵀ M⁻ᵀ (η2 − J2 b1) + η1
  {
    T w[MX], t[MX], e1[MX], eo[MX];
#pragma unroll
    for (int i = 0; i < MX; ++i) {
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < MX; ++k) acc += J2[i][k] * b1[k];
      w[i] = e2[i] - acc;
    }
#pragma unroll
    for (int i = 0; i < MX; ++i) {
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < MX; ++k) acc += Minv[k][i] * w[k];
      t[i] = acc;
    }
    load_vec(e1, e1g + l * dx, dx);
#pragma unroll
    for (int i = 0; i < MX; ++i) {
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < MX; ++k) acc += A1[k][i] * t[k];
      eo[i] = acc + e1[i];
    }
    store_vec(eg + size_t(m) * dx, eo, dx);
  }

  // J = sym(A1ᵀ (M⁻ᵀ J2) A1 + J1)
  {
    T J1[MX][MX];
    mtm(X, Minv, J2);
    mm(W, X, A1);
    mtm(X, A1, W);
    load_mat(J1, J1g + l * dd, dx);
#pragma unroll
    for (int i = 0; i < MX; ++i)
#pragma unroll
      for (int j = 0; j < MX; ++j)
        W[i][j] = T(0.5) * ((X[i][j] + X[j][i]) + (J1[i][j] + J1[j][i]));
    store_mat(Jg + size_t(m) * dd, W, dx);
  }
}

template <typename T, int MX>
__global__ void __launch_bounds__(kLaneThreads) bank_smoother_elements_kernel(
    const T* __restrict__ fmg, const T* __restrict__ fPg,
    const T* __restrict__ pmg, const T* __restrict__ pPg,
    const T* __restrict__ Fg, T* __restrict__ Eg, T* __restrict__ gg,
    T* __restrict__ Lg, int M, int f_banked, int dx) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const size_t dd = size_t(dx) * dx;

  // Lp = chol(Pp), NaN unless every pivot is positive; Li = Lp⁻¹
  T Pp[MX][MX], Lp[MX][MX], Li[MX][MX];
  load_mat(Pp, pPg + size_t(m) * dd, dx);
  unit_pad(Pp, dx);
  if (!reg_chol(Lp, Pp)) {
#pragma unroll
    for (int i = 0; i < MX; ++i)
#pragma unroll
      for (int j = 0; j < MX; ++j) Lp[i][j] = qnan<T>();
  }
  reg_tri_inv(Li, Lp);

  // G = (Li⁻ᵀ Li⁻¹ F Pf)ᵀ
  T F[MX][MX], Pf[MX][MX], X[MX][MX], Y[MX][MX];
  load_mat(F, Fg + (f_banked ? size_t(m) * dd : 0), dx);
  load_mat(Pf, fPg + size_t(m) * dd, dx);
  mm(X, F, Pf);
  mm(Y, Li, X);
  mtm(X, Li, Y);
#pragma unroll
  for (int i = 0; i < MX; ++i)
#pragma unroll
    for (int j = 0; j < MX; ++j) Y[i][j] = X[j][i];  // Y = G
  store_mat(Eg + size_t(m) * dd, Y, dx);

  // g = mf − G mp
  {
    T mf[MX], mp[MX], go[MX];
    load_vec(mf, fmg + size_t(m) * dx, dx);
    load_vec(mp, pmg + size_t(m) * dx, dx);
#pragma unroll
    for (int i = 0; i < MX; ++i) {
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < MX; ++k) acc += Y[i][k] * mp[k];
      go[i] = mf[i] - acc;
    }
    store_vec(gg + size_t(m) * dx, go, dx);
  }

  // L = sym(Pf) − sym((G Lp)(G Lp)ᵀ)
  mm(X, Y, Lp);
  mmt(Y, X, X);
#pragma unroll
  for (int i = 0; i < MX; ++i)
#pragma unroll
    for (int j = 0; j < MX; ++j)
      X[i][j] = T(0.5) * (Pf[i][j] + Pf[j][i]) - T(0.5) * (Y[i][j] + Y[j][i]);
  store_mat(Lg + size_t(m) * dd, X, dx);
}

template <typename T, int MX>
__global__ void __launch_bounds__(kLaneThreads) bank_smoother_combine_kernel(
    const T* __restrict__ E1g, const T* __restrict__ g1g,
    const T* __restrict__ L1g, const T* __restrict__ E2g,
    const T* __restrict__ g2g, const T* __restrict__ L2g, T* __restrict__ Eg,
    T* __restrict__ gg, T* __restrict__ Lg, int M, int Ml, int Mr, int dx) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const size_t l = Ml == M ? m : m % Ml;
  const size_t r = Mr == M ? m : m % Mr;
  const size_t dd = size_t(dx) * dx;

  T E1[MX][MX], E2[MX][MX], X[MX][MX], Y[MX][MX];
  load_mat(E1, E1g + l * dd, dx);
  load_mat(E2, E2g + r * dd, dx);
  mm(X, E1, E2);
  store_mat(Eg + size_t(m) * dd, X, dx);

  {
    T g1[MX], g2[MX], go[MX];
    load_vec(g1, g1g + l * dx, dx);
    load_vec(g2, g2g + r * dx, dx);
#pragma unroll
    for (int i = 0; i < MX; ++i) {
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < MX; ++k) acc += E1[i][k] * g2[k];
      go[i] = acc + g1[i];
    }
    store_vec(gg + size_t(m) * dx, go, dx);
  }

  load_mat(E2, L2g + r * dd, dx);  // E2 now holds L2
  mm(X, E1, E2);
  mmt(Y, X, E1);
  load_mat(E2, L1g + l * dd, dx);  // E2 now holds L1
#pragma unroll
  for (int i = 0; i < MX; ++i)
#pragma unroll
    for (int j = 0; j < MX; ++j)
      X[i][j] = T(0.5) * ((Y[i][j] + Y[j][i]) + (E2[i][j] + E2[j][i]));
  store_mat(Lg + size_t(m) * dd, X, dx);
}

int lane_blocks(int M) { return (M + kLaneThreads - 1) / kLaneThreads; }

template <typename T>
int launch_combine(const void* const* in, void* const* out, int M, int Ml,
                   int Mr, int dx, void* stream) {
  auto kernel = dx <= 4 ? bank_combine_kernel<T, 4> : bank_combine_kernel<T, 8>;
  const T* const* x = reinterpret_cast<const T* const*>(in);
  T* const* y = reinterpret_cast<T* const*>(out);
  kernel<<<lane_blocks(M), kLaneThreads, 0, cudaStream_t(stream)>>>(
      x[0], x[1], x[2], x[3], x[4], x[5], x[6], x[7], x[8], x[9], y[0], y[1],
      y[2], y[3], y[4], M, Ml, Mr, dx);
  return int(cudaGetLastError());
}

template <typename T>
int launch_elements(const void* fm, const void* fP, const void* pm,
                    const void* pP, const void* F, void* E, void* g, void* L,
                    int M, int f_banked, int dx, void* stream) {
  auto kernel = dx <= 4 ? bank_smoother_elements_kernel<T, 4>
                        : bank_smoother_elements_kernel<T, 8>;
  kernel<<<lane_blocks(M), kLaneThreads, 0, cudaStream_t(stream)>>>(
      static_cast<const T*>(fm), static_cast<const T*>(fP),
      static_cast<const T*>(pm), static_cast<const T*>(pP),
      static_cast<const T*>(F), static_cast<T*>(E), static_cast<T*>(g),
      static_cast<T*>(L), M, f_banked, dx);
  return int(cudaGetLastError());
}

template <typename T>
int launch_scombine(const void* E1, const void* g1, const void* L1,
                    const void* E2, const void* g2, const void* L2, void* E,
                    void* g, void* L, int M, int Ml, int Mr, int dx,
                    void* stream) {
  auto kernel = dx <= 4 ? bank_smoother_combine_kernel<T, 4>
                        : bank_smoother_combine_kernel<T, 8>;
  kernel<<<lane_blocks(M), kLaneThreads, 0, cudaStream_t(stream)>>>(
      static_cast<const T*>(E1), static_cast<const T*>(g1),
      static_cast<const T*>(L1), static_cast<const T*>(E2),
      static_cast<const T*>(g2), static_cast<const T*>(L2),
      static_cast<T*>(E), static_cast<T*>(g), static_cast<T*>(L), M, Ml, Mr,
      dx);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

#define BFT_COMBINE_ENTRY(NAME, T)                                           \
  int NAME(const void* A1, const void* b1, const void* C1, const void* J1,   \
           const void* e1, const void* A2, const void* b2, const void* C2,   \
           const void* J2, const void* e2, void* A, void* b, void* C,        \
           void* J, void* e, int M, int Ml, int Mr, int dx, void* stream) {  \
    const void* in[10] = {A1, b1, C1, J1, e1, A2, b2, C2, J2, e2};           \
    void* out[5] = {A, b, C, J, e};                                          \
    return launch_combine<T>(in, out, M, Ml, Mr, dx, stream);                \
  }
BFT_COMBINE_ENTRY(bft_bank_combine_f32, float)
BFT_COMBINE_ENTRY(bft_bank_combine_f64, double)
#undef BFT_COMBINE_ENTRY

int bft_bank_smoother_elements_f32(const void* fm, const void* fP,
                                   const void* pm, const void* pP,
                                   const void* F, void* E, void* g, void* L,
                                   int M, int f_banked, int dx,
                                   void* stream) {
  return launch_elements<float>(fm, fP, pm, pP, F, E, g, L, M, f_banked, dx,
                                stream);
}

int bft_bank_smoother_elements_f64(const void* fm, const void* fP,
                                   const void* pm, const void* pP,
                                   const void* F, void* E, void* g, void* L,
                                   int M, int f_banked, int dx,
                                   void* stream) {
  return launch_elements<double>(fm, fP, pm, pP, F, E, g, L, M, f_banked, dx,
                                 stream);
}

int bft_bank_smoother_combine_f32(const void* E1, const void* g1,
                                  const void* L1, const void* E2,
                                  const void* g2, const void* L2, void* E,
                                  void* g, void* L, int M, int Ml, int Mr,
                                  int dx, void* stream) {
  return launch_scombine<float>(E1, g1, L1, E2, g2, L2, E, g, L, M, Ml, Mr,
                                dx, stream);
}

int bft_bank_smoother_combine_f64(const void* E1, const void* g1,
                                  const void* L1, const void* E2,
                                  const void* g2, const void* L2, void* E,
                                  void* g, void* L, int M, int Ml, int Mr,
                                  int dx, void* stream) {
  return launch_scombine<double>(E1, g1, L1, E2, g2, L2, E, g, L, M, Ml, Mr,
                                 dx, stream);
}

}  // extern "C"
