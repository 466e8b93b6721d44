// The associative Kalman filtering combine (K10), the RTS smoothing
// elements (K11) and the smoothing combine (K12), each over a bank of M
// lanes, in two size bands: one thread per lane for dx ≤ 8 (the lane
// kernels, `bank_*_kernel`) and one thread block per lane for
// 8 < dx ≤ 512 (the block kernels, `block_*_kernel`, after the lane
// kernels below).
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
#include <algorithm>

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

// ---------------------------------------------------------------------------
// The block kernels, 8 < dx ≤ 512: the same three functions, one thread
// block per lane.
//
// A lane's lattice no longer fits one thread's registers (at dx = 64 one
// Woodbury combine is ~3.7M multiply-adds over six 64×64 intermediates), so
// a block of kBlockThreads threads shares it: the products are the
// block-cooperative dot products of common.cuh under fused_ekf.cu's layout
// rule (consecutive threads own consecutive output columns; an operand that
// would be read with a stride is transposed once into the workspace), the
// factorisations are common.cuh's one-barrier-per-column Cholesky and
// whole-column substitution. The intermediates live in the block's
// workspace: dynamic shared memory when it fits (K10 at dx = 64 holds six
// 64×64 matrices, 98 KB in float32, two blocks per SM), otherwise the
// caller's global scratch. Inputs are read in place from global memory
// (L1/L2 serve the repeated reads).
//
// The chunked scan launches these over anything from one lane (its top
// level) to T lanes (its last broadcast, 65,536 at T = 65,536), so the grid
// is persistent: min(M, what the SMs hold at once) blocks, each looping over
// lanes m = blockIdx.x, blockIdx.x + gridDim.x, ... The scratch is then
// bounded by the blocks in flight (kScratchBlocksPerSM per SM), not by M.
//
// What bounds them: the products run on the CUDA cores in the working type
// (TF32 is off); at dx = 64 in float32 K10 does ~32 flops per byte it must
// move and K11 ~27, above the card's ratio of 20, so both are
// operation-bound, and K12 (~14) is bytes-bound. A block is held back by
// shared-memory bandwidth in its products and by the n barriers of each
// factorisation; at the scan's narrow levels (a few lanes) by latency.
// ---------------------------------------------------------------------------

constexpr int kBlockThreads = 256;
constexpr int kScratchBlocksPerSM = 2;

size_t block_combine_ws(int n) { return 6 * size_t(n) * n + 3 * size_t(n); }
size_t block_elements_ws(int n) { return 4 * size_t(n) * n; }
size_t block_scombine_ws(int n) { return 3 * size_t(n) * n; }

size_t block_ws(int kind, int n) {
  return kind == 0 ? block_combine_ws(n)
                   : kind == 1 ? block_elements_ws(n) : block_scombine_ws(n);
}

// The global scratch, in elements, that a block kernel with a per-lane
// workspace of ws elements needs over M lanes: 0 when the workspace fits in
// shared memory, else kScratchBlocksPerSM workspaces per SM (at most M);
// -1 on a failed device query.
long long block_scratch_elems(size_t ws, int itemsize, int M, int device) {
  int sms = 0;
  const long long need = scratch_elems(ws, itemsize, device);
  if (need <= 0) return need;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    return -1;
  return (long long)std::min(M, kScratchBlocksPerSM * sms) * need;
}

// The launch shape of a block kernel over M lanes: a persistent grid of as
// many blocks as the SMs hold at once with the workspace in dynamic shared
// memory, or, when one lane's workspace exceeds the opt-in limit, one
// block per scratch workspace. False on a failed device query.
template <typename K>
bool block_plan(K kernel, size_t ws, int itemsize, int M, int device,
                int* grid, size_t* smem, long long* scratch) {
  int sms = 0;
  *scratch = block_scratch_elems(ws, itemsize, M, device);
  if (*scratch < 0 ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    return false;
  if (*scratch > 0) {
    *grid = int(*scratch / (long long)ws);
    *smem = 0;
    return true;
  }
  int per_sm = 0;
  *smem = ws * size_t(itemsize);
  if (set_smem(kernel, *smem) != 0 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kBlockThreads, *smem) != cudaSuccess)
    return false;
  *grid = std::min(M, std::max(per_sm, 1) * sms);
  return true;
}

// K10, block variant. Woodbury combine of one lane per loop iteration;
// the comments name each workspace matrix S0..S5 as it is reused.
template <typename T>
__global__ void __launch_bounds__(kBlockThreads) block_combine_kernel(
    const T* __restrict__ A1g, const T* __restrict__ b1g,
    const T* __restrict__ C1g, const T* __restrict__ J1g,
    const T* __restrict__ e1g, const T* __restrict__ A2g,
    const T* __restrict__ b2g, const T* __restrict__ C2g,
    const T* __restrict__ J2g, const T* __restrict__ e2g, T* __restrict__ Ag,
    T* __restrict__ bg, T* __restrict__ Cg, T* __restrict__ Jg,
    T* __restrict__ eg, int M, int Ml, int Mr, int n, T* scratch,
    size_t ws_elems) {
  __shared__ int s_bad;
  __shared__ T s_eps;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t dd = size_t(n) * n;
  T* S0 = workspace(scratch, ws_elems);
  T* S1 = S0 + dd;
  T* S2 = S1 + dd;
  T* S3 = S2 + dd;
  T* S4 = S3 + dd;
  T* S5 = S4 + dd;
  T* v0 = S5 + dd;  // b1 + C1 η2
  T* v1 = v0 + n;   // η2 − J2 b1
  T* v2 = v1 + n;   // M⁻ᵀ (η2 − J2 b1)

  for (int m = blockIdx.x; m < M; m += gridDim.x) {
    const size_t l = Ml == M ? m : m % Ml;  // lane of the left operand
    const size_t r = Mr == M ? m : m % Mr;  // lane of the right operand
    const T* A1 = A1g + l * dd;
    const T* C1 = C1g + l * dd;
    const T* J1 = J1g + l * dd;
    const T* b1 = b1g + l * n;
    const T* e1 = e1g + l * n;
    const T* A2 = A2g + r * dd;
    const T* C2 = C2g + r * dd;
    const T* J2 = J2g + r * dd;
    const T* b2 = b2g + r * n;
    const T* e2 = e2g + r * n;

    // ε = 1e-7·tr(C1)/dx + 1e-30; S0 = the lower triangle of C1 + εI,
    // column-major, factored in place: U, zeroed unless every pivot is
    // positive (then M⁻¹ = I)
    if (tid == 0) {
      T tr = T(0);
      for (int i = 0; i < n; ++i) tr += C1[i * n + i];
      s_eps = T(1e-7) * tr / T(n) + T(1e-30);
    }
    __syncthreads();
    const T eps = s_eps;
    for (int idx = tid; idx < n * n; idx += nt) {
      const int j = idx / n, i = idx % n;
      S0[idx] = i >= j ? C1[i * n + j] + (i == j ? eps : T(0)) : T(0);
    }
    __syncthreads();
    block_cholesky_cm(S0, n, &s_bad, T(0));  // S0 = Uᵀ (row-major)
    block_transpose(S1, S0, n, n);           // S1 = U
    __syncthreads();
    block_mm_nn(S2, J2, S1, n, n, n);        // S2 = J2 U
    __syncthreads();
    block_mm_nn(S3, S0, S2, n, n, n);        // S3 = Uᵀ J2 U
    __syncthreads();

    // inner = I + sym(Uᵀ J2 U), symmetric, so its row-major storage is the
    // column-major lower triangle; factor in place (NaN on failure, as
    // cholesky_nan), then S4 = its L⁻¹ and S0 = inner⁻¹ = L⁻ᵀ L⁻¹
    for (int idx = tid; idx < n * n; idx += nt) {
      const int i = idx / n, j = idx % n;
      if (i < j) {
        const T v = T(0.5) * (S3[i * n + j] + S3[j * n + i]);
        S3[i * n + j] = v;
        S3[j * n + i] = v;
      } else if (i == j) {
        S3[idx] = T(0.5) * (S3[idx] + S3[idx]) + T(1);
      }
    }
    __syncthreads();
    block_cholesky_cm(S3, n, &s_bad, qnan<T>());
    block_tri_inv_cm(S4, S3, n);
    __syncthreads();
    block_mm_tn(S0, S4, S4, n, n, n);        // S0 = inner⁻¹
    block_transpose(S5, S2, n, n);           // S5 = (J2 U)ᵀ
    __syncthreads();

    // M⁻¹ = I − U inner⁻¹ (J2 U)ᵀ
    block_mm_nn(S3, S0, S5, n, n, n);        // S3 = V = inner⁻¹ (J2 U)ᵀ
    __syncthreads();
    block_mm_nn(S2, S1, S3, n, n, n);        // S2 = U V
    __syncthreads();
    for (int idx = tid; idx < n * n; idx += nt)
      S2[idx] = (idx / n == idx % n ? T(1) : T(0)) - S2[idx];  // S2 = M⁻¹
    __syncthreads();

    // A = (A2 M⁻¹) A1; the vectors b1 + C1 η2 and η2 − J2 b1
    block_mm_nn(S0, A2, S2, n, n, n);        // S0 = A2M = A2 M⁻¹
    for (int i = tid; i < n; i += nt) {
      T acc = b1[i];
      for (int k = 0; k < n; ++k) acc += C1[i * n + k] * e2[k];
      v0[i] = acc;
      T w = T(0);
      for (int k = 0; k < n; ++k) w += J2[i * n + k] * b1[k];
      v1[i] = e2[i] - w;
    }
    __syncthreads();
    block_mm_nn(Ag + size_t(m) * dd, S0, A1, n, n, n);

    // b = A2M (b1 + C1 η2) + b2;  v2 = M⁻ᵀ (η2 − J2 b1)
    for (int i = tid; i < n; i += nt) {
      T acc = T(0);
      for (int k = 0; k < n; ++k) acc += S0[i * n + k] * v0[k];
      bg[size_t(m) * n + i] = acc + b2[i];
      T t = T(0);
      for (int k = 0; k < n; ++k) t += S2[k * n + i] * v1[k];
      v2[i] = t;
    }
    // C = sym(A2M C1 A2ᵀ + C2)
    block_mm_nn(S3, S0, C1, n, n, n);        // S3 = A2M C1
    block_transpose(S4, A2, n, n);           // S4 = A2ᵀ
    __syncthreads();
    block_mm_nn(S5, S3, S4, n, n, n);        // S5 = A2M C1 A2ᵀ
    // η = A1ᵀ v2 + η1
    for (int i = tid; i < n; i += nt) {
      T acc = T(0);
      for (int k = 0; k < n; ++k) acc += A1[k * n + i] * v2[k];
      eg[size_t(m) * n + i] = acc + e1[i];
    }
    __syncthreads();
    T* C = Cg + size_t(m) * dd;
    for (int idx = tid; idx < n * n; idx += nt) {
      const int i = idx / n, j = idx % n;
      C[idx] = T(0.5) * ((S5[i * n + j] + S5[j * n + i])
                         + (C2[i * n + j] + C2[j * n + i]));
    }

    // J = sym(A1ᵀ (M⁻ᵀ J2) A1 + J1)
    block_mm_tn(S3, S2, J2, n, n, n);        // S3 = M⁻ᵀ J2
    __syncthreads();
    block_mm_nn(S4, S3, A1, n, n, n);        // S4 = M⁻ᵀ J2 A1
    __syncthreads();
    block_mm_tn(S5, A1, S4, n, n, n);        // S5 = A1ᵀ M⁻ᵀ J2 A1
    __syncthreads();
    T* J = Jg + size_t(m) * dd;
    for (int idx = tid; idx < n * n; idx += nt) {
      const int i = idx / n, j = idx % n;
      J[idx] = T(0.5) * ((S5[i * n + j] + S5[j * n + i])
                         + (J1[i * n + j] + J1[j * n + i]));
    }
    __syncthreads();
  }
}

// K11, block variant: the RTS elements of one lane per loop iteration.
template <typename T>
__global__ void __launch_bounds__(kBlockThreads) block_smoother_elements_kernel(
    const T* __restrict__ fmg, const T* __restrict__ fPg,
    const T* __restrict__ pmg, const T* __restrict__ pPg,
    const T* __restrict__ Fg, T* __restrict__ Eg, T* __restrict__ gg,
    T* __restrict__ Lg, int M, int f_banked, int n, T* scratch,
    size_t ws_elems) {
  __shared__ int s_bad;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t dd = size_t(n) * n;
  T* S0 = workspace(scratch, ws_elems);
  T* S1 = S0 + dd;
  T* S2 = S1 + dd;
  T* S3 = S2 + dd;

  for (int m = blockIdx.x; m < M; m += gridDim.x) {
    const T* Pp = pPg + size_t(m) * dd;
    const T* Pf = fPg + size_t(m) * dd;
    const T* F = Fg + (f_banked ? size_t(m) * dd : 0);
    const T* mf = fmg + size_t(m) * n;
    const T* mp = pmg + size_t(m) * n;

    // Lp = chol(Pp) in S0 (column-major, so S0 = Lpᵀ row-major), NaN unless
    // every pivot is positive; S1 = Lp⁻¹
    for (int idx = tid; idx < n * n; idx += nt) {
      const int j = idx / n, i = idx % n;
      S0[idx] = i >= j ? Pp[i * n + j] : T(0);
    }
    __syncthreads();
    block_cholesky_cm(S0, n, &s_bad, qnan<T>());
    block_tri_inv_cm(S1, S0, n);
    block_mm_nn(S2, F, Pf, n, n, n);         // S2 = F Pf
    __syncthreads();
    block_mm_nn(S3, S1, S2, n, n, n);        // S3 = Lp⁻¹ F Pf
    __syncthreads();
    block_mm_tn(S2, S1, S3, n, n, n);        // S2 = Gᵀ = Pp⁻¹ F Pf
    __syncthreads();

    // G = S2ᵀ; g = mf − G mp
    T* E = Eg + size_t(m) * dd;
    for (int idx = tid; idx < n * n; idx += nt)
      E[idx] = S2[(idx % n) * n + idx / n];
    for (int i = tid; i < n; i += nt) {
      T acc = T(0);
      for (int k = 0; k < n; ++k) acc += S2[k * n + i] * mp[k];
      gg[size_t(m) * n + i] = mf[i] - acc;
    }

    // L = sym(Pf) − sym((G Lp)(G Lp)ᵀ), with (G Lp)ᵀ = Lpᵀ Gᵀ
    block_mm_nn(S3, S0, S2, n, n, n);        // S3 = (G Lp)ᵀ
    __syncthreads();
    block_mm_tn(S1, S3, S3, n, n, n);        // S1 = (G Lp)(G Lp)ᵀ
    __syncthreads();
    T* L = Lg + size_t(m) * dd;
    for (int idx = tid; idx < n * n; idx += nt) {
      const int i = idx / n, j = idx % n;
      L[idx] = T(0.5) * (Pf[i * n + j] + Pf[j * n + i])
               - T(0.5) * (S1[i * n + j] + S1[j * n + i]);
    }
    __syncthreads();
  }
}

// K12, block variant: the smoothing combine of one lane per loop iteration.
template <typename T>
__global__ void __launch_bounds__(kBlockThreads) block_smoother_combine_kernel(
    const T* __restrict__ E1g, const T* __restrict__ g1g,
    const T* __restrict__ L1g, const T* __restrict__ E2g,
    const T* __restrict__ g2g, const T* __restrict__ L2g, T* __restrict__ Eg,
    T* __restrict__ gg, T* __restrict__ Lg, int M, int Ml, int Mr, int n,
    T* scratch, size_t ws_elems) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t dd = size_t(n) * n;
  T* S0 = workspace(scratch, ws_elems);
  T* S1 = S0 + dd;
  T* S2 = S1 + dd;

  for (int m = blockIdx.x; m < M; m += gridDim.x) {
    const size_t l = Ml == M ? m : m % Ml;
    const size_t r = Mr == M ? m : m % Mr;
    const T* E1 = E1g + l * dd;
    const T* L1 = L1g + l * dd;
    const T* g1 = g1g + l * n;
    const T* E2 = E2g + r * dd;
    const T* L2 = L2g + r * dd;
    const T* g2 = g2g + r * n;

    block_mm_nn(Eg + size_t(m) * dd, E1, E2, n, n, n);  // E = E1 E2
    for (int i = tid; i < n; i += nt) {                 // g = E1 g2 + g1
      T acc = T(0);
      for (int k = 0; k < n; ++k) acc += E1[i * n + k] * g2[k];
      gg[size_t(m) * n + i] = acc + g1[i];
    }
    block_mm_nn(S0, E1, L2, n, n, n);        // S0 = E1 L2
    block_transpose(S1, E1, n, n);           // S1 = E1ᵀ
    __syncthreads();
    block_mm_nn(S2, S0, S1, n, n, n);        // S2 = E1 L2 E1ᵀ
    __syncthreads();
    T* L = Lg + size_t(m) * dd;              // L = sym(E1 L2 E1ᵀ + L1)
    for (int idx = tid; idx < n * n; idx += nt) {
      const int i = idx / n, j = idx % n;
      L[idx] = T(0.5) * ((S2[i * n + j] + S2[j * n + i])
                         + (L1[i * n + j] + L1[j * n + i]));
    }
    __syncthreads();
  }
}

template <typename T, typename K, typename... Args>
int launch_block(K kernel, int kind, void* scratch, int M, int dx,
                 void* stream, Args... args) {
  int dev = 0, grid = 0;
  size_t smem = 0;
  long long need = 0;
  const size_t ws = block_ws(kind, dx);
  if (cudaGetDevice(&dev) != cudaSuccess ||
      !block_plan(kernel, ws, int(sizeof(T)), M, dev, &grid, &smem, &need) ||
      (need > 0 && scratch == nullptr))
    return int(cudaErrorInvalidValue);
  kernel<<<grid, kBlockThreads, smem, cudaStream_t(stream)>>>(
      args..., need > 0 ? static_cast<T*>(scratch) : nullptr, ws);
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

long long bft_block_scratch_elems(int kind, int M, int dx, int itemsize,
                                  int device) {
  return block_scratch_elems(block_ws(kind, dx), itemsize, M, device);
}

#define BFT_BLOCK_COMBINE_ENTRY(NAME, T)                                     \
  int NAME(const void* A1, const void* b1, const void* C1, const void* J1,   \
           const void* e1, const void* A2, const void* b2, const void* C2,   \
           const void* J2, const void* e2, void* A, void* b, void* C,        \
           void* J, void* e, void* scratch, int M, int Ml, int Mr, int dx,   \
           void* stream) {                                                   \
    using P = const T*;                                                      \
    return launch_block<T>(block_combine_kernel<T>, 0, scratch, M, dx,       \
                           stream, P(A1), P(b1), P(C1), P(J1), P(e1), P(A2), \
                           P(b2), P(C2), P(J2), P(e2), (T*)A, (T*)b, (T*)C,  \
                           (T*)J, (T*)e, M, Ml, Mr, dx);                     \
  }
BFT_BLOCK_COMBINE_ENTRY(bft_block_combine_f32, float)
BFT_BLOCK_COMBINE_ENTRY(bft_block_combine_f64, double)
#undef BFT_BLOCK_COMBINE_ENTRY

#define BFT_BLOCK_ELEMENTS_ENTRY(NAME, T)                                    \
  int NAME(const void* fm, const void* fP, const void* pm, const void* pP,   \
           const void* F, void* E, void* g, void* L, void* scratch, int M,   \
           int f_banked, int dx, void* stream) {                             \
    using P = const T*;                                                      \
    return launch_block<T>(block_smoother_elements_kernel<T>, 1, scratch, M, \
                           dx, stream, P(fm), P(fP), P(pm), P(pP), P(F),     \
                           (T*)E, (T*)g, (T*)L, M, f_banked, dx);            \
  }
BFT_BLOCK_ELEMENTS_ENTRY(bft_block_smoother_elements_f32, float)
BFT_BLOCK_ELEMENTS_ENTRY(bft_block_smoother_elements_f64, double)
#undef BFT_BLOCK_ELEMENTS_ENTRY

#define BFT_BLOCK_SCOMBINE_ENTRY(NAME, T)                                    \
  int NAME(const void* E1, const void* g1, const void* L1, const void* E2,   \
           const void* g2, const void* L2, void* E, void* g, void* L,        \
           void* scratch, int M, int Ml, int Mr, int dx, void* stream) {     \
    using P = const T*;                                                      \
    return launch_block<T>(block_smoother_combine_kernel<T>, 2, scratch, M,  \
                           dx, stream, P(E1), P(g1), P(L1), P(E2), P(g2),    \
                           P(L2), (T*)E, (T*)g, (T*)L, M, Ml, Mr, dx);       \
  }
BFT_BLOCK_SCOMBINE_ENTRY(bft_block_smoother_combine_f32, float)
BFT_BLOCK_SCOMBINE_ENTRY(bft_block_smoother_combine_f64, double)
#undef BFT_BLOCK_SCOMBINE_ENTRY

}  // extern "C"
