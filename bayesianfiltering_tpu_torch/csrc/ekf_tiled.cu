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
// Here every product is a tiled product over the whole card (tiled.cuh),
// and the factorisation is blocked so that only an nb × nb diagonal factor
// per panel stays serial:
//
// - Each entry point enqueues its launches on the caller's stream and
//   returns the first CUDA error. The per-element scratch comes from the
//   wrapper (a few MB at dx = 512, resident in L2).
// - The Cholesky is right-looking with panels of kNb = 32 columns: the
//   diagonal block is factored and inverted by one warp per element, a row
//   in each lane's registers (right-looking too: each column costs a
//   shuffle per row, not a dependent dot product); the column panel below
//   it is the product of that panel and the block's inverse transposed;
//   the trailing matrix takes a lower product update.
// - The factor is of the augmented matrix W = [S; (H P)ᵀ; innovᵀ; I]
//   ((2dy + dx + 1) × dy): below S the same panel steps carry the rows of
//   (H P)ᵀ, innovᵀ and I, so they come out as (L⁻¹ H P)ᵀ = Zᵀ, (L⁻¹ innov)ᵀ
//   = zᵀ and L⁻ᵀ. The forward substitutions are thus tiled products inside
//   the factorisation, and the gain is one more product, K = Zᵀ L⁻¹ =
//   (S⁻¹ H P)ᵀ. No thread walks a dy-long dependent chain.
// - The Joseph covariance is A P, then lower(A P Aᵀ + (K Rs) Kᵀ) mirrored,
//   two products of one pass; K2t is F_x P and F_q Q, then lower(F_x P F_xᵀ
//   + F_q Q F_qᵀ) mirrored.
//
// Math and constants follow ops/ekf.py chol_update_precomputed and
// predict_cov_precomputed: S is symmetrised before the relative floor
// (jitter + 1e-6·max|diag S|) is added, the covariance is the symmetrised
// Joseph form, the log-det comes from diag L, and a non-PD S gives NaN: a
// diagonal block with a non-positive (or NaN) pivot is set to NaN, which
// every later step carries into all outputs. Nothing here raises.
#include "common.cuh"
#include "tiled.cuh"

namespace {

using namespace bft;

constexpr int kNb = 32;  // Cholesky panel width: one warp's lanes
constexpr int kThreads = 256;

// Per-element scratch of K1t: W and L (the augmented matrix and its
// factor), the diagonal blocks' inverses, sym(Rt), A = I − K H, K Rs, A P.
struct UpdateScratch {
  long long rows, w, l, li, rs, a, kr, ap, total;
  UpdateScratch(int dx, int dy) {
    rows = 2LL * dy + dx + 1;
    w = 0;
    l = w + rows * dy;
    li = l + rows * dy;
    rs = li + 1LL * dy * kNb;
    a = rs + 1LL * dy * dy;
    kr = a + 1LL * dx * dx;
    ap = kr + 1LL * dx * dy;
    total = ap + 1LL * dx * dx;
  }
};

template <typename T>
__device__ T block_sum(T v, T* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  const T total = sh[0];
  __syncthreads();
  return total;
}

// S = sym(Rt) + G + (jitter + 1e-6·max|diag(G + Rt)|)·I into W's top
// square (lower part), from G = lower(H P Hᵀ) in L's top square; sym(Rt)
// into Rs; innovᵀ and the identity into W's last dy + 1 rows. Grid
// (blocks, batch); every block finds the floor itself (dy reads).
template <typename T>
__global__ void __launch_bounds__(kThreads) ekf_tiled_prep_kernel(
    T* scratch, const T* __restrict__ R_all, const T* __restrict__ inn_all,
    UpdateScratch sc, int B, int dx, int dy, T jitter) {
  __shared__ T s_floor;
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    T* ws = scratch + b * sc.total;
    T* W = ws + sc.w;
    const T* G = ws + sc.l;
    T* Rs = ws + sc.rs;
    const T* R = R_all + b * dy * dy;
    const T* inn = inn_all + b * dy;
    if (threadIdx.x < 32) {
      T mx = T(0);
      for (int i = threadIdx.x; i < dy; i += 32) {
        const T a = dabs(G[i * dy + i] + R[i * dy + i]);
        mx = a > mx ? a : mx;
      }
      for (int o = 16; o > 0; o >>= 1) {
        const T other = __shfl_xor_sync(0xffffffffu, mx, o);
        mx = other > mx ? other : mx;
      }
      if (threadIdx.x == 0) s_floor = jitter + T(kRelJitter) * mx;
    }
    __syncthreads();
    const long long eye = (long long)(dy + dx + 1) * dy;  // first I row
    const int stride = gridDim.x * blockDim.x;
    for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < dy * dy;
         idx += stride) {
      const int i = idx / dy, j = idx % dy;
      const T r = T(0.5) * (R[i * dy + j] + R[j * dy + i]);
      Rs[idx] = r;
      if (j < i) W[idx] = G[idx] + r;
      else if (j == i) W[idx] = (G[idx] + R[idx]) + s_floor;
      W[eye + idx] = i == j ? T(1) : T(0);
    }
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < dy; j += stride)
      W[(long long)(dy + dx) * dy + j] = inn[j];
    __syncthreads();
  }
}

// Panel k: the n × n diagonal block of W at (k, k) (n ≤ kNb) factored
// into L's diagonal block (zero strict upper part, NaN throughout unless
// every pivot is positive) and inverted into Li's rows k..k+n. One warp
// per element: lane i holds row i; at column j lane j's pivot and every
// lane's l_ij are shuffled to the lanes that update with them. The
// inverse is forward substitution, lane j solving column j against the
// factor in shared memory (broadcast reads).
template <typename T>
__global__ void __launch_bounds__(kNb) chol_diag_kernel(
    T* scratch, UpdateScratch sc, int B, int dy, int k, int n) {
  __shared__ T Ls[kNb][kNb + 1];
  const unsigned full = 0xffffffffu;
  const int i = threadIdx.x;
  for (long long b = blockIdx.x; b < B; b += gridDim.x) {
    T* ws = scratch + b * sc.total;
    const T* W = ws + sc.w + (long long)(k + i) * dy + k;
    T a[kNb];
#pragma unroll
    for (int c = 0; c < kNb; ++c)
      a[c] = i < n && c <= i ? W[c] : T(0);
    bool bad = false;
#pragma unroll
    for (int j = 0; j < kNb; ++j) {
      if (j >= n) break;
      const T d = __shfl_sync(full, a[j], j);
      bad = bad || !(d > T(0));
      const T ljj = dsqrt(d);
      const T lij = i == j ? ljj : (i > j ? a[j] / ljj : T(0));
      a[j] = lij;
#pragma unroll
      for (int c = j + 1; c < kNb; ++c) {
        const T lcj = __shfl_sync(full, lij, c);
        if (c <= i) a[c] -= lij * lcj;
      }
    }
#pragma unroll
    for (int c = 0; c < kNb; ++c) {
      if (bad) a[c] = qnan<T>();
      Ls[i][c] = a[c];
    }
    __syncwarp();
    T* L = ws + sc.l + (long long)(k + i) * dy + k;
#pragma unroll
    for (int c = 0; c < kNb; ++c)
      if (i < n && c < n) L[c] = a[c];
    // column j = i of L_kk⁻¹: x[r] = (δ_rj − Σ_{c<r} L[r][c] x[c]) / L[r][r]
    T x[kNb];
#pragma unroll
    for (int r = 0; r < kNb; ++r) {
      if (r >= n) break;
      T acc = r == i ? T(1) : T(0);
#pragma unroll
      for (int c = 0; c < r; ++c) acc -= Ls[r][c] * x[c];
      x[r] = acc / Ls[r][r];
    }
    T* Li = ws + sc.li + (long long)k * kNb;
#pragma unroll
    for (int r = 0; r < kNb; ++r)
      if (i < n && r < n) Li[r * kNb + i] = x[r];
    __syncwarp();
  }
}

// ll = log N(innov | 0, S) from diag L and z = L⁻¹ innov (row dy + dx of
// the factor). One block per element.
template <typename T>
__global__ void __launch_bounds__(kThreads) ekf_tiled_loglik_kernel(
    const T* scratch, T* ll_all, UpdateScratch sc, int B, int dx, int dy) {
  __shared__ T sh[kThreads];
  for (long long b = blockIdx.x; b < B; b += gridDim.x) {
    const T* L = scratch + b * sc.total + sc.l;
    const T* z = L + (long long)(dy + dx) * dy;
    T logdet = T(0), zsq = T(0);
    for (int i = threadIdx.x; i < dy; i += blockDim.x) {
      logdet += dlog(L[(long long)i * dy + i]);
      zsq += z[i] * z[i];
    }
    logdet = block_sum(logdet, sh);
    zsq = block_sum(zsq, sh);
    if (threadIdx.x == 0)
      ll_all[b] = T(-0.5) * (T(dy * kLog2Pi) + T(2) * logdet + zsq);
  }
}

int grid_1d(int B) { return B < 65535 ? B : 65535; }

template <typename T>
int launch_update_tiled(const void* m_, const void* P_, const void* H_,
                        const void* R_, const void* inn_, void* ll_,
                        void* mean_, void* cov_, void* K_, void* scratch_,
                        int B, int dx, int dy, double jitter, void* stream_) {
  const T* P = static_cast<const T*>(P_);
  const T* H = static_cast<const T*>(H_);
  T* K = static_cast<T*>(K_);
  T* ws = static_cast<T*>(scratch_);
  const cudaStream_t stream = cudaStream_t(stream_);
  const UpdateScratch sc(dx, dy);
  const long long st = sc.total, xx = 1LL * dx * dx, yx = 1LL * dy * dx;
  const long long zrow = 1LL * dy * dy;              // (H P)ᵀ, then Zᵀ
  const long long erow = (long long)(dy + dx + 1) * dy;  // I, then L⁻ᵀ
  int err = 0;
  auto run = [&](const Gemm<T>& g) {
    const int e = gemm(g, stream);
    if (err == 0) err = e;
  };
  auto check = [&]() {
    const int e = int(cudaGetLastError());
    if (err == 0) err = e;
  };

  // (H P)ᵀ = Pᵀ Hᵀ into W's rows dy..dy+dx; G = lower((H P) Hᵀ) into L's
  // top square
  run(gemm_of<T>(dx, dy, dx, B, {P, dx, xx, 1}, {H, dx, yx, 1},
                 ws + sc.w + zrow, dy, st));
  {
    Gemm<T> g = gemm_of<T>(dy, dy, dx, B, {ws + sc.w + zrow, dy, st, 1},
                           {H, dx, yx, 1}, ws + sc.l, dy, st);
    g.tri = kLower;
    run(g);
  }
  {
    const int blocks = (dy * dy + kThreads - 1) / kThreads;
    ekf_tiled_prep_kernel<T><<<dim3(blocks < 64 ? blocks : 64,
                                    grid_1d(B)), kThreads, 0, stream>>>(
        ws, static_cast<const T*>(R_), static_cast<const T*>(inn_), sc, B,
        dx, dy, T(jitter));
    check();
  }
  // blocked right-looking Cholesky of the augmented W
  for (int k = 0; k < dy; k += kNb) {
    const int n = dy - k < kNb ? dy - k : kNb;
    const long long below = k + n;                  // first row under the panel
    const int rest = int(sc.rows - below);          // rows under the panel
    chol_diag_kernel<T><<<grid_1d(B), kNb, 0, stream>>>(ws, sc, B, dy, k,
                                                        n);
    check();
    // L[below:, k:k+n] = W[below:, k:k+n] · (L_kk⁻¹)ᵀ
    run(gemm_of<T>(rest, n, n, B, {ws + sc.w + below * dy + k, dy, st, 0},
                   {ws + sc.li + 1LL * k * kNb, kNb, st, 1},
                   ws + sc.l + below * dy + k, dy, st));
    if (below < dy) {
      // W[below:, below:dy] −= L[below:, k:k+n] · L[below:dy, k:k+n]ᵀ
      const T* panel = ws + sc.l + below * dy + k;
      Gemm<T> g = gemm_of<T>(rest, int(dy - below), n, B, {panel, dy, st, 0},
                             {panel, dy, st, 1}, ws + sc.w + below * dy + below,
                             dy, st, T(-1));
      g.Cin = g.C; g.ldcin = dy; g.bcin = st; g.beta = T(1);
      g.tri = kLower;
      run(g);
    }
  }
  // K = Zᵀ L⁻¹ = Zᵀ (L⁻ᵀ)ᵀ
  run(gemm_of<T>(dx, dy, dy, B, {ws + sc.l + zrow, dy, st, 0},
                 {ws + sc.l + erow, dy, st, 1}, K, dy, 1LL * dx * dy));
  // ll; μ = m + K innov, a product with one column
  ekf_tiled_loglik_kernel<T><<<grid_1d(B), kThreads, 0, stream>>>(
      ws, static_cast<T*>(ll_), sc, B, dx, dy);
  check();
  {
    Gemm<T> g = gemm_of<T>(dx, 1, dy, B, {K, dy, yx, 0},
                           {static_cast<const T*>(inn_), 1, dy, 0},
                           static_cast<T*>(mean_), 1, dx);
    g.Cin = static_cast<const T*>(m_); g.ldcin = 1; g.bcin = dx;
    g.beta = T(1);
    run(g);
  }
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

template <typename T>
int launch_predict_tiled(const void* Fx_, const void* P_, const void* Fq_,
                         const void* Q_, void* cov_, void* scratch_, int B,
                         int dx, int dq, void* stream_) {
  const T* Fx = static_cast<const T*>(Fx_);
  const T* Fq = static_cast<const T*>(Fq_);
  T* FP = static_cast<T*>(scratch_);
  T* FQ = FP + 1LL * dx * dx;
  const cudaStream_t stream = cudaStream_t(stream_);
  const long long st = 1LL * dx * dx + 1LL * dx * dq;
  const long long xx = 1LL * dx * dx, xq = 1LL * dx * dq;
  int err = gemm(gemm_of<T>(dx, dx, dx, B, {Fx, dx, xx, 0},
                            {static_cast<const T*>(P_), dx, xx, 0}, FP, dx,
                            st),
                 stream);
  // Q is shared by the batch: batch stride 0
  const int e2 = gemm(gemm_of<T>(dx, dq, dq, B, {Fq, dq, xq, 0},
                                 {static_cast<const T*>(Q_), dq, 0, 0}, FQ,
                                 dq, st),
                      stream);
  if (err == 0) err = e2;
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
  return UpdateScratch(dx, dy).total;
}

long long bft_ekf_predict_cov_tiled_scratch_elems(int dx, int dq) {
  return 1LL * dx * dx + 1LL * dx * dq;
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
