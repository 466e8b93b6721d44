// Unscented-transform kernels: sigma points (K6), augmented sigma points
// (K7), the UT measurement update (K8) and the UT predict moments (K9).
//
// Replace the TPU kernels of bayesianfiltering_tpu/ops/fused_ut.py:
// `_sigma_kernel` (K6), `_sigma_aug_kernel` (K7), `_ut_update_kernel` (K8)
// and `_ut_predict_kernel` (K9). The TPU versions are single-stream (a
// vmapped pallas_call runs its grid serially, so the TPU package turns them
// off for banks and batches). These take a leading batch axis, one thread
// block per batch element or mixture component, so the batched UKF and the
// UGSF/UAGSF banks run through them. The model evaluations f(pts) and
// h(pts) stay outside, in PyTorch; the kernels bracket them.
//
// What bounds them on an H100. The sigma factor is a dependent chain: the
// Cholesky closes one column per block barrier (n barriers), and the
// Newton–Schulz root is 14 rounds of 3 dependent n×n products (42 products,
// 84 n³ flops: at n=64, B=512 about 11 GFLOP per launch, the heaviest
// arithmetic of the UKF path). The moments (K8, K9) are 2n-row reductions
// (rows·d² flops) over sigma-point tensors that do not fit one block's
// shared memory (2,048 rows × 1,024 columns at the band edge). Every
// product is
// far too small per block to feed the tensor cores, and TF32 is off by the
// precision policy, so all arithmetic runs on the CUDA cores in the working
// type; each block is bound by shared-memory bandwidth in its products and
// by barrier latency in its factorisations.
//
// What the simple design does about it:
// - One workspace per block in dynamic shared memory (opted in above 48 KB).
//   K6 and K7 fall back to a global scratch from the caller, B workspaces,
//   when it exceeds the opt-in limit (the Cholesky above n = 170 in float64
//   and 240 in float32, Newton–Schulz above 85 and 120); their band reaches
//   every dimension ≤ 1,024 (the Lorenz-96 dx=512 configuration, additive
//   and augmented), where one element is one block on one of the card's
//   132 SMs, so a single sequence (B = 1) leaves the rest of the card idle.
//   K8 and K9 stop where their workspace stops fitting in shared memory
//   (K9 above dx = 232 in float32 and 161 in float64; K8 at config 5's
//   dx = 512, dy = 256): there ops/fused_ut.py runs their tiled variants
//   K8t and K9t (ut_tiled.cu), products and a blocked Cholesky spread
//   over the whole card.
// - Products follow fused_ekf.cu's layout rule: consecutive threads own
//   consecutive output columns, so one operand is a broadcast and the other
//   consecutive words.
// - The Cholesky factors in place in one n×n buffer that holds P
//   column-major, one barrier per column, and NaNs the whole factor unless
//   every pivot is positive (torch.linalg.cholesky_ex's info, which the
//   plain versions turn into NaN).
// - Sigma-point rows are streamed from global memory in chunks of
//   kRowChunk rows, centred once as they are staged, and the moment sums
//   accumulate in shared memory.
// - K7's noise covariance C is shared by the whole batch: its factor is
//   computed once per launch (one extra one-block launch,
//   ut_noise_sigma_kernel, into a small buffer), not once per block; the
//   points kernel then only factors P.
//
// Math and constants follow ops/fused_ut.py's plain versions: the weights
// (w_side, w0m, w0c) and the scale come from the wrapper; S is symmetrised
// before the relative floor 1e-6·max|diag S|; the covariance downdate is
// the grouped Joseph form P − KC − (KC)ᵀ + (KL)(KL)ᵀ; K8 takes μy and the
// innovation from the wrapper, which applies a model's residual function.
#include "common.cuh"

namespace {

using namespace bft;

constexpr int kUtThreads = 256;
constexpr int kRowChunk = 16;  // sigma-point rows staged per pass
constexpr int kNsIters = 14;   // utils/linalg.py sqrtm_psd_ns
constexpr int kCholesky = 0;   // ops/fused_ut.py _METHODS
constexpr int kSqrtm = 1;

size_t factor_ws_elems(int n, int method) {
  return size_t(n) * n * (method == kSqrtm ? 4 : 1);
}

size_t update_ws_elems(int dx, int dy) {
  return size_t(dy) * dy * 2          // S (factored in place), L⁻¹
         + size_t(dy) * dx * 3        // C, Z (later KLᵀ), W = Kᵀ
         + size_t(kRowChunk) * (dx + dy)  // staged centred rows
         + size_t(dy) * 4 + dx;       // μy, d0, innovation, z; m
}

size_t predict_ws_elems(int dx) {
  return size_t(dx) * dx + size_t(kRowChunk) * dx + 2 * size_t(dx);
}

// Workspace plan of a K6/K7 launch: dynamic shared memory, or the caller's
// scratch when the workspace exceeds the opt-in limit. False when that
// scratch is missing or the device query failed.
template <typename T>
bool plan(size_t ws, T* scratch, size_t* smem, T** use_scratch) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  const long long need = scratch_elems(ws, int(sizeof(T)), dev);
  if (need < 0 || (need > 0 && scratch == nullptr)) return false;
  *smem = need ? 0 : ws * sizeof(T);
  *use_scratch = need ? scratch : nullptr;
  return true;
}

// The sigma-point factor of the n×n matrix P (global, row-major), stored
// transposed: F[k*n + i] = L[i][k] for the Cholesky factor, or the
// symmetric Newton–Schulz root. ws holds factor_ws_elems(n, method)
// elements; the returned F points into it. Ends synchronised.
template <typename T>
__device__ T* block_factor(const T* P, int n, int method, T* ws, int* s_bad,
                           T* s_trace) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (method == kCholesky) {
    // Lc[j*n + i] = P[i][j]: the lower triangle, column-major
    for (int idx = tid; idx < n * n; idx += nt) {
      const int j = idx / n, i = idx % n;
      ws[idx] = i >= j ? P[i * n + j] : T(0);
    }
    __syncthreads();
    block_cholesky_cm(ws, n, s_bad, qnan<T>());
    return ws;
  }
  // Trace-normalised coupled Newton–Schulz: T = (3I − Z Y)/2, Y ← Y T,
  // Z ← T Z, root = sym(Y·√s), with Y = sym(P)/s, Z = I, s = tr P + 1e-30.
  T* Y = ws;
  T* Z = Y + n * n;
  T* Tm = Z + n * n;
  T* W = Tm + n * n;
  if (tid == 0) {
    T s = T(0);
    for (int i = 0; i < n; ++i) s += P[i * n + i];
    *s_trace = s + T(1e-30);
  }
  __syncthreads();
  const T s = *s_trace;
  for (int idx = tid; idx < n * n; idx += nt) {
    const int i = idx / n, j = idx % n;
    Y[idx] = (T(0.5) * (P[i * n + j] + P[j * n + i])) / s;
    Z[idx] = i == j ? T(1) : T(0);
  }
  __syncthreads();
  for (int it = 0; it < kNsIters; ++it) {
    for (int idx = tid; idx < n * n; idx += nt) {
      const int i = idx / n, j = idx % n;
      T acc = T(0);
      for (int k = 0; k < n; ++k) acc += Z[i * n + k] * Y[k * n + j];
      Tm[idx] = T(0.5) * ((i == j ? T(3) : T(0)) - acc);
    }
    __syncthreads();
    block_mm_nn(W, Y, Tm, n, n, n);
    __syncthreads();
    T* t = Y; Y = W; W = t;
    block_mm_nn(W, Tm, Z, n, n, n);
    __syncthreads();
    t = Z; Z = W; W = t;
  }
  const T rs = dsqrt(s);
  for (int idx = tid; idx < n * n; idx += nt) {
    const int i = idx / n, j = idx % n;
    Tm[idx] = T(0.5) * (Y[i * n + j] * rs + Y[j * n + i] * rs);
  }
  __syncthreads();
  return Tm;
}

// pts[b] = [m + scale·Fᵀ; m − scale·Fᵀ], (2n, n) for this block's element.
template <typename T>
__device__ void sigma_block(const T* __restrict__ m_all,
                            const T* __restrict__ P_all, T* pts_all,
                            T* scratch, size_t ws_elems, int n, T scale,
                            int method) {
  __shared__ int s_bad;
  __shared__ T s_trace;
  const size_t b = blockIdx.x;
  const T* m = m_all + b * n;
  T* pts = pts_all + b * 2 * n * n;
  const T* F = block_factor(P_all + b * n * n, n, method,
                            workspace(scratch, ws_elems), &s_bad, &s_trace);
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const T off = scale * F[idx];
    const T mi = m[idx % n];
    pts[idx] = mi + off;
    pts[n * n + idx] = mi - off;
  }
}

// K6: one block per batch element.
template <typename T>
__global__ void __launch_bounds__(kUtThreads) ut_sigma_kernel(
    const T* __restrict__ m_all, const T* __restrict__ P_all, T* pts_all,
    T* scratch, size_t ws_elems, int n, T scale, int method) {
  sigma_block(m_all, P_all, pts_all, scratch, ws_elems, n, scale, method);
}

// K7's first launch: the points of the shared noise block (bias, C), one
// block. A symbol of its own, so that a profile charges it to K7, not K6.
template <typename T>
__global__ void __launch_bounds__(kUtThreads) ut_noise_sigma_kernel(
    const T* __restrict__ bias, const T* __restrict__ C, T* noise_pts,
    T* scratch, size_t ws_elems, int dn, T scale, int method) {
  sigma_block(bias, C, noise_pts, scratch, ws_elems, dn, scale, method);
}

// K7: augmented points of N([m; bias], blkdiag(P, C)), (2na, na) per
// element, na = dx + dn. noise_pts = [bias + scale·F_Cᵀ; bias − scale·F_Cᵀ]
// (2dn, dn), made once per launch by ut_noise_sigma_kernel.
template <typename T>
__global__ void __launch_bounds__(kUtThreads) ut_sigma_aug_kernel(
    const T* __restrict__ m_all, const T* __restrict__ P_all,
    const T* __restrict__ bias, const T* __restrict__ noise_pts, T* pts_all,
    T* scratch, size_t ws_elems, int dx, int dn, T scale, int method) {
  __shared__ int s_bad;
  __shared__ T s_trace;
  const size_t b = blockIdx.x;
  const int na = dx + dn;
  const T* m = m_all + b * dx;
  T* pts = pts_all + b * 2 * na * na;
  const T* F = block_factor(P_all + b * dx * dx, dx, method,
                            workspace(scratch, ws_elems), &s_bad, &s_trace);
  for (int idx = threadIdx.x; idx < 2 * na * na; idx += blockDim.x) {
    const int r = idx / na, c = idx % na;
    const bool minus = r >= na;
    const int rr = minus ? r - na : r;
    T v;
    if (rr < dx) {  // state row: m ± scale·F row rr, then the bias
      if (c < dx) {
        const T off = scale * F[rr * dx + c];
        v = minus ? m[c] - off : m[c] + off;
      } else {
        v = bias[c - dx];
      }
    } else {        // noise row: m, then bias ± scale·F_C row rr − dx
      v = c < dx ? m[c]
                 : noise_pts[((minus ? dn : 0) + rr - dx) * dn + (c - dx)];
    }
    pts[idx] = v;
  }
}

// K8: the UT measurement update of one element from its sigma points pts
// (rows × ld, state in the first dx columns), their images hpts (rows ×
// dy), the image of the mean (center), μy and the innovation.
template <typename T>
__global__ void __launch_bounds__(kUtThreads) ut_update_kernel(
    const T* __restrict__ pts_all, const T* __restrict__ hpts_all,
    const T* __restrict__ center_all, const T* __restrict__ mu_all,
    const T* __restrict__ m_all, const T* __restrict__ P_all,
    const T* __restrict__ R, const T* __restrict__ inn_all, T* ll_all,
    T* mean_all, T* cov_all, int rows, int ld, int dx, int dy, T w_side,
    T w0c) {
  __shared__ int s_bad;
  __shared__ T s_floor;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const T* pts = pts_all + b * rows * ld;
  const T* hp = hpts_all + b * rows * dy;
  const T* P = P_all + b * dx * dx;
  T* cov = cov_all + b * dx * dx;

  T* ws = shared_workspace<T>();
  T* S = ws;                    // dy × dy; factored in place (column-major L)
  T* Li = S + dy * dy;          // dy × dy, lower, row-major
  T* C = Li + dy * dy;          // dy × dx cross-covariance
  T* Z = C + dy * dx;           // dy × dx: L⁻¹ C, then KLᵀ
  T* W = Z + dy * dx;           // dy × dx: Kᵀ = S⁻¹ C
  T* Hc = W + dy * dx;          // kRowChunk × dy staged hpts − μy
  T* Xc = Hc + kRowChunk * dy;  // kRowChunk × dx staged pts − m
  T* mu = Xc + kRowChunk * dx;  // dy
  T* d0 = mu + dy;              // dy, center − μy
  T* inn = d0 + dy;             // dy
  T* zv = inn + dy;             // dy, L⁻¹ innovation
  T* mx = zv + dy;              // dx

  // 1. vectors; clear the accumulators
  for (int i = tid; i < dy; i += nt) {
    const T u = mu_all[b * dy + i];
    mu[i] = u;
    d0[i] = center_all[b * dy + i] - u;
    inn[i] = inn_all[b * dy + i];
  }
  for (int i = tid; i < dx; i += nt) mx[i] = m_all[b * dx + i];
  for (int idx = tid; idx < dy * dy; idx += nt) S[idx] = T(0);
  for (int idx = tid; idx < dy * dx; idx += nt) C[idx] = T(0);
  __syncthreads();

  // 2. S += Σ cen cenᵀ and C += Σ cen (x − m)ᵀ over staged row chunks
  for (int r0 = 0; r0 < rows; r0 += kRowChunk) {
    const int nr = min(kRowChunk, rows - r0);
    for (int idx = tid; idx < nr * dy; idx += nt) {
      const int r = idx / dy, a = idx % dy;
      Hc[idx] = hp[(r0 + r) * dy + a] - mu[a];
    }
    for (int idx = tid; idx < nr * dx; idx += nt) {
      const int r = idx / dx, j = idx % dx;
      Xc[idx] = pts[size_t(r0 + r) * ld + j] - mx[j];
    }
    __syncthreads();
    for (int idx = tid; idx < dy * dy; idx += nt) {
      const int a = idx / dy, c = idx % dy;
      T acc = T(0);
      for (int r = 0; r < nr; ++r) acc += Hc[r * dy + a] * Hc[r * dy + c];
      S[idx] += acc;
    }
    for (int idx = tid; idx < dy * dx; idx += nt) {
      const int a = idx / dx, j = idx % dx;
      T acc = T(0);
      for (int r = 0; r < nr; ++r) acc += Hc[r * dy + a] * Xc[r * dx + j];
      C[idx] += acc;
    }
    __syncthreads();
  }

  // 3. weights and R; then S = sym(S) in place by pairs
  for (int idx = tid; idx < dy * dy; idx += nt) {
    const int a = idx / dy, c = idx % dy;
    T v = w_side * S[idx] + w0c * (d0[a] * d0[c]);
    if (R != nullptr) v += R[idx];
    S[idx] = v;
  }
  for (int idx = tid; idx < dy * dx; idx += nt) C[idx] = w_side * C[idx];
  __syncthreads();
  for (int idx = tid; idx < dy * dy; idx += nt) {
    const int i = idx / dy, j = idx % dy;
    if (i < j) {
      const T v = T(0.5) * (S[i * dy + j] + S[j * dy + i]);
      S[i * dy + j] = v;
      S[j * dy + i] = v;
    }
  }
  __syncthreads();

  // 4. relative diagonal floor
  if (tid == 0) {
    T mxd = T(0);
    for (int i = 0; i < dy; ++i) {
      const T a = dabs(S[i * dy + i]);
      mxd = a > mxd ? a : mxd;
    }
    s_floor = T(kRelJitter) * mxd;
  }
  __syncthreads();
  for (int i = tid; i < dy; i += nt) S[i * dy + i] += s_floor;
  __syncthreads();

  // 5. Cholesky in place (S is symmetric, so its row-major storage is the
  //    column-major lower triangle), then L⁻¹ by whole-column substitution
  block_cholesky_cm(S, dy, &s_bad, qnan<T>());
  const T* Lc = S;
  block_tri_inv_cm(Li, Lc, dy);
  __syncthreads();

  // 6. Z = L⁻¹ C, then Kᵀ = W = L⁻ᵀ Z = S⁻¹ C
  for (int idx = tid; idx < dy * dx; idx += nt) {
    const int i = idx / dx, c = idx % dx;
    T acc = T(0);
    for (int j = 0; j <= i; ++j) acc += Li[i * dy + j] * C[j * dx + c];
    Z[idx] = acc;
  }
  __syncthreads();
  for (int idx = tid; idx < dy * dx; idx += nt) {
    const int i = idx / dx, c = idx % dx;
    T acc = T(0);
    for (int j = i; j < dy; ++j) acc += Li[j * dy + i] * Z[j * dx + c];
    W[idx] = acc;
  }
  __syncthreads();

  // 7. (K L)ᵀ into Z: KLᵀ[c][i] = Σ_{l ≥ c} K[i][l] L[l][c]
  for (int idx = tid; idx < dy * dx; idx += nt) {
    const int c = idx / dx, i = idx % dx;
    T acc = T(0);
    for (int l = c; l < dy; ++l) acc += W[l * dx + i] * Lc[c * dy + l];
    Z[idx] = acc;
  }
  __syncthreads();

  // 8. Σ = P − KC − (KC)ᵀ + (KL)(KL)ᵀ, then symmetrised in place
  for (int idx = tid; idx < dx * dx; idx += nt) {
    const int i = idx / dx, j = idx % dx;
    T kc = T(0), kct = T(0), klk = T(0);
    for (int l = 0; l < dy; ++l) {
      kc += W[l * dx + i] * C[l * dx + j];
      kct += W[l * dx + j] * C[l * dx + i];
      klk += Z[l * dx + i] * Z[l * dx + j];
    }
    cov[idx] = P[idx] - kc - kct + klk;
  }
  __syncthreads();
  block_symmetrize(cov, dx);

  // 9. μ = m + K innov and z = L⁻¹ innov
  for (int i = tid; i < dx; i += nt) {
    T acc = T(0);
    for (int l = 0; l < dy; ++l) acc += W[l * dx + i] * inn[l];
    mean_all[b * dx + i] = mx[i] + acc;
  }
  for (int i = tid; i < dy; i += nt) {
    T acc = T(0);
    for (int j = 0; j <= i; ++j) acc += Li[i * dy + j] * inn[j];
    zv[i] = acc;
  }
  __syncthreads();

  // 10. log N(innov | 0, S) on the same factor
  if (tid == 0) {
    T logdet = T(0), zsq = T(0);
    for (int i = 0; i < dy; ++i) {
      logdet += dlog(Lc[i * dy + i]);
      zsq += zv[i] * zv[i];
    }
    ll_all[b] = T(-0.5) * (T(dy * kLog2Pi) + T(2) * logdet + zsq);
  }
}

// K9: μ = w_side·Σ fpts + w0m·center, Σ = sym(w_side·Σ ccᵀ + w0c·d0 d0ᵀ
// (+ Q)) for one element's propagated points fpts (rows × dx).
template <typename T>
__global__ void __launch_bounds__(kUtThreads) ut_predict_kernel(
    const T* __restrict__ fpts_all, const T* __restrict__ center_all,
    const T* __restrict__ Q, T* mu_all, T* cov_all, int rows, int dx,
    T w_side, T w0m, T w0c) {
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const T* fp = fpts_all + b * rows * dx;
  T* cov = cov_all + b * dx * dx;

  T* ws = shared_workspace<T>();
  T* acc = ws;                  // dx × dx
  T* Xc = acc + dx * dx;        // kRowChunk × dx staged fpts − μ
  T* mu = Xc + kRowChunk * dx;  // dx
  T* d0 = mu + dx;              // dx, center − μ

  for (int j = tid; j < dx; j += nt) {
    T s = T(0);
    for (int r = 0; r < rows; ++r) s += fp[r * dx + j];
    const T c = center_all[b * dx + j];
    const T u = w_side * s + w0m * c;
    mu[j] = u;
    d0[j] = c - u;
    mu_all[b * dx + j] = u;
  }
  for (int idx = tid; idx < dx * dx; idx += nt) acc[idx] = T(0);
  __syncthreads();

  for (int r0 = 0; r0 < rows; r0 += kRowChunk) {
    const int nr = min(kRowChunk, rows - r0);
    for (int idx = tid; idx < nr * dx; idx += nt) {
      const int r = idx / dx, j = idx % dx;
      Xc[idx] = fp[(r0 + r) * dx + j] - mu[j];
    }
    __syncthreads();
    for (int idx = tid; idx < dx * dx; idx += nt) {
      const int i = idx / dx, j = idx % dx;
      T a = T(0);
      for (int r = 0; r < nr; ++r) a += Xc[r * dx + i] * Xc[r * dx + j];
      acc[idx] += a;
    }
    __syncthreads();
  }

  for (int idx = tid; idx < dx * dx; idx += nt) {
    const int i = idx / dx, j = idx % dx;
    T v = w_side * acc[idx] + w0c * (d0[i] * d0[j]);
    if (Q != nullptr) v += Q[idx];
    acc[idx] = v;
  }
  __syncthreads();
  for (int idx = tid; idx < dx * dx; idx += nt) {
    const int i = idx / dx, j = idx % dx;
    cov[idx] = T(0.5) * (acc[i * dx + j] + acc[j * dx + i]);
  }
}

template <typename T, typename K>
int launch_sigma(K kernel, const void* m, const void* P, void* pts,
                 void* scratch, int B, int n, double scale, int method,
                 cudaStream_t stream) {
  const size_t ws = factor_ws_elems(n, method);
  size_t smem = 0;
  T* scr = nullptr;
  if (!plan(ws, static_cast<T*>(scratch), &smem, &scr))
    return int(cudaErrorInvalidValue);
  if (int err = set_smem(kernel, smem)) return err;
  kernel<<<B, kUtThreads, smem, stream>>>(
      static_cast<const T*>(m), static_cast<const T*>(P),
      static_cast<T*>(pts), scr, ws, n, T(scale), method);
  return int(cudaGetLastError());
}

template <typename T>
int launch_sigma_aug(const void* m, const void* P, const void* bias,
                     const void* C, void* pts, void* noise_pts, void* scratch,
                     int B, int dx, int dn, double scale, int method,
                     cudaStream_t stream) {
  // the shared noise block's points, once per launch
  if (int err = launch_sigma<T>(ut_noise_sigma_kernel<T>, bias, C, noise_pts,
                                scratch, 1, dn, scale, method, stream))
    return err;
  const size_t ws = factor_ws_elems(dx, method);
  size_t smem = 0;
  T* scr = nullptr;
  if (!plan(ws, static_cast<T*>(scratch), &smem, &scr))
    return int(cudaErrorInvalidValue);
  if (int err = set_smem(ut_sigma_aug_kernel<T>, smem)) return err;
  ut_sigma_aug_kernel<T><<<B, kUtThreads, smem, stream>>>(
      static_cast<const T*>(m), static_cast<const T*>(P),
      static_cast<const T*>(bias), static_cast<const T*>(noise_pts),
      static_cast<T*>(pts), scr, ws, dx, dn, T(scale), method);
  return int(cudaGetLastError());
}

template <typename T>
int launch_update(const void* pts, const void* hpts, const void* center,
                  const void* mu, const void* m, const void* P, const void* R,
                  const void* inn, void* ll, void* mean, void* cov, int B,
                  int rows, int ld, int dx, int dy, double w_side, double w0c,
                  cudaStream_t stream) {
  const size_t smem = update_ws_elems(dx, dy) * sizeof(T);
  if (int err = set_smem(ut_update_kernel<T>, smem)) return err;
  ut_update_kernel<T><<<B, kUtThreads, smem, stream>>>(
      static_cast<const T*>(pts), static_cast<const T*>(hpts),
      static_cast<const T*>(center), static_cast<const T*>(mu),
      static_cast<const T*>(m), static_cast<const T*>(P),
      static_cast<const T*>(R), static_cast<const T*>(inn),
      static_cast<T*>(ll), static_cast<T*>(mean), static_cast<T*>(cov), rows,
      ld, dx, dy, T(w_side), T(w0c));
  return int(cudaGetLastError());
}

template <typename T>
int launch_predict(const void* fpts, const void* center, const void* Q,
                   void* mu, void* cov, int B, int rows, int dx,
                   double w_side, double w0m, double w0c,
                   cudaStream_t stream) {
  const size_t smem = predict_ws_elems(dx) * sizeof(T);
  if (int err = set_smem(ut_predict_kernel<T>, smem)) return err;
  ut_predict_kernel<T><<<B, kUtThreads, smem, stream>>>(
      static_cast<const T*>(fpts), static_cast<const T*>(center),
      static_cast<const T*>(Q), static_cast<T*>(mu), static_cast<T*>(cov),
      rows, dx, T(w_side), T(w0m), T(w0c));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

long long bft_ut_sigma_scratch_elems(int n, int method, int itemsize,
                                     int device) {
  return bft::scratch_elems(factor_ws_elems(n, method), itemsize, device);
}

int bft_ut_sigma_f32(const void* m, const void* P, void* pts, void* scratch,
                     int B, int n, double scale, int method, void* stream) {
  return launch_sigma<float>(ut_sigma_kernel<float>, m, P, pts, scratch, B,
                             n, scale, method, cudaStream_t(stream));
}

int bft_ut_sigma_f64(const void* m, const void* P, void* pts, void* scratch,
                     int B, int n, double scale, int method, void* stream) {
  return launch_sigma<double>(ut_sigma_kernel<double>, m, P, pts, scratch, B,
                              n, scale, method, cudaStream_t(stream));
}

int bft_ut_sigma_aug_f32(const void* m, const void* P, const void* bias,
                         const void* C, void* pts, void* noise_pts,
                         void* scratch, int B, int dx, int dn, double scale,
                         int method, void* stream) {
  return launch_sigma_aug<float>(m, P, bias, C, pts, noise_pts, scratch, B,
                                 dx, dn, scale, method, cudaStream_t(stream));
}

int bft_ut_sigma_aug_f64(const void* m, const void* P, const void* bias,
                         const void* C, void* pts, void* noise_pts,
                         void* scratch, int B, int dx, int dn, double scale,
                         int method, void* stream) {
  return launch_sigma_aug<double>(m, P, bias, C, pts, noise_pts, scratch, B,
                                  dx, dn, scale, method,
                                  cudaStream_t(stream));
}

int bft_ut_update_f32(const void* pts, const void* hpts, const void* center,
                      const void* mu, const void* m, const void* P,
                      const void* R, const void* inn, void* ll, void* mean,
                      void* cov, int B, int rows, int ld, int dx, int dy,
                      double w_side, double w0c, void* stream) {
  return launch_update<float>(pts, hpts, center, mu, m, P, R, inn, ll, mean,
                              cov, B, rows, ld, dx, dy, w_side, w0c,
                              cudaStream_t(stream));
}

int bft_ut_update_f64(const void* pts, const void* hpts, const void* center,
                      const void* mu, const void* m, const void* P,
                      const void* R, const void* inn, void* ll, void* mean,
                      void* cov, int B, int rows, int ld, int dx, int dy,
                      double w_side, double w0c, void* stream) {
  return launch_update<double>(pts, hpts, center, mu, m, P, R, inn, ll, mean,
                               cov, B, rows, ld, dx, dy, w_side, w0c,
                               cudaStream_t(stream));
}

int bft_ut_predict_f32(const void* fpts, const void* center, const void* Q,
                       void* mu, void* cov, int B, int rows, int dx,
                       double w_side, double w0m, double w0c, void* stream) {
  return launch_predict<float>(fpts, center, Q, mu, cov, B, rows, dx, w_side,
                               w0m, w0c, cudaStream_t(stream));
}

int bft_ut_predict_f64(const void* fpts, const void* center, const void* Q,
                       void* mu, void* cov, int B, int rows, int dx,
                       double w_side, double w0m, double w0c, void* stream) {
  return launch_predict<double>(fpts, center, Q, mu, cov, B, rows, dx,
                                w_side, w0m, w0c, cudaStream_t(stream));
}

}  // extern "C"
