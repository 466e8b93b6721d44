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
// Cholesky of P, or the Newton–Schulz root, 14 rounds of 3 dependent n×n
// products (42 products, 84 n³ flops: at n=64, B=512 about 11 GFLOP per
// launch, the heaviest arithmetic of the UKF path). K6 and K7 write
// 2n × n (2na × na) points per element: at the Lorenz-96 batch (B = 512,
// n = 64, na = 128) K7's 64 MB of points is its bound. The moments (K8,
// K9) are 2n-row reductions (rows·d² flops) over sigma-point tensors that
// do not fit one block's shared memory (2,048 rows × 1,024 columns at the
// band edge). Every product is far too small per block to feed the tensor
// cores, and TF32 is off by the precision policy, so all arithmetic runs
// on the CUDA cores in the working type; each block is bound by
// shared-memory bandwidth in its products and by barrier latency in its
// factorisations.
//
// What the design does about it:
// - One workspace per block in dynamic shared memory (opted in above
//   48 KB), addressed as shared memory only. Where it does not fit (the
//   Cholesky above n = 240 in float32 and 170 in float64, Newton–Schulz
//   above 120 and 85; config 5's n = 512), ops/fused_ut.py runs the tiled
//   variants K6t/K7t (sigma_tiled.cu) instead, and K8/K9 hand over to
//   K8t/K9t (ut_tiled.cu) where theirs does not (K9 above dx = 232 in
//   float32 and 161 in float64; K8 at config 5's dx = 512, dy = 256).
// - The Cholesky factors P in place, held column-major, right-looking in
//   panels of 32 (common.cuh block_cholesky_panels): one warp factors the
//   diagonal block in registers, each thread substitutes whole rows of the
//   panel below it, and the block applies the trailing update: three
//   barriers a panel where a left-looking factor takes one a column.
//   Unless every pivot is positive the points that the factor enters are
//   NaN (torch.linalg.cholesky_ex's info, which the plain versions turn
//   into NaN).
// - The points are written row-major, 16 bytes a store (float4, double2)
//   where the widths allow, one rectangle at a time, so that the
//   broadcast blocks of K7 (the bias columns of the state rows, the mean
//   columns of the noise rows) cost no division or branch per entry.
// - Products follow fused_ekf.cu's layout rule: consecutive threads own
//   consecutive output columns, so one operand is a broadcast and the other
//   consecutive words.
// - Sigma-point rows are streamed from global memory in chunks of
//   kRowChunk rows, centred once as they are staged, and the moment sums
//   accumulate in shared memory.
// - K7's noise covariance C is shared by the whole batch: its points are
//   computed once per launch (one extra one-block launch,
//   ut_noise_sigma_kernel, into a small buffer). The points kernel is its
//   programmatic dependent (a Hopper launch attribute), so it starts at
//   once: each block stores the blocks that need no factor, stages P, and
//   waits for the noise points only then; it copies them into its shared
//   memory once and stores them while its factor of P runs.
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

__host__ __device__ size_t factor_ws_elems(int n, int method) {
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

// The sigma-point factor of the n×n matrix P (global, row-major) in the
// block's workspace ws (factor_ws_elems(n, method) elements), stored
// transposed: F[k*n + i] = L[i][k] for the Cholesky factor (F's entries
// with i < k are not written: read them as 0; *s_bad says whether a pivot
// failed), or the symmetric Newton–Schulz root. Right after its first
// barrier (everything written before the call is then visible to the
// block) it calls between(), work that the factor does not wait for.
// Returns F; ends synchronised.
template <typename T, typename G>
__device__ T* block_factor(const T* P, int n, int method, T* ws, int* s_bad,
                           T* s_trace, G between) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (method == kCholesky) {
    // Lc[j*n + i] = P[i][j]: the lower triangle, column-major
    if (tid == 0) *s_bad = 0;
    for (int idx = tid; idx < n * n; idx += nt) {
      const int j = idx / n, i = idx % n;
      if (i >= j) ws[idx] = P[i * n + j];
    }
    __syncthreads();
    between();
    block_cholesky_panels(ws, n, s_bad, n);
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
  between();
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

// One element's factor, read as the points need it: entry (r, c) of the
// scaled offsets scale·Fᵀ is scale·F[r*n + c], zero above a Cholesky
// factor's diagonal (c < r, never written), NaN throughout where a pivot
// failed.
template <typename T>
struct Offsets {
  const T* F;
  int n;
  T scale;
  bool lower, bad;
  __device__ T at(int r, int c) const {
    if (bad) return qnan<T>();
    return lower && c < r ? T(0) : scale * F[r * n + c];
  }
};

// The state block of the points, rows m ± scale·Fᵀ, V columns a store: all
// of K6's (2n, n) points (dn = 0), the first dx columns of K7's state rows
// (row stride na = dx + dn).
template <typename T, int V>
__device__ void write_state_points(const T* __restrict__ m, Offsets<T> off,
                                   int dn, T* pts) {
  const int dx = off.n, na = dx + dn;
  store_rect<T, V>(pts, pts + na * na, na, dx, dx,
                   [&](int r, int c, T (&p)[V], T (&q)[V]) {
#pragma unroll
                     for (int v = 0; v < V; ++v) {
                       const T o = off.at(r, c + v), mi = m[c + v];
                       p[v] = mi + o;
                       q[v] = mi - o;
                     }
                   });
}

// pts[b] = [m + scale·Fᵀ; m − scale·Fᵀ], (2n, n) for this block's element.
template <typename T>
__device__ void sigma_block(const T* __restrict__ m_all,
                            const T* __restrict__ P_all, T* pts_all, int n,
                            T scale, int method) {
  __shared__ int s_bad;
  __shared__ T s_trace;
  constexpr int V = 16 / sizeof(T);
  const size_t b = blockIdx.x;
  const T* m = m_all + b * n;
  T* pts = pts_all + b * 2 * n * n;
  const T* F = block_factor(P_all + b * n * n, n, method,
                            shared_workspace<T>(), &s_bad, &s_trace, [] {});
  const bool chol = method == kCholesky;
  const Offsets<T> off{F, n, scale, chol, chol && s_bad != 0};
  if (n % V == 0)
    write_state_points<T, V>(m, off, 0, pts);
  else
    write_state_points<T, 1>(m, off, 0, pts);
}

// K6: one block per batch element.
template <typename T>
__global__ void __launch_bounds__(kUtThreads) ut_sigma_kernel(
    const T* __restrict__ m_all, const T* __restrict__ P_all, T* pts_all,
    int n, T scale, int method) {
  sigma_block(m_all, P_all, pts_all, n, scale, method);
}

// K7's first launch: the points of the shared noise block (bias, C), one
// block. A symbol of its own, so that a profile charges it to K7, not K6.
template <typename T>
__global__ void __launch_bounds__(kUtThreads) ut_noise_sigma_kernel(
    const T* __restrict__ bias, const T* __restrict__ C, T* noise_pts,
    int dn, T scale, int method) {
  // let the points kernel start now: it waits for this grid only where it
  // reads noise_pts
  asm volatile("griddepcontrol.launch_dependents;");
  sigma_block(bias, C, noise_pts, dn, scale, method);
}

// K7's broadcast blocks of one element, V columns a store: the bias
// columns of the state rows and the mean columns of the noise rows. With
// the noise block (write_aug_noise) they are three quarters of the bytes
// at dx = dn, and none of them waits for P's factor.
template <typename T, int V>
__device__ void write_aug_broadcasts(const T* __restrict__ m,
                                     const T* __restrict__ bias, int dx,
                                     int dn, T* pts) {
  const int na = dx + dn;
  T* minus = pts + na * na;
  store_rect<T, V>(pts + dx, minus + dx, na, dx, dn,
                   [&](int, int c, T (&p)[V], T (&q)[V]) {
#pragma unroll
                     for (int v = 0; v < V; ++v) p[v] = q[v] = bias[c + v];
                   });
  store_rect<T, V>(pts + dx * na, minus + dx * na, na, dn, dx,
                   [&](int, int c, T (&p)[V], T (&q)[V]) {
#pragma unroll
                     for (int v = 0; v < V; ++v) p[v] = q[v] = m[c + v];
                   });
}

template <typename T, int V>
__device__ void write_aug_noise(const T* ns, int dx, int dn, T* pts) {
  const int na = dx + dn;
  T* minus = pts + na * na;
  store_rect<T, V>(pts + dx * na + dx, minus + dx * na + dx, na, dn, dn,
                   [&](int r, int c, T (&p)[V], T (&q)[V]) {
#pragma unroll
                     for (int v = 0; v < V; ++v) {
                       p[v] = ns[r * dn + c + v];
                       q[v] = ns[(dn + r) * dn + c + v];
                     }
                   });
}

// K7: augmented points of N([m; bias], blkdiag(P, C)), (2na, na) per
// element, na = dx + dn. noise_pts = [bias + scale·F_Cᵀ; bias − scale·F_Cᵀ]
// (2dn, dn), made once per launch by ut_noise_sigma_kernel and staged into
// shared memory behind P's factor workspace. Launched as a programmatic
// dependent of the noise launch, so that the two run at once: every block
// stores the broadcast blocks and stages P first, then waits for the noise
// points (griddepcontrol.wait), stages them and stores the noise block
// while P's factor runs, and stores the state block last.
template <typename T>
__global__ void __launch_bounds__(kUtThreads) ut_sigma_aug_kernel(
    const T* __restrict__ m_all, const T* __restrict__ P_all,
    const T* __restrict__ bias, const T* __restrict__ noise_pts, T* pts_all,
    int dx, int dn, T scale, int method) {
  __shared__ int s_bad;
  __shared__ T s_trace;
  constexpr int V = 16 / sizeof(T);
  const size_t b = blockIdx.x;
  const int na = dx + dn;
  T* ws = shared_workspace<T>();
  T* ns = ws + factor_ws_elems(dx, method);
  const T* m = m_all + b * dx;
  T* pts = pts_all + b * 2 * na * na;
  const bool vec = dx % V == 0 && dn % V == 0;
  if (vec)
    write_aug_broadcasts<T, V>(m, bias, dx, dn, pts);
  else
    write_aug_broadcasts<T, 1>(m, bias, dx, dn, pts);
  const T* F = block_factor(P_all + b * dx * dx, dx, method, ws, &s_bad,
                            &s_trace, [&] {
                              asm volatile("griddepcontrol.wait;" ::
                                               : "memory");
                              for (int idx = threadIdx.x; idx < 2 * dn * dn;
                                   idx += blockDim.x)
                                ns[idx] = noise_pts[idx];
                              __syncthreads();
                              if (vec)
                                write_aug_noise<T, V>(ns, dx, dn, pts);
                              else
                                write_aug_noise<T, 1>(ns, dx, dn, pts);
                            });
  const bool chol = method == kCholesky;
  const Offsets<T> off{F, dx, scale, chol, chol && s_bad != 0};
  if (vec)
    write_state_points<T, V>(m, off, dn, pts);
  else
    write_state_points<T, 1>(m, off, dn, pts);
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
int launch_sigma(K kernel, const void* m, const void* P, void* pts, int B,
                 int n, double scale, int method, cudaStream_t stream) {
  const size_t smem = factor_ws_elems(n, method) * sizeof(T);
  if (int err = set_smem(kernel, smem)) return err;
  kernel<<<B, kUtThreads, smem, stream>>>(
      static_cast<const T*>(m), static_cast<const T*>(P),
      static_cast<T*>(pts), n, T(scale), method);
  return int(cudaGetLastError());
}

template <typename T>
int launch_sigma_aug(const void* m, const void* P, const void* bias,
                     const void* C, void* pts, void* noise_pts, int B,
                     int dx, int dn, double scale, int method,
                     cudaStream_t stream) {
  // the shared noise block's points, once per launch
  if (int err = launch_sigma<T>(ut_noise_sigma_kernel<T>, bias, C, noise_pts,
                                1, dn, scale, method, stream))
    return err;
  const size_t smem =
      (factor_ws_elems(dx, method) + 2 * size_t(dn) * dn) * sizeof(T);
  if (int err = set_smem(ut_sigma_aug_kernel<T>, smem)) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B);
  cfg.blockDim = dim3(kUtThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return int(cudaLaunchKernelEx(
      &cfg, ut_sigma_aug_kernel<T>, static_cast<const T*>(m),
      static_cast<const T*>(P), static_cast<const T*>(bias),
      static_cast<const T*>(noise_pts), static_cast<T*>(pts), dx, dn,
      T(scale), method));
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

int bft_ut_sigma_f32(const void* m, const void* P, void* pts, int B, int n,
                     double scale, int method, void* stream) {
  return launch_sigma<float>(ut_sigma_kernel<float>, m, P, pts, B, n, scale,
                             method, cudaStream_t(stream));
}

int bft_ut_sigma_f64(const void* m, const void* P, void* pts, int B, int n,
                     double scale, int method, void* stream) {
  return launch_sigma<double>(ut_sigma_kernel<double>, m, P, pts, B, n,
                              scale, method, cudaStream_t(stream));
}

int bft_ut_sigma_aug_f32(const void* m, const void* P, const void* bias,
                         const void* C, void* pts, void* noise_pts, int B,
                         int dx, int dn, double scale, int method,
                         void* stream) {
  return launch_sigma_aug<float>(m, P, bias, C, pts, noise_pts, B, dx, dn,
                                 scale, method, cudaStream_t(stream));
}

int bft_ut_sigma_aug_f64(const void* m, const void* P, const void* bias,
                         const void* C, void* pts, void* noise_pts, int B,
                         int dx, int dn, double scale, int method,
                         void* stream) {
  return launch_sigma_aug<double>(m, P, bias, C, pts, noise_pts, B, dx, dn,
                                  scale, method, cudaStream_t(stream));
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
