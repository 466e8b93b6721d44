// The blocked Cholesky of an augmented matrix, shared by the tiled EKF
// update (K1t, ekf_tiled.cu) and the tiled UT update (K8t, ut_tiled.cu);
// its panel loop alone (blocked_cholesky, on a layout of height dy) also
// factors the tiled sigma points' P (K6t, K7t: sigma_tiled.cu).
//
// Both updates factor
//
//   W = [S; X; vᵀ; I]   ((2dy + dx + 1) × dy, row-major)
//
// with S the innovation covariance (its lower part), X the transposed
// cross-covariance (dx × dy: (H P)ᵀ for K1t, Cᵀ for K8t) and v the
// innovation. Below L (S = L Lᵀ) the same panel steps carry the rows of X,
// vᵀ and I, so they come out as (L⁻¹ Xᵀ)ᵀ = Zᵀ, (L⁻¹ v)ᵀ = zᵀ and L⁻ᵀ: the
// forward substitutions are tiled products inside the factorisation, and
// the gain is one more product, K = Zᵀ L⁻¹. No thread walks a dy-long
// dependent chain.
//
// - Right-looking, in panels of kNb = 32 columns: the diagonal block is
//   factored and inverted by one warp per element, a row in each lane's
//   registers (each column costs a shuffle per row, not a dependent dot
//   product); the column panel below it is the product of that panel and
//   the block's inverse transposed; the trailing matrix takes a lower
//   product update (tiled.cuh).
// - A diagonal block with a non-positive (or NaN) pivot is set to NaN,
//   which every later step carries into all outputs: a non-PD S gives NaN,
//   as the plain versions' cholesky does. Nothing here raises.
// - The per-element scratch holds W, its factor and the diagonal blocks'
//   inverses at the offsets of an AugLayout; the caller's own slots follow
//   them (AugLayout::end), and AugLayout::total is the element stride.
#pragma once

#include "common.cuh"
#include "tiled.cuh"

namespace bft {

constexpr int kNb = 32;        // Cholesky panel width: one warp's lanes
constexpr int kThreads = 256;  // the element-wise kernels' blocks

struct AugLayout {
  int dx, dy;
  long long height;     // rows of W: 2dy + dx + 1, or dy for S alone
  long long w, l, li;   // W, its factor L, the diagonal blocks' inverses
  long long end;        // the first element after them
  long long total;      // the per-element stride of the scratch (≥ end)
  AugLayout(int dx_, int dy_) : AugLayout(dx_, dy_, 2LL * dy_ + dx_ + 1) {}
  // W of `height` rows: dy for the factor of S alone (no X, vᵀ or I)
  AugLayout(int dx_, int dy_, long long height_)
      : dx(dx_), dy(dy_), height(height_) {
    w = 0;
    l = w + height * dy;
    li = l + height * dy;
    end = li + 1LL * dy * kNb;
    total = end;
  }
  // offsets of the rows of X (then Zᵀ), vᵀ (then zᵀ) and I (then L⁻ᵀ)
  __host__ __device__ long long xrow() const { return 1LL * dy * dy; }
  __host__ __device__ long long vrow() const {
    return (long long)(dy + dx) * dy;
  }
  __host__ __device__ long long erow() const {
    return (long long)(dy + dx + 1) * dy;
  }
};

inline int grid_1d(long long B) { return B < 65535 ? int(B) : 65535; }

// Element-wise grids: enough blocks for `work` elements, at most 256 (a
// few per SM) per batch row.
inline dim3 elementwise_grid(long long work, int B) {
  const long long blocks = (work + kThreads - 1) / kThreads;
  return dim3(unsigned(blocks < 256 ? (blocks > 0 ? blocks : 1) : 256),
              unsigned(grid_1d(B)));
}

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

// Fill W around X. S = sym(R) + G + (jitter + 1e-6·max|diag(G + R)|)·I
// into W's top square (lower part), from G = lower(...) in L's top square,
// whose strict upper part is then zeroed (K8t reads L's top square as a
// full square; the factorisation writes only its lower part); vᵀ and the
// identity into W's last dy + 1 rows. R (dy × dy, batch stride r_batch: 0
// when the batch shares it) may be null, for S = G + floor. Where x_src ≥
// 0, X is copied into W from that offset of the scratch; where rs ≥ 0,
// sym(R) goes to that offset. Grid (blocks, batch); every block finds the
// floor itself (dy reads).
template <typename T>
__global__ void __launch_bounds__(kThreads) chol_prep_kernel(
    T* scratch, const T* __restrict__ R_all, long long r_batch,
    const T* __restrict__ inn_all, AugLayout sc, long long x_src,
    long long rs, int B, T jitter) {
  __shared__ T s_floor;
  const int dx = sc.dx, dy = sc.dy;
  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    T* ws = scratch + b * sc.total;
    T* W = ws + sc.w;
    T* L = ws + sc.l;  // G in its lower part
    const T* R = R_all != nullptr ? R_all + b * r_batch : nullptr;
    const T* inn = inn_all + b * dy;
    if (threadIdx.x < 32) {
      T mx = T(0);
      for (int i = threadIdx.x; i < dy; i += 32) {
        const T a = dabs(L[i * dy + i] + (R ? R[i * dy + i] : T(0)));
        mx = a > mx ? a : mx;
      }
      for (int o = 16; o > 0; o >>= 1) {
        const T other = __shfl_xor_sync(0xffffffffu, mx, o);
        mx = other > mx ? other : mx;
      }
      if (threadIdx.x == 0) s_floor = jitter + T(kRelJitter) * mx;
    }
    __syncthreads();
    const long long eye = sc.erow();
    const int stride = gridDim.x * blockDim.x;
    for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < dy * dy;
         idx += stride) {
      const int i = idx / dy, j = idx % dy;
      const T r = R ? T(0.5) * (R[i * dy + j] + R[j * dy + i]) : T(0);
      if (rs >= 0) ws[rs + idx] = r;
      if (j < i) W[idx] = L[idx] + r;
      else if (j == i) W[idx] = (L[idx] + (R ? R[idx] : T(0))) + s_floor;
      else L[idx] = T(0);
      W[eye + idx] = i == j ? T(1) : T(0);
    }
    if (x_src >= 0)
      for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < dx * dy;
           idx += stride)
        W[sc.xrow() + idx] = ws[x_src + idx];
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < dy; j += stride)
      W[sc.vrow() + j] = inn[j];
    __syncthreads();
  }
}

// Panel k: the n × n diagonal block of W at (k, k) (n ≤ kNb) factored
// into L's diagonal block (zero strict upper part, NaN throughout unless
// every pivot is positive) and inverted into Li's rows k..k+n. One warp
// per element: lane i holds row i; at column j lane j's pivot and every
// lane's l_ij are shuffled to the lanes that update with them
// (warp_cholesky). The inverse is forward substitution, lane j solving
// column j against the factor and its pivots' reciprocals in shared memory
// (broadcast reads); every loop has a constant trip count (warp_cholesky
// leaves identity rows on lanes ≥ n), so that the arrays stay in
// registers.
template <typename T>
__global__ void __launch_bounds__(kNb) chol_diag_kernel(
    T* scratch, AugLayout sc, int B, int k, int n) {
  static_assert(kNb == kWarp, "one lane a row of the diagonal block");
  __shared__ T Ls[kNb][kNb + 1];
  __shared__ T Rs[kNb];  // 1/L[r][r]
  const int i = threadIdx.x, dy = sc.dy;
  for (long long b = blockIdx.x; b < B; b += gridDim.x) {
    T* ws = scratch + b * sc.total;
    const T* W = ws + sc.w + (long long)(k + i) * dy + k;
    T a[kNb];
#pragma unroll
    for (int c = 0; c < kNb; ++c)
      a[c] = i < n && c <= i ? W[c] : T(0);
    T rinv = T(1);
    const bool bad = warp_cholesky(a, n, &rinv);
    Rs[i] = bad ? qnan<T>() : rinv;
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
      T acc = r == i ? T(1) : T(0);
#pragma unroll
      for (int c = 0; c < r; ++c) acc -= Ls[r][c] * x[c];
      x[r] = acc * Rs[r];
    }
    T* Li = ws + sc.li + (long long)k * kNb;
#pragma unroll
    for (int r = 0; r < kNb; ++r)
      if (i < n && r < n) Li[r * kNb + i] = x[r];
    __syncwarp();
  }
}

// ll = log N(v | 0, S) from diag L and z = L⁻¹ v (the factor's zᵀ row).
// One block per element.
template <typename T>
__global__ void __launch_bounds__(kThreads) chol_loglik_kernel(
    const T* scratch, T* ll_all, AugLayout sc, int B) {
  __shared__ T sh[kThreads];
  const int dy = sc.dy;
  for (long long b = blockIdx.x; b < B; b += gridDim.x) {
    const T* L = scratch + b * sc.total + sc.l;
    const T* z = L + sc.vrow();
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

// Enqueue chol_prep_kernel on `stream` (grid: up to 64 blocks an
// element); returns cudaGetLastError().
template <typename T>
int chol_prep(T* ws, const T* R, long long r_batch, const T* inn,
              const AugLayout& sc, long long x_src, long long rs, int B,
              T jitter, cudaStream_t stream) {
  int work = sc.dy * sc.dy;
  if (x_src >= 0 && sc.dx * sc.dy > work) work = sc.dx * sc.dy;
  const int blocks = (work + kThreads - 1) / kThreads;
  chol_prep_kernel<T><<<dim3(blocks < 64 ? blocks : 64, grid_1d(B)),
                        kThreads, 0, stream>>>(ws, R, r_batch, inn, sc, x_src,
                                               rs, B, jitter);
  return int(cudaGetLastError());
}

// The panel loop: factor the prepared W (its lower top square and the
// sc.height − dy rows below it) of every element into L, enqueued on
// `stream`; returns the first CUDA error. Writes only L's lower part.
template <typename T>
int blocked_cholesky(T* ws, const AugLayout& sc, int B,
                     cudaStream_t stream) {
  const int dy = sc.dy;
  const long long st = sc.total;
  int err = 0;
  auto keep = [&](int e) {
    if (err == 0) err = e;
  };
  for (int k = 0; k < dy; k += kNb) {
    const int n = dy - k < kNb ? dy - k : kNb;
    const long long below = k + n;              // first row under the panel
    const int rest = int(sc.height - below);    // rows under the panel
    chol_diag_kernel<T><<<grid_1d(B), kNb, 0, stream>>>(ws, sc, B, k, n);
    keep(int(cudaGetLastError()));
    // L[below:, k:k+n] = W[below:, k:k+n] · (L_kk⁻¹)ᵀ
    keep(gemm(gemm_of<T>(rest, n, n, B,
                         {ws + sc.w + below * dy + k, dy, st, 0},
                         {ws + sc.li + 1LL * k * kNb, kNb, st, 1},
                         ws + sc.l + below * dy + k, dy, st),
              stream));
    if (below < dy) {
      // W[below:, below:dy] −= L[below:, k:k+n] · L[below:dy, k:k+n]ᵀ
      const T* panel = ws + sc.l + below * dy + k;
      Gemm<T> g = gemm_of<T>(rest, int(dy - below), n, B, {panel, dy, st, 0},
                             {panel, dy, st, 1},
                             ws + sc.w + below * dy + below, dy, st, T(-1));
      g.Cin = g.C; g.ldcin = dy; g.bcin = st; g.beta = T(1);
      g.tri = kLower;
      keep(gemm(g, stream));
    }
  }
  return err;
}

// Factor the prepared W of every element and finish the update's common
// part: the gain K = Zᵀ L⁻¹ (dx × dy, leading dimension dy, batch stride
// k_batch), ll = log N(v | 0, S) and μ = m + K v. Enqueued on `stream`;
// returns the first CUDA error.
template <typename T>
int factor_and_gain(T* ws, const AugLayout& sc, int B, T* K,
                    long long k_batch, const T* m, const T* inn, T* ll,
                    T* mean, cudaStream_t stream) {
  const int dx = sc.dx, dy = sc.dy;
  const long long st = sc.total;
  int err = blocked_cholesky(ws, sc, B, stream);
  auto keep = [&](int e) {
    if (err == 0) err = e;
  };
  // K = Zᵀ L⁻¹ = Zᵀ (L⁻ᵀ)ᵀ
  keep(gemm(gemm_of<T>(dx, dy, dy, B, {ws + sc.l + sc.xrow(), dy, st, 0},
                       {ws + sc.l + sc.erow(), dy, st, 1}, K, dy, k_batch),
            stream));
  // ll; μ = m + K v, a product with one column
  chol_loglik_kernel<T><<<grid_1d(B), kThreads, 0, stream>>>(ws, ll, sc, B);
  keep(int(cudaGetLastError()));
  Gemm<T> g = gemm_of<T>(dx, 1, dy, B, {K, dy, k_batch, 0}, {inn, 1, dy, 0},
                         mean, 1, dx);
  g.Cin = m; g.ldcin = 1; g.bcin = dx; g.beta = T(1);
  keep(gemm(g, stream));
  return err;
}

}  // namespace bft
