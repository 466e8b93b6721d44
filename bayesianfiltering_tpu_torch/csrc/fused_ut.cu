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
// do not fit one block's shared memory (8,192 rows × 4,096 columns at
// path N's widths): at the Lorenz-96 batch (128 rows, dx = 64, dy = 32) the
// schedules below do ~0.5 M multiply-adds an element in K8 (~1 MFLOP
// against ~80 KB moved) and ~0.28 M in K9 (against 48 KB), both below the
// card's ratio of 20 flops a byte in float32: bytes-bound at full width.
// Every product is far too small per block to feed the tensor cores, and
// TF32 is off by the precision policy, so all arithmetic runs on the CUDA
// cores in the working type; each block is bound by shared-memory
// bandwidth in its products and by latency in its factorisations (K8's
// one-warp factor of S is a serial chain of 32 columns whatever dy is).
//
// What the design does about it:
// - One workspace per block in dynamic shared memory (opted in above
//   48 KB), addressed as shared memory only. Where it does not fit (the
//   Cholesky above n = 240 in float32 and 170 in float64, Newton–Schulz
//   above 128 and 96; config 5's n = 512), ops/fused_ut.py runs the tiled
//   variants K6t/K7t (sigma_tiled.cu) instead, and K8/K9 hand over to
//   K8t/K9t (ut_tiled.cu) where theirs does not (K9 above dx = 192 in
//   float32 and 128 in float64; K8 above dx = 188 and 105 at dy = 32, and
//   at config 5's dx = 512, dy = 256).
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
// - K6/K7's Newton–Schulz rounds run on block_mm.cuh's register-tiled
//   product (4 × 4 outputs a thread, 16-byte operand loads, A row-major),
//   in three buffers Y, Z, T with padded leading dimensions: T = (3I −
//   Z Y)/2 is the first product's epilogue, and Y T and T Z are stored
//   over Y and Z once every thread holds its tiles in registers
//   (tile_mm_held: one super-tile a thread to n = 64, 2 × 2 to 128). At
//   the Lorenz-96 batch (n = 64) the 48 KB float32 workspace and a
//   64-register budget hold four elements an SM, so B = 512 is one wave
//   over 132 SMs (four buffers of one dot product a thread had held two).
// - K8 and K9 are built from block_mm.cuh, as K10b/K12b are. Sigma-point
//   rows are staged by cp.async in chunks of kRowChunk = 64 into a
//   workspace whose rows are aligned to 16 bytes, centred in place, and
//   reduced by one register-tiled product a chunk (tile_mm, 4 × 4 outputs
//   a thread, the rows as the product's inner dimension read in the
//   A-transposed layout), whose epilogue adds the tile into the shared
//   accumulator: K8's [S | C] += Hcᵀ [Hc | Xc] (Hc and Xc side by side in
//   one staged row), K9's lower tiles of Σ ccᵀ. P's copy (K8) lands under
//   the first chunk. K9 first sums the staged chunks for μ (each row read
//   once from global memory), then stages them again (from L2; the last
//   chunk, still staged, first) and centres them, so the second moment is
//   never formed uncentred. Centring walks columns, not elements: one
//   division a thread (for_rows).
// - K8 factors S with the panel factor (one warp at dy ≤ 32; panels of 8,
//   whose warp factor takes 8 serial columns, not 32, at dy ≤ 8) and never
//   inverts it:
//   one panel triangular solve (block_mm.cuh block_tri_solve, the same
//   panel width) gives [Z | z] = L⁻¹ [C | innov] in place. With
//   K = Cᵀ S⁻¹ = Zᵀ L⁻¹, KC = (KL)(KL)ᵀ = ZᵀZ, so the grouped form
//   P − KC − (KC)ᵀ + (KL)(KL)ᵀ is sym(P) − ZᵀZ: one lower-half product
//   with K = dy, μ = m + Zᵀz, ll from Σ log Lᵢᵢ and zᵀz by warp
//   reductions. At a condition number of ~6e5 this form keeps the
//   covariance and the mean within the float32 tolerance of the float64
//   reference (tests/test_torch_ut_block.py). A failed pivot NaNs the
//   pivots' reciprocals, so every output is NaN, as cholesky_nan makes
//   it.
// - Symmetric outputs are exact: only lower tiles are computed, and the
//   epilogue stores each tile and its mirror from registers (K8's cov, and
//   K9's Σ in the final product's epilogue), 16 bytes a store where the
//   rows allow it.
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
// the grouped Joseph form P − KC − (KC)ᵀ + (KL)(KL)ᵀ, evaluated as
// sym(P) − ZᵀZ; K8 takes μy and the innovation from the wrapper, which
// applies a model's residual function.
#include "block_mm.cuh"
#include "common.cuh"

namespace {

using namespace bft;

constexpr int kUtThreads = 256;
constexpr int kRowChunk = 64;  // sigma-point rows staged per pass (K8, K9)
constexpr int kNarrowPanel = 8;  // K8's factor and solve panel at dy ≤ 8
constexpr int kNsIters = 14;   // utils/linalg.py sqrtm_psd_ns
constexpr int kCholesky = 0;   // ops/fused_ut.py _METHODS
constexpr int kSqrtm = 1;
// The register-tiled products (block_mm.cuh tile_mm): 4 × 4 outputs a
// thread over kUtThreads = 256 threads, a 64 × 64 super-tile. K8 and K9
// run them on their staged rows, K6 and K7 on the Newton–Schulz rounds.
constexpr int kTM = 4, kTN = 4;
constexpr int kSuper = 64;
// The widest Newton–Schulz factor in a block: each thread holds its
// tiles of 2 × 2 super-tiles through an in-place product
// (ops/fused_ut.py _NS_MAX)
constexpr int kNsMax = 2 * kSuper;

// Newton–Schulz's buffers Y, Z and T in the block's workspace: each
// round_up(n, kTM) rows (a product's last row tile reads inside its
// buffer) with a leading dimension of round_up(n, 32), so that every row
// is aligned to 16 bytes (ops/fused_ut.py _factor_ws).
__host__ __device__ inline int ns_ld(int n) { return round_up(n, 32); }
__host__ __device__ inline size_t ns_buf(int n) {
  return size_t(round_up(n, kTM)) * ns_ld(n);
}

__host__ __device__ inline size_t factor_ws_elems(int n, int method) {
  return method == kSqrtm ? 3 * ns_buf(n) : size_t(n) * n;
}

// The factor's variant: 0 for the Cholesky; for Newton–Schulz the super-
// tiles a thread holds along each side (1 to n = 64, 2 to kNsMax), or -1
// past kNsMax.
inline int factor_variant(int n, int method) {
  if (method != kSqrtm) return 0;
  return n <= kSuper ? 1 : n <= kNsMax ? 2 : -1;
}

// K8's workspace (ops/fused_ut.py _update_ws): leading dimensions are
// multiples of 32 and C starts at a multiple of 4 columns, so that every
// row of every matrix is aligned to 16 bytes. The staged rows hold Hc in
// columns [0, dy) and Xc from column oc; the accumulator holds S in
// columns [0, dy), C from column oc, the innovation in column oc + dx,
// and is readable to the next multiple of 4 columns after it (the panel
// solve's right-hand side of dx + 1 columns) and of 32 rows.
struct UpdateWs {
  int oc, lstg, lsc, ldx, ry;
  __host__ __device__ UpdateWs(int dx, int dy)
      : oc(round_up(dy, 4)),
        lstg(round_up(oc + dx, 32)),
        lsc(round_up(oc + round_up(dx + 1, 4), 32)),
        ldx(round_up(dx, 32)),
        ry(round_up(dy, 32)) {}
  __host__ __device__ size_t elems(int dx) const {
    return size_t(kRowChunk) * lstg + size_t(ry) * lsc + size_t(dx) * ldx +
           lstg + 2 * size_t(ry);
  }
};

// K9's workspace (ops/fused_ut.py _predict_ws): staged rows, the lower
// tiles of Σ ccᵀ, μ, d0 and the partial sums of μ.
struct PredictWs {
  int ldx;
  __host__ __device__ explicit PredictWs(int dx) : ldx(round_up(dx, 32)) {}
  __host__ __device__ size_t elems(int dx) const {
    return size_t(kRowChunk + dx) * ldx + 2 * size_t(ldx) +
           size_t(ldx > kUtThreads ? ldx : kUtThreads);
  }
};

size_t update_ws_elems(int dx, int dy) { return UpdateWs(dx, dy).elems(dx); }

size_t predict_ws_elems(int dx) { return PredictWs(dx).elems(dx); }

// The sigma-point factor of the n×n matrix P (global, row-major) in the
// block's workspace ws (factor_ws_elems(n, method) elements): with
// kNs = 0 the Cholesky factor stored transposed, F[k*ld + i] = L[i][k]
// with ld = n (F's entries with i < k are not written: read them as 0;
// *s_bad says whether a pivot failed); with kNs = 1 or 2 (the super-tiles
// a thread holds along a side, n ≤ 64 or ≤ kNsMax) the symmetric
// Newton–Schulz root, ld = ns_ld(n). Right after its first barrier
// (everything written before the call is then visible to the block) it
// calls between(), work that the factor does not wait for. Returns F and
// sets *ld; ends synchronised.
template <typename T, int kNs, typename G>
__device__ T* block_factor(const T* P, int n, T* ws, int* s_bad, T* s_trace,
                           int* ld, G between) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if constexpr (kNs == 0) {
    // Lc[j*n + i] = P[i][j]: the lower triangle, column-major
    if (tid == 0) *s_bad = 0;
    for (int idx = tid; idx < n * n; idx += nt) {
      const int j = idx / n, i = idx % n;
      if (i >= j) ws[idx] = P[i * n + j];
    }
    __syncthreads();
    between();
    block_cholesky_panels(ws, n, s_bad, n);
    *ld = n;
    return ws;
  } else {
    // Trace-normalised coupled Newton–Schulz: T = (3I − Z Y)/2, Y ← Y T,
    // Z ← T Z, root = sym(Y·√s), with Y = sym(P)/s, Z = I,
    // s = tr P + 1e-30; every product a register-tiled tile_mm, T formed
    // in the first one's epilogue, Y T and T Z stored over Y and Z once
    // the whole block has read them (tile_mm_held), so that three buffers
    // hold a round
    constexpr int NT = kUtThreads;
    const int L = ns_ld(n);
    T* Y = ws;
    T* Z = Y + ns_buf(n);
    T* Tm = Z + ns_buf(n);
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
      Y[i * L + j] = (T(0.5) * (P[i * n + j] + P[j * n + i])) / s;
      Z[i * L + j] = i == j ? T(1) : T(0);
    }
    __syncthreads();
    const auto into = [&](T* X) {
      return [=](int i0, int j0, const T (&acc)[kTM][kTN]) {
        put_rows<false>(X, L, i0, j0, acc, n, n, 0, true,
                        [](T v, int, int) { return v; });
      };
    };
    for (int it = 0; it < kNsIters; ++it) {
      tile_mm<T, NT, kTM, kTN, false>(
          Z, L, Y, L, n, n, n, 0, false,
          [&](int i0, int j0, const T (&acc)[kTM][kTN]) {
            put_rows<false>(Tm, L, i0, j0, acc, n, n, 0, true,
                            [](T v, int i, int j) {
                              return T(0.5) * ((i == j ? T(3) : T(0)) - v);
                            });
          });
      __syncthreads();
      tile_mm_held<T, NT, kTM, kTN, kNs>(Y, L, Tm, L, n, n, n, into(Y));
      __syncthreads();
      tile_mm_held<T, NT, kTM, kTN, kNs>(Tm, L, Z, L, n, n, n, into(Z));
      __syncthreads();
    }
    const T rs = dsqrt(s);
    for (int idx = tid; idx < n * n; idx += nt) {
      const int i = idx / n, j = idx % n;
      Tm[i * L + j] = T(0.5) * (Y[i * L + j] * rs + Y[j * L + i] * rs);
    }
    __syncthreads();
    *ld = L;
    return Tm;
  }
}

// One element's factor, read as the points need it: entry (r, c) of the
// scaled offsets scale·Fᵀ is scale·F[r*ld + c], zero above a Cholesky
// factor's diagonal (c < r, never written), NaN throughout where a pivot
// failed.
template <typename T>
struct Offsets {
  const T* F;
  int n, ld;
  T scale;
  bool lower, bad;
  __device__ T at(int r, int c) const {
    if (bad) return qnan<T>();
    return lower && c < r ? T(0) : scale * F[r * ld + c];
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
template <typename T, int kNs>
__device__ void sigma_block(const T* __restrict__ m_all,
                            const T* __restrict__ P_all, T* pts_all, int n,
                            T scale) {
  __shared__ int s_bad;
  __shared__ T s_trace;
  constexpr int V = 16 / sizeof(T);
  const size_t b = blockIdx.x;
  const T* m = m_all + b * n;
  T* pts = pts_all + b * 2 * n * n;
  int ld = n;
  const T* F = block_factor<T, kNs>(P_all + b * n * n, n,
                                    shared_workspace<T>(), &s_bad, &s_trace,
                                    &ld, [] {});
  const bool chol = kNs == 0;
  const Offsets<T> off{F, n, ld, scale, chol, chol && s_bad != 0};
  if (n % V == 0)
    write_state_points<T, V>(m, off, 0, pts);
  else
    write_state_points<T, 1>(m, off, 0, pts);
}

// K6: one block per batch element. The register budget follows the
// blocks an SM that shared memory holds: Newton–Schulz with one super-tile
// a thread fits four float32 elements an SM (three 64 × 64 buffers, 48 KB)
// or two float64 ones, the two-super-tile variant two and one; the
// Cholesky two float32 elements an SM at 128 registers (left alone, the
// compiler took 167 for it, one block an SM) and one float64.
template <typename T, int kNs>
__global__ void __launch_bounds__(
    kUtThreads,
    sizeof(T) == 4 ? (kNs == 1 ? 4 : 2) : (kNs == 1 ? 2 : 1))
    ut_sigma_kernel(const T* __restrict__ m_all, const T* __restrict__ P_all,
                    T* pts_all, int n, T scale) {
  sigma_block<T, kNs>(m_all, P_all, pts_all, n, scale);
}

// K7's first launch: the points of the shared noise block (bias, C), one
// block. A symbol of its own, so that a profile charges it to K7, not K6.
template <typename T, int kNs>
__global__ void __launch_bounds__(kUtThreads) ut_noise_sigma_kernel(
    const T* __restrict__ bias, const T* __restrict__ C, T* noise_pts,
    int dn, T scale) {
  // let the points kernel start now: it waits for this grid only where it
  // reads noise_pts
  asm volatile("griddepcontrol.launch_dependents;");
  sigma_block<T, kNs>(bias, C, noise_pts, dn, scale);
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
template <typename T, int kNs>
__global__ void __launch_bounds__(kUtThreads) ut_sigma_aug_kernel(
    const T* __restrict__ m_all, const T* __restrict__ P_all,
    const T* __restrict__ bias, const T* __restrict__ noise_pts, T* pts_all,
    int dx, int dn, T scale) {
  __shared__ int s_bad;
  __shared__ T s_trace;
  constexpr int V = 16 / sizeof(T);
  const size_t b = blockIdx.x;
  const int na = dx + dn;
  T* ws = shared_workspace<T>();
  T* ns = ws + factor_ws_elems(dx, kNs == 0 ? kCholesky : kSqrtm);
  const T* m = m_all + b * dx;
  T* pts = pts_all + b * 2 * na * na;
  const bool vec = dx % V == 0 && dn % V == 0;
  if (vec)
    write_aug_broadcasts<T, V>(m, bias, dx, dn, pts);
  else
    write_aug_broadcasts<T, 1>(m, bias, dx, dn, pts);
  int ld = dx;
  const T* F = block_factor<T, kNs>(P_all + b * dx * dx, dx, ws, &s_bad,
                                    &s_trace, &ld, [&] {
                                      asm volatile("griddepcontrol.wait;" ::
                                                       : "memory");
                                      for (int idx = threadIdx.x;
                                           idx < 2 * dn * dn;
                                           idx += blockDim.x)
                                        ns[idx] = noise_pts[idx];
                                      __syncthreads();
                                      if (vec)
                                        write_aug_noise<T, V>(ns, dx, dn,
                                                              pts);
                                      else
                                        write_aug_noise<T, 1>(ns, dx, dn,
                                                              pts);
                                    });
  const bool chol = kNs == 0;
  const Offsets<T> off{F, dx, ld, scale, chol, chol && s_bad != 0};
  if (vec)
    write_state_points<T, V>(m, off, dn, pts);
  else
    write_state_points<T, 1>(m, off, dn, pts);
}

// f(X[r·ld + c], c) for r < nr, c < w: the block split into max(1,
// blockDim/w) parts along the rows, consecutive threads on consecutive
// columns (conflict-free), one division a thread rather than one an
// element. The caller synchronises.
template <typename T, typename F>
__device__ void for_rows(T* X, int ld, int nr, int w, F f) {
  const int parts = max(1, int(blockDim.x) / w);
  for (int idx = threadIdx.x; idx < parts * w; idx += blockDim.x) {
    const int p = idx / w, c = idx - p * w;
    for (int r = p; r < nr; r += parts) f(X[r * ld + c], c);
  }
}

// K8: the UT measurement update of one element from its sigma points pts
// (rows × ld, state in the first dx columns), their images hpts (rows ×
// dy), the image of the mean (center), μy and the innovation. Workspace
// (UpdateWs): kRowChunk staged rows [Hc | pad | Xc], the accumulator
// [S | pad | C | innov] (dy rows, to the next multiple of 32), P, and the
// vectors.
template <typename T>
__global__ void __launch_bounds__(kUtThreads) ut_update_kernel(
    const T* __restrict__ pts_all, const T* __restrict__ hpts_all,
    const T* __restrict__ center_all, const T* __restrict__ mu_all,
    const T* __restrict__ m_all, const T* __restrict__ P_all,
    const T* __restrict__ R, const T* __restrict__ inn_all, T* ll_all,
    T* mean_all, T* cov_all, int rows, int ld, int dx, int dy, T w_side,
    T w0c) {
  constexpr int NT = kUtThreads;
  __shared__ int s_bad;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const UpdateWs L(dx, dy);
  const int oc = L.oc, lstg = L.lstg, lsc = L.lsc, ldx = L.ldx;
  const T* pts = pts_all + b * rows * ld;
  const T* hp = hpts_all + b * rows * dy;
  T* cov = cov_all + b * dx * dx;

  T* stg = shared_workspace<T>();   // kRowChunk × lstg: [Hc | pad | Xc]
  T* sc = stg + kRowChunk * lstg;   // ry × lsc: [S | pad | C | innov]
  T* ps = sc + L.ry * lsc;          // dx × ldx: P
  T* cv = ps + dx * ldx;            // lstg: [μy | 0 | m], the centres
  T* d0 = cv + lstg;                // ry: center − μy
  T* dinv = d0 + L.ry;              // ry: the pivots' reciprocals

  // 1. the centres and d0; the accumulator cleared
  for (int c = tid; c < oc + dx; c += NT) {
    T v = T(0);
    if (c < dy) {
      v = mu_all[b * dy + c];
      d0[c] = center_all[b * dy + c] - v;
    } else if (c >= oc) {
      v = m_all[b * dx + c - oc];
    }
    cv[c] = v;
  }
  for (int idx = tid; idx < dy * lsc; idx += NT) sc[idx] = T(0);
  if (tid == 0) s_bad = 0;

  // 2. [S | C] += Hcᵀ [Hc | Xc] over staged chunks of rows; P's copy is
  //    issued behind the first chunk's and waited for only after the last
  for (int r0 = 0; r0 < rows; r0 += kRowChunk) {
    const int nr = min(kRowChunk, rows - r0);
    stage<T, true>(stg, lstg, hp + size_t(r0) * dy, size_t(dy), nr, dy);
    stage<T, true>(stg + oc, lstg, pts + size_t(r0) * ld, size_t(ld), nr,
                   dx);
    cp_async_commit();
    if (r0 == 0) {
      stage<T, true>(ps, ldx, P_all + b * dx * dx, dx);
      cp_async_commit();
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    for_rows(stg, lstg, nr, oc + dx, [&](T& x, int c) { x -= cv[c]; });
    __syncthreads();
    tile_mm<T, NT, kTM, kTN, true>(
        stg, lstg, stg, lstg, dy, oc + dx, nr, 0, false,
        [&](int i0, int j0, const T (&acc)[kTM][kTN]) {
          put_rows<true>(sc, lsc, i0, j0, acc, dy, oc + dx, 0, true,
                         [](T v, int, int) { return -v; });
        });
    __syncthreads();
  }
  cp_async_wait_all();

  // 3. S = sym(w_side·S + w0c·d0 d0ᵀ + R) in place by pairs, and its
  //    diagonal with the relative floor 1e-6·max|diag S| (warp 0 alone);
  //    C ← w_side·C; the innovation into the column after C
  const int ext = (dy + kWarp - 1) / kWarp * kWarp;
  diag_walk(ext, [&](int i, int j) {
    if (i < dy && j < i) {
      T v = w_side * sc[i * lsc + j] + w0c * (d0[i] * d0[j]);
      if (R != nullptr) v += T(0.5) * (R[i * dy + j] + R[j * dy + i]);
      sc[i * lsc + j] = v;
      sc[j * lsc + i] = v;
    }
  });
  if (tid < kWarp) {
    T mxd = T(0);
    for (int i = tid; i < dy; i += kWarp) {
      T v = w_side * sc[i * lsc + i] + w0c * (d0[i] * d0[i]);
      if (R != nullptr) v += R[i * dy + i];
      sc[i * lsc + i] = v;
      const T a = dabs(v);
      mxd = a > mxd ? a : mxd;
    }
#pragma unroll
    for (int o = kWarp / 2; o > 0; o /= 2) {
      const T other = __shfl_xor_sync(0xffffffffu, mxd, o);
      mxd = other > mxd ? other : mxd;
    }
    for (int i = tid; i < dy; i += kWarp)
      sc[i * lsc + i] += T(kRelJitter) * mxd;
  }
  for_rows(sc + oc, lsc, dy, dx, [&](T& x, int) { x *= w_side; });
  for (int a = tid; a < dy; a += NT)
    sc[a * lsc + oc + dx] = inn_all[b * dy + a];
  __syncthreads();

  // 4. S = L Lᵀ in place (S is symmetric, so its rows are the columns of
  //    its lower triangle); NaN throughout unless every pivot is positive:
  //    the pivots' reciprocals are NaN and carry it into every output.
  //    Panels of 8 at dy ≤ 8 (the range-bearing banks' dy = 2), else of 32
  const bool narrow = dy <= kNarrowPanel;
  if (narrow)
    block_cholesky_panels<T, kNarrowPanel>(sc, dy, &s_bad, lsc);
  else
    block_cholesky_panels<T>(sc, dy, &s_bad, lsc);
  const bool bad = s_bad != 0;
  for (int i = tid; i < L.ry; i += NT)
    dinv[i] = bad ? qnan<T>() : i < dy ? T(1) / sc[i * lsc + i] : T(1);
  __syncthreads();

  // 5. [Z | z] = L⁻¹ [C | innov] in place: no inverse of L
  if (narrow)
    block_tri_solve<T, NT, kTM, kTN, kNarrowPanel>(sc, dinv, sc + oc, dx + 1,
                                                   nullptr, 0, dy, lsc);
  else
    block_tri_solve<T, NT, kTM, kTN>(sc, dinv, sc + oc, dx + 1, nullptr, 0,
                                     dy, lsc);

  // 6. K = Cᵀ S⁻¹ = Zᵀ L⁻¹, so KC = (KL)(KL)ᵀ = ZᵀZ and the grouped form
  //    P − KC − (KC)ᵀ + (KL)(KL)ᵀ is sym(P) − ZᵀZ: its lower tiles, each
  //    stored and mirrored from registers; μ = m + Zᵀz;
  //    ll = −½(dy·log 2π + 2·Σ log Lᵢᵢ + zᵀz)
  const T* Z = sc + oc;
  const bool vec = rows_aligned(cov_all, dx);
  tile_mm<T, NT, kTM, kTN, true>(
      Z, lsc, Z, lsc, dx, dx, dy, 0, true,
      [&](int i0, int j0, const T (&acc)[kTM][kTN]) {
        T out[kTM][kTN];
#pragma unroll
        for (int r = 0; r < kTM; ++r)
#pragma unroll
          for (int c = 0; c < kTN; ++c) {
            const int i = i0 + r, j = j0 + c;
            out[r][c] = i < dx && j < dx
                            ? T(0.5) * (ps[i * ldx + j] + ps[j * ldx + i]) -
                                  acc[r][c]
                            : T(0);
          }
        put_rows<false>(cov, dx, i0, j0, out, dx, dx, 0, vec,
                        [](T v, int, int) { return v; });
        put_cols(cov, dx, i0, j0, out, dx, dx, vec);
      });
  for (int i = tid; i < dx; i += NT) {
    T s = T(0);
    for (int k = 0; k < dy; ++k) s += Z[k * lsc + i] * Z[k * lsc + dx];
    mean_all[b * dx + i] = cv[oc + i] + s;
  }
  if (tid < kWarp) {
    T logdet = T(0), zsq = T(0);
    for (int i = tid; i < dy; i += kWarp) {
      const T z = Z[i * lsc + dx];
      logdet += dlog(sc[i * lsc + i]);
      zsq += z * z;
    }
    logdet = warp_sum(logdet);
    zsq = warp_sum(zsq);
    if (tid == 0)
      ll_all[b] = T(-0.5) * (T(dy * kLog2Pi) + T(2) * logdet + zsq);
  }
}

// K9: μ = w_side·Σ fpts + w0m·center, Σ = sym(w_side·Σ ccᵀ + w0c·d0 d0ᵀ
// (+ Q)) for one element's propagated points fpts (rows × dx). Workspace
// (PredictWs): kRowChunk staged rows, the lower tiles of Σ ccᵀ, μ, d0 and
// the partial sums of μ. Two passes over the chunks: sums for μ, then the
// centred products.
template <typename T>
__global__ void __launch_bounds__(kUtThreads) ut_predict_kernel(
    const T* __restrict__ fpts_all, const T* __restrict__ center_all,
    const T* __restrict__ Q, T* mu_all, T* cov_all, int rows, int dx,
    T w_side, T w0m, T w0c) {
  constexpr int NT = kUtThreads;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const PredictWs L(dx);
  const int ldx = L.ldx;
  const T* fp = fpts_all + b * rows * dx;
  T* cov = cov_all + b * dx * dx;

  T* stg = shared_workspace<T>();   // kRowChunk × ldx: staged fpts − μ
  T* acc = stg + kRowChunk * ldx;   // dx × ldx: lower tiles of Σ ccᵀ
  T* mu = acc + dx * ldx;           // ldx
  T* d0 = mu + ldx;                 // ldx: center − μ
  T* part = d0 + ldx;               // max(NT, ldx): partial sums of μ

  // μ: every chunk staged in turn (cp.async) and summed by columns, max(1,
  // 256/dx) parts of rows a column; each row is read once from global
  // memory here and once more, from L2, below
  const int parts = max(1, NT / dx);
  const int chunks = (rows + kRowChunk - 1) / kRowChunk;
  const auto stage_chunk = [&](int c) {
    const int r0 = c * kRowChunk;
    stage<T, true>(stg, ldx, fp + size_t(r0) * dx, size_t(dx),
                   min(kRowChunk, rows - r0), dx);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  };
  for (int idx = tid; idx < parts * dx; idx += NT) part[idx] = T(0);
  for (int c = 0; c < chunks; ++c) {
    if (c > 0) __syncthreads();  // the previous chunk is summed
    stage_chunk(c);
    const int nr = min(kRowChunk, rows - c * kRowChunk);
    for (int idx = tid; idx < parts * dx; idx += NT) {
      const int p = idx / dx, j = idx - p * dx;
      T s = part[idx];
      for (int r = p; r < nr; r += parts) s += stg[r * ldx + j];
      part[idx] = s;
    }
  }
  for (int idx = tid; idx < dx * ldx; idx += NT) acc[idx] = T(0);
  __syncthreads();
  for (int j = tid; j < dx; j += NT) {
    T s = T(0);
    for (int p = 0; p < parts; ++p) s += part[p * dx + j];
    const T c = center_all[b * dx + j];
    const T u = w_side * s + w0m * c;
    mu[j] = u;
    d0[j] = c - u;
    mu_all[b * dx + j] = u;
  }
  __syncthreads();

  // Σ ccᵀ over the chunks of centred rows, the last one (still staged)
  // first, lower tiles only; the epilogue of the final product (chunk 0)
  // adds the accumulated tiles, weights them, adds w0c·d0 d0ᵀ and sym(Q)
  // and stores each tile and its mirror
  const bool vec = rows_aligned(cov_all, dx);
  for (int c = chunks - 1; c >= 0; --c) {
    if (c < chunks - 1) stage_chunk(c);
    const int nr = min(kRowChunk, rows - c * kRowChunk);
    for_rows(stg, ldx, nr, dx, [&](T& x, int j) { x -= mu[j]; });
    __syncthreads();
    const bool last = c == 0;
    tile_mm<T, NT, kTM, kTN, true>(
        stg, ldx, stg, ldx, dx, dx, nr, 0, true,
        [&](int i0, int j0, const T (&a)[kTM][kTN]) {
          if (!last) {
            put_rows<true>(acc, ldx, i0, j0, a, dx, dx, 0, true,
                           [](T v, int, int) { return -v; });
            return;
          }
          T out[kTM][kTN];
#pragma unroll
          for (int r = 0; r < kTM; ++r)
#pragma unroll
            for (int c = 0; c < kTN; ++c) {
              const int i = i0 + r, j = j0 + c;
              if (i >= dx || j >= dx) {
                out[r][c] = T(0);
                continue;
              }
              T v = w_side * (acc[i * ldx + j] + a[r][c]) +
                    w0c * (d0[i] * d0[j]);
              if (Q != nullptr) v += T(0.5) * (Q[i * dx + j] + Q[j * dx + i]);
              out[r][c] = v;
            }
          put_rows<false>(cov, dx, i0, j0, out, dx, dx, 0, vec,
                          [](T v, int, int) { return v; });
          put_cols(cov, dx, i0, j0, out, dx, dx, vec);
        });
    __syncthreads();
  }
}

// K6 over B elements, the variant (factor_variant) picked from n and the
// method: a template argument each, so that the Cholesky, one super-tile
// and two super-tiles a thread compile to kernels of their own.
template <typename T>
int launch_sigma(const void* m, const void* P, void* pts, int B, int n,
                 double scale, int method, cudaStream_t stream) {
  const size_t smem = factor_ws_elems(n, method) * sizeof(T);
  const auto run = [&](auto kernel) {
    if (int err = set_smem(kernel, smem)) return err;
    kernel<<<B, kUtThreads, smem, stream>>>(
        static_cast<const T*>(m), static_cast<const T*>(P),
        static_cast<T*>(pts), n, T(scale));
    return int(cudaGetLastError());
  };
  switch (factor_variant(n, method)) {
    case 0: return run(ut_sigma_kernel<T, 0>);
    case 1: return run(ut_sigma_kernel<T, 1>);
    case 2: return run(ut_sigma_kernel<T, 2>);
    default: return int(cudaErrorInvalidValue);
  }
}

// K7's noise launch (one block) and points launch, each kernel's variant
// picked from its own width: dn for the noise, dx for the points.
template <typename T, int kNs>
int launch_sigma_aug_points(const void* m, const void* P, const void* bias,
                            const void* noise_pts, void* pts, int B, int dx,
                            int dn, double scale, int method,
                            cudaStream_t stream) {
  const size_t smem =
      (factor_ws_elems(dx, method) + 2 * size_t(dn) * dn) * sizeof(T);
  if (int err = set_smem(ut_sigma_aug_kernel<T, kNs>, smem)) return err;
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
      &cfg, ut_sigma_aug_kernel<T, kNs>, static_cast<const T*>(m),
      static_cast<const T*>(P), static_cast<const T*>(bias),
      static_cast<const T*>(noise_pts), static_cast<T*>(pts), dx, dn,
      T(scale)));
}

template <typename T>
int launch_sigma_aug(const void* m, const void* P, const void* bias,
                     const void* C, void* pts, void* noise_pts, int B,
                     int dx, int dn, double scale, int method,
                     cudaStream_t stream) {
  // the shared noise block's points, once per launch
  const size_t smem = factor_ws_elems(dn, method) * sizeof(T);
  const auto noise = [&](auto kernel) {
    if (int err = set_smem(kernel, smem)) return err;
    kernel<<<1, kUtThreads, smem, stream>>>(
        static_cast<const T*>(bias), static_cast<const T*>(C),
        static_cast<T*>(noise_pts), dn, T(scale));
    return int(cudaGetLastError());
  };
  int err = 0;
  switch (factor_variant(dn, method)) {
    case 0: err = noise(ut_noise_sigma_kernel<T, 0>); break;
    case 1: err = noise(ut_noise_sigma_kernel<T, 1>); break;
    case 2: err = noise(ut_noise_sigma_kernel<T, 2>); break;
    default: err = int(cudaErrorInvalidValue);
  }
  if (err) return err;
  switch (factor_variant(dx, method)) {
    case 0:
      return launch_sigma_aug_points<T, 0>(m, P, bias, noise_pts, pts, B, dx,
                                           dn, scale, method, stream);
    case 1:
      return launch_sigma_aug_points<T, 1>(m, P, bias, noise_pts, pts, B, dx,
                                           dn, scale, method, stream);
    case 2:
      return launch_sigma_aug_points<T, 2>(m, P, bias, noise_pts, pts, B, dx,
                                           dn, scale, method, stream);
    default: return int(cudaErrorInvalidValue);
  }
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
  return launch_sigma<float>(m, P, pts, B, n, scale, method,
                             cudaStream_t(stream));
}

int bft_ut_sigma_f64(const void* m, const void* P, void* pts, int B, int n,
                     double scale, int method, void* stream) {
  return launch_sigma<double>(m, P, pts, B, n, scale, method,
                              cudaStream_t(stream));
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
