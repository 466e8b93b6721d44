// Shared helpers for the filter kernels: constants, the per-block
// workspace in dynamic shared memory, a block-wide small matrix product,
// the panel Cholesky factorisation, and vector stores.
#pragma once

#include <cuda_runtime.h>

namespace bft {

constexpr size_t kStaticSmemSlack = 256;  // the kernels' static __shared__

// The block's dynamic shared memory.
template <typename T>
__device__ T* shared_workspace() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<T*>(smem_raw);
}

// Opt a kernel in to more than 48 KB of shared memory (the dynamic smem
// bytes beside up to kStaticSmemSlack of static).
template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem + kStaticSmemSlack <= 48 * 1024) return 0;
  return int(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

constexpr double kLog2Pi = 1.8378770664093453;  // log(2π)
constexpr double kRelJitter = 1e-6;             // ops/ekf.py _REL_JITTER

__device__ inline float dsqrt(float x) { return sqrtf(x); }
__device__ inline double dsqrt(double x) { return sqrt(x); }
__device__ inline float dlog(float x) { return logf(x); }
__device__ inline double dlog(double x) { return log(x); }
__device__ inline float drsqrt(float x) { return rsqrtf(x); }
__device__ inline double drsqrt(double x) { return rsqrt(x); }
__device__ inline float dabs(float x) { return fabsf(x); }
__device__ inline double dabs(double x) { return fabs(x); }
template <typename T> __device__ T qnan();
template <> __device__ inline float qnan<float>() {
  return __int_as_float(0x7fc00000);
}
template <> __device__ inline double qnan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// C[M,N] = A[M,K] B[K,N], row-major, over a whole thread block: each
// output element is one dot product owned by one thread; the caller
// synchronises afterwards. Its caller: K6's Newton–Schulz rounds
// (fused_ut.cu block_factor); the other block kernels use block_mm.cuh's
// register-tiled tile_mm.
template <typename T>
__device__ void block_mm_nn(T* C, const T* A, const T* B, int M, int N, int K) {
  for (int idx = threadIdx.x; idx < M * N; idx += blockDim.x) {
    const int i = idx / N, j = idx % N;
    T acc = T(0);
    for (int k = 0; k < K; ++k) acc += A[i * K + k] * B[k * N + j];
    C[idx] = acc;
  }
}

constexpr int kWarp = 32;

// The Cholesky factor of an n × n block (n ≤ W ≤ kWarp) held a row a
// lane: lane i holds row i of the block's lower part in a (zeros
// elsewhere, and everywhere on lanes ≥ n) on entry and row i of L on exit. At column j
// lane j's pivot and every lane's l_ij are shuffled to the lanes that
// update with them, so a column costs shuffles, not a dependent dot
// product; one reciprocal square root a column (l_jj = d·d^-½, l_ij =
// a_ij·d^-½) keeps division and the square root off the dependent chain.
// Every loop has a constant trip count, so that it unrolls and a stays in
// registers: columns past n are taken as the identity's (pivot 1, nothing
// to update), which leaves lanes ≥ n with garbage that callers never
// store. Lane i < n gets 1/l_ii in *rinv. Returns whether some pivot was
// not positive (a NaN pivot fails too), the same on every lane. The whole
// warp calls it; the width W sets the trip counts (W columns, W(W − 1)/2
// shuffles), so a small block takes a narrow W.
template <typename T, int W>
__device__ bool warp_cholesky(T (&a)[W], int n, T* rinv) {
  static_assert(W <= kWarp, "one lane a row");
  const unsigned full = 0xffffffffu;
  const int i = threadIdx.x % kWarp;
  bool bad = false;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const bool live = j < n;
    T d = __shfl_sync(full, a[j], j);
    if (!live) d = T(1);
    bad = bad || !(d > T(0));
    const T r = drsqrt(d);
    if (i == j) *rinv = r;
    const T lij = i == j ? d * r : (i > j ? a[j] * r : T(0));
    a[j] = lij;
#pragma unroll
    for (int c = j + 1; c < W; ++c) {
      const T lcj = __shfl_sync(full, lij, c);
      if (c <= i) a[c] -= lij * lcj;
    }
  }
  return bad;
}

// In-place Cholesky of the n × n symmetric matrix whose lower triangle Lc
// holds column-major with leading dimension ld ≥ n (Lc[j*ld + i] = S[i][j]
// for i ≥ j), right-looking in panels of W ≤ kWarp columns (kWarp unless a
// caller knows n is small: K8 takes 8 at dy ≤ 8):
// 1. warp 0 factors the panel's diagonal block in registers
//    (warp_cholesky);
// 2. each thread forward-substitutes whole rows of the panel below it
//    against that block: a row's kWarp entries stay in registers, the
//    block and its pivots' reciprocals (parked by warp 0 in the free strict
//    upper part, column k + W) are read as broadcasts, and no other
//    thread touches the row;
// 3. the block applies the lower trailing update.
// Three barriers a panel (n = 64, W = kWarp: five in all) instead of one a
// column.
// Writes the lower triangle, and the parked reciprocals into the strict
// upper part, which is otherwise left as it was: the caller must not read
// it (or must zero it) and handles a failed factor itself (K6/K7 NaN their
// points; K10b zeroes one factor and NaNs the other's solves). Sets *s_bad unless every pivot is
// positive. The block must have synchronised after Lc was written and
// *s_bad cleared; ends synchronised.
template <typename T, int W = kWarp>
__device__ void block_cholesky_panels(T* Lc, int n, int* s_bad, int ld) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int k = 0; k < n; k += W) {
    const int nb = min(W, n - k);
    const T* D = Lc + k * ld + k;  // D[c*ld + r]: the diagonal block's (r, c)
    const int below = k + nb;
    T* inv = Lc + below * ld + k;  // rows k.., column below: strict upper
    if (tid < kWarp) {
      T a[W], rinv = T(0);
#pragma unroll
      for (int c = 0; c < W; ++c)
        a[c] = tid < nb && c <= tid ? D[c * ld + tid] : T(0);
      if (warp_cholesky(a, nb, &rinv) && tid == 0) *s_bad = 1;
#pragma unroll
      for (int c = 0; c < W; ++c)
        if (tid < nb && c <= tid) Lc[(k + c) * ld + k + tid] = a[c];
      if (below < n && tid < W) inv[tid] = rinv;
    }
    __syncthreads();
    if (below >= n) break;
    // rows i ≥ below (only under a full panel, nb = W): L[i][k:k+nb]
    // solves x · L_kkᵀ = S[i][k:k+nb]
    for (int i = below + tid; i < n; i += nt) {
      T x[W];
#pragma unroll
      for (int c = 0; c < W; ++c) x[c] = Lc[(k + c) * ld + i];
#pragma unroll
      for (int c = 0; c < W; ++c) {
        x[c] *= inv[c];
#pragma unroll
        for (int j = c + 1; j < W; ++j) x[j] -= x[c] * D[c * ld + j];
      }
#pragma unroll
      for (int c = 0; c < W; ++c) Lc[(k + c) * ld + i] = x[c];
    }
    __syncthreads();
    // S[i][j] −= Σ_c L[i][k+c]·L[j][k+c] for below ≤ j ≤ i
    const int rest = n - below;
    T* Sb = Lc + below * ld + below;
    const T* Lp = Lc + k * ld + below;  // Lp[c*ld + r] = L[below + r][k + c]
    for (int idx = tid; idx < rest * rest; idx += nt) {
      const int j = idx / rest, i = idx % rest;
      if (i < j) continue;
      T s = Sb[j * ld + i];
      for (int c = 0; c < nb; ++c) s -= Lp[c * ld + i] * Lp[c * ld + j];
      Sb[j * ld + i] = s;
    }
    __syncthreads();
  }
}

// V consecutive elements in one store: 16 bytes, or one element.
template <typename T, int V> struct Vec;
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<float, 2> { using type = float2; };
template <> struct Vec<double, 2> { using type = double2; };
template <> struct Vec<float, 1> { using type = float; };
template <> struct Vec<double, 1> { using type = double; };

template <typename T, int V>
__device__ inline void store_vec(T* p, const T (&v)[V]) {
  typename Vec<T, V>::type w;
  T* e = reinterpret_cast<T*>(&w);
#pragma unroll
  for (int i = 0; i < V; ++i) e[i] = v[i];
  *reinterpret_cast<typename Vec<T, V>::type*>(p) = w;
}

// A rows × cols rectangle of both halves of a sigma-point set, V columns
// a store: f(r, c, p, q) fills p and q with columns c..c+V−1 of row r,
// stored at plus[r*ld + c] and minus[r*ld + c]. cols, ld and both pointers
// are multiples of V elements. Each thread's (r, c) advances by the
// block's stride with no division per store.
template <typename T, int V, typename F>
__device__ void store_rect(T* plus, T* minus, int ld, int rows, int cols,
                           F f) {
  const int nv = cols / V;
  if (nv == 0 || rows <= 0) return;
  const int dr = blockDim.x / nv, dc = blockDim.x % nv;
  int r = threadIdx.x / nv, c = threadIdx.x % nv;
  while (r < rows) {
    T p[V], q[V];
    f(r, c * V, p, q);
    const size_t at = size_t(r) * ld + size_t(c) * V;
    store_vec<T, V>(plus + at, p);
    store_vec<T, V>(minus + at, q);
    r += dr;
    c += dc;
    if (c >= nv) {
      c -= nv;
      ++r;
    }
  }
}

}  // namespace bft
