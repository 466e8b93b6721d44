// Shared helpers for the filter kernels: constants, per-block workspaces
// (dynamic shared memory, or a global scratch above the opt-in limit), and
// block-wide small matrix products.
#pragma once

#include <cuda_runtime.h>

namespace bft {

constexpr size_t kStaticSmemSlack = 256;  // the kernels' static __shared__

// 0 when a per-block workspace of ws_elems fits in shared memory, else the
// per-block element count of the global scratch the caller must pass; -1
// on a CUDA error.
inline long long scratch_elems(size_t ws_elems, int itemsize, int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  const size_t bytes = ws_elems * size_t(itemsize);
  return bytes + kStaticSmemSlack <= size_t(optin) ? 0
                                                   : (long long)ws_elems;
}

// The block's dynamic shared memory.
template <typename T>
__device__ T* shared_workspace() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<T*>(smem_raw);
}

// The block's workspace: its slice of the global scratch when one is
// given, else the dynamic shared memory.
template <typename T>
__device__ T* workspace(T* scratch, size_t per_block) {
  return scratch != nullptr ? scratch + size_t(blockIdx.x) * per_block
                            : shared_workspace<T>();
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return int(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

constexpr double kLog2Pi = 1.8378770664093453;  // log(2π)
constexpr double kRelJitter = 1e-6;             // ops/ekf.py _REL_JITTER

__device__ inline float dsqrt(float x) { return sqrtf(x); }
__device__ inline double dsqrt(double x) { return sqrt(x); }
__device__ inline float dlog(float x) { return logf(x); }
__device__ inline double dlog(double x) { return log(x); }
__device__ inline float dabs(float x) { return fabsf(x); }
__device__ inline double dabs(double x) { return fabs(x); }
template <typename T> __device__ T qnan();
template <> __device__ inline float qnan<float>() {
  return __int_as_float(0x7fc00000);
}
template <> __device__ inline double qnan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// Row-major products over a whole thread block. Each output element is one
// dot product owned by one thread; the caller synchronises afterwards.
// C[M,N] = A[M,K] B[K,N]
template <typename T>
__device__ void block_mm_nn(T* C, const T* A, const T* B, int M, int N, int K) {
  for (int idx = threadIdx.x; idx < M * N; idx += blockDim.x) {
    const int i = idx / N, j = idx % N;
    T acc = T(0);
    for (int k = 0; k < K; ++k) acc += A[i * K + k] * B[k * N + j];
    C[idx] = acc;
  }
}

// C[M,N] = Aᵀ B with A stored (K, M) row-major: A[k][i] is read as a
// broadcast, B[k][j] as consecutive words. The caller synchronises.
template <typename T>
__device__ void block_mm_tn(T* C, const T* A, const T* B, int M, int N,
                            int K) {
  for (int idx = threadIdx.x; idx < M * N; idx += blockDim.x) {
    const int i = idx / N, j = idx % N;
    T acc = T(0);
    for (int k = 0; k < K; ++k) acc += A[k * M + i] * B[k * N + j];
    C[idx] = acc;
  }
}

// Xᵀ (cols × rows) from X (rows × cols): reads coalesced, once per call.
// The caller synchronises.
template <typename T>
__device__ void block_transpose(T* XT, const T* X, int rows, int cols) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x)
    XT[(idx % cols) * rows + idx / cols] = X[idx];
}

// In-place Cholesky of the n×n symmetric matrix held column-major in Lc
// (Lc[j*n + i] = S[i][j] for i ≥ j on entry, L[i][j] on exit), one barrier
// per column: the thread that completes row j+1 of column j also takes
// pivot j+1. The strict upper part is zeroed; unless every pivot is
// positive (a NaN pivot fails too, the info of torch.linalg.cholesky_ex)
// the whole factor is set to `fail` (NaN, or zero for a guarded factor).
// The block must have synchronised after Lc was written; ends synchronised.
template <typename T>
__device__ void block_cholesky_cm(T* Lc, int n, int* s_bad, T fail) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (tid == 0) {
    *s_bad = 0;
    const T d = Lc[0];
    if (!(d > T(0))) *s_bad = 1;
    Lc[0] = dsqrt(d);
  }
  __syncthreads();
  for (int j = 0; j + 1 < n; ++j) {
    const T ljj = Lc[j * n + j];
    for (int i = j + 1 + tid; i < n; i += nt) {
      T s = Lc[j * n + i];
      for (int k = 0; k < j; ++k) s -= Lc[k * n + i] * Lc[k * n + j];
      const T lij = s / ljj;
      Lc[j * n + i] = lij;
      if (i == j + 1) {
        T d = Lc[i * n + i];
        for (int k = 0; k <= j; ++k) d -= Lc[k * n + i] * Lc[k * n + i];
        if (!(d > T(0))) *s_bad = 1;
        Lc[i * n + i] = dsqrt(d);
      }
    }
    __syncthreads();
  }
  const bool bad = *s_bad != 0;
  for (int idx = tid; idx < n * n; idx += nt) {
    const int k = idx / n, i = idx % n;  // Lc[k*n + i] = L[i][k]
    if (bad) Lc[idx] = fail;
    else if (i < k) Lc[idx] = T(0);
  }
  __syncthreads();
}

// Li = L⁻¹, row-major with a zero strict upper part, of the lower factor
// held column-major in Lc (Lc[k*n + i] = L[i][k]): each thread
// forward-substitutes whole columns. The caller synchronises.
template <typename T>
__device__ void block_tri_inv_cm(T* Li, const T* Lc, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    for (int i = 0; i < j; ++i) Li[i * n + j] = T(0);
    Li[j * n + j] = T(1) / Lc[j * n + j];
    for (int i = j + 1; i < n; ++i) {
      T acc = T(0);
      for (int k = j; k < i; ++k) acc += Lc[k * n + i] * Li[k * n + j];
      Li[i * n + j] = -acc / Lc[i * n + i];
    }
  }
}

// Symmetrise a dx×dx matrix in place: X ← (X + Xᵀ)/2. The block must have
// synchronised after X was written; the caller synchronises afterwards.
template <typename T>
__device__ void block_symmetrize(T* X, int n) {
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, j = idx % n;
    if (i < j) {
      const T v = T(0.5) * (X[i * n + j] + X[j * n + i]);
      X[i * n + j] = v;
      X[j * n + i] = v;
    }
  }
}

}  // namespace bft
