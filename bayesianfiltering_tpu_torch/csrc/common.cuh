// Shared helpers for the filter kernels: constants, block-wide small
// matrix products, and the plain C entry points every library exports.
#pragma once

#include <cuda_runtime.h>

namespace bft {

constexpr double kLog2Pi = 1.8378770664093453;  // log(2π)
constexpr double kRelJitter = 1e-6;             // ops/ekf.py _REL_JITTER

__device__ inline float dsqrt(float x) { return sqrtf(x); }
__device__ inline double dsqrt(double x) { return sqrt(x); }
__device__ inline float dlog(float x) { return logf(x); }
__device__ inline double dlog(double x) { return log(x); }
__device__ inline float dabs(float x) { return fabsf(x); }
__device__ inline double dabs(double x) { return fabs(x); }

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
