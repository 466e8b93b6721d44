// Block-wide building blocks of the block-per-lane combines K10b and K12b
// (csrc/bank_combine.cu): a register-tiled product on operands held in a
// per-block workspace, staging from global memory (cp.async into shared
// memory), a bank-conflict-free diagonal walk for transposes and
// symmetric passes, matrix-vector products over the whole block and a
// panel triangular solve.
//
// Workspace matrices are row-major with a leading dimension ld that is a
// multiple of 32 and at least the super-tile extent of the product, so
// that every row a product touches, including its ragged edge, lies inside
// the matrix: entries past n hold whatever was there before and only ever
// reach outputs past n, which no epilogue stores.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace bft {

// ---------------------------------------------------------------------------
// Staging
// ---------------------------------------------------------------------------

// B bytes from global memory at src to dst: cp.async into shared memory
// (complete after cp_async_wait_all and a barrier) when kAsync, else a
// plain load and store.
template <bool kAsync, int B>
__device__ __forceinline__ void copy_bytes(void* dst, const void* src) {
  if constexpr (kAsync) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (B == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(src)
                   : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                   "l"(src), "n"(B)
                   : "memory");
  } else if constexpr (B == 16) {
    *static_cast<uint4*>(dst) = *static_cast<const uint4*>(src);
  } else if constexpr (B == 8) {
    *static_cast<uint2*>(dst) = *static_cast<const uint2*>(src);
  } else {
    *static_cast<unsigned*>(dst) = *static_cast<const unsigned*>(src);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// f(i, j) for every (i, j) in [0, ext)², ext a multiple of 32, walked in
// 32 × 32 tiles along their diagonals: lane l of a warp takes row
// i = 32·ti + l and column j = 32·tj + (l + s) mod 32, so that both
// X[i·ld + j] and X[j·ld + i] fall in 32 distinct banks when ld is a
// multiple of 32 (a plain transpose puts all 32 lanes in one bank).
template <typename F>
__device__ __forceinline__ void diag_walk(int ext, F f) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int nw = blockDim.x / kWarp, tiles = ext / kWarp;
  for (int w = warp; w < tiles * tiles * kWarp; w += nw) {
    const int t = w / kWarp, s = w % kWarp;
    f((t / tiles) * kWarp + lane, (t % tiles) * kWarp + ((lane + s) & 31));
  }
}

// dst (ld) ← the n × n row-major matrix at src: 16 bytes a copy where the
// rows allow it. The caller commits and waits (kAsync) and synchronises.
template <typename T, bool kAsync>
__device__ void stage(T* dst, int ld, const T* src, int n) {
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x, nt = blockDim.x;
  if (n % V == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = n / V;
    for (int idx = tid; idx < n * nv; idx += nt) {
      const int i = idx / nv, c = (idx - i * nv) * V;
      copy_bytes<kAsync, 16>(dst + i * ld + c, src + size_t(i) * n + c);
    }
  } else {
    for (int idx = tid; idx < n * n; idx += nt) {
      const int i = idx / n, j = idx - i * n;
      copy_bytes<kAsync, sizeof(T)>(dst + i * ld + j, src + idx);
    }
  }
}

// dst (ld) ← the transpose of the n × n row-major matrix at src, one
// element a copy along diag_walk (conflict-free in shared memory).
template <typename T, bool kAsync>
__device__ void stage_t(T* dst, int ld, const T* src, int n) {
  diag_walk((n + kWarp - 1) / kWarp * kWarp, [&](int i, int j) {
    if (i < n && j < n)
      copy_bytes<kAsync, sizeof(T)>(dst + j * ld + i, src + size_t(i) * n + j);
  });
}

// ---------------------------------------------------------------------------
// Spans: N consecutive elements in as few loads or stores as their
// alignment (N·sizeof(T) bytes from an address aligned to that) allows
// ---------------------------------------------------------------------------

template <typename T, int N>
__device__ __forceinline__ void load_span(T (&v)[N], const T* p) {
  constexpr int bytes = N * int(sizeof(T));
  constexpr int W = bytes % 16 == 0 ? 16 / int(sizeof(T))
                    : (bytes % 8 == 0 && sizeof(T) == 4) ? 2 : 1;
  using V = typename Vec<T, W>::type;
#pragma unroll
  for (int q = 0; q < N / W; ++q) {
    const V w = reinterpret_cast<const V*>(p)[q];
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int i = 0; i < W; ++i) v[q * W + i] = e[i];
  }
}

// The first `valid` of v at p: whole vectors when all N are valid and
// `vec` says p is aligned to them, else element by element.
template <typename T, int N>
__device__ __forceinline__ void store_span(T* p, const T (&v)[N], int valid,
                                           bool vec) {
  constexpr int bytes = N * int(sizeof(T));
  constexpr int W = bytes % 16 == 0 ? 16 / int(sizeof(T))
                    : (bytes % 8 == 0 && sizeof(T) == 4) ? 2 : 1;
  using V = typename Vec<T, W>::type;
  if (vec && valid == N) {
#pragma unroll
    for (int q = 0; q < N / W; ++q) {
      V w;
      T* e = reinterpret_cast<T*>(&w);
#pragma unroll
      for (int i = 0; i < W; ++i) e[i] = v[q * W + i];
      reinterpret_cast<V*>(p)[q] = w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < valid) p[i] = v[i];
  }
}

// ---------------------------------------------------------------------------
// The register-tiled product
// ---------------------------------------------------------------------------

// C(i, j) = Σ_{k<K} A(i, k) B(k, j) for i < M, j < N over a block of NT
// threads laid out 16 × NT/16: thread (ty, tx) owns the TM × TN tile at
// (16·TM·a + TM·ty, (NT/16)·TN·b + TN·tx) of every super-tile (a, b) that
// meets [0, M) × [0, N), in independent accumulators. A(i, k) is
// A[k·lda + i] with kAt (read as a TM-span: the "A transposed" layout) or
// A[i·lda + k] (TM rows, 16 bytes of k a load); B(k, j) is B[k·ldb + j], a
// TN-span a k. Both operands lie in the block's workspace (lda, ldb
// multiples of 32). Tiles wholly above row_lo's boundary (rows < row_lo),
// or, with `lower`, wholly above the diagonal, are skipped; epi(i0, j0,
// acc) gets every other tile and masks what it stores to i < M, j < N
// (and i ≥ row_lo). The caller synchronises.
template <typename T, int NT, int TM, int TN, bool kAt, typename Epi>
__device__ __forceinline__ void tile_mm(const T* A, int lda, const T* B,
                                        int ldb, int M, int N, int K,
                                        int row_lo, bool lower, Epi epi) {
  constexpr int CX = NT / 16;
  constexpr int KV = 16 / int(sizeof(T));
  const int tx = threadIdx.x % CX, ty = threadIdx.x / CX;
  for (int ib = 0; ib < M; ib += 16 * TM)
    for (int jb = 0; jb < N; jb += CX * TN) {
      const int i0 = ib + ty * TM, j0 = jb + tx * TN;
      if (i0 >= M || j0 >= N || i0 + TM <= row_lo ||
          (lower && i0 + TM <= j0))
        continue;
      T acc[TM][TN];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = T(0);
      const T* pb = B + j0;
      if constexpr (kAt) {
        const T* pa = A + i0;
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
          T a[TM], b[TN];
          load_span<T, TM>(a, pa + size_t(k) * lda);
          load_span<T, TN>(b, pb + size_t(k) * ldb);
#pragma unroll
          for (int r = 0; r < TM; ++r)
#pragma unroll
            for (int c = 0; c < TN; ++c) acc[r][c] += a[r] * b[c];
        }
      } else {
        const T* pa = A + size_t(i0) * lda;
        int k = 0;
        for (; k + KV <= K; k += KV) {
          T a[TM][KV];
#pragma unroll
          for (int r = 0; r < TM; ++r)
            load_span<T, KV>(a[r], pa + size_t(r) * lda + k);
#pragma unroll
          for (int kk = 0; kk < KV; ++kk) {
            T b[TN];
            load_span<T, TN>(b, pb + size_t(k + kk) * ldb);
#pragma unroll
            for (int r = 0; r < TM; ++r)
#pragma unroll
              for (int c = 0; c < TN; ++c) acc[r][c] += a[r][kk] * b[c];
          }
        }
        for (; k < K; ++k) {
          T b[TN];
          load_span<T, TN>(b, pb + size_t(k) * ldb);
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            const T a = pa[size_t(r) * lda + k];
#pragma unroll
            for (int c = 0; c < TN; ++c) acc[r][c] += a * b[c];
          }
        }
      }
      epi(i0, j0, acc);
    }
}

// Epilogue: rows i ∈ [row_lo, M) of a tile into X (ld), columns < N: x ←
// f(v, i, j) for each element v, or with kSub x ← x − f(v, i, j); vectors
// when the whole row segment is valid and `vec` says X's rows are aligned
// to them.
template <bool kSub, typename T, int TM, int TN, typename F>
__device__ __forceinline__ void put_rows(T* X, size_t ld, int i0, int j0,
                                         const T (&acc)[TM][TN], int M, int N,
                                         int row_lo, bool vec, F f) {
  const int valid = min(TN, N - j0);
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int i = i0 + r;
    if (i >= M || i < row_lo) continue;
    T* p = X + i * ld + j0;
    T v[TN];
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      v[c] = f(acc[r][c], i, j0 + c);
      if constexpr (kSub) v[c] = (c < valid ? p[c] : T(0)) - v[c];
    }
    store_span<T, TN>(p, v, valid, vec);
  }
}

// Epilogue: a tile stored transposed, Xᵀ(j, i) = C(i, j), a TM-span a column.
template <typename T, int TM, int TN>
__device__ __forceinline__ void put_cols(T* X, int ld, int i0, int j0,
                                         const T (&acc)[TM][TN], int M, int N) {
  const int valid = min(TM, M - i0);
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    if (j0 + c >= N) continue;
    T v[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) v[r] = acc[r][c];
    store_span<T, TM>(X + (j0 + c) * ld + i0, v, valid, true);
  }
}

// ---------------------------------------------------------------------------
// Matrix-vector products over the whole block
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T warp_sum(T s) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// f(i, Σ_k X[i·ld + k] v[k]) for i < n: a warp a row, lanes along k (so
// the rows are read without bank conflicts), a shuffle reduction. The
// caller synchronises.
template <typename T, typename F>
__device__ void mv_rows(const T* X, int ld, const T* v, int n, F f) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int nw = blockDim.x / kWarp;
  for (int i = warp; i < n; i += nw) {
    T s = T(0);
    for (int k = lane; k < n; k += kWarp) s += X[i * ld + k] * v[k];
    s = warp_sum(s);
    if (lane == 0) f(i, s);
  }
}

// f(i, Σ_k X[k·ld + i] v[k]) for i < n (the product with Xᵀ): the block
// split into P = max(1, blockDim/n) parts along k, each thread one
// (part, i) partial sum (consecutive threads on consecutive i), summed
// after a barrier from part[] (max(blockDim, n) elements). Every thread
// calls it; the caller synchronises before part[] is reused.
template <typename T, typename F>
__device__ void mv_cols(const T* X, int ld, const T* v, int n, T* part, F f) {
  const int P = max(1, int(blockDim.x) / n), chunk = (n + P - 1) / P;
  for (int idx = threadIdx.x; idx < P * n; idx += blockDim.x) {
    const int p = idx / n, i = idx - p * n;
    const int k1 = min(n, (p + 1) * chunk);
    T s = T(0);
    for (int k = p * chunk; k < k1; ++k) s += X[k * ld + i] * v[k];
    part[idx] = s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    T s = T(0);
    for (int p = 0; p < P; ++p) s += part[p * n + i];
    f(i, s);
  }
}

// ---------------------------------------------------------------------------
// The panel triangular solve
// ---------------------------------------------------------------------------

// R1 ← L⁻¹ R1 and R2 ← L⁻¹ R2 in place (n × n, row-major, ld), L lower
// triangular, held column-major in Lc (Lc[k·ld + i] = L[i][k], only its
// lower part read), dinv[i] = 1/L[i][i] for i < ld (any finite value past
// n). In panels of kWarp rows: (1) each thread takes one column of R1 or
// R2 and substitutes the panel's rows in registers against the panel's
// diagonal block, read as broadcasts, with constant trip counts (rows past
// n take garbage that is never stored); (2) the rows below take the
// panel's update as two tiled products. Two barriers a panel (n = 64: 3).
// The block must have synchronised after R1, R2, Lc and dinv were written;
// ends synchronised.
template <typename T, int NT, int TM, int TN>
__device__ void block_tri_solve2(const T* Lc, const T* dinv, T* R1, T* R2,
                                 int n, int ld) {
  for (int k = 0; k < n; k += kWarp) {
    const int nb = min(kWarp, n - k);
    for (int c = threadIdx.x; c < 2 * n; c += NT) {
      T* col = c < n ? R1 + c : R2 + (c - n);
      T x[kWarp];
#pragma unroll
      for (int r = 0; r < kWarp; ++r) x[r] = col[(k + r) * ld];
#pragma unroll
      for (int r = 0; r < kWarp; ++r) {
        x[r] *= dinv[k + r];
        const T* Lr = Lc + (k + r) * ld + k;  // column k + r from row k
#pragma unroll
        for (int j = r + 1; j < kWarp; ++j) x[j] -= Lr[j] * x[r];
      }
#pragma unroll
      for (int r = 0; r < kWarp; ++r)
        if (r < nb) col[(k + r) * ld] = x[r];
    }
    __syncthreads();
    if (k + kWarp >= n) break;
    // rows i ≥ k + kWarp: R[i][:] −= L[i][k:k+kWarp] R[k:k+kWarp][:]
    const auto below = [&](T* R) {
      tile_mm<T, NT, TM, TN, true>(
          Lc + k * ld, ld, R + k * ld, ld, n, n, kWarp, k + kWarp, false,
          [&](int i0, int j0, const T (&acc)[TM][TN]) {
            put_rows<true>(R, ld, i0, j0, acc, n, n, k + kWarp, true,
                           [](T v, int, int) { return v; });
          });
    };
    below(R1);
    below(R2);
    __syncthreads();
  }
}

}  // namespace bft
