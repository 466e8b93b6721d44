// Block-wide building blocks of the block-per-lane combines K10b and K12b
// and the RTS elements K11b (csrc/bank_combine.cu), of the sigma points K6
// and K7 (their Newton–Schulz rounds) and the UT update and predict K8 and
// K9 (csrc/fused_ut.cu) and of the EKF update and predict K1 and K2
// (csrc/fused_ekf.cu): a register-tiled product on operands held in a
// per-block workspace (its packed lower-triangle form, and an in-place
// form that holds its tiles in registers), staging from
// global memory (cp.async into shared memory), a bank-conflict-free
// diagonal walk for transposes and symmetric passes (an in-place
// symmetrisation), matrix-vector products over the whole block and a panel
// triangular solve.
//
// Workspace matrices are row-major with a leading dimension ld that is a
// multiple of 32 and at least the product's extent rounded up to its
// thread tile (TM rows, TN columns), so that every span a product reads,
// including its ragged edge, lies inside the matrix: entries past n hold
// whatever was there before and only ever reach outputs past n, which no
// epilogue stores.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace bft {

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

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

// Wait until at most N of this thread's most recently committed cp.async
// groups are still in flight (the older ones are complete).
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// X ← (X + Xᵀ)/2 in place for the n × n matrix X (ld a multiple of 32),
// each pair along diag_walk. The caller synchronises before and after.
template <typename T>
__device__ void symmetrize(T* X, int ld, int n) {
  diag_walk(round_up(n, kWarp), [&](int i, int j) {
    if (i < n && j < i) {
      const T v = T(0.5) * (X[i * ld + j] + X[j * ld + i]);
      X[i * ld + j] = v;
      X[j * ld + i] = v;
    }
  });
}

// dst (ld) ← the rows × cols matrix at src (row stride src_ld): 16 bytes a
// copy where the rows allow it (dst and ld aligned to 16 bytes, as the
// workspace's are). The caller commits and waits (kAsync) and
// synchronises. dst's offsets are computed in ld's type I (long long for
// a global workspace larger than an int counts).
template <typename T, bool kAsync, typename I = int>
__device__ void stage(T* dst, I ld, const T* src, size_t src_ld, int rows,
                      int cols) {
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x, nt = blockDim.x;
  if (cols % V == 0 && src_ld % V == 0 &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = cols / V;
    for (int idx = tid; idx < rows * nv; idx += nt) {
      const int i = idx / nv, c = (idx - i * nv) * V;
      copy_bytes<kAsync, 16>(dst + i * ld + c, src + i * src_ld + c);
    }
  } else {
    for (int idx = tid; idx < rows * cols; idx += nt) {
      const int i = idx / cols, j = idx - i * cols;
      copy_bytes<kAsync, sizeof(T)>(dst + i * ld + j, src + i * src_ld + j);
    }
  }
}

// dst (ld) ← the n × n row-major matrix at src.
template <typename T, bool kAsync, typename I = int>
__device__ void stage(T* dst, I ld, const T* src, int n) {
  stage<T, kAsync>(dst, ld, src, size_t(n), n, n);
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

// Whether rows of n elements at p (a global output) keep every row aligned
// to 16 bytes: the condition for vector stores.
template <typename T>
__device__ bool rows_aligned(const T* p, int n) {
  return n % (16 / int(sizeof(T))) == 0 &&
         (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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

// acc = the TM × TN tile at (i0, j0) of Σ_{k<K} A(i, k) B(k, j): A(i, k)
// is A[k·lda + i] with kAt (read as a TM-span: the "A transposed" layout)
// or A[i·lda + k] (TM rows, 16 bytes of k a load); B(k, j) is B[k·ldb +
// j], a TN-span a k. One thread's work in tile_mm and tile_mm_lower.
template <typename T, int TM, int TN, bool kAt>
__device__ __forceinline__ void tile_acc(const T* A, int lda, const T* B,
                                         int ldb, int i0, int j0, int K,
                                         T (&acc)[TM][TN]) {
  constexpr int KV = 16 / int(sizeof(T));
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
}

// C(i, j) = Σ_{k<K} A(i, k) B(k, j) for i < M, j < N over a block of NT
// threads laid out 16 × NT/16: thread (ty, tx) owns the TM × TN tile at
// (16·TM·a + TM·ty, (NT/16)·TN·b + TN·tx) of every super-tile (a, b) that
// meets [0, M) × [0, N), in independent accumulators (tile_acc: A in
// either layout, B row-major). Both operands lie in the block's workspace
// (lda, ldb multiples of 32). Tiles wholly above row_lo's boundary (rows
// < row_lo), or, with `lower`, wholly above the diagonal, are skipped;
// epi(i0, j0, acc) gets every other tile and masks what it stores to
// i < M, j < N (and i ≥ row_lo). The caller synchronises.
template <typename T, int NT, int TM, int TN, bool kAt, typename Epi>
__device__ __forceinline__ void tile_mm(const T* A, int lda, const T* B,
                                        int ldb, int M, int N, int K,
                                        int row_lo, bool lower, Epi epi) {
  constexpr int CX = NT / 16;
  const int tx = threadIdx.x % CX, ty = threadIdx.x / CX;
  for (int ib = 0; ib < M; ib += 16 * TM)
    for (int jb = 0; jb < N; jb += CX * TN) {
      const int i0 = ib + ty * TM, j0 = jb + tx * TN;
      if (i0 >= M || j0 >= N || i0 + TM <= row_lo ||
          (lower && i0 + TM <= j0))
        continue;
      T acc[TM][TN];
      tile_acc<T, TM, TN, kAt>(A, lda, B, ldb, i0, j0, K, acc);
      epi(i0, j0, acc);
    }
}

// tile_mm's product with A row-major (tile_acc's kAt = false) for a block
// in which every thread owns at most S × S super-tiles (M ≤ S·16·TM,
// N ≤ S·(NT/16)·TN): each thread's tiles stay in registers until the
// whole block has read A and B (one barrier), so that epi(i0, j0, acc)
// may store over either operand, an in-place product (K6's and K7's
// Newton–Schulz rounds, Y ← Y T and Z ← T Z, in three buffers). The caller
// synchronises after.
template <typename T, int NT, int TM, int TN, int S, typename Epi>
__device__ __forceinline__ void tile_mm_held(const T* A, int lda, const T* B,
                                             int ldb, int M, int N, int K,
                                             Epi epi) {
  constexpr int CX = NT / 16;
  const int tx = threadIdx.x % CX, ty = threadIdx.x / CX;
  T acc[S][S][TM][TN];
#pragma unroll
  for (int a = 0; a < S; ++a)
#pragma unroll
    for (int b = 0; b < S; ++b) {
      const int i0 = a * 16 * TM + ty * TM, j0 = b * CX * TN + tx * TN;
      if (i0 < M && j0 < N)
        tile_acc<T, TM, TN, false>(A, lda, B, ldb, i0, j0, K, acc[a][b]);
    }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < S; ++a)
#pragma unroll
    for (int b = 0; b < S; ++b) {
      const int i0 = a * 16 * TM + ty * TM, j0 = b * CX * TN + tx * TN;
      if (i0 < M && j0 < N) epi(i0, j0, acc[a][b]);
    }
}

// The lower tiles of an n × n product (TM × TM tiles (ti, tj), tj ≤ ti),
// numbered row by row and taken by consecutive threads: a warp holds only
// tiles below the diagonal and threads past the last tile skip the
// product, where tile_mm's lower mode keeps the 16 × NT/16 grid and idles
// the lanes above the diagonal in every warp (at n = 64: 5 warps' work in
// 8). Operands as tile_mm's; A with kAt, so that a warp's distinct tile
// rows read distinct banks. The caller synchronises.
template <typename T, int NT, int TM, typename Epi>
__device__ __forceinline__ void tile_mm_lower(const T* A, int lda, const T* B,
                                              int ldb, int n, int K,
                                              Epi epi) {
  const int nt = (n + TM - 1) / TM, tiles = nt * (nt + 1) / 2;
  for (int t = threadIdx.x; t < tiles; t += NT) {
    int ti = int((sqrtf(8.f * float(t) + 1.f) - 1.f) * 0.5f);
    while (ti * (ti + 1) / 2 > t) --ti;
    while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
    const int i0 = ti * TM, j0 = (t - ti * (ti + 1) / 2) * TM;
    T acc[TM][TM];
    tile_acc<T, TM, TM, true>(A, lda, B, ldb, i0, j0, K, acc);
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
// Vectors when the whole column segment is valid and `vec` says X's rows
// are aligned to them (always in a workspace).
template <typename T, int TM, int TN>
__device__ __forceinline__ void put_cols(T* X, int ld, int i0, int j0,
                                         const T (&acc)[TM][TN], int M, int N,
                                         bool vec = true) {
  const int valid = min(TM, M - i0);
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    if (j0 + c >= N) continue;
    T v[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) v[r] = acc[r][c];
    store_span<T, TM>(X + size_t(j0 + c) * ld + i0, v, valid, vec);
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

// f(i, Σ_k X[k·ld + i] v[k·vs]) for i < n (the product with Xᵀ; v a
// column of a workspace matrix where vs is its leading dimension): the
// block split into P = max(1, blockDim/n) parts along k, each thread one
// (part, i) partial sum (consecutive threads on consecutive i), summed
// after a barrier from part[] (max(blockDim, n) elements). Every thread
// calls it; the caller synchronises before part[] is reused. Offsets in
// ld's type I, as stage's.
template <typename T, typename F, typename I = int>
__device__ void mv_cols(const T* X, I ld, const T* v, int n, T* part, F f,
                        I vs = 1) {
  const int P = max(1, int(blockDim.x) / n), chunk = (n + P - 1) / P;
  for (int idx = threadIdx.x; idx < P * n; idx += blockDim.x) {
    const int p = idx / n, i = idx - p * n;
    const int k1 = min(n, (p + 1) * chunk);
    T s = T(0);
    for (int k = p * chunk; k < k1; ++k) s += X[k * ld + i] * v[k * vs];
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

// R ← L⁻¹ R in place for two right-hand sides, R1 (n × c1) and R2
// (n × c2, none when c2 = 0), row-major (ld), L lower triangular, held
// column-major in Lc (Lc[k·ld + i] = L[i][k], only its lower part read),
// dinv[i] = 1/L[i][i] for i < the next multiple of W (any finite value
// past n). In panels of W ≤ kWarp rows (kWarp unless the caller knows n is
// small; the factor's panel width): (1) each thread takes one column of R1
// or R2 and substitutes the panel's rows in registers against the panel's
// diagonal block, read as broadcasts, with constant trip counts (rows past
// n take garbage that is never stored: R's rows must exist to the next
// multiple of W); (2) the rows below take the panel's update as one
// tiled product a right-hand side (R's rows aligned to 16 bytes, and
// columns readable to the next multiple of TN). Two barriers a panel
// (n = 64, W = kWarp: 3). The block must have synchronised after R1, R2,
// Lc and dinv were written; ends synchronised. Offsets in ld's type I, as
// block_cholesky_panels'.
template <typename T, int NT, int TM, int TN, int W = kWarp, typename I = int>
__device__ void block_tri_solve(const T* Lc, const T* dinv, T* R1, int c1,
                                T* R2, int c2, int n, I ld) {
  for (int k = 0; k < n; k += W) {
    const int nb = min(W, n - k);
    for (int c = threadIdx.x; c < c1 + c2; c += NT) {
      T* col = c < c1 ? R1 + c : R2 + (c - c1);
      T x[W];
#pragma unroll
      for (int r = 0; r < W; ++r) x[r] = col[(k + r) * ld];
#pragma unroll
      for (int r = 0; r < W; ++r) {
        x[r] *= dinv[k + r];
        const T* Lr = Lc + (k + r) * ld + k;  // column k + r from row k
#pragma unroll
        for (int j = r + 1; j < W; ++j) x[j] -= Lr[j] * x[r];
      }
#pragma unroll
      for (int r = 0; r < W; ++r)
        if (r < nb) col[(k + r) * ld] = x[r];
    }
    __syncthreads();
    if (k + W >= n) break;
    // rows i ≥ k + W: R[i][:] −= L[i][k:k+W] R[k:k+W][:]
    const auto below = [&](T* R, int cols) {
      tile_mm<T, NT, TM, TN, true>(
          Lc + k * ld, ld, R + k * ld, ld, n, cols, W, k + W, false,
          [&](int i0, int j0, const T (&acc)[TM][TN]) {
            put_rows<true>(R, ld, i0, j0, acc, n, cols, k + W, true,
                           [](T v, int, int) { return v; });
          });
    };
    below(R1, c1);
    if (c2 > 0) below(R2, c2);
    __syncthreads();
  }
}

}  // namespace bft
