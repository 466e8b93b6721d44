// A lane over a group of MX threads: the machinery of the small-matrix
// bank kernels K3, K4 (csrc/bank_update.cu), K10, K11 and K12
// (csrc/bank_combine.cu), whose lanes hold d × d matrices with d ≤ 8.
//
// - Layout: each lane of the bank takes a group of MX threads (MX = 4 where
//   every dimension of the lane is ≤ 4, else 8); thread i of the group holds
//   row i of each of the lane's matrices in registers (MX entries, zero past
//   the matrix's width) and entry i of each vector. Consecutive groups take
//   consecutive lanes.
// - Loads and stores: a row goes 16 bytes at a time where every row of that
//   operand is a multiple of 16 bytes on a 16-byte boundary (rows_vec: the
//   width times sizeof(T) a multiple of 16 and every pointer aligned; lane m
//   of an operand then starts on one as any lane does), else element by
//   element. A warp reads 8 lanes × 4 rows of a 4 × 4 float32 matrix as one
//   512-byte stretch.
// - Exchanges inside the group: a product's right operand goes to the
//   group's board in shared memory (Slots slots of an MX × MX matrix and an
//   MX-vector), and each thread reads it back row by row, 16 bytes a read
//   that every thread of the group makes at one address; a transposed
//   operand is read back as a column. A product hands each thread MX²
//   values, four a 16-byte read where a shuffle gives one, and a column is
//   an address where a transpose by shuffles would index registers by the
//   thread's row. One __syncwarp ends each exchange; a slot is rewritten
//   only after a __syncwarp has followed its last read.
// - Factors: a column sweep over the group (group_chol), the pivot and the
//   column shuffled from their owners, one reciprocal square root a column.
//   A kernel whose matrix has n < MX real pivots sweeps only those n
//   columns (the bound is uniform over the warp, the loop keeps its
//   constant trip count and unrolls).
// - Launch shape: kGroupThreads = 64 threads a block, 16 lanes at MX = 4
//   (13 blocks at M = 200, 489 at M = 7,813); groups past M compute on lane
//   M − 1 and store nothing, warps wholly past M return.
#pragma once

#include <cstdint>
#include <initializer_list>

#include "block_mm.cuh"
#include "common.cuh"

namespace bft {

constexpr int kGroupThreads = 64;  // threads a block of the group kernels
constexpr unsigned kFullMask = 0xffffffffu;

// A slot of the board: an MX × MX matrix (row k at k·MX) and an MX-vector
// after it.
template <int MX>
__host__ __device__ constexpr int slot_len() {
  return MX * (MX + 1);
}

// A group's board: Slots slots, and MX more elements when Slots is even, so
// that consecutive groups' boards start an odd multiple of MX elements
// apart. A warp's reads of one row of each group's matrix (16 bytes a
// group, the group's threads reading the same address) and of one column
// (thread i reading entry i of each row) then fall in distinct banks in
// float32.
template <int MX, int Slots>
__host__ __device__ constexpr int board_len() {
  return Slots * slot_len<MX>() + (Slots % 2 == 0 ? MX : 0);
}

// Row i of a lane's rows × cols matrix at g into x, zero past the matrix:
// 16 bytes a load where `vec` (rows of 16-byte multiples on 16-byte
// boundaries), else element by element. Both read the same elements.
template <typename T, int MX>
__device__ __forceinline__ void load_row(T (&x)[MX], const T* __restrict__ g,
                                         int i, int rows, int cols,
                                         bool vec) {
  constexpr int NV = 16 / int(sizeof(T));
  using V = typename Vec<T, NV>::type;
  if (vec) {
#pragma unroll
    for (int c = 0; c < MX / NV; ++c) {
      V w{};
      if (i < rows && c * NV < cols)
        w = reinterpret_cast<const V*>(g + i * cols)[c];
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int q = 0; q < NV; ++q) x[c * NV + q] = e[q];
    }
  } else {
#pragma unroll
    for (int j = 0; j < MX; ++j)
      x[j] = (i < rows && j < cols) ? g[i * cols + j] : T(0);
  }
}

// Row i of a lane's dx × dx matrix
template <typename T, int MX>
__device__ __forceinline__ void load_row(T (&x)[MX], const T* __restrict__ g,
                                         int i, int dx, bool vec) {
  load_row(x, g, i, dx, dx, vec);
}

// Row i (i < rows) of x to a lane's rows × cols matrix at g, as load_row
// reads.
template <typename T, int MX>
__device__ __forceinline__ void store_row(T* __restrict__ g, const T (&x)[MX],
                                          int i, int rows, int cols,
                                          bool vec) {
  constexpr int NV = 16 / int(sizeof(T));
  using V = typename Vec<T, NV>::type;
  if (i >= rows) return;
  if (vec) {
#pragma unroll
    for (int c = 0; c < MX / NV; ++c) {
      if (c * NV < cols) {
        V w;
        T* e = reinterpret_cast<T*>(&w);
#pragma unroll
        for (int q = 0; q < NV; ++q) e[q] = x[c * NV + q];
        reinterpret_cast<V*>(g + i * cols)[c] = w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < MX; ++j)
      if (j < cols) g[i * cols + j] = x[j];
  }
}

template <typename T, int MX>
__device__ __forceinline__ void store_row(T* __restrict__ g, const T (&x)[MX],
                                          int i, int dx, bool vec) {
  store_row(g, x, i, dx, dx, vec);
}

template <typename T>
__device__ __forceinline__ T load_entry(const T* __restrict__ g, int i,
                                        int dx) {
  return i < dx ? g[i] : T(0);
}

// The board: thread i writes its row i, or its entry i of the vector
template <typename T, int MX>
__device__ __forceinline__ void put_row(T* s, const T (&x)[MX], int i) {
  store_span<T, MX>(s + i * MX, x, MX, true);
}

template <typename T, int MX>
__device__ __forceinline__ void put_entry(T* s, T v, int i) {
  s[MX * MX + i] = v;
}

template <typename T, int MX>
__device__ __forceinline__ void get_row(T (&x)[MX], const T* s, int k) {
  load_span<T, MX>(x, s + k * MX);
}

// Column i of the slot's matrix: the row of its transpose
template <typename T, int MX>
__device__ __forceinline__ void get_col(T (&x)[MX], const T* s, int i) {
#pragma unroll
  for (int k = 0; k < MX; ++k) x[k] = s[k * MX + i];
}

template <typename T, int MX>
__device__ __forceinline__ void get_vec(T (&x)[MX], const T* s) {
  load_span<T, MX>(x, s + MX * MX);
}

// y = x B with B's rows from the slot: y_j = Σ_k x_k B_kj, over the first
// n rows of B (the rest are zero; n is uniform over the warp)
template <typename T, int MX>
__device__ __forceinline__ void row_mul(T (&y)[MX], const T (&x)[MX],
                                        const T* s, int n = MX) {
#pragma unroll
  for (int j = 0; j < MX; ++j) y[j] = T(0);
#pragma unroll
  for (int k = 0; k < MX; ++k) {
    if (k < n) {
      T b[MX];
      get_row(b, s, k);
#pragma unroll
      for (int j = 0; j < MX; ++j) y[j] += x[k] * b[j];
    }
  }
}

// y = x Bᵀ with B's rows from the slot: y_j = Σ_k x_k B_jk, over the first
// n rows of B (y_j = 0 past them)
template <typename T, int MX>
__device__ __forceinline__ void row_mul_t(T (&y)[MX], const T (&x)[MX],
                                          const T* s, int n = MX) {
#pragma unroll
  for (int j = 0; j < MX; ++j) {
    T acc = T(0);
    if (j < n) {
      T b[MX];
      get_row(b, s, j);
#pragma unroll
      for (int k = 0; k < MX; ++k) acc += x[k] * b[k];
    }
    y[j] = acc;
  }
}

template <typename T, int MX>
__device__ __forceinline__ T dot(const T (&x)[MX], const T (&v)[MX]) {
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < MX; ++k) acc += x[k] * v[k];
  return acc;
}

// Entry i of the row: a select over constant indices (a register array
// indexed by the thread's i would go to local memory).
template <typename T, int MX>
__device__ __forceinline__ T entry(const T (&x)[MX], int i) {
  T v = x[0];
#pragma unroll
  for (int k = 1; k < MX; ++k)
    if (k == i) v = x[k];
  return v;
}

// The sum over the group by a butterfly of xor shuffles: the same value on
// every thread of the group (each step adds the same two numbers).
template <typename T, int MX>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int o = MX / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o, MX);
  return v;
}

// The maximum over the group, the same butterfly: the same bits on every
// thread.
template <typename T, int MX>
__device__ __forceinline__ T group_max(T v) {
#pragma unroll
  for (int o = MX / 2; o > 0; o >>= 1) {
    const T w = __shfl_xor_sync(kFullMask, v, o, MX);
    v = w > v ? w : v;
  }
  return v;
}

// Lower Cholesky factor of the group's symmetric matrix, thread i holding
// row i of it in a (the lower part is read) and getting row i of L (zeros
// above the diagonal): a column sweep, right-looking. At column j the
// pivot a_jj comes from thread j by one shuffle; every thread forms
// l_ij = a_ij·d^-½ (l_jj = d·d^-½: one reciprocal square root a column),
// takes l_kj from each later thread k by a shuffle and updates a_ik. Every
// loop has a constant trip count. Only the first n columns are swept (n
// uniform over the warp): the rows and columns past n must be those of the
// identity, whose factor they are, and keep their entries. Thread i < n
// gets 1/l_ii in rinv (the rest keep theirs). Returns whether every pivot
// was positive (a NaN pivot fails), the same on every thread of the group;
// a failed pivot leaves NaN (or ±∞) in the factor.
template <typename T, int MX>
__device__ __forceinline__ bool group_chol(T (&a)[MX], int i, T& rinv,
                                           int n = MX) {
  bool ok = true;
#pragma unroll
  for (int j = 0; j < MX; ++j) {
    if (j < n) {
      const T d = __shfl_sync(kFullMask, a[j], j, MX);
      ok = ok && d > T(0);
      const T rs = drsqrt(d);
      if (i == j) rinv = rs;
      const T l = i == j ? d * rs : (i > j ? a[j] * rs : T(0));
      a[j] = l;
#pragma unroll
      for (int k = j + 1; k < MX; ++k) {
        if (k < n) {
          const T lk = __shfl_sync(kFullMask, l, k, MX);
          if (i > j) a[k] -= l * lk;
        }
      }
    }
  }
  return ok;
}

// The lane of a group and its board. Groups past M compute on lane M − 1
// (every thread of a warp takes part in its shuffles and __syncwarp) and
// store nothing; a warp whose groups are all past M has returned.
template <typename T, int MX, int Slots>
struct GroupLane {
  static constexpr int kLanes = kGroupThreads / MX;  // groups a block
  // elements of a block's boards (its __shared__ array)
  static constexpr int kBoards = kLanes * board_len<MX, Slots>();
  int i;     // the thread's row
  int m;     // its lane, M − 1 for a group past M
  bool live; // whether the group stores
  T* board;  // the group's Slots slots

  __device__ GroupLane(T* boards, int M) {
    const int g = threadIdx.x / MX;
    i = threadIdx.x % MX;
    const int m0 = blockIdx.x * kLanes + g;
    live = m0 < M;
    m = live ? m0 : M - 1;
    board = boards + g * board_len<MX, Slots>();
  }
  __device__ T* slot(int s) const { return board + s * slot_len<MX>(); }
};

// Whether every thread of the warp belongs to a group past M.
template <int MX>
__device__ __forceinline__ bool warp_idle(int M) {
  constexpr int lanes = kGroupThreads / MX;
  return blockIdx.x * lanes + (threadIdx.x / kWarp) * (kWarp / MX) >= M;
}

// Blocks of a group kernel over M lanes, groups of MX threads.
inline int group_blocks(int M, int mx) {
  const int lanes = kGroupThreads / mx;
  return (M + lanes - 1) / lanes;
}

// Whether rows of n elements at every pointer start on 16-byte boundaries:
// the group kernels' 16-byte loads and stores (lane m of an operand of
// r × n matrices starts m·r·n·sizeof(T) bytes in, a multiple of 16 when a
// row is, so broadcast lanes qualify as any lane does).
template <typename T>
int rows_vec(int n, std::initializer_list<const void*> ptrs) {
  if ((n * int(sizeof(T))) % 16 != 0) return 0;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) & 15) return 0;
  return 1;
}

}  // namespace bft
