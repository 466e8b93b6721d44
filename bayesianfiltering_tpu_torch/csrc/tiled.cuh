// Tiled batched matrix products spread over many thread blocks.
//
//   C[b] = Σ_t α_t·op(A_t[b])·op(B_t[b]) + β·Cin[b] + δ·I,   t = 0, 1
//
// for b < batch, with a transpose flag, a leading dimension and a batch
// stride per operand (a stride of 0 shares an operand, such as Q, across
// the batch). The second product (inner dimension K[1], 0 for none)
// accumulates into the same register tile, so sym(X Y Xᵀ + U V Uᵀ) is one
// pass over (X Y) and (U V). A lower mode computes only the tiles that
// touch the lower triangle and writes only i ≥ j; a mirrored lower mode
// also writes C[j][i] = C[i][j], for symmetric outputs. Cin may be taken
// symmetrised, β·½(Cin + Cinᵀ), so that sym(P) − ZᵀZ is one product.
// Two independent products can share a launch (gemm2: a grouped launch,
// the product picked by block index, each with its own batch), so that
// together they fill the card where each alone would leave SMs idle.
//
// What bounds a product on an H100: one element of a dx = 512 filter is a
// few 512³ products, ~0.1–0.3 GFLOP each, which one SM could not finish in
// under ~1 ms at its share (~0.5 TFLOP/s) of the float32 CUDA-core peak.
// TF32 is off by the precision policy, so float32 runs on the CUDA cores;
// float64 runs on the float64 tensor cores (mma.m8n8k4.f64, full float64
// precision, ~2× the float64 CUDA-core rate). The grid is (row tiles ×
// k-splits, column tiles, batch), a grouped launch's (both products'
// tiles × k-splits, 1, batch): a single element's product runs on every
// SM. A tile's operands are staged by cp.async, one k-slab ahead, into
// padded shared memory. In float32 each thread reuses every loaded value 4
// times from a 4 × 4 register tile: per k, two 16-byte shared loads feed
// 16 FMAs; in float64 a warp owns 16 × 32 of the tile as eight 8 × 8
// fragments. Edges are bounds-checked (cp.async fills zeros past them), so
// any M, N, K works.
//
// Tile shapes: 64 × 64 over 256 threads when the grid has at least as many
// such tiles as the card has SMs; otherwise 64 × 32 over 128 threads, and
// where even those tiles leave SMs idle (a 512 × 256 output at batch 1 is
// 64 of them), the inner dimension is split over a thread-block cluster of
// 2 or 4 blocks on one output tile: each block sums its share of k, and
// the cluster's first block adds the others' partial tiles from their
// shared memory (distributed shared memory, in a fixed order) before the
// epilogue. No atomics, no second pass.
//
// In float32, thread (tx, ty) owns rows 4ty..4ty+3 and columns
// 4tx..4tx+3 of its block's tile; a warp's shared loads of A are
// broadcasts and of B 16-byte vectors on consecutive addresses, free of
// bank conflicts.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "block_mm.cuh"

namespace bft {

// One operand: element (r, c) of op(X) for batch element b is
// p[b·batch + r·ld + c], or p[b·batch + c·ld + r] when trans.
template <typename T>
struct Mat {
  const T* p;
  long long ld;
  long long batch;
  int trans;
};

enum Tri { kFull = 0, kLower = 1, kLowerMirror = 2 };

template <typename T>
struct Gemm {
  int M, N, batch;
  int K[2];        // inner dimensions; K[1] = 0 for a single product
  Mat<T> A[2], B[2];
  T alpha[2];
  const T* Cin;    // + beta·Cin (may be C itself); nullptr for none
  long long ldcin, bcin;
  T beta;
  int sym_cin;     // + beta·½(Cin + Cinᵀ) instead (square C)
  T diag;          // + diag on the diagonal
  T* C;
  long long ldc, bc;
  int tri;         // Tri
  int split;       // k-splits (the cluster's size); set by the launch
};

// A product C = alpha·op(A)·op(B), to be completed field by field.
template <typename T>
Gemm<T> gemm_of(int M, int N, int K, int batch, Mat<T> A, Mat<T> B, T* C,
                long long ldc, long long bc, T alpha = T(1)) {
  Gemm<T> g{};
  g.M = M; g.N = N; g.batch = batch;
  g.K[0] = K; g.A[0] = A; g.B[0] = B; g.alpha[0] = alpha;
  g.C = C; g.ldc = ldc; g.bc = bc;
  g.split = 1;
  return g;
}

constexpr int kGemmBK = 16;   // the k-slab
constexpr int kGemmTM = 4;    // the register tile
constexpr int kGemmPad = 4;   // keeps 16-byte rows; stride ≢ 0 (mod 32)
constexpr int kMaxSplit = 4;

// The block's tile configuration: BM × BN outputs over NT threads.
template <typename T, int BM, int BN, int NT>
struct GemmCfg {
  static constexpr int TX = BN / kGemmTM, TY = BM / kGemmTM;
  static_assert(TX * TY == NT, "one 4 x 4 register tile a thread");
  static constexpr int LA = BM + kGemmPad, LB = BN + kGemmPad;
  static constexpr int kStage = kGemmBK * (LA + LB);  // one slab of both
  static constexpr int kSmem = 2 * kStage;            // two slabs in turn
  static_assert(kSmem >= kGemmTM * kGemmTM * NT, "room for a partial tile");
};

// Stage one BK-slab of op(X) (R rows of A's tile, or R columns of B's
// tile, from r0; k from k0 to kend) into S[k][r] by cp.async, zeros past
// rows / kend. along_k: memory runs along k (A untransposed, B
// transposed); consecutive threads then take consecutive k, else
// consecutive r, so that global reads are coalesced either way.
template <typename T, int R, int NT, int LD>
__device__ __forceinline__ void stage_slab(T* S, const T* p, long long ld,
                                           bool along_k, int rows, int kend,
                                           int r0, int k0) {
  constexpr int kPer = R * kGemmBK / NT;
  static_assert(kPer * NT == R * kGemmBK, "whole slabs");
#pragma unroll
  for (int s = 0; s < kPer; ++s) {
    const int idx = threadIdx.x + s * NT;
    const int r = along_k ? idx / kGemmBK : idx % R;
    const int k = along_k ? idx % kGemmBK : idx / R;
    const int gr = r0 + r, gk = k0 + k;
    const bool in = gr < rows && gk < kend;
    const T* src = in ? p + (along_k ? gr * ld + gk : gk * ld + gr) : p;
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(S + k * LD + r));
    // src-size 0 fills the element with zeros and reads nothing
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(sizeof(T)), "r"(in ? int(sizeof(T)) : 0)
                 : "memory");
  }
}

// Four consecutive shared-memory values (16-byte aligned) into v.
__device__ __forceinline__ void lds4(float (&v)[4], const float* p) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
}
__device__ __forceinline__ void lds4(double (&v)[4], const double* p) {
  const double2 w0 = *reinterpret_cast<const double2*>(p);
  const double2 w1 = *reinterpret_cast<const double2*>(p + 2);
  v[0] = w0.x; v[1] = w0.y; v[2] = w1.x; v[3] = w1.y;
}

// part += the staged slab's product (As[k][r], Bs[k][c]), float32 on the
// CUDA cores: thread (tx, ty)'s 4 × 4 tile, two 16-byte shared loads
// feeding 16 FMAs a k.
template <int BM, int BN, int NT>
__device__ __forceinline__ void slab_product(float (&part)[kGemmTM][kGemmTM],
                                             const float* As,
                                             const float* Bs, int tx,
                                             int ty) {
  using Cfg = GemmCfg<float, BM, BN, NT>;
#pragma unroll
  for (int k = 0; k < kGemmBK; ++k) {
    float a[kGemmTM], c[kGemmTM];
    lds4(a, As + k * Cfg::LA + ty * kGemmTM);
    lds4(c, Bs + k * Cfg::LB + tx * kGemmTM);
#pragma unroll
    for (int i = 0; i < kGemmTM; ++i)
#pragma unroll
      for (int j = 0; j < kGemmTM; ++j) part[i][j] += a[i] * c[j];
  }
}

// D(8×8) += A(8×4)·B(4×8) on the float64 tensor cores (full float64):
// lane l holds A[l/4][l%4], B[l%4][l/4] and D[l/4][2(l%4) + {0, 1}].
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// The float64 slab on the tensor cores: warp w owns 16 rows × 32 columns
// of the tile (rows 16·(w / (BN/32)), columns 32·(w % (BN/32))), two 8-row
// by four 8-column fragments; the same 16 accumulators a thread as the
// float32 tile, fragment (m, n)'s pair at flat index 8m + 2n of part
// (gemm_entry).
template <int BM, int BN, int NT>
__device__ __forceinline__ void slab_product(double (&part)[kGemmTM][kGemmTM],
                                             const double* As,
                                             const double* Bs, int, int) {
  using Cfg = GemmCfg<double, BM, BN, NT>;
  static_assert((BM / 16) * (BN / 32) * kWarp == NT, "16 x 32 a warp");
  const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
  const int g = lane / 4, t = lane % 4;
  const int r0 = 16 * (w / (BN / 32)), c0 = 32 * (w % (BN / 32));
#pragma unroll
  for (int ks = 0; ks < kGemmBK; ks += 4) {
    const double* Ak = As + (ks + t) * Cfg::LA + r0 + g;
    const double* Bk = Bs + (ks + t) * Cfg::LB + c0 + g;
    const double a0 = Ak[0], a1 = Ak[8];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const double b = Bk[8 * n];
      dmma(*reinterpret_cast<double(*)[2]>(&part[n / 2][2 * (n % 2)]), a0,
           b);
      dmma(*reinterpret_cast<double(*)[2]>(&part[2 + n / 2][2 * (n % 2)]),
           a1, b);
    }
  }
}

// The tile row and column of accumulator (i, j) of this thread: the
// float32 4 × 4 register tile, or the float64 fragments (flat index
// 4i + j = 8m + 2n + e: row 8m + l/4 of the warp's 16, column
// 8n + 2(l%4) + e of its 32).
template <typename T, int BN>
__device__ __forceinline__ void gemm_entry(int i, int j, int tx, int ty,
                                           int* r, int* c) {
  if constexpr (sizeof(T) == 4) {
    *r = ty * kGemmTM + i;
    *c = tx * kGemmTM + j;
  } else {
    const int lane = threadIdx.x % kWarp, w = threadIdx.x / kWarp;
    const int m = i / 2, n = (i % 2) * 2 + j / 2;
    *r = 16 * (w / (BN / 32)) + 8 * m + lane / 4;
    *c = 32 * (w % (BN / 32)) + 8 * n + 2 * (lane % 4) + j % 2;
  }
}

// acc += alpha·op(A)·op(B) over k in [kbeg, kend) of the block's tile
// (rows i0.., columns j0..) of batch element b. Ends synchronised.
template <typename T, int BM, int BN, int NT>
__device__ void gemm_accumulate(T (&acc)[kGemmTM][kGemmTM], const Mat<T>& A,
                                const Mat<T>& B, T alpha, int M, int N,
                                int kbeg, int kend, int i0, int j0,
                                long long b, T* smem) {
  using Cfg = GemmCfg<T, BM, BN, NT>;
  const int tx = threadIdx.x % Cfg::TX, ty = threadIdx.x / Cfg::TX;
  const T* pa = A.p + b * A.batch;
  const T* pb = B.p + b * B.batch;
  const bool ak = !A.trans, bk = B.trans;
  const int slabs = kend > kbeg ? (kend - kbeg + kGemmBK - 1) / kGemmBK : 0;
  if (slabs == 0) return;
  T part[kGemmTM][kGemmTM];
#pragma unroll
  for (int i = 0; i < kGemmTM; ++i)
#pragma unroll
    for (int j = 0; j < kGemmTM; ++j) part[i][j] = T(0);
  __syncthreads();  // earlier readers of the buffers are done
  stage_slab<T, BM, NT, Cfg::LA>(smem, pa, A.ld, ak, M, kend, i0, kbeg);
  stage_slab<T, BN, NT, Cfg::LB>(smem + kGemmBK * Cfg::LA, pb, B.ld, bk, N,
                                 kend, j0, kbeg);
  cp_async_commit();
  for (int t = 0; t < slabs; ++t) {
    T* cur = smem + (t & 1) * Cfg::kStage;
    if (t + 1 < slabs) {  // the next slab is in flight during this one
      T* nxt = smem + ((t + 1) & 1) * Cfg::kStage;
      const int k0 = kbeg + (t + 1) * kGemmBK;
      stage_slab<T, BM, NT, Cfg::LA>(nxt, pa, A.ld, ak, M, kend, i0, k0);
      stage_slab<T, BN, NT, Cfg::LB>(nxt + kGemmBK * Cfg::LA, pb, B.ld, bk,
                                     N, kend, j0, k0);
      cp_async_commit();
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();
    slab_product<BM, BN, NT>(part, cur, cur + kGemmBK * Cfg::LA, tx, ty);
    __syncthreads();  // this slab's buffer is staged again two slabs on
  }
#pragma unroll
  for (int i = 0; i < kGemmTM; ++i)
#pragma unroll
    for (int j = 0; j < kGemmTM; ++j) acc[i][j] += alpha * part[i][j];
}

// Two products in a launch, each over its own batch: block x of the grid
// belongs to product 1 from first1 on, to product 0 before it; both have
// the same tile shape and k-split.
template <typename T>
struct GemmPair {
  Gemm<T> g[2];
  int first1;  // product 1's first block: product 0's tiles × its split
};

// The output tile at (i0, j0) of product g for batch elements b0, b0 +
// bstep, …: block rank s of a cluster of g.split blocks on the tile sums
// the s-th share of every inner dimension, and the first block adds the
// others' partial tiles before the epilogue.
template <typename T, int BM, int BN, int NT>
__device__ __forceinline__ void gemm_tile(const Gemm<T>& g, int i0, int j0,
                                          int s, long long b0,
                                          long long bstep, T* smem) {
  using Cfg = GemmCfg<T, BM, BN, NT>;
  const int split = g.split;
  const int tx = threadIdx.x % Cfg::TX, ty = threadIdx.x / Cfg::TX;
  for (long long b = b0; b < g.batch; b += bstep) {
    T acc[kGemmTM][kGemmTM];
#pragma unroll
    for (int i = 0; i < kGemmTM; ++i)
#pragma unroll
      for (int j = 0; j < kGemmTM; ++j) acc[i][j] = T(0);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (g.K[t] <= 0) continue;
      // this block's share of k, in whole slabs
      const int per =
          (g.K[t] + split * kGemmBK - 1) / (split * kGemmBK) * kGemmBK;
      const int kb = s * per, ke = min(g.K[t], kb + per);
      gemm_accumulate<T, BM, BN, NT>(acc, g.A[t], g.B[t], g.alpha[t], g.M,
                                     g.N, kb, ke, i0, j0, b, smem);
    }
    if (split > 1) {
      namespace cg = cooperative_groups;
      cg::cluster_group cluster = cg::this_cluster();
      __syncthreads();
      // element e of thread t's partial at red[e·NT + t]: the first block
      // reads each remote tile with consecutive threads on consecutive words
      T* red = smem;
      if (s != 0) {
#pragma unroll
        for (int i = 0; i < kGemmTM; ++i)
#pragma unroll
          for (int j = 0; j < kGemmTM; ++j)
            red[(i * kGemmTM + j) * NT + threadIdx.x] = acc[i][j];
      }
      cluster.sync();
      if (s == 0)
        for (int r = 1; r < split; ++r) {
          const T* other = cluster.map_shared_rank(red, r);
#pragma unroll
          for (int i = 0; i < kGemmTM; ++i)
#pragma unroll
            for (int j = 0; j < kGemmTM; ++j)
              acc[i][j] += other[(i * kGemmTM + j) * NT + threadIdx.x];
        }
      cluster.sync();  // the partials stay until they have been read
      if (s != 0) continue;
    }
    T* C = g.C + b * g.bc;
    const T* Cin = g.Cin != nullptr ? g.Cin + b * g.bcin : nullptr;
#pragma unroll
    for (int i = 0; i < kGemmTM; ++i) {
#pragma unroll
      for (int j = 0; j < kGemmTM; ++j) {
        int r, c;
        gemm_entry<T, BN>(i, j, tx, ty, &r, &c);
        r += i0;
        c += j0;
        if (r >= g.M || c >= g.N || (g.tri != kFull && c > r)) continue;
        T v = acc[i][j];
        if (Cin != nullptr)
          v += g.sym_cin ? g.beta * (T(0.5) * (Cin[r * g.ldcin + c] +
                                               Cin[c * g.ldcin + r]))
                         : g.beta * Cin[r * g.ldcin + c];
        if (r == c) v += g.diag;
        C[r * g.ldc + c] = v;
        if (g.tri == kLowerMirror && c < r) C[c * g.ldc + r] = v;
      }
    }
  }
}

// Grid (row tiles × g.split, column tiles, batch); a cluster of g.split
// blocks along x shares one output tile.
template <typename T, int BM, int BN, int NT>
__global__ void __launch_bounds__(NT) tiled_gemm_kernel(const Gemm<T> g) {
  using Cfg = GemmCfg<T, BM, BN, NT>;
  __shared__ __align__(16) T smem[Cfg::kSmem];
  const int i0 = (blockIdx.x / g.split) * BM, j0 = blockIdx.y * BN;
  if (g.tri != kFull && i0 + BM - 1 < j0) return;  // the whole cluster
  gemm_tile<T, BM, BN, NT>(g, i0, j0, blockIdx.x % g.split, blockIdx.z,
                           gridDim.z, smem);
}

// The grouped launch: grid (Σ tiles × split, 1, batch), each product's
// tiles in row-major order. (Reaching the product by a branch instead of
// an index, each with its fields at fixed parameter offsets, was slower
// at config 5 on an H100.)
template <typename T, int BM, int BN, int NT>
__global__ void __launch_bounds__(NT)
    tiled_gemm_pair_kernel(const __grid_constant__ GemmPair<T> pair) {
  using Cfg = GemmCfg<T, BM, BN, NT>;
  __shared__ __align__(16) T smem[Cfg::kSmem];
  const int p = int(blockIdx.x) >= pair.first1 ? 1 : 0;
  const Gemm<T>& g = pair.g[p];
  const int local = int(blockIdx.x) - (p ? pair.first1 : 0);
  const int tile = local / g.split, nt = (g.N + BN - 1) / BN;
  const int i0 = (tile / nt) * BM, j0 = (tile % nt) * BN;
  if (g.tri != kFull && i0 + BM - 1 < j0) return;  // the whole cluster
  gemm_tile<T, BM, BN, NT>(g, i0, j0, local % g.split, blockIdx.z, gridDim.z,
                           smem);
}

inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 1;
  return n;
}

// Output tiles of BM × BN that the product computes (lower modes skip
// those above the diagonal), over the batch.
template <typename T>
long long live_tiles(const Gemm<T>& g, int BM, int BN) {
  const int mt = (g.M + BM - 1) / BM, nt = (g.N + BN - 1) / BN;
  long long tiles = 0;
  for (int i = 0; i < mt; ++i) {
    const int last = g.tri != kFull ? min(nt, (i * BM + BM - 1) / BN + 1) : nt;
    tiles += last;
  }
  return tiles * g.batch;
}

// Launch `kernel` on `grid` blocks of nt threads, in clusters of `split`
// blocks along x; returns the launch's error.
template <typename Kernel, typename Arg>
int launch_tiles(Kernel kernel, const Arg& arg, dim3 grid, int nt, int split,
                 cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(nt);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (split > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = unsigned(split);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return int(cudaLaunchKernelEx(&cfg, kernel, arg));
}

inline unsigned batch_grid(int batch) {
  return unsigned(batch < 65535 ? batch : 65535);
}

template <typename T, int BM, int BN, int NT>
int launch_gemm(Gemm<T> g, int split, cudaStream_t stream) {
  g.split = split;
  const dim3 grid(unsigned((g.M + BM - 1) / BM * split),
                  unsigned((g.N + BN - 1) / BN), batch_grid(g.batch));
  return launch_tiles(tiled_gemm_kernel<T, BM, BN, NT>, g, grid, NT, split,
                      stream);
}

// The grid's batch rows cover the larger batch; the other product's
// blocks in the rows past its own batch find no element and return.
template <typename T, int BM, int BN, int NT>
int launch_gemm_pair(GemmPair<T> pair, int split, cudaStream_t stream) {
  long long blocks = 0;
  for (int p = 0; p < 2; ++p) {
    Gemm<T>& g = pair.g[p];
    g.split = split;
    if (p == 1) pair.first1 = int(blocks);
    blocks += 1LL * ((g.M + BM - 1) / BM) * ((g.N + BN - 1) / BN) * split;
  }
  const int batch = pair.g[0].batch > pair.g[1].batch ? pair.g[0].batch
                                                      : pair.g[1].batch;
  return launch_tiles(tiled_gemm_pair_kernel<T, BM, BN, NT>, pair,
                      dim3(unsigned(blocks), 1u, batch_grid(batch)), NT,
                      split, stream);
}

// The k-split of a product whose 64 × 32 tiles number `tiles`: 4 where
// they would fill at most a quarter of the SMs, 2 where at most all of
// them, as long as each share keeps at least two slabs of the longer inner
// dimension. (Float32 on an H100 at config 5's shapes: a split of 2 beat
// 1 and 4 at 64 and 128 tiles, 4 beat 2 at 20.)
inline int gemm_split(long long tiles, int K, int sms) {
  int split = tiles * kMaxSplit <= sms ? kMaxSplit : (tiles <= sms ? 2 : 1);
  while (split > 1 && K < 2 * split * 2 * kGemmBK) split /= 2;
  return split;
}

inline bool empty_product(int M, int N, int batch) {
  return M <= 0 || N <= 0 || batch <= 0;
}

// Enqueue one product on `stream`: 64 × 64 tiles where they fill the card,
// else 64 × 32 with a k-split. Returns the launch's error.
template <typename T>
int gemm(const Gemm<T>& g, cudaStream_t stream) {
  if (empty_product(g.M, g.N, g.batch)) return 0;
  const int sms = sm_count();
  if (live_tiles(g, 64, 64) >= sms)
    return launch_gemm<T, 64, 64, 256>(g, 1, stream);
  const int K = g.K[0] > g.K[1] ? g.K[0] : g.K[1];
  return launch_gemm<T, 64, 32, 128>(
      g, gemm_split(live_tiles(g, 64, 32), K, sms), stream);
}

// The k-split of a grouped launch of two products whose 64 × 32 tiles
// number ta and tb: gemm_split of both, or 2 where the pair's tiles just
// pass the SMs but the larger product's alone do not, so that it keeps
// its share of k as it would have alone, the pair's blocks staying within
// 2.5 an SM. (K7t's Newton–Schulz rounds at dx = 512, dn = 256 on an
// H100: 1.36 → 1.07 ms in float32. At dn = 512, and K2t, the pair's tiles
// fill the card twice and keep a split of 1.)
inline int pair_split(long long ta, long long tb, int K, int sms) {
  const int split = gemm_split(ta + tb, K, sms);
  if (split == 1 && (ta > tb ? ta : tb) <= sms && 4 * (ta + tb) <= 5LL * sms &&
      K >= 2 * 2 * 2 * kGemmBK)
    return 2;
  return split;
}

// Enqueue two independent products as one grouped launch (each with its
// own batch), the tile shape and k-split chosen as gemm's from their
// tiles together.
template <typename T>
int gemm2(const Gemm<T>& a, const Gemm<T>& b, cudaStream_t stream) {
  if (empty_product(b.M, b.N, b.batch)) return gemm(a, stream);
  if (empty_product(a.M, a.N, a.batch)) return gemm(b, stream);
  const GemmPair<T> pair{{a, b}, 0};
  const int sms = sm_count();
  if (live_tiles(a, 64, 64) + live_tiles(b, 64, 64) >= sms)
    return launch_gemm_pair<T, 64, 64, 256>(pair, 1, stream);
  int K = a.K[0] > a.K[1] ? a.K[0] : a.K[1];
  K = b.K[0] > K ? b.K[0] : K;
  K = b.K[1] > K ? b.K[1] : K;
  return launch_gemm_pair<T, 64, 32, 128>(
      pair, pair_split(live_tiles(a, 64, 32), live_tiles(b, 64, 32), K, sms),
      stream);
}

}  // namespace bft
