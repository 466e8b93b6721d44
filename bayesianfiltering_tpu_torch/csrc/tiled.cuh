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
// also writes C[j][i] = C[i][j], for symmetric outputs.
//
// What bounds a product on an H100: one element of a dx = 512 filter is a
// few 512³ products, ~0.1–0.3 GFLOP each, which one SM could not finish in
// under ~1 ms at its share (~0.5 TFLOP/s) of the float32 CUDA-core peak.
// TF32 and the tensor cores are off by the precision policy. So the grid is
// (row tiles, column tiles, batch): a single element's product runs on
// every SM, and a tile's operands are read once per k-slab from global
// memory (L2 at these sizes) into padded shared memory, double-buffered
// through registers, where each thread reuses every loaded value TM or TN
// times from a TM × TN register tile. Edges are bounds-checked (zeros are
// loaded past them), so any M, N, K works.
//
// Tile shapes: 64 × 64 with a 4 × 4 register tile when the grid has at
// least as many 64 × 64 tiles as the card has SMs, 32 × 32 with 2 × 2
// otherwise (one dx = 512 product is 64 tiles of 64 × 64 but 256 of
// 32 × 32); 256 threads and k-slabs of 16 either way.
//
// Thread (tx, ty) owns rows ty + i·TY and columns tx + j·TX of its block's
// tile, so within a warp the A values are broadcasts and the B values 16
// consecutive words: the shared-memory reads are free of bank conflicts,
// and the stores of C are coalesced along tx.
#pragma once

#include <cuda_runtime.h>

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
  T diag;          // + diag on the diagonal
  T* C;
  long long ldc, bc;
  int tri;         // Tri
};

// A product C = alpha·op(A)·op(B), to be completed field by field.
template <typename T>
Gemm<T> gemm_of(int M, int N, int K, int batch, Mat<T> A, Mat<T> B, T* C,
                long long ldc, long long bc, T alpha = T(1)) {
  Gemm<T> g{};
  g.M = M; g.N = N; g.batch = batch;
  g.K[0] = K; g.A[0] = A; g.B[0] = B; g.alpha[0] = alpha;
  g.C = C; g.ldc = ldc; g.bc = bc;
  return g;
}

constexpr int kGemmThreads = 256;
constexpr int kGemmBK = 16;
constexpr int kGemmPad = 2;  // row stride ≡ 2 (mod 32): conflict-free stores

// A thread's share of one R × BK panel of an operand: element (r, k) is
// op(A)[r0 + r][k0 + k] (R rows of A's tile) or op(B)[k0 + k][r0 + r]
// (R columns of B's tile). along_k: memory runs along k (A untransposed,
// B transposed); consecutive threads then take consecutive k, else
// consecutive r, so that global reads are coalesced either way.
template <typename T, int R>
struct Panel {
  static constexpr int kPer = R * kGemmBK / kGemmThreads;
  T v[kPer];

  __device__ static void coords(int s, bool along_k, int* r, int* k) {
    const int idx = threadIdx.x + s * kGemmThreads;
    *r = along_k ? idx / kGemmBK : idx % R;
    *k = along_k ? idx % kGemmBK : idx / R;
  }

  __device__ void load(const T* p, long long ld, bool along_k, int rows,
                       int kdim, int r0, int k0, T scale) {
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      int r, k;
      coords(s, along_k, &r, &k);
      const int gr = r0 + r, gk = k0 + k;
      v[s] = (gr < rows && gk < kdim)
                 ? scale * p[along_k ? gr * ld + gk : gk * ld + gr]
                 : T(0);
    }
  }

  __device__ void store(T (*S)[R + kGemmPad], bool along_k) const {
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      int r, k;
      coords(s, along_k, &r, &k);
      S[k][r] = v[s];
    }
  }
};

// acc += alpha·op(A)·op(B) over the block's tile (rows i0.., columns j0..)
// of batch element b. Ends synchronised.
template <typename T, int BM, int BN, int TM, int TN>
__device__ void gemm_accumulate(T (&acc)[TM][TN], const Mat<T>& A,
                                const Mat<T>& B, T alpha, int M, int N,
                                int K, int i0, int j0, long long b,
                                T (*As)[kGemmBK][BM + kGemmPad],
                                T (*Bs)[kGemmBK][BN + kGemmPad]) {
  constexpr int TX = BN / TN, TY = BM / TM;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const T* pa = A.p + b * A.batch;
  const T* pb = B.p + b * B.batch;
  const bool ak = !A.trans, bk = B.trans;
  Panel<T, BM> va;
  Panel<T, BN> vb;
  const int slabs = (K + kGemmBK - 1) / kGemmBK;
  va.load(pa, A.ld, ak, M, K, i0, 0, alpha);
  vb.load(pb, B.ld, bk, N, K, j0, 0, T(1));
  __syncthreads();  // earlier readers of the buffers are done
  va.store(As[0], ak);
  vb.store(Bs[0], bk);
  __syncthreads();
  for (int t = 0; t < slabs; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < slabs;
    if (more) {  // the next slab's loads are in flight during this one
      va.load(pa, A.ld, ak, M, K, i0, (t + 1) * kGemmBK, alpha);
      vb.load(pb, B.ld, bk, N, K, j0, (t + 1) * kGemmBK, T(1));
    }
#pragma unroll
    for (int k = 0; k < kGemmBK; ++k) {
      T a[TM], c[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[cur][k][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) c[j] = Bs[cur][k][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * c[j];
    }
    if (more) {
      va.store(As[cur ^ 1], ak);
      vb.store(Bs[cur ^ 1], bk);
    }
    __syncthreads();
  }
}

template <typename T, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kGemmThreads)
tiled_gemm_kernel(const Gemm<T> g) {
  static_assert((BM / TM) * (BN / TN) == kGemmThreads, "one tile a thread");
  constexpr int TX = BN / TN, TY = BM / TM;
  __shared__ T As[2][kGemmBK][BM + kGemmPad];
  __shared__ T Bs[2][kGemmBK][BN + kGemmPad];
  const int i0 = blockIdx.x * BM, j0 = blockIdx.y * BN;
  if (g.tri != kFull && i0 + BM - 1 < j0) return;  // above the diagonal
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  for (long long b = blockIdx.z; b < g.batch; b += gridDim.z) {
    T acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = T(0);
#pragma unroll
    for (int t = 0; t < 2; ++t)
      if (g.K[t] > 0)
        gemm_accumulate<T, BM, BN, TM, TN>(acc, g.A[t], g.B[t], g.alpha[t],
                                           g.M, g.N, g.K[t], i0, j0, b, As,
                                           Bs);
    T* C = g.C + b * g.bc;
    const T* Cin = g.Cin != nullptr ? g.Cin + b * g.bcin : nullptr;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = i0 + ty + i * TY;
      if (r >= g.M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = j0 + tx + j * TX;
        if (c >= g.N || (g.tri != kFull && c > r)) continue;
        T v = acc[i][j];
        if (Cin != nullptr) v += g.beta * Cin[r * g.ldcin + c];
        if (r == c) v += g.diag;
        C[r * g.ldc + c] = v;
        if (g.tri == kLowerMirror && c < r) C[c * g.ldc + r] = v;
      }
    }
  }
}

inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 1;
  return n;
}

template <typename T, int BM, int BN, int TM, int TN>
void launch_gemm(const Gemm<T>& g, cudaStream_t stream) {
  const dim3 grid((g.M + BM - 1) / BM, (g.N + BN - 1) / BN,
                  g.batch < 65535 ? g.batch : 65535);
  tiled_gemm_kernel<T, BM, BN, TM, TN><<<grid, kGemmThreads, 0, stream>>>(g);
}

// Enqueue one product on `stream`; returns cudaGetLastError().
template <typename T>
int gemm(const Gemm<T>& g, cudaStream_t stream) {
  if (g.M <= 0 || g.N <= 0 || g.batch <= 0) return 0;
  const long long tiles64 =
      (long long)((g.M + 63) / 64) * ((g.N + 63) / 64) * g.batch;
  if (tiles64 >= sm_count())
    launch_gemm<T, 64, 64, 4, 4>(g, stream);
  else
    launch_gemm<T, 32, 32, 2, 2>(g, stream);
  return int(cudaGetLastError());
}

}  // namespace bft
