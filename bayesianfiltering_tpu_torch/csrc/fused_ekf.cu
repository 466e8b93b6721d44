// Batched EKF measurement update (K1) and covariance predict (K2).
//
// Replaces the TPU kernels bayesianfiltering_tpu/ops/fused_ekf.py
// `_update_kernel` (K1) and `_predict_kernel` (K2). The TPU versions are
// single-stream: a vmapped pallas_call runs its grid serially, so the TPU
// package switches them off for the batched bench workload. These take a
// leading batch axis, one thread block per batch element, so the batched
// filter goes through them.
//
// What bounds them on an H100: at the main-path shape (B=512, dx=64,
// dy=32) one update is ~0.8 MFLOP per element, mostly the dx³ products of
// the Joseph form, and one predict ~0.9 MFLOP — far too little per block
// to feed the tensor cores, and TF32 is off by the precision policy, so all
// arithmetic runs on the CUDA cores in the working type. A block is bound
// by the issue rate of its products' fused multiply-adds and shared-memory
// loads, and by the latency of the factor's serial chain and of the
// barriers between dependent products; how many blocks share an SM is set
// by the workspace and the registers.
//
// What the design does about it (csrc/block_mm.cuh, as K8/K9 and
// K10b/K12b):
// - The operands are staged by cp.async into one workspace in dynamic
//   shared memory whose rows are aligned to 16 bytes (UpdateWs,
//   PredictWs), and every product is one register-tiled tile_mm (4 × 4
//   outputs a thread over 256 threads, a 64 × 64 super-tile). No operand is
//   transposed: a product that needs Hᵀ, Aᵀ, Kᵀ, Pᵀ or Rtᵀ on its left
//   reads the stored matrix in tile_mm's A-transposed layout, and a product
//   whose transpose is needed stores it transposed from registers
//   (put_cols).
// - K1 factors S with the panel factor (common.cuh block_cholesky_panels)
//   and one rectangular panel solve (block_mm.cuh block_tri_solve) gives
//   [Z | z | L⁻¹] = L⁻¹ [H P | innov | I] in place; L⁻¹ is what the
//   reference forms too (chol_and_inv_lower), and it comes out exactly
//   lower triangular. Panels of 16 (8 at dy ≤ 8): with panels of 32 the
//   one-warp factor of L96's S was a block's longest step and its
//   registers held float32 to one block an SM (PERF.md §6).
// - The covariance keeps the reference's Joseph form: cov = A P Aᵀ +
//   K Rt Kᵀ with A = I − K H is one product [A P | K Rt] · [Aᵀ ; Kᵀ] over
//   dx + dy, its first operand formed as its transpose [P Aᵀ ; Rt Kᵀ] so
//   that the product reads it in the A-transposed layout and can take
//   the packed lower tiles (tile_mm_lower: 5 warps' work of 8 at dx = 64);
//   K2's Σ⁺ = Fx P Fxᵀ + Fq Q Fqᵀ is one product [Fx | Fq] · [(Fx P)ᵀ ;
//   (Fq Q)ᵀ] over dx + dq (tile_mm's lower mode; staging Fᵀ for the
//   packed tiles was not faster). Their P, Rt and Q are symmetrised in
//   place first: A sym(P) Aᵀ = sym(A P Aᵀ) in exact arithmetic, so the
//   product is the reference's symmetrised result to rounding for any
//   input, and only its lower tiles are computed. The epilogue stores each
//   tile and its mirror from registers (a tile on the diagonal averaged
//   with its own transpose first), so the output is exactly symmetric.
// - Regions whose operands are dead are reused (H and the right-hand side
//   become [P Aᵀ ; Rt Kᵀ], (H P)ᵀ and S become Aᵀ): at the main-path shape
//   K1's workspace is 17,472 elements (68 KB in float32, where its 128
//   registers allow two blocks an SM; 137 KB in float64, one) and K2's
//   24,576 (96 KB: two blocks an SM; 192 KB in float64). An element whose
//   workspace exceeds the opt-in limit goes to the tiled variants K1t and
//   K2t instead (ekf_tiled.cu; ops/fused_ekf.py chooses by shape).
//
// Math and constants follow ops/ekf.py chol_update_precomputed, in its
// order: S = sym(Rt + H P Hᵀ) plus the floor jitter + 1e-6·max|diag S|,
// L = chol(S), Z = L⁻¹ H P, Kᵀ = W = L⁻ᵀ Z, cov = sym(A P Aᵀ + K Rt Kᵀ),
// μ = m + K innov, and the log-likelihood from diag L and z = L⁻¹ innov.
// A non-PD S gives NaN in every output (the pivots' reciprocals are NaN),
// as the plain version's cholesky_nan does; nothing here raises.
#include "block_mm.cuh"
#include "common.cuh"

namespace {

using namespace bft;

constexpr int kThreads = 256;
constexpr int kTM = 4, kTN = 4;  // tile_mm's thread tile over 256 threads
constexpr int kPanel = 16;       // the factor's and solve's panel width
constexpr int kNarrowPanel = 8;  // and at dy ≤ 8

__host__ __device__ size_t larger(size_t a, size_t b) { return a > b ? a : b; }

// K1's workspace (ops/fused_ekf.py _update_ws), offsets in elements. Every
// leading dimension is a multiple of 32 and every region starts at a
// multiple of 32 elements, so every row is aligned to 16 bytes:
//   P, then sym(P)             dx × ldx
//   Rt, then sym(Rt)           dy × ldy
//   H                          round_up(dy, 4) × ldx   ┐ later [P Aᵀ ;
//   [H P | innov | pad | I]    ry × ldr                ┘ Rt Kᵀ], (dx + dy) × ldx
//   (H P)ᵀ, then S and L       dx × ldy, ry × ldr      ┐ later Aᵀ and W = Kᵀ,
//                                                       ┘ (dx + dy) × ldx
//   the pivots' reciprocals, the innovation            ry each
// with ry = ldy (the panel solve's rows reach the next multiple of 32), I
// from column oi = round_up(dx + 1, 4) (16-byte aligned), L with the
// right-hand side's leading dimension ldr (block_tri_solve reads both with
// one), and W right below Aᵀ so that [Aᵀ ; W] is one operand.
struct UpdateWs {
  int ldx, ldy, ldr, oi;
  size_t rt, h, rhs, q, lc, w, dinv, inn, total;
  __host__ __device__ UpdateWs(int dx, int dy)
      : ldx(round_up(dx, 32)),
        ldy(round_up(dy, 32)),
        ldr(round_up(round_up(dx + 1, 4) + dy, 32)),
        oi(round_up(dx + 1, 4)) {
    rt = size_t(dx) * ldx;
    h = rt + size_t(dy) * ldy;
    rhs = h + size_t(round_up(dy, 4)) * ldx;
    q = larger(rhs + size_t(ldy) * ldr, h + size_t(dx + dy) * ldx);
    lc = q + size_t(dx) * ldy;
    w = q + size_t(dx) * ldx;
    dinv = larger(lc + size_t(ldy) * ldr, w + size_t(dy) * ldx);
    inn = dinv + ldy;
    total = inn + ldy;
  }
};

// K2's workspace (ops/fused_ekf.py _predict_ws): [Fx | 0 | Fq] with Fq
// from the 16-byte aligned column oq = round_up(dx, 4) (the pad columns
// zero), P, Q, and G = [(Fx P)ᵀ ; 0 ; (Fq Q)ᵀ] (oq + dq rows, the pad rows
// zero), so that Σ⁺ = [Fx | 0 | Fq] · G is one product over oq + dq.
struct PredictWs {
  int oq, ldF, ldx, ldq;
  size_t p, q, g, total;
  __host__ __device__ PredictWs(int dx, int dq)
      : oq(round_up(dx, 4)),
        ldF(round_up(round_up(dx, 4) + dq, 32)),
        ldx(round_up(dx, 32)),
        ldq(round_up(dq, 32)) {
    p = size_t(oq) * ldF;
    q = p + size_t(dx) * ldx;
    g = q + size_t(dq) * ldq;
    total = g + size_t(oq + dq) * ldx;
  }
};

// The epilogue of a symmetric product's lower tiles into out (n × n, rows
// of ld): each tile and its mirror, a tile on the diagonal first averaged
// with its transpose (the thread holds both), so out is exactly symmetric.
template <typename T>
__device__ __forceinline__ void put_mirrored(T* out, int ld, int i0, int j0,
                                             const T (&acc)[kTM][kTN], int n,
                                             bool vec) {
  static_assert(kTM == kTN, "a diagonal tile holds its own transpose");
  T v[kTM][kTN];
#pragma unroll
  for (int r = 0; r < kTM; ++r)
#pragma unroll
    for (int c = 0; c < kTN; ++c)
      v[r][c] = i0 == j0 ? T(0.5) * (acc[r][c] + acc[c][r]) : acc[r][c];
  put_rows<false>(out, ld, i0, j0, v, n, n, 0, vec,
                  [](T x, int, int) { return x; });
  put_cols(out, ld, i0, j0, v, n, n, vec);
}

// K1: the Joseph-form update of one element. Barriers: staging, H P, S,
// its symmetrisation and floor, the factor (three a panel), the pivots,
// the solve (two a panel), W, Aᵀ, [P Aᵀ ; Rt Kᵀ].
template <typename T>
__global__ void __launch_bounds__(kThreads) ekf_update_kernel(
    const T* __restrict__ m_all, const T* __restrict__ P_all,
    const T* __restrict__ H_all, const T* __restrict__ R_all,
    const T* __restrict__ inn_all, T* ll_all, T* mean_all, T* cov_all,
    T* kt_all, int dx, int dy, T jitter) {
  constexpr int NT = kThreads;
  __shared__ int s_bad;
  __shared__ T s_logdet;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const UpdateWs L(dx, dy);
  const int ldx = L.ldx, ldy = L.ldy, ldr = L.ldr, oi = L.oi;
  const auto same = [](T v, int, int) { return v; };

  T* ws = shared_workspace<T>();
  T* ps = ws;              // P, then sym(P)
  T* rs = ws + L.rt;       // Rt, then sym(Rt)
  T* hs = ws + L.h;        // H
  T* rhs = ws + L.rhs;     // [H P | innov | pad | I], then [Z | z | pad | L⁻¹]
  T* xt = ws + L.h;        // [P Aᵀ ; Rt Kᵀ] = [A P | K Rt]ᵀ, over H and rhs
  T* hpt = ws + L.q;       // (H P)ᵀ
  T* lc = ws + L.lc;       // S, then L (lc[k·ldr + i] = L[i][k])
  T* at = ws + L.q;        // Aᵀ = I − Hᵀ W, over (H P)ᵀ and S
  T* wr = ws + L.w;        // W = Kᵀ = L⁻ᵀ Z, right below Aᵀ
  T* dinv = ws + L.dinv;   // the pivots' reciprocals
  T* inn = ws + L.inn;     // the innovation
  T* kt = kt_all + b * dy * dx;

  // 0. P, H and Rt staged (cp.async); the innovation and the identity into
  //    the right-hand side
  stage<T, true>(ps, ldx, P_all + b * dx * dx, dx);
  stage<T, true>(hs, ldx, H_all + b * dy * dx, size_t(dx), dy, dx);
  stage<T, true>(rs, ldy, R_all + b * dy * dy, dy);
  cp_async_commit();
  for (int i = tid; i < dy; i += NT) {
    const T v = inn_all[b * dy + i];
    inn[i] = v;
    rhs[i * ldr + dx] = v;
  }
  for (int idx = tid; idx < dy * dy; idx += NT) {
    const int i = idx / dy, j = idx - i * dy;
    rhs[i * ldr + oi + j] = i == j ? T(1) : T(0);
  }
  if (tid == 0) s_bad = 0;
  cp_async_wait_all();
  __syncthreads();

  // 1. H P into the right-hand side, and its transpose into (H P)ᵀ
  tile_mm<T, NT, kTM, kTN, false>(
      hs, ldx, ps, ldx, dy, dx, dx, 0, false,
      [&](int i0, int j0, const T (&acc)[kTM][kTN]) {
        put_rows<false>(rhs, ldr, i0, j0, acc, dy, dx, 0, true, same);
        put_cols(hpt, ldy, i0, j0, acc, dy, dx);
      });
  __syncthreads();

  // 2. Rt + H (H P)ᵀ into S; P symmetrised in place (H P has read it)
  tile_mm<T, NT, kTM, kTN, false>(
      hs, ldx, hpt, ldy, dy, dy, dx, 0, false,
      [&](int i0, int j0, const T (&acc)[kTM][kTN]) {
        put_rows<false>(lc, ldr, i0, j0, acc, dy, dy, 0, true,
                        [&](T v, int i, int j) {
                          return rs[i * ldy + j] + v;
                        });
      });
  symmetrize(ps, ldx, dx);
  __syncthreads();

  // 3. S = sym(Rt + G), its diagonal with the floor jitter + 1e-6·max|diag
  //    S| (warp 0 alone); Rt symmetrised in place
  symmetrize(lc, ldr, dy);
  symmetrize(rs, ldy, dy);
  if (tid < kWarp) {
    T mxd = T(0);
    for (int i = tid; i < dy; i += kWarp) {
      const T a = dabs(lc[i * ldr + i]);
      mxd = a > mxd ? a : mxd;
    }
#pragma unroll
    for (int o = kWarp / 2; o > 0; o /= 2) {
      const T other = __shfl_xor_sync(0xffffffffu, mxd, o);
      mxd = other > mxd ? other : mxd;
    }
    for (int i = tid; i < dy; i += kWarp)
      lc[i * ldr + i] += jitter + T(kRelJitter) * mxd;
  }
  __syncthreads();

  // 4. S = L Lᵀ in place (S is symmetric, so its rows are the columns of
  //    its lower triangle), in panels of 8 at dy ≤ 8, else of 16; the
  //    pivots' reciprocals, NaN throughout unless every pivot is positive,
  //    and Σ log Lᵢᵢ
  const bool narrow = dy <= kNarrowPanel;
  if (narrow)
    block_cholesky_panels<T, kNarrowPanel>(lc, dy, &s_bad, ldr);
  else
    block_cholesky_panels<T, kPanel>(lc, dy, &s_bad, ldr);
  const bool bad = s_bad != 0;
  for (int i = tid; i < ldy; i += NT)
    dinv[i] = bad ? qnan<T>() : i < dy ? T(1) / lc[i * ldr + i] : T(1);
  if (tid < kWarp) {
    T logdet = T(0);
    for (int i = tid; i < dy; i += kWarp) logdet += dlog(lc[i * ldr + i]);
    logdet = warp_sum(logdet);
    if (tid == 0) s_logdet = logdet;
  }
  __syncthreads();

  // 5. [Z | z | L⁻¹] = L⁻¹ [H P | innov | I] in place
  if (narrow)
    block_tri_solve<T, NT, kTM, kTN, kNarrowPanel>(lc, dinv, rhs, dx + 1,
                                                   rhs + oi, dy, dy, ldr);
  else
    block_tri_solve<T, NT, kTM, kTN, kPanel>(lc, dinv, rhs, dx + 1, rhs + oi,
                                             dy, dy, ldr);

  // 6. ll = −½(dy·log 2π + 2·Σ log Lᵢᵢ + zᵀz) (warp 0); W = Kᵀ = L⁻ᵀ Z,
  //    stored below Aᵀ and as the gain
  if (tid < kWarp) {
    T zsq = T(0);
    for (int i = tid; i < dy; i += kWarp) {
      const T z = rhs[i * ldr + dx];
      zsq += z * z;
    }
    zsq = warp_sum(zsq);
    if (tid == 0)
      ll_all[b] = T(-0.5) * (T(dy * kLog2Pi) + T(2) * s_logdet + zsq);
  }
  const bool vk = rows_aligned(kt_all, dx);
  tile_mm<T, NT, kTM, kTN, true>(
      rhs + oi, ldr, rhs, ldr, dy, dx, dy, 0, false,
      [&](int i0, int j0, const T (&acc)[kTM][kTN]) {
        put_rows<false>(wr, ldx, i0, j0, acc, dy, dx, 0, true, same);
        put_rows<false>(kt, dx, i0, j0, acc, dy, dx, 0, vk, same);
      });
  __syncthreads();

  // 7. Aᵀ = I − Hᵀ W (H read as Hᵀ); μ = m + K innov
  tile_mm<T, NT, kTM, kTN, true>(
      hs, ldx, wr, ldx, dx, dx, dy, 0, false,
      [&](int i0, int j0, const T (&acc)[kTM][kTN]) {
        put_rows<false>(at, ldx, i0, j0, acc, dx, dx, 0, true,
                        [](T v, int i, int j) {
                          return (i == j ? T(1) : T(0)) - v;
                        });
      });
  for (int i = tid; i < dx; i += NT) {
    T s = T(0);
    for (int l = 0; l < dy; ++l) s += wr[l * ldx + i] * inn[l];
    mean_all[b * dx + i] = m_all[b * dx + i] + s;
  }
  __syncthreads();

  // 8. [A P | K Rt]ᵀ = [sym(P) Aᵀ ; sym(Rt) W] over H and the
  //    right-hand side (P and Rt read as Pᵀ and Rtᵀ)
  tile_mm<T, NT, kTM, kTN, true>(
      ps, ldx, at, ldx, dx, dx, dx, 0, false,
      [&](int i0, int j0, const T (&acc)[kTM][kTN]) {
        put_rows<false>(xt, ldx, i0, j0, acc, dx, dx, 0, true, same);
      });
  tile_mm<T, NT, kTM, kTN, true>(
      rs, ldy, wr, ldx, dy, dx, dy, 0, false,
      [&](int i0, int j0, const T (&acc)[kTM][kTN]) {
        put_rows<false>(xt + dx * ldx, ldx, i0, j0, acc, dy, dx, 0, true,
                        same);
      });
  __syncthreads();

  // 9. cov = [A P | K Rt] · [Aᵀ ; W] (the first operand read from its
  //    transpose): the packed lower tiles, each stored with its mirror
  const bool vc = rows_aligned(cov_all, dx);
  tile_mm_lower<T, NT, kTM>(
      xt, ldx, at, ldx, dx, dx + dy,
      [&](int i0, int j0, const T (&acc)[kTM][kTN]) {
        put_mirrored(cov_all + b * dx * dx, dx, i0, j0, acc, dx, vc);
      });
}

// K2: Σ⁺ = sym(Fx P Fxᵀ + Fq Q Fqᵀ) of one element, Q shared. Barriers:
// staging, the symmetrisation of P and Q, G.
template <typename T>
__global__ void __launch_bounds__(kThreads) ekf_predict_cov_kernel(
    const T* __restrict__ Fx_all, const T* __restrict__ P_all,
    const T* __restrict__ Fq_all, const T* __restrict__ Q, T* cov_all,
    int dx, int dq) {
  constexpr int NT = kThreads;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const PredictWs L(dx, dq);
  const int oq = L.oq, ldF = L.ldF, ldx = L.ldx, ldq = L.ldq;

  T* ws = shared_workspace<T>();
  T* fs = ws;           // [Fx | 0 | Fq], round_up(dx, 4) rows
  T* ps = ws + L.p;     // P, then sym(P)
  T* qs = ws + L.q;     // Q, then sym(Q)
  T* gs = ws + L.g;     // [(Fx P)ᵀ ; 0 ; (Fq Q)ᵀ]

  // 0. staged (cp.async); the pad columns of F and pad rows of G zeroed
  stage<T, true>(fs, ldF, Fx_all + b * dx * dx, size_t(dx), dx, dx);
  stage<T, true>(fs + oq, ldF, Fq_all + b * dx * dq, size_t(dq), dx, dq);
  stage<T, true>(ps, ldx, P_all + b * dx * dx, dx);
  stage<T, true>(qs, ldq, Q, dq);
  cp_async_commit();
  const int pad = oq - dx;
  for (int idx = tid; idx < dx * pad; idx += NT)
    fs[(idx / pad) * ldF + dx + idx % pad] = T(0);
  for (int idx = tid; idx < pad * ldx; idx += NT) gs[dx * ldx + idx] = T(0);
  cp_async_wait_all();
  __syncthreads();

  // 1. P and Q symmetrised in place
  symmetrize(ps, ldx, dx);
  symmetrize(qs, ldq, dq);
  __syncthreads();

  // 2. G: Fx P and Fq Q, each stored transposed
  tile_mm<T, NT, kTM, kTN, false>(
      fs, ldF, ps, ldx, dx, dx, dx, 0, false,
      [&](int i0, int j0, const T (&acc)[kTM][kTN]) {
        put_cols(gs, ldx, i0, j0, acc, dx, dx);
      });
  tile_mm<T, NT, kTM, kTN, false>(
      fs + oq, ldF, qs, ldq, dx, dq, dq, 0, false,
      [&](int i0, int j0, const T (&acc)[kTM][kTN]) {
        put_cols(gs + oq * ldx, ldx, i0, j0, acc, dx, dq);
      });
  __syncthreads();

  // 3. Σ⁺ = [Fx | 0 | Fq] · G: lower tiles, each stored with its mirror
  const bool vc = rows_aligned(cov_all, dx);
  tile_mm<T, NT, kTM, kTN, false>(
      fs, ldF, gs, ldx, dx, dx, oq + dq, 0, true,
      [&](int i0, int j0, const T (&acc)[kTM][kTN]) {
        put_mirrored(cov_all + b * dx * dx, dx, i0, j0, acc, dx, vc);
      });
}

template <typename T>
int launch_update(const void* m, const void* P, const void* H, const void* R,
                  const void* inn, void* ll, void* mean, void* cov, void* kt,
                  int B, int dx, int dy, double jitter, void* stream) {
  const size_t smem = UpdateWs(dx, dy).total * sizeof(T);
  if (int err = set_smem(ekf_update_kernel<T>, smem)) return err;
  ekf_update_kernel<T><<<B, kThreads, smem, cudaStream_t(stream)>>>(
      static_cast<const T*>(m), static_cast<const T*>(P),
      static_cast<const T*>(H), static_cast<const T*>(R),
      static_cast<const T*>(inn), static_cast<T*>(ll), static_cast<T*>(mean),
      static_cast<T*>(cov), static_cast<T*>(kt), dx, dy, T(jitter));
  return int(cudaGetLastError());
}

template <typename T>
int launch_predict(const void* Fx, const void* P, const void* Fq,
                   const void* Q, void* cov, int B, int dx, int dq,
                   void* stream) {
  const size_t smem = PredictWs(dx, dq).total * sizeof(T);
  if (int err = set_smem(ekf_predict_cov_kernel<T>, smem)) return err;
  ekf_predict_cov_kernel<T><<<B, kThreads, smem, cudaStream_t(stream)>>>(
      static_cast<const T*>(Fx), static_cast<const T*>(P),
      static_cast<const T*>(Fq), static_cast<const T*>(Q),
      static_cast<T*>(cov), dx, dq);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* bft_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}

// The device's shared-memory opt-in per block in bytes (the bound on K1's
// and K2's workspaces), or -1 on a CUDA error.
int bft_smem_optin(int device) {
  int optin = 0;
  return cudaDeviceGetAttribute(&optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                device) == cudaSuccess
             ? optin
             : -1;
}

int bft_ekf_update_f32(const void* m, const void* P, const void* H,
                       const void* R, const void* inn, void* ll, void* mean,
                       void* cov, void* kt, int B, int dx, int dy,
                       double jitter, void* stream) {
  return launch_update<float>(m, P, H, R, inn, ll, mean, cov, kt, B, dx, dy,
                              jitter, stream);
}

int bft_ekf_update_f64(const void* m, const void* P, const void* H,
                       const void* R, const void* inn, void* ll, void* mean,
                       void* cov, void* kt, int B, int dx, int dy,
                       double jitter, void* stream) {
  return launch_update<double>(m, P, H, R, inn, ll, mean, cov, kt, B, dx, dy,
                               jitter, stream);
}

int bft_ekf_predict_cov_f32(const void* Fx, const void* P, const void* Fq,
                            const void* Q, void* cov, int B, int dx, int dq,
                            void* stream) {
  return launch_predict<float>(Fx, P, Fq, Q, cov, B, dx, dq, stream);
}

int bft_ekf_predict_cov_f64(const void* Fx, const void* P, const void* Fq,
                            const void* Q, void* cov, int B, int dx, int dq,
                            void* stream) {
  return launch_predict<double>(Fx, P, Fq, Q, cov, B, dx, dq, stream);
}

}  // extern "C"
