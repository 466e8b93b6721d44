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
// the Joseph form — far too little per block to feed the tensor cores. A
// block is bound by shared-memory bandwidth in those products and by the
// latency of the dy dependent Cholesky columns, each closed by a block
// barrier; occupancy is set by the working set. What the simple design
// does about it: every intermediate (H P, Hᵀ, S, L, L⁻¹, (I − K H)ᵀ,
// (I − K H) P, K Rt) stays in dynamic shared memory (19,456 elements at the
// main-path shape: 78 KB in f32, two blocks per SM). An element whose
// workspace exceeds the opt-in limit goes to the tiled variants K1t and K2t
// instead (ekf_tiled.cu; ops/fused_ekf.py chooses by shape). The
// factorisation needs one barrier per column (the thread that finishes row
// j+1 also takes pivot j+1), and L⁻¹ needs none: each thread
// forward-substitutes whole columns. Products are plain per-thread dot
// products in the working type — no TF32, no tensor cores — laid out so
// that their inner loops read shared memory without bank conflicts (the
// layout rule below); a first version that read A and Fx with a stride of
// dx words was 3–5× slower (measured on an H100 80GB HBM3 at 700 W,
// PERF.md).
//
// Math and constants follow ops/ekf.py chol_update_precomputed: S is
// symmetrised before the relative floor (jitter + 1e-6·max|diag S|) is
// added, the covariance is the symmetrised Joseph form, and the log-det
// comes from diag L. A non-PD S gives NaN (sqrt of a negative pivot), as in
// JAX; nothing here raises.
#include "common.cuh"

namespace {

using namespace bft;

constexpr int kThreads = 256;

size_t update_ws_elems(int dx, int dy) {
  return size_t(dy) * dx * 4      // H P, Hᵀ, Z, and K Rt (dx × dy)
         + size_t(dy) * dy * 3    // S, L (column-major), L⁻¹
         + size_t(dx) * dx * 2;   // (I − K H)ᵀ, (I − K H) P
}

size_t predict_ws_elems(int dx, int dq) {
  return size_t(dx) * dx * 2 + size_t(dx) * dq * 2;  // Fx P, Fxᵀ, Fq Q, Fqᵀ
}

// Layout rule for every product below: consecutive threads own consecutive
// output columns j, so the operand indexed by the output row is read as a
// broadcast and the one indexed by j as consecutive words (conflict-free
// shared memory, coalesced global). Operands that would otherwise be read
// with a stride (Hᵀ, Aᵀ, Fxᵀ, Fqᵀ, L stored column-major) are kept
// transposed.
template <typename T>
__global__ void __launch_bounds__(kThreads) ekf_update_kernel(
    const T* __restrict__ m_all, const T* __restrict__ P_all,
    const T* __restrict__ H_all, const T* __restrict__ R_all,
    const T* __restrict__ inn_all, T* ll_all, T* mean_all, T* cov_all,
    T* kt_all, int dx, int dy, T jitter) {
  __shared__ T s_floor;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const T* P = P_all + b * dx * dx;
  const T* H = H_all + b * dy * dx;
  const T* R = R_all + b * dy * dy;
  const T* m = m_all + b * dx;
  const T* inn = inn_all + b * dy;
  T* cov = cov_all + b * dx * dx;
  T* W = kt_all + b * dy * dx;  // Kᵀ = S⁻¹ H P, an output read back below

  T* ws = shared_workspace<T>();
  T* HP = ws;              // dy × dx
  T* HT = HP + dy * dx;    // dx × dy
  T* Z = HT + dx * dy;     // dy × dx; reused for z = L⁻¹ innov
  T* KR = Z + dy * dx;     // dx × dy
  T* S = KR + dx * dy;     // dy × dy
  T* Lc = S + dy * dy;     // dy × dy, Lc[k*dy + i] = L[i][k]
  T* Li = Lc + dy * dy;    // dy × dy, lower, row-major
  T* AT = Li + dy * dy;    // dx × dx, AT[k*dx + j] = A[j][k], A = I − K H
  T* AP = AT + dx * dx;    // dx × dx

  // 1. H P, Hᵀ
  block_mm_nn(HP, H, P, dy, dx, dx);
  block_transpose(HT, H, dy, dx);
  __syncthreads();

  // 2. G = H P Hᵀ into S
  for (int idx = tid; idx < dy * dy; idx += nt) {
    const int i = idx / dy, j = idx % dy;
    T g = T(0);
    for (int k = 0; k < dx; ++k) g += HP[i * dx + k] * HT[k * dy + j];
    S[idx] = g;
  }
  __syncthreads();

  // 3. S = sym(Rt + G), in place by pairs; clear L
  for (int idx = tid; idx < dy * dy; idx += nt) {
    const int i = idx / dy, j = idx % dy;
    if (i < j) {
      const T v = T(0.5) * ((R[i * dy + j] + S[i * dy + j])
                            + (R[j * dy + i] + S[j * dy + i]));
      S[i * dy + j] = v;
      S[j * dy + i] = v;
    } else if (i == j) {
      S[idx] = R[idx] + S[idx];
    }
    Lc[idx] = T(0);
  }
  __syncthreads();

  // 4. relative diagonal floor
  if (tid == 0) {
    T mx = T(0);
    for (int i = 0; i < dy; ++i) {
      const T a = dabs(S[i * dy + i]);
      mx = a > mx ? a : mx;
    }
    s_floor = jitter + T(kRelJitter) * mx;
  }
  __syncthreads();
  for (int i = tid; i < dy; i += nt) S[i * dy + i] += s_floor;
  __syncthreads();

  // 5. Cholesky–Crout, one barrier per column: the thread that completes
  //    row j+1 in column j also takes pivot j+1.
  if (tid == 0) Lc[0] = dsqrt(S[0]);
  __syncthreads();
  for (int j = 0; j + 1 < dy; ++j) {
    const T ljj = Lc[j * dy + j];
    for (int i = j + 1 + tid; i < dy; i += nt) {
      T s = S[i * dy + j];
      for (int k = 0; k < j; ++k) s -= Lc[k * dy + i] * Lc[k * dy + j];
      const T lij = s / ljj;
      Lc[j * dy + i] = lij;
      if (i == j + 1) {
        T d = S[i * dy + i];
        for (int k = 0; k <= j; ++k) d -= Lc[k * dy + i] * Lc[k * dy + i];
        Lc[i * dy + i] = dsqrt(d);
      }
    }
    __syncthreads();
  }

  // 6. L⁻¹ by forward substitution, whole columns per thread
  block_tri_inv_cm(Li, Lc, dy);
  __syncthreads();

  // 7. Z = L⁻¹ H P
  for (int idx = tid; idx < dy * dx; idx += nt) {
    const int i = idx / dx, c = idx % dx;
    T acc = T(0);
    for (int j = 0; j <= i; ++j) acc += Li[i * dy + j] * HP[j * dx + c];
    Z[idx] = acc;
  }
  __syncthreads();

  // 8. Kᵀ = L⁻ᵀ Z = S⁻¹ H P
  for (int idx = tid; idx < dy * dx; idx += nt) {
    const int i = idx / dx, c = idx % dx;
    T acc = T(0);
    for (int j = i; j < dy; ++j) acc += Li[j * dy + i] * Z[j * dx + c];
    W[idx] = acc;
  }
  __syncthreads();

  // 9. Aᵀ = (I − K H)ᵀ and K Rt
  for (int idx = tid; idx < dx * dx; idx += nt) {
    const int j = idx / dx, i = idx % dx;  // AT[j*dx + i] = A[i][j]
    T acc = T(0);
    for (int l = 0; l < dy; ++l) acc += W[l * dx + i] * HT[j * dy + l];
    AT[idx] = (i == j ? T(1) : T(0)) - acc;
  }
  for (int idx = tid; idx < dx * dy; idx += nt) {
    const int i = idx / dy, c = idx % dy;
    T acc = T(0);
    for (int a = 0; a < dy; ++a) acc += W[a * dx + i] * R[a * dy + c];
    KR[idx] = acc;
  }
  __syncthreads();

  // 10. A P
  for (int idx = tid; idx < dx * dx; idx += nt) {
    const int i = idx / dx, j = idx % dx;
    T acc = T(0);
    for (int k = 0; k < dx; ++k) acc += AT[k * dx + i] * P[k * dx + j];
    AP[idx] = acc;
  }
  __syncthreads();

  // 11. Joseph form Σ = A P Aᵀ + K Rt Kᵀ, then symmetrised in place
  for (int idx = tid; idx < dx * dx; idx += nt) {
    const int i = idx / dx, j = idx % dx;
    T apa = T(0), krk = T(0);
    for (int k = 0; k < dx; ++k) apa += AP[i * dx + k] * AT[k * dx + j];
    for (int c = 0; c < dy; ++c) krk += KR[i * dy + c] * W[c * dx + j];
    cov[idx] = apa + krk;
  }
  __syncthreads();
  block_symmetrize(cov, dx);

  // 12. μ = m + K innov and z = L⁻¹ innov
  for (int i = tid; i < dx; i += nt) {
    T acc = T(0);
    for (int l = 0; l < dy; ++l) acc += W[l * dx + i] * inn[l];
    mean_all[b * dx + i] = m[i] + acc;
  }
  for (int i = tid; i < dy; i += nt) {
    T acc = T(0);
    for (int j = 0; j <= i; ++j) acc += Li[i * dy + j] * inn[j];
    Z[i] = acc;
  }
  __syncthreads();

  // 13. log N(innov | 0, S) on the same factor
  if (tid == 0) {
    T logdet = T(0), zsq = T(0);
    for (int i = 0; i < dy; ++i) {
      logdet += dlog(Lc[i * dy + i]);
      zsq += Z[i] * Z[i];
    }
    ll_all[b] = T(-0.5) * (T(dy * kLog2Pi) + T(2) * logdet + zsq);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ekf_predict_cov_kernel(
    const T* __restrict__ Fx_all, const T* __restrict__ P_all,
    const T* __restrict__ Fq_all, const T* __restrict__ Q, T* cov_all,
    int dx, int dq) {
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const T* Fx = Fx_all + b * dx * dx;
  const T* P = P_all + b * dx * dx;
  const T* Fq = Fq_all + b * dx * dq;
  T* cov = cov_all + b * dx * dx;

  T* ws = shared_workspace<T>();
  T* FP = ws;              // dx × dx
  T* FxT = FP + dx * dx;   // dx × dx
  T* FQ = FxT + dx * dx;   // dx × dq
  T* FqT = FQ + dx * dq;   // dq × dx

  block_mm_nn(FP, Fx, P, dx, dx, dx);
  block_mm_nn(FQ, Fq, Q, dx, dq, dq);
  block_transpose(FxT, Fx, dx, dx);
  block_transpose(FqT, Fq, dx, dq);
  __syncthreads();
  for (int idx = tid; idx < dx * dx; idx += nt) {
    const int i = idx / dx, j = idx % dx;
    T fpf = T(0), fqf = T(0);
    for (int k = 0; k < dx; ++k) fpf += FP[i * dx + k] * FxT[k * dx + j];
    for (int k = 0; k < dq; ++k) fqf += FQ[i * dq + k] * FqT[k * dx + j];
    cov[idx] = fpf + fqf;
  }
  __syncthreads();
  block_symmetrize(cov, dx);
}

template <typename T>
int launch_update(const void* m, const void* P, const void* H, const void* R,
                  const void* inn, void* ll, void* mean, void* cov, void* kt,
                  int B, int dx, int dy, double jitter, void* stream) {
  const size_t smem = update_ws_elems(dx, dy) * sizeof(T);
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
  const size_t smem = predict_ws_elems(dx, dq) * sizeof(T);
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
